"""Property tests: vectorized emission paths vs the reference-faithful
SnpWriter on randomized inputs (beyond the end-to-end golden tests)."""

import io

import numpy as np

from ebwt2indel.models import emit, emit_vec
from ebwt2indel.utils.config import Config

BASES = np.frombuffer(b"ACGT", np.uint8)


def random_pair_inputs(rng, S, L=15, Lr=10):
    found = rng.random(S) < 0.8
    freq0 = rng.random((S, 4)) < 0.4
    full0 = rng.random((S, 4)) < 0.8
    freq1 = rng.random((S, 4)) < 0.4
    full1 = rng.random((S, 4)) < 0.8
    support0 = rng.integers(0, 8, (S, 4)).astype(np.int32)
    support1 = rng.integers(0, 8, (S, 4)).astype(np.int32)
    ctx0 = rng.choice(BASES, size=(S, 4, L))
    ctx1 = rng.choice(BASES, size=(S, 4, L))
    # make some context pairs nearly identical so distances pass filters
    for s in range(S):
        if rng.random() < 0.6:
            for c in range(4):
                ctx1[s, c] = ctx0[s, c]
                ctx1[s, c, -1] = BASES[(int(np.where(BASES == ctx0[s, c, -1])[0][0]) + 1) % 4]
    seq = rng.choice(BASES, size=(S, Lr))
    seqlen = rng.integers(0, Lr + 1, S).astype(np.int32)
    return (found, freq0, full0, freq1, full1, support0, support1,
            ctx0, ctx1, seq, seqlen)


def reference_pair_emit(cfg, found, freq0, full0, freq1, full1,
                        support0, support1, ctx0, ctx1, seq, seqlen):
    out = io.StringIO()
    writer = emit.SnpWriter(out, complexity=cfg.complexity,
                            max_snvs=cfg.max_snvs, mcov_out=cfg.mcov_out,
                            max_gap=cfg.max_gap)
    S = len(found)
    for j in range(S):
        variants = []
        if found[j]:
            right = seq[j, : seqlen[j]].tobytes().decode()
            for c0 in range(4):
                if not (freq0[j, c0] and full0[j, c0]):
                    continue
                for c1 in range(4):
                    if not (freq1[j, c1] and full1[j, c1]):
                        continue
                    if c0 != c1:
                        variants.append(emit.VariantPair(
                            ctx0[j, c0].tobytes().decode(),
                            ctx1[j, c1].tobytes().decode(),
                            right, int(support0[j, c0]),
                            int(support1[j, c1])))
        writer.write_pair_cluster(variants)
    return out.getvalue(), writer.events, writer.cluster_nr


def test_emit_pair_matches_writer(rng):
    for trial in range(8):
        S = int(rng.integers(1, 60))
        cfg = Config(
            mcov_out=int(rng.integers(1, 5)),
            max_snvs=int(rng.integers(1, 4)),
            max_gap=int(rng.integers(1, 5)),
            complexity=int(rng.integers(1, 6)),
            k_left=15, k_right=10, K=4,
        ).resolved()
        args = random_pair_inputs(rng, S)
        exp_text, _exp_events, exp_nr = reference_pair_emit(cfg, *args)
        buf = io.StringIO()
        got = emit_vec.emit_pair(buf, cfg, *args)
        assert buf.getvalue() == exp_text, f"trial {trial}"
        assert got["cluster_nr"] == exp_nr, f"trial {trial}"
