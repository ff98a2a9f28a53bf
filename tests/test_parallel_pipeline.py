"""End-to-end SHARDED mode-1 pipeline tests on the 8-device virtual CPU
mesh: the .snp produced from a mesh run must be byte-identical to the
single-device pipeline (itself golden-tested against the reference binary)
and, when the reference is built, to the reference binary directly."""

import os
import subprocess

import pytest

from ebwt2indel.models import pipeline as mpipe
from ebwt2indel.parallel import pipeline as ppipe
from ebwt2indel.parallel import shard
from ebwt2indel.utils.config import Config
from tests.test_parity import REF_BIN, make_dataset, needs_ref


def _quiet(*a, **k):
    pass


def test_sharded_mode1_matches_single_device(tmp_path, rng):
    path, _ = make_dataset(str(tmp_path), rng, genome_len=5000, coverage=12)
    one = str(tmp_path / "one.snp")
    mesh_out = str(tmp_path / "mesh.snp")

    mpipe.run_one_dataset(Config(input1=path, output=one), log=_quiet)
    mesh = shard.make_mesh(8)
    stats = ppipe.run_one_dataset_sharded(
        Config(input1=path, output=mesh_out), mesh, log=_quiet
    )
    assert open(one, "rb").read() == open(mesh_out, "rb").read()
    assert stats["n_clusters"] > 0


@needs_ref
def test_sharded_mode1_matches_reference(tmp_path, rng):
    path, _ = make_dataset(str(tmp_path), rng, genome_len=5000, coverage=12)
    ref_out = str(tmp_path / "ref.snp")
    mesh_out = str(tmp_path / "mesh.snp")
    subprocess.run([REF_BIN, "-1", path, "-o", ref_out, "-m", "2", "-k",
                    "12"], check=True, capture_output=True)

    mesh = shard.make_mesh(8)
    cfg = Config(input1=path, output=mesh_out)
    cfg.mcov_out = 2
    cfg.K = 12
    ppipe.run_one_dataset_sharded(cfg, mesh, log=_quiet)
    assert open(ref_out, "rb").read() == open(mesh_out, "rb").read()


def test_sharded_mode2_matches_single_device(tmp_path, rng):
    from ebwt2indel.tools import ebwt, simulate

    genome = simulate.random_genome(rng, 5000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    p1 = str(tmp_path / "a.ebwt")
    p2 = str(tmp_path / "b.ebwt")
    open(p1, "w").write(
        ebwt.ebwt_of_reads(simulate.sample_reads(rng, genome, 8, 80)))
    open(p2, "w").write(
        ebwt.ebwt_of_reads(simulate.sample_reads(rng, hap2, 8, 80)))

    one = str(tmp_path / "one.snp")
    mesh_out = str(tmp_path / "mesh.snp")
    mpipe.run_two_datasets(Config(input1=p1, input2=p2, output=one),
                           log=_quiet)
    mesh = shard.make_mesh(8)
    stats = ppipe.run_two_datasets_sharded(
        Config(input1=p1, input2=p2, output=mesh_out), mesh, log=_quiet
    )
    assert open(one, "rb").read() == open(mesh_out, "rb").read()
    assert os.path.getsize(one) > 0
    assert stats["n_clusters"] > 0


def test_sharded_mode3_matches_single_device(tmp_path, rng):
    from ebwt2indel.tools import ebwt, simulate

    genome = simulate.random_genome(rng, 5000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads1 = simulate.sample_reads(rng, genome, 8, 80)
    reads2 = simulate.sample_reads(rng, hap2, 8, 80)
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    p = str(tmp_path / "merged.ebwt")
    pda = str(tmp_path / "merged.da")
    open(p, "w").write(bwt)
    open(pda, "w").write(da)

    one = str(tmp_path / "one.snp")
    mesh_out = str(tmp_path / "mesh.snp")
    mpipe.run_two_datasets_da(Config(input1=p, input_da=pda, output=one),
                              log=_quiet)
    mesh = shard.make_mesh(8)
    stats = ppipe.run_two_datasets_da_sharded(
        Config(input1=p, input_da=pda, output=mesh_out), mesh, log=_quiet
    )
    assert open(one, "rb").read() == open(mesh_out, "rb").read()
    assert os.path.getsize(one) > 0
    assert stats["n_clusters"] > 0


def test_multihost_two_process_cli(tmp_path, rng):
    """True multi-process run: 2 jax.distributed processes x 4 virtual CPU
    devices form one 8-device global mesh over a localhost coordinator
    (gloo collectives); process 0's .snp must match single-device."""
    import socket

    path, _ = make_dataset(str(tmp_path), rng, genome_len=3000, coverage=10)
    one = str(tmp_path / "one.snp")
    mesh_out = str(tmp_path / "dist.snp")
    mpipe.run_one_dataset(Config(input1=path, output=one), log=_quiet)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    procs = []
    for pid in range(2):
        env = dict(
            os.environ, JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            EBWT_COORD=f"localhost:{port}", EBWT_NPROCS="2",
            EBWT_PROCID=str(pid),
        )
        procs.append(subprocess.Popen(
            ["python", "-m", "ebwt2indel.cli", "-1", path, "-o",
             mesh_out],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"proc failed:\n{out}\n{err}"
    assert "mesh" in outs[0][0]
    assert open(one, "rb").read() == open(mesh_out, "rb").read()
    # non-primary wrote its replica to the scratch path, identical content
    assert open(mesh_out + ".proc1", "rb").read() == open(one, "rb").read()
    # sharded loader: each process packed only ~half the input bytes
    import re

    n_file = os.path.getsize(path)
    for out, _ in outs:
        m = re.search(r"\[loader\] process \d+ packed (\d+)/(\d+)", out)
        assert m, f"loader line missing in:\n{out}"
        assert int(m.group(2)) == n_file
        assert int(m.group(1)) <= n_file // 2 + 4 * 128  # half + row slack


def test_sharded_cli_switch(tmp_path, rng):
    """EBWT_MESH routes the CLI through the sharded pipeline."""
    path, _ = make_dataset(str(tmp_path), rng, genome_len=3000, coverage=10)
    one = str(tmp_path / "one.snp")
    mesh_out = str(tmp_path / "mesh.snp")
    mpipe.run_one_dataset(Config(input1=path, output=one), log=_quiet)

    env = dict(os.environ, EBWT_MESH="8", JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run(
        ["python", "-m", "ebwt2indel.cli", "-1", path, "-o", mesh_out],
        env=env, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    assert "mesh" in r.stdout  # sharded banner
    assert open(one, "rb").read() == open(mesh_out, "rb").read()
