"""CLI surface tests: flag parity, dispatch, and error paths, driving the
actual `ebwt2indel` entry point in a subprocess."""

import os
import subprocess
import sys

import pytest

from ebwt2indel.tools import ebwt, simulate

REPO = os.path.join(os.path.dirname(__file__), "..")


def run_cli(args, timeout=240):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", "ebwt2indel.cli"] + args,
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO,
    )


def test_cli_help():
    r = run_cli(["-h", "-1", "x"])
    assert r.returncode == 0
    assert "ebwt2InDel [options]" in r.stdout
    assert "-t <arg>    ASCII value of terminator character" in r.stdout


def test_cli_missing_file():
    r = run_cli(["-1", "/nonexistent.ebwt", "-o", "/tmp/x.snp"])
    assert r.returncode == 1
    assert "Error: could not find file /nonexistent.ebwt" in r.stdout


def test_cli_mutually_exclusive(tmp_path):
    p = tmp_path / "a.ebwt"
    p.write_text("A#")
    r = run_cli(["-1", str(p), "-2", str(p), "-d", str(p), "-o", "/tmp/x.snp"])
    assert r.returncode == 1
    assert "Document array (-d) can only be used" in r.stdout


def test_cli_forbidden_character(tmp_path):
    p = tmp_path / "bad.ebwt"
    p.write_text("ACGTN#")
    r = run_cli(["-1", str(p), "-o", str(tmp_path / "o.snp")])
    assert r.returncode == 1
    assert "read forbidden character 'N'" in r.stdout


def test_cli_mode1_end_to_end(tmp_path, rng):
    genome = simulate.random_genome(rng, 3000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.005,
                                      indel_rate=0.001)
    reads = simulate.sample_reads(rng, genome, 8, 70) + \
        simulate.sample_reads(rng, hap2, 8, 70)
    p = tmp_path / "r.ebwt"
    p.write_text(ebwt.ebwt_of_reads(reads))
    out = tmp_path / "o.snp"
    r = run_cli(["-1", str(p), "-o", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "This is ebwt2InDel" in r.stdout
    assert "Phase 4/4" in r.stdout
    assert out.exists()
    content = out.read_text()
    if content:
        assert content.startswith(">cluster:1_id:1_right:")


def test_cli_custom_terminator(tmp_path, rng):
    reads = ["ACGTACGTACGTACGT"] * 6
    bwt = ebwt.ebwt_of_reads(reads, term="$")
    p = tmp_path / "r.ebwt"
    p.write_text(bwt)
    out = tmp_path / "o.snp"
    r = run_cli(["-1", str(p), "-o", str(out), "-t", "36"])
    assert r.returncode == 0, r.stdout + r.stderr
