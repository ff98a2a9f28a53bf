"""CPU tests of what the on-card checks rest on: chip_smoke.py's device gate
and its small-size oracle comparison, bench.py's device gate, the
compile-cache placement, and the mesh-size guard."""

import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from ebwt2indel.models import traverse
from ebwt2indel.parallel import shard
from ebwt2indel.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra)
    return env


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_no_gpu_exits_nonzero_without_result(script):
    r = subprocess.run([sys.executable, script], cwd=REPO, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert '"value"' not in r.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_bytes(
        open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_oracle_check_agrees_with_oracle():
    r = chip_smoke.oracle_check(n_reads=30, read_len=30, genome_len=300)
    assert r["n"] == 30 * 31
    for n_k, n_r, n_min in r["counts"].values():
        assert n_k > 0 and n_r >= 0 and n_min >= 0


def test_oracle_check_catches_a_wrong_flag(monkeypatch):
    real = traverse.navigate_one_bwt

    def flipped(fm, K, k_right):
        res = real(fm, K, k_right)
        thr = np.asarray(res.thr_K).copy()
        thr[len(thr) // 2] ^= 1
        res.thr_K = thr
        return res

    monkeypatch.setattr(traverse, "navigate_one_bwt", flipped)
    with pytest.raises(RuntimeError, match="thr_K"):
        chip_smoke.oracle_check(n_reads=20, read_len=25, genome_len=200)


def test_forced_regime_restores_thresholds():
    before = traverse._LEAN_N, traverse._LOG_FLAGS_MIN
    with chip_smoke.forced_regime(huge=True):
        assert (traverse._LEAN_N, traverse._LOG_FLAGS_MIN) == (1000, 0)
        assert os.environ["EBWT_FORCE_HUGE_DIF"] == "1"
    assert (traverse._LEAN_N, traverse._LOG_FLAGS_MIN) == before
    assert "EBWT_FORCE_HUGE_DIF" not in os.environ


@pytest.mark.parametrize("env,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/x/cache", "JAX_PLATFORMS": "cpu"},
     "/x/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/x/cache", "JAX_PLATFORMS": ""},
     "/x/cache"),
    ({"JAX_PLATFORMS": ""}, compile_cache.DEFAULT_DIR),
    ({"JAX_PLATFORMS": "cpu"}, None),
])
def test_cache_dir_choice(monkeypatch, env, expected):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert compile_cache.cache_dir() == expected


_PROBE = ("import jax; from ebwt2indel.utils import compile_cache as c; "
          "d = c.enable(); print(d); "
          "print(jax.config.jax_compilation_cache_dir)")


def test_enable_uses_env_dir_and_sets_no_other(tmp_path):
    want = str(tmp_path / "xla")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
        env=dict(_cpu_env(), JAX_COMPILATION_CACHE_DIR=want))
    assert r.stdout.split() == [want, want]
    assert os.listdir(tmp_path) == ["xla"]


def test_enable_default_is_fixed_in_checkout_path():
    assert compile_cache.DEFAULT_DIR == os.path.join(REPO, ".cache", "xla")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True, env=_cpu_env(JAX_PLATFORMS=""))
    assert r.stdout.split() == [compile_cache.DEFAULT_DIR] * 2


def test_make_mesh_refuses_more_devices_than_exist():
    assert len(shard.make_mesh(8).devices.flat) == 8
    with pytest.raises(ValueError, match="9-device mesh"):
        shard.make_mesh(9)
