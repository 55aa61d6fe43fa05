"""scan.route: one route per platform, and the compile-cache location."""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import pytest

from vgen_tpu import compile_cache
from vgen_tpu.crypto.address import AddressFormat as F
from vgen_tpu.ops import pipeline
from vgen_tpu.pattern import Pattern
from vgen_tpu.scan import route

BATCH = 524_288
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# format -> (literal prefix, prefilter-able regex, unanchored regex)
PATTERNS = {
    F.P2PKH: ("^1Cat", "^1Catsxy[ab]", "Cat$"),
    F.P2PKH_UNCOMPRESSED: ("^1Cat", "^1Catsxy[ab]", "Cat$"),
    F.P2SH_P2WPKH: ("^3Cat", "^3Catsxy[ab]", "Cat$"),
    F.P2WPKH: ("^bc1qcat", "^bc1qcatsxy[ac]", "cat$"),
    F.P2TR: ("^bc1pcat", "^bc1pcatsxy[ac]", "cat$"),
    F.ETHEREUM: ("^0x1234", "^0x123456[ab]", "12$"),
}
SHAPES = {"literal": ("range", 0), "prefilter": ("range", 1),
          "unanchored": ("dfa", 2)}


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("fmt", list(PATTERNS), ids=lambda f: f.value)
def test_route_per_platform(fmt, shape, platform):
    kind, col = SHAPES[shape]
    pat = Pattern(PATTERNS[fmt][col])
    for is_range in (False, True):
        ivs = route.plan_intervals(pat, fmt, BATCH, is_range)
        r = route.route(platform, fmt, ivs, is_range)
        assert r.kind == kind
        # GLV (6 keys per EC add) on random scans of the GLV formats only;
        # range scans must report keys inside the range
        assert r.glv == (not is_range and fmt in pipeline.GLV_FORMATS)
        assert r.k_sub == (route.GPU_K_SUB if platform == "gpu" else 1)
        assert [f.name for f in dataclasses.fields(r)] == [
            "kind", "glv", "k_sub"]
        assert "pallas" not in repr(r).lower()
        assert "fused" not in repr(r).lower()


def test_no_pallas_module_left():
    import vgen_tpu.ops

    names = [m.name for m in pkgutil.iter_modules(vgen_tpu.ops.__path__)]
    assert "pipeline" in names
    assert not [n for n in names if "pallas" in n]


def test_unsupported_platform_is_an_error():
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        route.route("rocm", F.P2PKH, None, False)
    with pytest.raises(ValueError):
        route.exact_f32_dots("metal")


def test_platform_choices():
    # the dot form of u256.mul_cols is exact in f32 only; TF32 rounds it
    assert route.exact_f32_dots("cpu") and not route.exact_f32_dots("gpu")
    assert route.windows_per_dispatch("gpu", 16) == 16
    assert route.windows_per_dispatch("cpu", 16) == 1


def test_prefilter_budget_counts_glv():
    """A prefix selective enough for a range scan can be too weak once GLV
    multiplies the survivors by 6."""
    pat = Pattern("^1Ca[tb]")
    p = pat.prefilter_intervals(F.P2PKH)[1]
    batch = int(route.PREFILTER_MAX_SURVIVORS / p / 3)
    assert route.plan_intervals(pat, F.P2PKH, batch, True) is not None
    assert route.plan_intervals(pat, F.P2PKH, batch, False) is None


# -- compile cache ------------------------------------------------------------


def test_cache_env_set_is_honoured(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_env_unset_uses_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.enable() == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        ROOT, ".jax_cache")


def test_cache_path_stable_across_calls_and_processes(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.enable()
    assert compile_cache.enable() == first
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = subprocess.run(
        [sys.executable, "-c",
         "from vgen_tpu import compile_cache; print(compile_cache.enable())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == first


def test_cache_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# -- chip_smoke without a gpu -------------------------------------------------


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "phase 1: JAX sees no gpu" in out.stderr
    assert '"ok"' not in out.stdout
