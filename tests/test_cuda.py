"""CPU tests of the CUDA route: its wrapper, build, route choice, and the
kernel body itself, run through a host emulation of a CUDA block
(tests/cuda_emu/dp_host.cc) and compared with the plain-JAX DP on all
four output columns."""

import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agatha_jax import cuda
from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.engine import AlignEngine
from agatha_jax.ops import dp
from agatha_jax.ops.bucket import build_bucket_arrays
from agatha_jax.ops.packing import encode_padded

from .conftest import mutate, random_seq

CANON = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMU_SRC = os.path.join(os.path.dirname(__file__), "cuda_emu", "dp_host.cc")


@pytest.fixture(scope="module")
def emulated_kernel(tmp_path_factory):
    """Register the host emulation as the ``agatha_dp`` CPU target."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    out = str(tmp_path_factory.mktemp("emu") / "libdp_host.so")
    subprocess.run(
        ["g++", "-std=c++20", "-O2", "-shared", "-fPIC",
         "-I", jax.ffi.include_dir(), "-I", cuda._DIR, "-o", out,
         EMU_SRC, "-lpthread"],
        check=True, capture_output=True,
    )
    lib = ctypes.CDLL(out)
    jax.ffi.register_ffi_target(
        cuda.TARGET, jax.ffi.pycapsule(lib.AgathaDpHost), platform="cpu"
    )
    return lib


def _random_pairs(rng, n, lo, hi, n_frac=0.02):
    pairs = []
    for i in range(n):
        q = random_seq(rng, int(rng.integers(lo, hi)), n_frac)
        t = mutate(rng, q) if i % 2 == 0 else random_seq(
            rng, int(rng.integers(lo, hi)), n_frac)
        pairs.append((encode_padded(q), encode_padded(t), len(q), len(t)))
    return pairs


def _shapes(rng, shapes, n_frac=0.05):
    pairs = []
    for ql, rl in shapes:
        q = random_seq(rng, ql, n_frac)
        t = random_seq(rng, rl, n_frac)
        pairs.append((encode_padded(q), encode_padded(t), ql, rl))
    return pairs


EMU_CASES = {
    "canonical": (CANON, lambda r: _random_pairs(r, 12, 1, 260), False),
    "z<0 strips": (AlignConfig(z_threshold=-1, band_width=50,
                               slice_width=1),
                   lambda r: _random_pairs(r, 8, 1, 260), False),
    "tight band": (AlignConfig(band_width=10, z_threshold=20,
                               slice_width=2),
                   lambda r: _random_pairs(r, 8, 1, 260), False),
    "band 0": (AlignConfig(band_width=0),
               lambda r: _random_pairs(r, 8, 1, 200), False),
    "windowed 2 warps": (
        AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                    band_width=60, z_threshold=200),
        lambda r: _random_pairs(r, 4, 650, 800, 0.01), False),
    "windowed forced strips": (
        AlignConfig(band_width=36, z_threshold=150),
        lambda r: _random_pairs(r, 4, 650, 800, 0.01), True),
    "3 warps": (AlignConfig(band_width=300, z_threshold=150),
                lambda r: _random_pairs(r, 4, 500, 700, 0.01), False),
    "edge shapes and N": (
        AlignConfig(match=2, mismatch=3, gap_open=5, gap_extend=1,
                    slice_width=2, z_threshold=60, band_width=15),
        lambda r: _shapes(r, [(8, 400), (400, 8), (1, 200), (200, 1),
                              (16, 391), (9, 9), (64, 257), (120, 120)],
                          0.2), False),
}


@pytest.mark.parametrize("case", list(EMU_CASES))
def test_kernel_body_matches_plain_dp(rng, emulated_kernel, case):
    """The CUDA kernel's body, run by the host emulation through the
    same jax.ffi call the gpu route makes, equals the plain-JAX DP on
    score, end points and diagonal count."""
    cfg, make, force = EMU_CASES[case]
    meta, tcodes, qfwd = build_bucket_arrays(make(rng))
    safe16 = dp.bucket_safe16(cfg, tcodes, qfwd, force)
    got = jax.jit(
        lambda m, t, q: cuda.dp_call(m, t, q, cfg=cfg, safe16=safe16)
    )(jnp.asarray(meta), jnp.asarray(tcodes), jnp.asarray(qfwd))
    ref = dp.align_bucket(meta, tcodes, qfwd, cfg, force_strips=force)
    got, ref = np.asarray(got), np.asarray(ref)
    assert (got == ref).all(), np.argwhere((got != ref).any(axis=1))


def test_ffi_call_shapes_and_attributes(rng):
    """The wrapper emits one agatha_dp custom call on the packed wire
    arrays, with the config as attributes and a (GB, 4) int32 result."""
    meta, tcodes, qfwd = build_bucket_arrays(_random_pairs(rng, 11, 900, 1500))
    assert meta.shape == (16, 2)
    assert tcodes.dtype == np.uint8 and tcodes.shape == (16, 768)
    text = jax.jit(
        lambda m, t, q: cuda.dp_call(m, t, q, cfg=CANON, safe16=True)
    ).lower(meta, tcodes, qfwd).as_text()
    assert "stablehlo.custom_call @agatha_dp" in text
    assert "tensor<16x4xi32>" in text
    for attr in ("match = 1", "mismatch = 4", "gap_oe = 8",
                 "gap_extend = 2", "slice_width = 3", "z_threshold = 400",
                 "band_width = 751", "w_state = 1024", "safe16 = 1"):
        assert attr in text, attr


@pytest.mark.parametrize("wt,band,rows", [
    (128, 751, 256),     # one warp covers a short target
    (384, 751, 512),     # whole warps only
    (1024, 751, 1024),   # the canonical window exactly
    (10240, 751, 1024),  # long target: the window slides
    (76800, 2001, 2304),  # wide band: nine warps
    (640, 36, 512),      # small band: window_width(36) = 384 -> 512
])
def test_state_width(wt, band, rows):
    assert cuda.state_width(wt, AlignConfig(band_width=band)) == rows


def test_state_width_refuses_too_wide_a_band():
    with pytest.raises(ValueError, match="holds at most"):
        cuda.state_width(100000, AlignConfig(band_width=4000))


def test_build_command_targets_sm90a():
    cmd = cuda.build_command("out.so", "nvcc")
    assert cmd[0] == "nvcc"
    i = cmd.index("-gencode")
    assert cmd[i + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and cmd[cmd.index("-o") + 1] == "out.so"
    assert cmd[cmd.index("-I") + 1] == jax.ffi.include_dir()
    assert cmd[-1] == os.path.join(cuda._DIR, "dp_ffi.cu")
    # every source the build reads is committed and hashed
    for name in cuda.SOURCES:
        assert os.path.exists(os.path.join(cuda._DIR, name)), name
    with open(os.path.join(cuda._DIR, "dp_ffi.cu")) as f:
        assert '#include "dp.cuh"' in f.read()


def test_library_path_keyed_by_sources(tmp_path, monkeypatch):
    path = cuda.library_path()
    rel = os.path.relpath(path, REPO).split(os.sep)
    assert rel[:2] == [".cache", "cuda"] and len(rel[2]) == 16
    assert rel[3] == "libagatha_dp.so"
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".cache/" in f.read().split()
    # an edited source gets its own build directory
    for name in cuda.SOURCES:
        shutil.copy(os.path.join(cuda._DIR, name), tmp_path / name)
    monkeypatch.setattr(cuda, "_DIR", str(tmp_path))
    assert os.path.basename(os.path.dirname(cuda.library_path())) == rel[2]
    with open(tmp_path / "dp.cuh", "a") as f:
        f.write("// edit\n")
    assert os.path.basename(os.path.dirname(cuda.library_path())) != rel[2]


@pytest.mark.parametrize("backend,requested,route", [
    ("gpu", None, "cuda"),
    ("cpu", None, "xla"),
    ("gpu", "xla", "xla"),
    ("cpu", "xla", "xla"),
    ("cpu", "cuda", ValueError),
    ("rocm", None, ValueError),
    ("gpu", "triton", ValueError),
])
def test_select_route(backend, requested, route):
    if route is ValueError:
        with pytest.raises(ValueError):
            dp.select_route(backend, requested)
    else:
        assert dp.select_route(backend, requested) == route


def test_gpu_raises_when_library_cannot_build(rng, tmp_path, monkeypatch):
    """On a gpu backend a failed build raises; the plain DP never runs
    in the CUDA route's place."""
    monkeypatch.setattr(dp.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cuda, "_registered", False)
    monkeypatch.setattr(cuda, "nvcc", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(cuda, "library_path",
                        lambda: str(tmp_path / "lib" / "libagatha_dp.so"))

    def no_fallback(*a, **k):
        raise AssertionError("fell back to the plain-JAX DP")

    monkeypatch.setattr(dp, "_dp_xla", no_fallback)
    meta, tcodes, qfwd = build_bucket_arrays(_random_pairs(rng, 3, 10, 50))
    with pytest.raises(RuntimeError, match="nvcc"):
        dp.align_bucket(meta, tcodes, qfwd, CANON)
    assert AlignEngine(CANON).route == "cuda"


def test_engine_route_follows_backend():
    assert AlignEngine(CANON).route == "xla"
    assert AlignEngine(CANON, EngineConfig(dp_route="xla")).route == "xla"
    with pytest.raises(ValueError, match="gpu backend"):
        AlignEngine(CANON, EngineConfig(dp_route="cuda")).route


@pytest.mark.gpu
def test_cuda_route_matches_plain_dp_on_card(rng):
    pairs = _random_pairs(rng, 16, 1, 2000)
    meta, tcodes, qfwd = build_bucket_arrays(pairs)
    got = dp.align_bucket(meta, tcodes, qfwd, CANON, route="cuda")
    ref = dp.align_bucket(meta, tcodes, qfwd, CANON, route="xla")
    assert (np.asarray(got) == np.asarray(ref)).all()
