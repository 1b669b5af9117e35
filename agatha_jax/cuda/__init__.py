"""The Hopper DP kernel: built from the committed sources, called via jax.ffi.

``dp.cuh`` holds the kernel body, ``dp_ffi.cu`` its CUDA entry point and
XLA FFI handler.  `load` compiles them with nvcc for ``sm_90a`` at first
use into ``.cache/cuda/<hash>/`` at the checkout root (gitignored; the
hash covers the sources and the command, so an edit rebuilds) and
registers the handler as the CUDA target ``agatha_dp``.  A failed build
raises: the gpu backend never falls back to the plain-JAX DP.

The kernel needs no scratch memory: each block keeps one pair's band
state in registers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp

from agatha_jax.config import AlignConfig
from agatha_jax.ops.bucket import window_width, wire_width

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("dp.cuh", "dp_ffi.cu")
TARGET = "agatha_dp"
ROWS_PER_THREAD = 8
WARP_ROWS = 32 * ROWS_PER_THREAD
MAX_THREADS = 512  # dp.cuh kMaxThreads
_LIB_NAME = "libagatha_dp.so"

_registered = False


def state_width(wt: int, cfg: AlignConfig) -> int:
    """Rows of the kernel's band window for a target width ``wt``.

    The window must cover the whole target, or at least
    `window_width(cfg)` rows when it slides; it is rounded up to whole
    warps (256 rows).  Rows past the target are never computed.
    """
    w = min(wt, window_width(cfg))
    w = -(-w // WARP_ROWS) * WARP_ROWS
    if w // ROWS_PER_THREAD > MAX_THREADS:
        raise ValueError(
            f"band_width {cfg.band_width} needs a {w}-row window; the CUDA "
            f"kernel holds at most {MAX_THREADS * ROWS_PER_THREAD} rows"
        )
    return w


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "nvcc"


def build_command(out: str, compiler: str = "nvcc") -> list[str]:
    """The one command that builds the kernel library into ``out``."""
    return [
        compiler, "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
        "-o", out, os.path.join(_DIR, "dp_ffi.cu"),
    ]


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(_DIR))


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(f.read())
    # the command's flags, not where the checkout happens to be
    h.update(" ".join(a for a in build_command("", "")
                      if not a.startswith(_DIR)).encode())
    return os.path.join(_repo_root(), ".cache", "cuda", h.hexdigest()[:16],
                        _LIB_NAME)


def build() -> str:
    """Compile the library if it is not built yet; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # build to a private name and rename, so that concurrent processes
    # never load a half-written library
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(build_command(tmp, nvcc()),
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run nvcc to build the DP kernel: {e}")
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed to build the DP kernel:\n" + proc.stderr[-4000:]
        )
    os.replace(tmp, path)
    return path


def load() -> None:
    """Build (once), load and register the kernel for the CUDA platform."""
    global _registered
    if _registered:
        return
    lib = ctypes.CDLL(build())
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.AgathaDp), platform="CUDA"
    )
    _registered = True


def dp_call(meta, tcodes, qfwd, *, cfg: AlignConfig, safe16: bool):
    """Traceable kernel call on one device's bucket (nibble-packed codes).

    The target must already be registered for the platform (`load`).
    """
    assert tcodes.dtype == jnp.uint8 and qfwd.dtype == jnp.uint8
    gb = meta.shape[0]
    return jax.ffi.ffi_call(
        TARGET, jax.ShapeDtypeStruct((gb, 4), jnp.int32)
    )(
        meta.astype(jnp.int32), tcodes, qfwd,
        match=cfg.match, mismatch=cfg.mismatch, gap_oe=cfg.gap_oe,
        gap_extend=cfg.gap_extend, slice_width=cfg.slice_width,
        z_threshold=cfg.z_threshold, band_width=cfg.band_width,
        w_state=state_width(wire_width(tcodes), cfg), safe16=int(safe16),
    )
