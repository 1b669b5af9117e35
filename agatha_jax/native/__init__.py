"""Native (C++) host-path helpers, loaded through ctypes.

The shared object is built on demand with g++ (cached next to the
source); every entry point has a pure-NumPy fallback so the package
works without a toolchain.  The native path exists because host-side
encode/pack throughput must keep multiple chips fed at pod scale —
the same reason the reference implements its batch fill in C++
(host_batch.cpp) and packing on the GPU (pack_rc_seqs.h).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_DIR, "packer.cpp"),
    os.path.join(_DIR, "traceback.cpp"),
]


def _arch_tag() -> str:
    """Microarchitecture fingerprint embedded in the cached .so name.

    The library is built -march=native; on a shared filesystem (NFS
    home on a pod) or a pre-baked container image another host could
    otherwise dlopen a binary with unsupported instructions and die
    with SIGILL mid-call.  Hashing the CPU feature-flag set gives each
    microarchitecture its own cache entry.
    """
    import hashlib
    import platform

    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    h = hashlib.sha256(feats.encode()).hexdigest()[:10]
    return f"{platform.machine()}-{h}"


_SO = os.path.join(_DIR, f"_packer.{_arch_tag()}.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)) or any(
            os.path.getmtime(_SO) < os.path.getmtime(s) for s in _SRCS
        ):
            # build to a private temp file and rename atomically so
            # concurrent processes never dlopen a half-written .so
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp] + _SRCS,
                check=True, capture_output=True,
            )
            os.replace(tmp, _SO)
        lib = ctypes.CDLL(_SO)
        i64 = ctypes.c_int64
        p8 = ctypes.POINTER(ctypes.c_uint8)
        p64 = ctypes.POINTER(ctypes.c_int64)
        p32 = ctypes.POINTER(ctypes.c_int32)
        lib.agatha_encode_batch.argtypes = [p8, p64, p8, i64, p8, i64,
                                            p32, ctypes.c_int32]
        lib.agatha_encode_batch.restype = ctypes.c_int
        lib.agatha_pack_nibbles.argtypes = [p8, i64, i64, p8,
                                            ctypes.c_int32]
        lib.agatha_pack_nibbles.restype = ctypes.c_int
        i32 = ctypes.c_int32
        lib.agatha_traceback.argtypes = [
            p8, p8, i32, i32, i32, i32, i32, i32, i32, i32,
            ctypes.c_char_p, i64, p64,
        ]
        lib.agatha_traceback.restype = ctypes.c_int
        lib.agatha_traceback_adaptive.argtypes = [
            p8, p8, i32, i32, i32, i32, i32, i32, i32, i64,
            ctypes.c_char_p, i64, p64,
        ]
        lib.agatha_traceback_adaptive.restype = ctypes.c_int
        lib.agatha_traceback_batch.argtypes = [
            p8, p64, p8, p64, p32, p32, p64, i64,
            i32, i32, i32, i32, i32,
            ctypes.c_char_p, i64, p64, p32, i32,
        ]
        lib.agatha_traceback_batch.restype = ctypes.c_int
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def encode_batch(
    seqs: list[bytes],
    ops: np.ndarray | None,
    stride: int,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of ASCII sequences to (n, stride) padded codes.

    Falls back to ops.packing.encode_padded when the native library is
    unavailable.  Returns (codes uint8 (n, stride), lens int32 (n,)).
    """
    n = len(seqs)
    out = np.zeros((n, stride), np.uint8)
    lens = np.zeros(n, np.int32)
    lib = _load()
    if lib is not None:
        blob = b"".join(seqs)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(s) for s in seqs], out=offsets[1:])
        opsa = (
            np.zeros(n, np.uint8) if ops is None
            else np.ascontiguousarray(ops, np.uint8)
        )
        blob_a = np.frombuffer(blob, np.uint8)
        if blob_a.size == 0:
            blob_a = np.zeros(1, np.uint8)
        rc = lib.agatha_encode_batch(
            _p8(blob_a),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            _p8(opsa),
            n,
            _p8(out),
            stride,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int32(n_threads),
        )
        if rc == 0:
            return out, lens
    # fallback
    from agatha_jax.ops.packing import encode_padded

    for i, s in enumerate(seqs):
        op = 0 if ops is None else int(ops[i])
        c = encode_padded(s, op)
        out[i, : len(c)] = c
        lens[i] = len(s)
    return out, lens


def traceback(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_end: int,
    t_end: int,
    cfg,
    bw_region: int | None = None,
) -> tuple[str, int] | None:
    """Native CIGAR traceback; None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    if bw_region is None:
        bw_region = max(cfg.band_width, abs(q_end - t_end)) + 16
    qc = np.ascontiguousarray(q_codes, np.uint8)
    tc = np.ascontiguousarray(t_codes, np.uint8)
    cap = 16 * (q_end + t_end + 8) + 64
    score = np.zeros(1, np.int64)
    # rc contract: 0 ok, -1 cigar buffer too small (retry larger),
    # -2 walk escaped the band (a real failure — raise, don't fall
    # back to the slow NumPy path only to re-derive the same escape).
    for _ in range(3):
        buf = ctypes.create_string_buffer(cap)
        rc = lib.agatha_traceback(
            _p8(qc), _p8(tc),
            ctypes.c_int32(q_end), ctypes.c_int32(t_end),
            ctypes.c_int32(cfg.match), ctypes.c_int32(cfg.mismatch),
            ctypes.c_int32(cfg.gap_oe), ctypes.c_int32(cfg.gap_extend),
            ctypes.c_int32(cfg.band_width), ctypes.c_int32(bw_region),
            buf, ctypes.c_int64(cap),
            score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == 0:
            return buf.value.decode("ascii"), int(score[0])
        if rc == -1:
            cap *= 4
            continue
        break
    if rc == -2:
        raise RuntimeError(
            f"traceback escaped the band (q_end={q_end}, t_end={t_end}, "
            f"bw_region={bw_region}): the kernel-reported end position "
            "is not reachable inside the walk-back region"
        )
    raise RuntimeError(f"native traceback failed with rc={rc}")


def _path_band_excursion(cigar: str) -> int:
    """Max |r - q| along a query-centric CIGAR path from (0, 0).

    Only D/I runs change the r - q offset (M consumes both), and the
    offset is monotone within a run, so checking after each run is
    exact.  Used to attribute traceback-vs-kernel score mismatches:
    a path that exits the scoring band was invisible to the kernel's
    boundary-block band mask by construction.
    """
    off = 0
    mx = 0
    num = 0
    for ch in cigar:
        if "0" <= ch <= "9":
            num = num * 10 + ord(ch) - 48
            continue
        if ch == "D":
            off += num
        elif ch == "I":
            off -= num
        mx = max(mx, abs(off))
        num = 0
    return mx


def traceback_adaptive(
    q_codes: np.ndarray,
    t_codes: np.ndarray,
    q_end: int,
    t_end: int,
    cfg,
    expected_score: int,
) -> tuple[str, int] | None:
    """Adaptive-band CIGAR traceback; None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    qc = np.ascontiguousarray(q_codes, np.uint8)
    tc = np.ascontiguousarray(t_codes, np.uint8)
    cap = 4 * (q_end + t_end + 8) + 64
    buf = ctypes.create_string_buffer(cap)
    score = np.zeros(1, np.int64)
    rc = lib.agatha_traceback_adaptive(
        _p8(qc), _p8(tc),
        ctypes.c_int32(q_end), ctypes.c_int32(t_end),
        ctypes.c_int32(cfg.match), ctypes.c_int32(cfg.mismatch),
        ctypes.c_int32(cfg.gap_oe), ctypes.c_int32(cfg.gap_extend),
        ctypes.c_int32(cfg.band_width),
        ctypes.c_int64(expected_score),
        buf, ctypes.c_int64(cap),
        score.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == -2:
        raise RuntimeError(
            f"traceback escaped the walk-back window (q_end={q_end}, "
            f"t_end={t_end}): the kernel-reported end position is not "
            "reachable inside the region"
        )
    if rc == 1:
        # Accepted at the widest window with achieved != expected.
        # Two band-geometry regimes explain a mismatch and are NOT
        # engine bugs (tests/test_traceback.py
        # test_band_exempt_end_stale_carry):
        #   * band-exempt end (|q_end-t_end| > bw): the reference's
        #     boundary-block band test SKIPS out-of-band cells while
        #     retaining their stale H (agatha_kernel.h:236-239
        #     `continue` keeps the previous column's value in the
        #     register), so the kernel score can include stale-carry
        #     values no genuine affine path reproduces;
        #   * achieved > expected along a path that exits the band:
        #     the walk window is deliberately wider than the scoring
        #     band, so it can see genuine paths the kernel's band
        #     mask hid.
        # Anything else signals a scoring mismatch (legitimate only
        # under int16 wrap, outside int16_safe) — make it observable.
        cig = buf.value.decode("ascii")
        explained = abs(q_end - t_end) > cfg.band_width or (
            int(score[0]) > expected_score
            and _path_band_excursion(cig) > cfg.band_width
        )
        if not explained:
            import warnings

            warnings.warn(
                f"traceback score {int(score[0])} != kernel-reported "
                f"{expected_score} at the widest window (q_end={q_end}, "
                f"t_end={t_end}); expected only in int16-wrap regimes",
                RuntimeWarning, stacklevel=2,
            )
    elif rc != 0:
        raise RuntimeError(f"native adaptive traceback rc={rc}")
    return buf.value.decode("ascii"), int(score[0])


def traceback_batch(
    encoded: list,
    q_ends: np.ndarray,
    t_ends: np.ndarray,
    expected: np.ndarray,
    cfg,
    n_threads: int = 0,
) -> list[str] | None:
    """Batch adaptive-band CIGAR traceback; None when unavailable.

    encoded: list of (q_codes, t_codes, qlen, rlen).  The adaptive
    engine starts from a narrow window skewed along the end-point line
    and widens until the achieved score equals ``expected`` (the score
    the device DP reported) — see native/traceback.cpp engine 2.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(encoded)
    if n == 0:
        return []
    qoff = np.zeros(n + 1, np.int64)
    toff = np.zeros(n + 1, np.int64)
    np.cumsum([len(e[0]) for e in encoded], out=qoff[1:])
    np.cumsum([len(e[1]) for e in encoded], out=toff[1:])
    qblob = np.concatenate([np.asarray(e[0], np.uint8) for e in encoded])
    tblob = np.concatenate([np.asarray(e[1], np.uint8) for e in encoded])
    qe = np.ascontiguousarray(q_ends, np.int32)
    te = np.ascontiguousarray(t_ends, np.int32)
    exp = np.ascontiguousarray(expected, np.int64)
    # Worst-case CIGAR: alternating single ops, 2 bytes per op.
    per_cap = int(4 * (qe.max() + te.max() + 8) + 64)
    cigars = np.zeros((n, per_cap), np.uint8)
    scores = np.zeros(n, np.int64)
    rcs = np.zeros(n, np.int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.agatha_traceback_batch(
        _p8(qblob), qoff.ctypes.data_as(p64),
        _p8(tblob), toff.ctypes.data_as(p64),
        qe.ctypes.data_as(p32), te.ctypes.data_as(p32),
        exp.ctypes.data_as(p64), ctypes.c_int64(n),
        ctypes.c_int32(cfg.match), ctypes.c_int32(cfg.mismatch),
        ctypes.c_int32(cfg.gap_oe), ctypes.c_int32(cfg.gap_extend),
        ctypes.c_int32(cfg.band_width),
        cigars.ctypes.data_as(ctypes.c_char_p), ctypes.c_int64(per_cap),
        scores.ctypes.data_as(p64), rcs.ctypes.data_as(p32),
        ctypes.c_int32(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"native traceback_batch failed with rc={rc}")
    bad = np.flatnonzero(rcs == -2)
    if bad.size:
        raise RuntimeError(
            f"traceback escaped the walk-back window for pairs "
            f"{bad[:5].tolist()}: kernel-reported end positions are "
            "not reachable inside the region"
        )
    bad = np.flatnonzero((rcs != 0) & (rcs != 1))
    if bad.size:
        raise RuntimeError(
            f"native traceback_batch per-pair failure rc="
            f"{rcs[bad[0]]} for pairs {bad[:5].tolist()}"
        )
    out = []
    for i in range(n):
        row = cigars[i]
        end = int(np.argmin(row)) if row[-1] == 0 else per_cap
        out.append(row[:end].tobytes().decode("ascii"))
    mismatched = np.flatnonzero(rcs == 1)
    if mismatched.size:
        # rc 1: widest-window acceptance with achieved != expected
        # (see traceback_adaptive).  Band-geometry regimes explain a
        # mismatch and stay silent: band-exempt ends (the reference's
        # stale-carry regime) and higher-scoring genuine paths that
        # exit the band (invisible to the kernel's band mask).  Warn
        # only on the unexplained remainder.
        bw = cfg.band_width
        unexplained = [
            int(i) for i in mismatched
            if abs(int(qe[i]) - int(te[i])) <= bw
            and not (int(scores[i]) > int(exp[i])
                     and _path_band_excursion(out[i]) > bw)
        ]
        if unexplained:
            import warnings

            warnings.warn(
                f"{len(unexplained)} pair(s) {unexplained[:5]} "
                "produced a traceback score different from the kernel-"
                "reported score at the widest window; expected only in "
                "int16-wrap regimes",
                RuntimeWarning, stacklevel=2,
            )
    return out


def pack_nibbles_rows(codes: np.ndarray,
                      n_threads: int = 0) -> np.ndarray:
    """(n, stride) codes -> (n, stride/2) nibble-packed, native if able."""
    n, stride = codes.shape
    lib = _load()
    if lib is not None and stride % 2 == 0:
        codes = np.ascontiguousarray(codes, np.uint8)
        out = np.empty((n, stride // 2), np.uint8)
        if lib.agatha_pack_nibbles(_p8(codes), n, stride, _p8(out),
                                   ctypes.c_int32(n_threads)) == 0:
            return out
    from agatha_jax.ops.bucket import pack_nibbles

    return pack_nibbles(codes)
