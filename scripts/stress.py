"""Randomized device-vs-oracle stress verification.

Runs the backend's DP route (the CUDA kernel on a gpu, the plain-JAX DP
on the CPU) against the scalar-semantics oracle over randomized pairs
and configs, covering the full-width and sliding-window layouts, the
int16-safe fast path and the strict strip path, reverse/complement
ops, N bases, and extreme length asymmetry.  On a gpu every bucket is
also run through the plain-JAX DP and must match on all four columns.

Usage: python scripts/stress.py [n_rounds] [seed]
Exits non-zero on any mismatch.
"""

import _path  # noqa: F401  (repo-root shim, scripts/_path.py)
import sys


import numpy as np  # noqa: E402

from agatha_jax.config import AlignConfig  # noqa: E402
from agatha_jax.ops.bucket import build_bucket_arrays  # noqa: E402
from agatha_jax.ops.dp import align_bucket, select_route  # noqa: E402
from agatha_jax.ops.packing import encode_padded  # noqa: E402
from agatha_jax.ops.sweep import align_one_sweep  # noqa: E402

CONFIGS = [
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2),  # canonical
    AlignConfig(),                                               # defaults
    AlignConfig(band_width=100, z_threshold=100, slice_width=2),
    AlignConfig(band_width=2001, z_threshold=800),               # wide ONT
    AlignConfig(z_threshold=-1, band_width=200),                 # no Z-drop
    AlignConfig(match=3, mismatch=9, gap_open=16, gap_extend=1,
                slice_width=4, z_threshold=50, band_width=33),
]


def rseq(rng, n, nf=0.03):
    b = np.array(list("ACGT"))
    s = b[rng.integers(0, 4, size=n)]
    s[rng.random(n) < nf] = "N"
    return "".join(s)


def mutate(rng, seq, div=0.12):
    out = []
    bases = "ACGT"
    for ch in seq:
        r = rng.random()
        if r < div / 3:
            continue
        out.append(bases[rng.integers(0, 4)] if r < div else ch)
        if rng.random() < div / 3:
            out.append(bases[rng.integers(0, 4)])
    return "".join(out) or "A"


def main():
    argv = sys.argv[1:]
    rounds = int(argv[0]) if len(argv) > 0 else 4
    seed = int(argv[1]) if len(argv) > 1 else 0
    rng = np.random.default_rng(seed)
    route = select_route()
    total = bad = 0
    for rd in range(rounds):
        cfg = CONFIGS[rd % len(CONFIGS)]
        pairs = []
        for i in range(16):
            kind = rng.integers(0, 4)
            if kind == 0:      # homologous
                ql = int(rng.integers(1, 2000))
                q = rseq(rng, ql)
                t = mutate(rng, q)
            elif kind == 1:    # unrelated
                q = rseq(rng, int(rng.integers(1, 1500)))
                t = rseq(rng, int(rng.integers(1, 1500)))
            elif kind == 2:    # asymmetric
                q = rseq(rng, int(rng.integers(1, 50)))
                t = rseq(rng, int(rng.integers(500, 3000)))
            else:              # ops applied
                q = rseq(rng, int(rng.integers(10, 600)))
                t = mutate(rng, q)
            qop = int(rng.integers(0, 4))
            top = int(rng.integers(0, 4))
            qc = encode_padded(q, qop)
            tc = encode_padded(t, top)
            pairs.append((qc, tc, len(q), len(t)))

        meta, tcodes, qfwd = build_bucket_arrays(pairs)
        force = bool(rng.integers(0, 2))
        out = np.asarray(
            align_bucket(meta, tcodes, qfwd, cfg, force_strips=force)
        )
        round_bad = 0
        if route != "xla":
            ref = np.asarray(align_bucket(meta, tcodes, qfwd, cfg,
                                          force_strips=force, route="xla"))
            nb = int((out != ref).any(axis=1).sum())
            if nb:
                round_bad += nb
                print(f"ROUTE MISMATCH round={rd}: {nb} rows of {route} "
                      "differ from the plain-JAX DP")
        for p, (qc, tc, ql, rl) in enumerate(pairs):
            exp = align_one_sweep(qc, tc, ql, rl, cfg)
            got = tuple(int(v) for v in out[p, :3])
            total += 1
            if got != tuple(exp):
                round_bad += 1
                print(
                    f"MISMATCH round={rd} cfg=(bw={cfg.band_width},"
                    f"z={cfg.z_threshold},sw={cfg.slice_width}) "
                    f"pair={p} ql={ql} rl={rl} exp={tuple(exp)} got={got}"
                )
        bad += round_bad
        print(f"round {rd + 1}/{rounds} "
              f"(bw={cfg.band_width}, z={cfg.z_threshold}, "
              f"strips={'forced' if force else 'auto'}, route={route}): "
              f"{round_bad} bad")
    print(f"stress: {total - bad}/{total} pairs bit-exact")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
