"""Randomized device-vs-oracle stress at the ENGINE level.

scripts/stress.py verifies the DP route bucket by bucket; this script
verifies everything AROUND it on the backend's route: the bucket split,
rev/comp op application at encode, result re-ordering at collect, and
the over-range validation path — by pushing randomized MIXED workloads
through `AlignEngine.align` and checking every pair against the
scalar-semantics oracle.

Each round draws a config and a batch that deliberately spans the DP's
layouts: short reads, full-width mid-lengths, sliding-window long
pairs (rlen > window_width), extreme asymmetry, N runs, and all four
op codes on both sides.  Lengths are drawn from a few fixed regimes so
shapes stay on the compile grid (bounded compile count).

Usage: python scripts/engine_stress.py [n_rounds] [seed]
Exits non-zero on any mismatch.
"""
import _path  # noqa: F401
import sys

import numpy as np

from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.engine import AlignEngine
from agatha_jax.io.fasta import SeqPair
from agatha_jax.ops.bucket import window_width
from agatha_jax.ops.sweep import align_one_sweep

CONFIGS = [
    AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2),
    AlignConfig(band_width=100, z_threshold=100, slice_width=2),
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


def make_batch(rng, cfg, n=96):
    """Mixed batch: short / mid / windowed / asymmetric pairs,
    random op codes.  Length regimes are fixed per config so bucket
    shapes stay on the compile grid across rounds."""
    W = window_width(cfg)
    regimes = [
        (20, 120),            # short reads
        (300, 700),           # full width
        (W + 100, W + 900),   # forces the sliding window
    ]
    pairs = []
    for i in range(n):
        lo, hi = regimes[i % 3]
        ql = int(rng.integers(lo, hi))
        q = rseq(rng, ql)
        if i % 5 == 0:      # unrelated target, possibly asymmetric
            t = rseq(rng, int(rng.integers(max(1, lo // 4), hi)))
        elif i % 7 == 0:    # extreme asymmetry
            t = rseq(rng, int(rng.integers(1, 30)))
        else:
            t = mutate(rng, q)
        pairs.append(SeqPair(q, t, int(rng.integers(0, 4)),
                             int(rng.integers(0, 4))))
    return pairs


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 0
    rng = np.random.default_rng(seed)
    total = 0
    bad = 0
    for r in range(rounds):
        cfg = CONFIGS[r % len(CONFIGS)]
        pairs = make_batch(rng, cfg)
        eng = AlignEngine(cfg, EngineConfig())
        enc = eng.encode_pairs(pairs)
        res = eng.align(enc)
        routes = sorted(set(res.routes or []))
        for i, (qc, tc, ql, rl) in enumerate(enc):
            want = align_one_sweep(qc, tc, ql, rl, cfg)
            got = (int(res.scores[i]), int(res.query_ends[i]),
                   int(res.target_ends[i]))
            total += 1
            if got != tuple(want):
                bad += 1
                print(f"MISMATCH round {r} pair {i}: engine {got} "
                      f"oracle {tuple(want)} (ql={ql} rl={rl})",
                      flush=True)
        print(f"round {r + 1}/{rounds} (bw={cfg.band_width}, "
              f"sw={cfg.slice_width}): {len(enc)} pairs ok, "
              f"buckets={res.n_buckets} routes={routes}", flush=True)
    print(f"engine stress: {total - bad}/{total} pairs bit-exact")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
