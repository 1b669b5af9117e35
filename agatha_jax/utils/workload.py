"""Workload synthesis, DP-cell accounting and the measured device's name.

The reference's published metric is kernel time on its (stripped)
dataset; ours is GCUPS — exact banded cell updates per second — which
needs the in-band cell count of the antidiagonals each pair actually
swept (`AlignmentResult.diags` credits Z-drop early exits).
"""

from __future__ import annotations

import subprocess

import numpy as np


def gpu_name_power() -> str:
    """The card's name and power limit as nvidia-smi reports them.

    Every GPU measurement is printed beside this: a card set below its
    maximum power runs slower under load.
    """
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def banded_cells(qlens, rlens, diags, band_width) -> int:
    """Exact in-band cell count over the first `diags` antidiagonals."""
    total = 0
    for ql, rl, nd in zip(qlens, rlens, diags):
        d = np.arange(int(nd), dtype=np.int64)
        ub = np.minimum(np.minimum(rl - 1, d), (d + band_width) // 2)
        lb = np.maximum(
            np.maximum(0, d - ql + 1), -((band_width - d) // 2)
        )
        total += int(np.maximum(0, ub - lb + 1).sum())
    return total


def result_gcups(encoded, result, cfg, seconds: float) -> float:
    """GCUPS of an AlignmentResult measured over `seconds`."""
    cells = banded_cells(
        [e[2] for e in encoded],
        [e[3] for e in encoded],
        result.diags,
        cfg.band_width,
    )
    return cells / seconds / 1e9


def make_workload(n_pairs=512, mean_len=10000, seed=1234, div=0.10,
                  spread=0.5):
    """Deterministic homologous pair set (seed-extension style).

    Pairs diverge by ~`div` (substitutions + short indels) — the
    long-read mapping regime the reference targets.  ``spread`` is the
    +-fractional length jitter: 0.5 models long-read length spread;
    short-read datasets (the reference's fixed-length Illumina
    150/300/600 bp files, test_prog/Makefile:45-61) want ~0.05.
    Returns encoded (q_codes, t_codes, qlen, rlen) tuples.
    """
    from agatha_jax.ops.packing import encode_padded

    rng = np.random.default_rng(seed)
    bases = np.array(list("ACGT"))
    sub = div / 2
    indel = div / 4
    pairs = []
    lo = max(1, int(mean_len * (1 - spread)))
    hi = max(lo + 1, int(mean_len * (1 + spread)))
    for _ in range(n_pairs):
        n = int(rng.integers(lo, hi))
        q = bases[rng.integers(0, 4, size=n)]
        t = []
        i = 0
        while i < n:
            r = rng.random()
            if r < indel:  # deletion
                i += int(rng.integers(1, 4))
                continue
            if r < 2 * indel:  # insertion
                t.extend(
                    bases[rng.integers(0, 4, size=int(rng.integers(1, 4)))]
                )
            if rng.random() < sub:
                t.append(bases[rng.integers(0, 4)])
            else:
                t.append(q[i])
            i += 1
        qs = "".join(q)
        ts = "".join(t) if t else "A"
        pairs.append(
            (encode_padded(qs), encode_padded(ts), len(qs), len(ts))
        )
    return pairs
