"""Streaming-scale evidence: 1M pairs with O(chunk) peak memory.

Feeds `AlignEngine.align_stream` from a generator (no dataset ever
materializes in host memory), tracks ru_maxrss across the run, and
reports throughput.  The reference driver holds the whole FASTA in
memory (test_prog.cpp load phase); this path bounds peak RSS by the
-a chunk size times the in-flight window.

Usage: python scripts/stream_scale.py [n_pairs] [read_len] [chunk]
"""
import _path  # noqa: F401  (repo-root shim, scripts/_path.py)
import resource
import sys
import time


import numpy as np

from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.engine import AlignEngine

CODES = np.array([1, 3, 4, 7], np.uint8)  # A C T G


def pair_gen(n, mean_len, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ln = int(mean_len * (0.9 + 0.2 * rng.random()))
        ln8 = -(-ln // 8) * 8
        q = CODES[rng.integers(0, 4, size=ln8)]
        q[ln:] = 14  # N padding
        t = q.copy()
        sub = rng.random(ln) < 0.08
        t[:ln][sub] = CODES[rng.integers(0, 4, size=int(sub.sum()))]
        yield (q, t, ln, ln)


def rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    mean_len = int(sys.argv[2]) if len(sys.argv) > 2 else 150
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 8192
    cfg = AlignConfig(match=1, mismatch=4, gap_open=6, gap_extend=2,
                      slice_width=3, z_threshold=400, band_width=751)
    engine = AlignEngine(cfg, EngineConfig(aligns_per_batch=chunk))

    # warm-up: compile the chunk's bucket shapes, then record baseline
    list(engine.align_stream(pair_gen(chunk, mean_len, 1)))
    base = rss_mb()
    print(f"baseline RSS after warm-up: {base:.0f} MB", flush=True)

    t0 = time.perf_counter()
    total = 0
    checksum = 0
    k = 0
    for res in engine.align_stream(pair_gen(n, mean_len, 2)):
        total += len(res.scores)
        checksum ^= int(res.scores.sum()) & 0xFFFFFFFF
        k += 1
        if k % 16 == 0:
            print(f"  {total}/{n} pairs, RSS {rss_mb():.0f} MB",
                  flush=True)
    dt = time.perf_counter() - t0
    peak = rss_mb()
    print(f"aligned {total} pairs in {dt:.1f}s "
          f"({total/dt/1e3:.0f}k pairs/s), checksum {checksum:#x}")
    print(f"peak RSS {peak:.0f} MB (baseline {base:.0f} MB, "
          f"growth {peak - base:.0f} MB)")
    # O(chunk) gate: growth across 1M pairs must stay far below the
    # dataset size (~190 MB of codes for 1M x 150 bp).
    ok = (peak - base) < 500
    print("RSS O(chunk):", "OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
