"""Reference-compatible CLI driver.

Drop-in analogue of the reference's `manual` binary
(test_prog/test_prog.cpp + args_parser.cpp:74-89): same flags, same
FASTA pair input convention, same stdout format
(``score\tquery_batch_end=..\ttarget_batch_end=..``, test_prog.cpp:361-366)
and the same raw-time file shape: one line per bucket when -p is given,
mirroring the reference's one cudaEvent line per batch
(gasal_align.cu:219-236).  Caveat: our per-bucket times are host
wall-clock around dispatch+completion and include bucket packing and
upload, not device-event-only time.

Usage:
    python -m agatha_jax.cli [-m] [-x] [-q] [-r] [-s] [-z] [-w] [-b] [-t]
        [-a] [-p] [-n] <query_batch.fasta> <target_batch.fasta> [raw.log]

-b/-t (the reference's kernel geometry) are accepted and ignored: block
shapes follow from the bucket shapes.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="agatha_jax",
        description="guided (banded, Z-drop) extension aligner",
    )
    # Defaults mirror args_parser.cpp:12-25.
    p.add_argument("-m", type=int, default=2, help="match score [2]")
    p.add_argument("-x", type=int, default=4, help="mismatch penalty [4]")
    p.add_argument("-q", type=int, default=4, help="gap open penalty [4]")
    p.add_argument("-r", type=int, default=2, help="gap extension penalty [2]")
    p.add_argument("-s", type=int, default=3, help="slice width [3]")
    p.add_argument("-z", type=int, default=400, help="z-drop threshold [400]")
    p.add_argument("-w", type=int, default=751, help="band width [751]")
    p.add_argument("-b", type=int, default=256,
                   help="(ignored) blocks per kernel")
    p.add_argument("-t", type=int, default=256,
                   help="(ignored) threads per block")
    p.add_argument("-a", type=int, default=8192,
                   help="alignments per kernel batch [8192]")
    p.add_argument("-p", action="store_true",
                   help="print alignment results and kernel times "
                        "(warm-run timing; without -p the reported "
                        "process time includes JIT compilation)")
    p.add_argument("-n", type=int, default=0,
                   help="host worker threads for the native traceback/"
                        "encode pools [0 = all cores] (reference: "
                        "OpenMP input threads)")
    p.add_argument("--stream", action="store_true",
                   help="stream the input in -a sized chunks with a "
                        "bounded in-flight window (O(chunk) memory; "
                        "stdout identical to the batch path; process "
                        "time includes compilation of the first chunk)")
    p.add_argument("--cigar", action="store_true",
                   help="append a CIGAR column to each result line "
                        "(capability beyond the reference)")
    p.add_argument("query_fasta")
    p.add_argument("target_fasta")
    p.add_argument("raw_file", nargs="?", default=None)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from agatha_jax.config import AlignConfig, EngineConfig
    from agatha_jax.engine import AlignEngine
    from agatha_jax.io.fasta import read_fasta_pairs
    from agatha_jax.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    cfg = AlignConfig(
        match=args.m,
        mismatch=args.x,
        gap_open=args.q,
        gap_extend=args.r,
        slice_width=args.s,
        z_threshold=args.z,
        band_width=args.w,
    )
    engine = AlignEngine(
        cfg,
        EngineConfig(aligns_per_batch=args.a, cpu_threads=args.n),
    )

    if args.stream:
        return _main_stream(args, engine)

    t_load = time.perf_counter()
    pairs = read_fasta_pairs(args.query_fasta, args.target_fasta)
    load_ms = (time.perf_counter() - t_load) * 1e3

    encoded = engine.encode_pairs(pairs)
    if args.cigar:
        args.p = True  # CIGARs are results; computing them unprinted
        #               would be silent wasted work
    if args.p:
        # Warm-up run compiles the kernels; results + timing then come
        # from a single warm run (results are deterministic, so nothing
        # is lost by discarding the cold pass — the reference's timed
        # window also excludes compilation: nvcc compiles ahead of
        # time).  CIGARs are computed once, on the warm run, after the
        # timing window closes.
        engine.align(encoded)
        result = engine.align(
            encoded, traceback=args.cigar,
            per_bucket_times=bool(args.raw_file),
        )
    else:
        result = engine.align(encoded)

    if args.p:
        _emit_result_lines(result, args.cigar, sys.stdout)
        if args.raw_file:
            # One line per bucket (the reference writes one per batch,
            # gasal_align.cu:219-236); avg_time.py sums lines per
            # iteration either way.
            with open(args.raw_file, "a") as rf:
                for ms in result.bucket_ms or [result.kernel_ms]:
                    rf.write(f"{ms:.6f}\n")

    print(
        f"load time (in milliseconds): {load_ms:.3f}",
        file=sys.stderr,
    )
    print(
        f"process time (in milliseconds): {result.kernel_ms:.3f}",
        file=sys.stderr,
    )
    print(
        f"pairs={len(pairs)} buckets={result.n_buckets}",
        file=sys.stderr,
    )
    return 0


def _emit_result_lines(res, cigar: bool, out) -> None:
    """Reference stdout format (test_prog.cpp:363-366), one per pair."""
    write = out.write
    for i in range(len(res.scores)):
        line = (
            f"{res.scores[i]}"
            f"\tquery_batch_end={res.query_ends[i]}"
            f"\ttarget_batch_end={res.target_ends[i]}"
        )
        if cigar:
            line += f"\tcigar={res.cigars[i]}"
        write(line + "\n")


def _main_stream(args, engine) -> int:
    """Streaming pipeline: chunked read -> encode -> bounded-window
    dispatch, results printed as each chunk lands (input order).

    Mirrors the reference driver's bounded <=8192-pair batches with
    double-buffered streams (test_prog.cpp:245-376); peak memory is
    O(-a chunk), not O(dataset).
    """
    from agatha_jax.io.fasta import iter_fasta_pairs

    if args.cigar:
        args.p = True
    t_all = time.perf_counter()
    total = 0
    chunk_ms: list[float] = []
    out = sys.stdout
    tprev = t_all
    for res in engine.align_stream(
        iter_fasta_pairs(args.query_fasta, args.target_fasta),
        traceback=args.cigar,
    ):
        # completion deltas, not the per-chunk dispatch->collect
        # windows: with a max_in_flight pipeline those windows overlap
        # and their sum would over-report wall time up to 3x.
        tnow = time.perf_counter()
        chunk_ms.append((tnow - tprev) * 1e3)
        tprev = tnow
        if args.p:
            _emit_result_lines(res, args.cigar, out)
        total += len(res.scores)
    process_ms = sum(chunk_ms)
    if args.p and args.raw_file:
        with open(args.raw_file, "a") as rf:
            for ms in chunk_ms:
                rf.write(f"{ms:.6f}\n")
    print(
        "load time (in milliseconds): 0.000 (streamed)",
        file=sys.stderr,
    )
    print(
        f"process time (in milliseconds): {process_ms:.3f}",
        file=sys.stderr,
    )
    print(
        f"pairs={total} chunks={len(chunk_ms)} "
        f"wall={(time.perf_counter() - t_all) * 1e3:.1f}ms",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
