"""Batched alignment engine: bucketing, dispatch, result assembly.

Replaces the reference's host-side scheduling stack:

* OpenMP thread pool + 2 CUDA streams per thread + `is_free` polling
  (test_prog.cpp:195-214, 273-374)  ->  JAX async dispatch: every
  bucket is launched without blocking and results are gathered at the
  end, so host packing of bucket N+1 overlaps device compute of N.
* Uneven bucketing + subwarp rejoining (agatha_kernel.h:113, 365-408)
  ->  host-side length bucketing: pairs are sorted by cost and grouped
  into shape-uniform buckets, so every pair in a bucket carries
  near-equal work.
* The mid-launch device->host sort round-trip (gasal_align.cu:14-18)
  ->  eliminated: sorting happens on host before dispatch.

Every bucket goes to the DP route of the backend (ops.dp.select_route):
the CUDA kernel on a gpu, the plain-JAX DP on the CPU.  Bucket shapes
are rounded to a coarse geometric grid so the number of distinct
compiled shapes stays small across arbitrary datasets.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from agatha_jax.config import AlignConfig, EngineConfig
from agatha_jax.io.fasta import SeqPair
from agatha_jax.ops.bucket import ROW_UNIT, WIDTH_UNIT, build_bucket_arrays
from agatha_jax.ops.dp import align_bucket, select_route
from agatha_jax.ops.packing import encode_padded

# Per-bucket pair floor: tiny buckets would pay a dispatch each for
# little work (and leave most of a card's SMs idle).
MIN_BUCKET_PAIRS = 64


def _round_shape(x: int) -> int:
    """Round up to 128 * {1, 2, 3, 4, 6, 8, 12, ...} (geometric grid).

    A compile-count grid: it bounds padding waste at 50% worst-case
    while keeping the set of compiled bucket shapes logarithmic in the
    length range.  All values are multiples of WIDTH_UNIT.
    """
    if x <= WIDTH_UNIT:
        return WIDTH_UNIT
    if x <= 2 * WIDTH_UNIT:
        return 2 * WIDTH_UNIT
    p = 2 * WIDTH_UNIT
    while True:
        if x <= p:
            return p
        if x <= p + p // 2:
            return p + p // 2
        p *= 2


@dataclasses.dataclass
class AlignmentResult:
    """Per-pair results in input order plus engine statistics."""

    scores: np.ndarray        # int32 (N,)
    query_ends: np.ndarray    # int32 (N,)
    target_ends: np.ndarray   # int32 (N,)
    diags: np.ndarray         # int32 (N,) antidiagonals swept per pair
    n_buckets: int = 0
    kernel_ms: float = 0.0    # wall-clock of the dispatch+gather window
    cigars: list[str] | None = None  # when traceback was requested
    bucket_ms: list[float] | None = None  # per-bucket completion deltas
    routes: list[str] | None = None  # per-bucket DP route that served it
                                     # (cuda/xla, "-sharded" on a mesh)


@dataclasses.dataclass
class _Bucket:
    indices: np.ndarray       # original pair indices (n,)
    meta: np.ndarray
    tcodes: np.ndarray
    qfwd: np.ndarray


class AlignEngine:
    """Aligns arbitrary batches of encoded pairs on the local device(s).

    Reuses compiled kernels across calls (keyed on bucket shape + cfg,
    via jax.jit's cache).
    """

    def __init__(
        self,
        cfg: AlignConfig,
        engine_cfg: EngineConfig | None = None,
    ):
        self.cfg = cfg
        self.engine_cfg = engine_cfg or EngineConfig()
        self._mesh = None  # lazy: None = unprobed, False = single-dev
        self._route = None  # lazy: the backend is known at dispatch

    @property
    def route(self) -> str:
        """The DP route every bucket takes (see ops.dp.select_route)."""
        if self._route is None:
            self._route = select_route(requested=self.engine_cfg.dp_route)
        return self._route

    # -- input preparation ------------------------------------------------
    def encode_pairs(
        self, pairs: list[SeqPair]
    ) -> list[tuple[np.ndarray, np.ndarray, int, int]]:
        """FASTA pairs -> (q_codes, t_codes, qlen, rlen) with ops applied.

        Uses the native C++ batch encoder when available (the host-side
        hot path at scale); falls back to NumPy per pair.
        """
        from agatha_jax import native

        if native.available() and pairs:
            def batch(seqs, ops):
                stride = max(
                    8, -(-max(len(s) for s in seqs) // 8) * 8
                )
                rows, lens = native.encode_batch(
                    [s.encode() if isinstance(s, str) else s
                     for s in seqs],
                    np.asarray(ops, np.uint8),
                    stride,
                    n_threads=self.engine_cfg.cpu_threads,
                )
                return rows, lens

            q_rows, q_lens = batch(
                [p.query for p in pairs], [p.query_op for p in pairs]
            )
            t_rows, t_lens = batch(
                [p.target for p in pairs], [p.target_op for p in pairs]
            )
            out = []
            for i in range(len(pairs)):
                ql, rl = int(q_lens[i]), int(t_lens[i])
                out.append(
                    (
                        q_rows[i, : -(-ql // 8) * 8],
                        t_rows[i, : -(-rl // 8) * 8],
                        ql,
                        rl,
                    )
                )
            return out

        out = []
        for p in pairs:
            qc = encode_padded(p.query, p.query_op)
            tc = encode_padded(p.target, p.target_op)
            out.append((qc, tc, len(p.query), len(p.target)))
        return out

    # -- bucketing ---------------------------------------------------------
    def make_buckets(
        self, encoded: list[tuple[np.ndarray, np.ndarray, int, int]]
    ) -> list[_Bucket]:
        return list(self.iter_buckets(encoded))

    def iter_buckets(
        self, encoded: list[tuple[np.ndarray, np.ndarray, int, int]]
    ):
        """Yield buckets one at a time so dispatch overlaps packing.

        The batch splits into ~target_buckets buckets of at least
        MIN_BUCKET_PAIRS pairs, and of at most aligns_per_batch (-a).
        """
        n = len(encoded)
        sw = self.cfg.slice_width
        tb = max(1, self.engine_cfg.target_buckets)
        cap = max(ROW_UNIT, self.engine_cfg.aligns_per_batch)
        take = min(cap, max(MIN_BUCKET_PAIRS, -(-n // tb)))

        w_need = np.empty(n, np.int64)
        q_need = np.empty(n, np.int64)
        d_need = np.empty(n, np.int64)
        for i, (_qc, _tc, ql, rl) in enumerate(encoded):
            pql = -(-ql // 8)
            prl = -(-rl // 8)
            w_need[i] = prl * 8
            q_need[i] = pql * 8
            tad = prl + pql - 1
            d_need[i] = 8 * (-(-tad // sw) * sw) + 8

        # Sort by sweep length (the DP's trip count), then width: pairs
        # sharing a bucket then terminate together.
        order = np.lexsort((w_need, d_need))
        for lo in range(0, n, take):
            idx = order[lo : lo + take]
            yield _Bucket(idx, *build_bucket_arrays(
                [encoded[i] for i in idx],
                w=_round_shape(int(w_need[idx].max())),
                qf=_round_shape(int(q_need[idx].max())),
            ))

    # -- dispatch ----------------------------------------------------------
    def align(
        self,
        encoded: list[tuple[np.ndarray, np.ndarray, int, int]],
        *,
        traceback: bool = False,
        per_bucket_times: bool = False,
    ) -> AlignmentResult:
        """Align all pairs; optionally compute CIGARs (new capability —
        the reference outputs score + end positions only,
        agatha_kernel.h:359-363).

        ``per_bucket_times`` records one completion delta per bucket
        (the analogue of the reference's one cudaEvent line per batch,
        gasal_align.cu:219-236) at the cost of one tiny device fetch
        per bucket; leave it off on latency-sensitive paths.

        ``kernel_ms`` covers the whole dispatch+gather window — host
        bucket packing and upload included — unlike the reference's
        device-event-only number.
        """
        import time

        n = len(encoded)
        if n == 0:
            z = np.zeros(0, np.int32)
            return AlignmentResult(z, z, z, z, cigars=[] if traceback
                                   else None)
        self._validate(encoded)
        t0 = time.perf_counter()
        buckets, pending, routes = self._dispatch(encoded)
        return self._collect(
            encoded, buckets, pending, t0, routes=routes,
            traceback=traceback, per_bucket_times=per_bucket_times,
        )

    def _validate(self, encoded) -> None:
        over_range: list[int] = []
        for i, (_qc, _tc, ql, rl) in enumerate(encoded):
            if ql < 1 or rl < 1:
                raise ValueError(
                    f"pair {i}: empty sequence (qlen={ql}, rlen={rl}); "
                    "the aligner requires at least one base per side"
                )
            # 16-bit packing limits, identical to the reference
            # (BASELINE.md: scores < 2^15 from the (H<<16)|r max
            # packing, ref end positions < 2^16 from the r extraction;
            # gasal.h:147, agatha_kernel.h:29-30).  Results degrade the
            # same way the reference's would — warn, don't refuse.
            if rl > 0xFFFF or self.cfg.match * min(ql, rl) >= 0x8000:
                over_range.append(i)
        if over_range:
            # One aggregated warning per call: a per-pair message would
            # defeat the warnings-registry dedupe and flood stderr on
            # large long-read batches.
            import warnings

            head = ", ".join(map(str, over_range[:5]))
            more = (
                f" (+{len(over_range) - 5} more)"
                if len(over_range) > 5 else ""
            )
            warnings.warn(
                f"{len(over_range)} pair(s) [{head}{more}] exceed the "
                "16-bit score/position packing range shared with the "
                "reference: end positions alias mod 65536 and scores "
                ">= 32768 corrupt the max tracking",
                RuntimeWarning,
                stacklevel=2,
            )

    def _dispatch(self, encoded):
        """Pack into buckets and launch every bucket asynchronously.

        Buckets dispatch as soon as each is packed, so host packing and
        uploads overlap device compute (the JAX analogue of the
        reference's fill-next-batch-while-previous-runs streams,
        test_prog.cpp:273-374).
        """
        mesh = self._local_mesh()
        route = self.route
        buckets = []
        pending = []
        routes = []
        for b in self.iter_buckets(encoded):
            buckets.append(b)
            if mesh is not None:
                from agatha_jax.parallel.sharding import (
                    align_bucket_sharded,
                    pad_rows,
                )

                unit = mesh.devices.size * ROW_UNIT
                gb = -(-b.meta.shape[0] // unit) * unit
                routes.append(f"{route}-sharded")
                pending.append(
                    align_bucket_sharded(
                        pad_rows(b.meta, gb, 1),
                        pad_rows(b.tcodes, gb),
                        pad_rows(b.qfwd, gb),
                        self.cfg, mesh, route=route,
                    )
                )
            else:
                routes.append(route)
                pending.append(
                    align_bucket(b.meta, b.tcodes, b.qfwd, self.cfg,
                                 route=route)
                )
        return buckets, pending, routes

    def _local_mesh(self):
        """1-D 'pairs' mesh when >1 local device is usable, else None.

        Every bucket's rows are sharded across all local devices
        (SURVEY.md §2.3 inter-device row): pairs are embarrassingly
        parallel, and bucket-level sharding keeps all devices busy even
        when a batch produces fewer buckets than there are devices.
        """
        if not self.engine_cfg.use_all_devices:
            return None
        if self._mesh is None:
            import jax

            # local devices only: under jax.distributed the global list
            # includes other hosts' devices, which a single process
            # cannot device_put to (cross-host batches go through
            # parallel.distributed instead)
            devs = jax.local_devices()
            if len(devs) <= 1:
                self._mesh = False
            else:
                from agatha_jax.parallel.sharding import make_pairs_mesh

                self._mesh = make_pairs_mesh(devs)
        return self._mesh or None

    def _collect(
        self, encoded, buckets, pending, t0, *,
        traceback: bool, per_bucket_times: bool = False,
        routes: list[str] | None = None,
    ) -> AlignmentResult:
        """Fetch dispatched results, reorder, and run traceback.

        Score-only results come back in one device-side concat and a
        single fetch.  CIGARs come from the host traceback engine
        (native/traceback.cpp), seeded with the device's end points.
        """
        import time

        import jax.numpy as jnp

        n = len(encoded)
        bucket_ms: list[float] | None = None
        if per_bucket_times:
            # Per-bucket fetches in dispatch order: bucket i's fetch
            # returns once its kernel is done, so the deltas
            # approximate per-bucket completion times (compute still
            # overlaps; only the fetches serialize).
            bucket_ms = []
            outs = []
            tprev = time.perf_counter()
            for p in pending:
                outs.append(np.asarray(p))
                tnow = time.perf_counter()
                bucket_ms.append((tnow - tprev) * 1e3)
                tprev = tnow
            all_out = np.concatenate(outs)
        elif len(pending) > 1:
            all_out = np.asarray(jnp.concatenate(pending, axis=0))
        else:
            all_out = np.asarray(pending[0])
        scores = np.zeros(n, np.int32)
        qends = np.zeros(n, np.int32)
        tends = np.zeros(n, np.int32)
        diags = np.zeros(n, np.int32)
        # output rows per bucket come from the dispatched arrays, not
        # bucket meta: the sharded path pads rows to the device grid
        row = 0
        for b, p in zip(buckets, pending):
            out = all_out[row : row + p.shape[0]]
            row += p.shape[0]
            idx = b.indices
            k = len(idx)
            scores[idx] = out[:k, 0]
            qends[idx] = out[:k, 1]
            tends[idx] = out[:k, 2]
            diags[idx] = out[:k, 3]
        ms = (time.perf_counter() - t0) * 1e3
        cigars = None
        if traceback:
            from agatha_jax.ops.traceback import traceback_all

            cigars = traceback_all(
                encoded, qends, tends, scores, self.cfg,
                n_threads=self.engine_cfg.cpu_threads,
            )
        return AlignmentResult(
            scores, qends, tends, diags,
            n_buckets=len(buckets), kernel_ms=ms, cigars=cigars,
            bucket_ms=bucket_ms,
            # threaded through from _dispatch (NOT instance state:
            # align_stream keeps several dispatched chunks in flight,
            # and a shared attribute would attach the last chunk's
            # routes to every earlier chunk's result)
            routes=routes,
        )

    def align_pairs(self, pairs: list[SeqPair]) -> AlignmentResult:
        return self.align(self.encode_pairs(pairs))

    # -- streaming ---------------------------------------------------------
    def align_stream(
        self,
        pairs_iter,
        *,
        traceback: bool = False,
        max_in_flight: int = 3,
    ):
        """Stream alignment over an iterator of SeqPairs (or
        pre-encoded ``(q_codes, t_codes, qlen, rlen)`` tuples).

        The analogue of the reference driver's bounded-batch pipeline
        (test_prog.cpp:245-376: fill batch N+1 while N computes on the
        other CUDA stream): pairs are consumed in chunks of
        ``aligns_per_batch`` (-a), each chunk is encoded + dispatched
        asynchronously, and at most ``max_in_flight`` chunks are alive
        at once — so peak host memory is O(chunk), not O(dataset),
        while encoding of chunk N+1 overlaps device compute of N.

        Yields one AlignmentResult per chunk, in input order.
        """
        import itertools
        import time
        from collections import deque

        chunk_pairs = max(ROW_UNIT, self.engine_cfg.aligns_per_batch)
        it = iter(pairs_iter)
        window: deque = deque()

        def drain_one():
            encoded, buckets, pending, t0, routes = window.popleft()
            return self._collect(
                encoded, buckets, pending, t0, routes=routes,
                traceback=traceback,
            )

        while True:
            chunk = list(itertools.islice(it, chunk_pairs))
            if not chunk:
                break
            encoded = (
                chunk if isinstance(chunk[0], tuple)
                else self.encode_pairs(chunk)
            )
            self._validate(encoded)
            t0 = time.perf_counter()
            buckets, pending, routes = self._dispatch(encoded)
            window.append((encoded, buckets, pending, t0, routes))
            if len(window) >= max_in_flight:
                yield drain_one()
        while window:
            yield drain_one()
