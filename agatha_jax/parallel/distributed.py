"""Multi-host orchestration.

The reference is single-process/single-GPU; this module is the pod-
scale story (BASELINE config 5: whole-genome seed-extend batches
sharded across N >= 2 hosts, target >= 85% reads/s scaling efficiency).

Model: pairs are embarrassingly parallel, so each host aligns its own
shard of the input with its local devices (data parallelism over DCN
requires no mid-flight collectives at all); per-host results are
combined by the caller or via `jax.experimental.multihost_utils`.
`host_shard` deterministically partitions by index so every host can
compute its shard independently from a shared input manifest.
"""

from __future__ import annotations

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize multi-host JAX.

    Wraps `jax.distributed.initialize`; with no arguments, discovery is
    delegated to JAX (cluster environments it recognises).  Only call this
    in multi-process runs — single-process users should not.
    """
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)


def host_shard(n_items: int) -> slice:
    """This host's contiguous shard of an n_items-long input list.

    Balanced to within one item; deterministic across hosts.
    """
    p = jax.process_index()
    np_ = jax.process_count()
    base, rem = divmod(n_items, np_)
    start = p * base + min(p, rem)
    stop = start + base + (1 if p < rem else 0)
    return slice(start, stop)


def align_distributed(engine, encoded, **kw):
    """Align this host's shard of `encoded`; returns (slice, result).

    Every host calls this with the SAME full input list; each computes
    only its shard with its local devices.  Gather/merge of results is
    I/O-level (each host writes its shard's outputs), matching how
    mapping pipelines shard reads across machines.
    """
    sl = host_shard(len(encoded))
    return sl, engine.align(encoded[sl], **kw)
