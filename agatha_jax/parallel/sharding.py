"""Multi-device / multi-host data-parallel dispatch.

The reference is strictly single-process single-GPU (gasal_set_device,
interfaces.cpp:86-116; no NCCL/MPI anywhere).  Alignment pairs are
embarrassingly parallel, so the batch dimension is sharded over a 1-D
``pairs`` mesh with `shard_map`: every device runs the DP route (the
CUDA kernel's FFI call, or the plain-JAX DP) on its own shard, and the
(score, q_end, t_end, diags) rows come back sharded (XLA inserts the
gather on host fetch).  No collective runs during the DP; every device
reaches every other at the same rate, so a 1-D mesh is all the
algorithm needs.  Cross-host runs use the same code after
`jax.distributed.initialize()`; the only cross-host traffic is the
result gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from agatha_jax.config import AlignConfig
from agatha_jax.ops.bucket import ROW_UNIT
from agatha_jax.ops.dp import align_bucket_impl, bucket_safe16, select_route


def make_pairs_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) local devices, axis name 'pairs'."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), ("pairs",))


@functools.partial(
    jax.jit, static_argnames=("cfg", "safe16", "mesh", "route")
)
def _align_sharded_jit(meta, tcodes, qfwd, *, cfg, safe16, mesh, route):
    spec = P("pairs", None)

    def local(m, t, q):
        return align_bucket_impl(m, t, q, cfg=cfg, safe16=safe16,
                                 route=route)

    # check_vma=False: the FFI call's result carries no vma metadata.
    f = jax.shard_map(
        local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )
    return f(meta, tcodes, qfwd)


def align_bucket_sharded(
    meta,
    tcodes,
    qfwd,
    cfg: AlignConfig,
    mesh: Mesh,
    *,
    route: str | None = None,
):
    """Shard one bucket's pairs over the mesh and align.

    GB must be divisible by n_devices * ROW_UNIT (pad with dummy pairs).
    """
    n_dev = mesh.devices.size
    gb = int(tcodes.shape[0])
    assert gb % (n_dev * ROW_UNIT) == 0, (
        f"bucket rows {gb} not divisible by {n_dev} devices x {ROW_UNIT}"
    )
    route = select_route(requested=route)
    safe16 = bucket_safe16(cfg, tcodes, qfwd)
    spec = NamedSharding(mesh, P("pairs", None))
    meta = jax.device_put(jnp.asarray(meta, jnp.int32), spec)
    tcodes = jax.device_put(jnp.asarray(tcodes), spec)
    qfwd = jax.device_put(jnp.asarray(qfwd), spec)
    return _align_sharded_jit(
        meta, tcodes, qfwd, cfg=cfg, safe16=safe16, mesh=mesh, route=route,
    )


def pad_rows(arr: np.ndarray, rows: int, fill=1) -> np.ndarray:
    """Pad array along axis 0 to `rows` rows.

    The default fill of 1 keeps padded meta rows on align_bucket's
    documented dummy-pair contract (qlen = rlen = 1); a fill of 1 in
    code arrays is a harmless base code.
    """
    if arr.shape[0] == rows:
        return arr
    pad = np.full((rows - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)
