"""Batched AGAThA guided-alignment DP: route selection and the plain-JAX DP.

Two routes compute the same ``(GB, 4)`` int32 rows
``[score, query_end, target_end, diagonals_swept]`` from a bucket (see
ops/bucket.py for the wire format):

* ``"cuda"`` — the hand-written Hopper kernel in agatha_jax/cuda,
  called through ``jax.ffi``.  The route on a ``gpu`` backend.
* ``"xla"``  — the plain-JAX DP below: a ``lax.while_loop`` over packed
  antidiagonals with a sliding band window, compiled by XLA.  The route
  on a ``cpu`` backend, and on the card the reference the CUDA kernel is
  compared with and timed against.

The route is chosen in one place (`select_route`); a ``gpu`` backend
never falls back to the plain DP when the CUDA library cannot be built.

The plain DP sweeps the DP along *base* antidiagonals — the only axis
on which all in-flight cells are independent.  One loop iteration
processes one packed antidiagonal (8 base diagonals, statically
unrolled), so slice/chunk clipping bounds are hoisted and computed once
per 8 steps.  O(band) state (H at d-1 and d-2, E, F, the query window)
is held as (GB, W) rows: W is the target width when it fits the band
window, else `window_width(cfg)` rows that slide up the target
SHIFT_Q rows at a time.  Z-drop and empty-slice termination are per-pair
masks; the loop exits when every pair has terminated or finished.

Bit-exactness contract: reproduces `ops.sweep.align_one_sweep` (itself
cross-validated against `ops.reference_sim`) exactly, including int16
strip truncation, chunk/slice clipping, the packed (H<<16)|r tie-break
and the per-diagonal Z-drop schedule.  With ``safe16`` (see
`int16_safe`) the int16 strip truncations are identities and are left
out.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from agatha_jax.config import AlignConfig
from agatha_jax.constants import INT32_MIN, MINUS_INF2, N_PENALTY, N_VALUE
from agatha_jax.ops.bucket import (
    GUARD,
    SHIFT_EVERY,
    SHIFT_Q,
    int16_safe,
    unpack_nibbles,
    window_width,
    wire_width,
)

_I32 = jnp.int32
ROUTES = ("cuda", "xla")
_BACKEND_ROUTE = {"gpu": "cuda", "cpu": "xla"}


def select_route(backend: str | None = None,
                 requested: str | None = None) -> str:
    """The DP route for a JAX backend: CUDA on ``gpu``, plain JAX on ``cpu``.

    ``requested`` names a route explicitly (measurement and the on-card
    reference); ``"cuda"`` still requires a ``gpu`` backend.
    """
    backend = backend or jax.default_backend()
    if requested is not None:
        if requested not in ROUTES:
            raise ValueError(f"unknown DP route {requested!r}")
        if requested == "cuda" and backend != "gpu":
            raise ValueError(
                f"the CUDA route needs a gpu backend, not {backend!r}"
            )
        return requested
    try:
        return _BACKEND_ROUTE[backend]
    except KeyError:
        raise ValueError(
            f"no DP route for JAX backend {backend!r} (have gpu, cpu)"
        ) from None


def _trunc16(x):
    """int16 wraparound of int32 values (short2 strip storage, gasal.h:147)."""
    return (x << 16) >> 16


def _ctrunc16(t):
    """C-style truncation of t/16 (slice clipping, agatha_kernel.h:184)."""
    return jnp.where(t >= 0, t >> 4, -((-t) >> 4))


def _roll(x, shift):
    return jnp.roll(x, shift, axis=1)


def _dp_xla(meta, tcodes, qfwd, *, cfg: AlignConfig, safe16: bool):
    """Plain-JAX DP over int32 (GB, wt) target and (GB, qf) query codes."""
    gb, wt = tcodes.shape
    qf = qfwd.shape[1]
    assert qf % 8 == 0 and wt % 8 == 0, (wt, qf)
    W = min(wt, window_width(cfg))
    windowed = W < wt
    sw, bw, z = cfg.slice_width, cfg.band_width, cfg.z_threshold
    goe, ge = cfg.gap_oe, cfg.gap_extend
    match, mism = cfg.match, cfg.mismatch
    minf = jnp.int32(MINUS_INF2)
    strip16 = (lambda x: x) if safe16 else _trunc16

    qlen = meta[:, 0:1]
    rlen = meta[:, 1:2]
    pql = (qlen + 7) >> 3
    prl = (rlen + 7) >> 3
    n_diags = qlen + rlen - 1
    tad = prl + pql - 1
    i_end8 = (((tad + (sw - 1)) // sw) * sw) << 3
    end_p = i_end8 + 8

    pos = jax.lax.broadcasted_iota(_I32, (1, W), 1)
    bottom = pos == 0

    def slice_bounds(i):
        # banded slice clipping (agatha_kernel.h:183-186)
        ss = jnp.maximum(jnp.maximum(0, i - pql + 1),
                         _ctrunc16((i << 3) + (8 - bw)))
        se = jnp.minimum(jnp.minimum(prl - 1, i + (sw - 1)),
                         _ctrunc16((i << 3) + (8 * (sw - 1) + 7 + bw)))
        return ss, se

    def boundary_init(r):
        """Left-strip H/F inits for rows r (agatha_kernel.h:126-148)."""
        kb = _trunc16(-(goe + ge * r))
        in_b0 = r <= bw
        return (jnp.where(in_b0, kb, minf),
                jnp.where(in_b0, _trunc16(kb - goe), minf))

    def top_h(col):
        # top-boundary H for column col; col == -1 is the origin corner
        v = jnp.where(col <= bw, _trunc16(-(goe + ge * col)), minf)
        return jnp.where(col < 0, 0, v)

    def top_e(col):
        k = _trunc16(-(goe + ge * col))
        return jnp.where(col <= bw, _trunc16(k - goe), minf)

    def t_window(vbase):
        return jax.lax.dynamic_slice(tcodes, (0, vbase), (gb, W))

    def shift(state):
        """Slide the window up SHIFT_Q rows.  Rows [vbase, vbase+SHIFT_Q)
        can never compute again; incoming rows are ahead of the
        wavefront, so H/F take their boundary inits, the flowing E is
        MINUS_INF2, and the query window heals row by row before those
        rows compute (window_width margin)."""
        vbase, hfa, hfb, fst, est, qwin = state
        vbase = vbase + SHIFT_Q
        inc = pos >= W - SHIFT_Q
        h0n, f0n = boundary_init(vbase + pos)

        def shl(x):
            return _roll(x, -SHIFT_Q)

        return (vbase,
                jnp.where(inc, h0n, shl(hfa)),
                jnp.where(inc, h0n, shl(hfb)),
                jnp.where(inc, f0n, shl(fst)),
                jnp.where(inc, minf, shl(est)),
                shl(qwin))

    def cond(c):
        d8, term = c[0], c[-2]
        return jnp.any((term == 0) & (d8 < end_p))

    def body(c):
        (d8, vbase, i1, kph, hfa, hfb, fst, est, qwin,
         ms, mr, mq, term, diags) = c
        if windowed:
            want = (
                (d8 % SHIFT_EVERY == 0)
                & ((((d8 - bw) >> 1) - GUARD) - vbase >= SHIFT_Q)
                & (vbase + SHIFT_Q <= wt - W)
            )
            vbase, hfa, hfb, fst, est, qwin = jax.lax.cond(
                want, shift, lambda s: s, (vbase, hfa, hfb, fst, est, qwin)
            )
        r = vbase + pos
        pr = r >> 3
        ro = r & 7
        blk_first = ro == 0
        cs = jnp.maximum(0, (pr << 3) - bw) >> 3
        ce = jnp.minimum(pql - 1, ((pr << 3) + (7 + bw)) >> 3)
        fake = r >= rlen
        prev_fake = r > rlen
        # target-side N folds into the match/mismatch selections
        tb = t_window(vbase) if windowed else tcodes
        t_is_n = tb == N_VALUE
        sub_m = jnp.where(t_is_n, -N_PENALTY, match)
        sub_x = jnp.where(t_is_n, -N_PENALTY, -mism)
        # query feed for the bottom row: q[d - vbase], d in [d8, d8+8).
        # Clamped reads land only on cells with qq outside [0, qlen).
        feed = jax.lax.dynamic_slice(
            qfwd, (0, jnp.clip(d8 - vbase, 0, qf - 8)), (gb, 8)
        )

        # --- hoisted per-packed-diagonal values ---
        D = d8 >> 3
        i2 = jnp.where(kph == 0, i1 - sw, i1)
        pq_a = D - pr
        pq_b = pq_a - 1
        base_qq = d8 - r
        base_band = d8 - (r << 1)
        ss1, se1 = slice_bounds(i1)
        ss2, se2 = slice_bounds(i2)
        # X: in slice+chunk; Y: also chunk-interior (band-exempt)
        x_a = (pr >= ss1) & (pr <= se1) & (pq_a >= cs) & (pq_a <= ce)
        x_b = (pr >= ss2) & (pr <= se2) & (pq_b >= cs) & (pq_b <= ce)
        y_a = x_a & (pq_a > cs) & (pq_a < ce)
        y_b = x_b & (pq_b > cs) & (pq_b < ce)
        cse_a = pq_a == jnp.maximum(cs, i1 - pr)
        # empty-slice termination (agatha_kernel.h:189-191): slices
        # start at multiples of 8*sw, i.e. at substep 0 of an iteration
        ss_sl, se_sl = slice_bounds(D)
        term = jnp.where(
            (term == 0) & (kph == 0) & (d8 < i_end8) & (ss_sl > se_sl),
            1, term,
        )
        at0 = vbase == 0

        for k in range(8):
            d = d8 + k
            # cells with ro > k sit on packed diagonal D-1 (class b)
            cls = ro > k
            qq_ge0 = base_qq >= -k
            valid = qq_ge0 & (base_qq < qlen - k)
            in_band = jnp.abs(base_band + k) <= bw
            z_a = y_a | (x_a & in_band)
            z_b = y_b | (x_b & in_band)
            C = valid & jnp.where(cls, z_b, z_a)
            # chunk-start cells (qo == 0) are always class a
            cst = (ro == k) & qq_ge0 & cse_a
            # H at d-1 / d-2 alternate between hfa and hfb
            hf1, hf2 = (hfa, hfb) if k % 2 == 0 else (hfb, hfa)

            # query window: qwin[:, l] = q[d - vbase - l]
            qwin = jnp.where(bottom, feed[:, k:k + 1], _roll(qwin, 1))
            # diagonal-H input with strip round-trip / fake-row reload.
            # Once the window leaves row 0, the bottom row is in the
            # never-computed margin and reads MINUS_INF2.
            htl = jnp.where(bottom, jnp.where(at0, top_h(d - 1), minf),
                            _roll(hf2, 1))
            if not safe16:
                htl = jnp.where(blk_first | cst, _trunc16(htl), htl)
            htl = jnp.where(cst & prev_fake, minf, htl)
            # E flows down rows (top strip is int16); F along rows
            # (left strip is int16)
            e_in = jnp.where(blk_first, strip16(est), est)
            e_in = jnp.where(bottom, jnp.where(at0, top_e(d), minf), e_in)
            f_in = jnp.where(cst, strip16(fst), fst)
            f_in = jnp.where(cst & fake, minf, f_in)

            s = jnp.where(qwin == tb, sub_m, sub_x)
            s = jnp.where(qwin == N_VALUE, -N_PENALTY, s)
            temp = htl + s
            h_new = jnp.maximum(jnp.maximum(temp, f_in), e_in)
            tg = temp - goe
            fst = jnp.where(C, jnp.maximum(tg, f_in - ge), f_in)
            e_nx = jnp.where(C, jnp.maximum(tg, e_in - ge), e_in)
            est = _roll(e_nx, 1)
            new_h = jnp.where(C, h_new, hf1)
            if k % 2 == 0:
                hfb = new_h
            else:
                hfa = new_h

            packed = jnp.where(C, (h_new << 16) + r, jnp.int32(INT32_MIN))
            dmax = jnp.max(packed, axis=1, keepdims=True)

            # --- per-pair bookkeeping (agatha_kernel.h:291-313,
            # 336-356): the last slice is checked up to n_diags, the
            # wrap-up pass after it without that guard ---
            live = (term == 0) & (d < end_p)
            gate = live & (((d < i_end8) & (d < n_diags)) | (d >= i_end8))
            th = dmax >> 16
            tr = dmax & 0xFFFF
            dq = d - tr
            upd = gate & (th > ms)
            if z >= 0:
                zel = gate & ~upd & (tr >= mr) & (dq >= mq)
                gap = jnp.abs((tr - mr) - (dq - mq))
                term = jnp.where(zel & (ms - th > z + gap * ge), 1, term)
            ms = jnp.where(upd, th, ms)
            mr = jnp.where(upd, tr, mr)
            mq = jnp.where(upd, dq, mq)
            diags = diags + live.astype(_I32)

        kph = kph + 1
        wrap = kph >= sw
        return (d8 + 8, vbase, jnp.where(wrap, i1 + sw, i1),
                jnp.where(wrap, 0, kph), hfa, hfb, fst, est, qwin,
                ms, mr, mq, term, diags)

    h0, f0 = boundary_init(pos)
    zeros = jnp.zeros((gb, 1), _I32)
    state = jnp.zeros((gb, W), _I32)
    init = (
        jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
        state + h0, state + h0, state + f0, state + minf, state,
        zeros, zeros, zeros, zeros, zeros,
    )
    final = jax.lax.while_loop(cond, body, init)
    ms, mr, mq, _term, diags = final[-5:]
    return jnp.concatenate([ms, mq, mr, diags], axis=1)


def align_bucket_impl(meta, tcodes, qfwd, *, cfg: AlignConfig,
                      safe16: bool, route: str):
    """Traceable bucket alignment on one device (call under jit or
    shard_map).  ``tcodes``/``qfwd`` are nibble-packed uint8."""
    if route == "cuda":
        from agatha_jax import cuda

        cuda.load()
        return cuda.dp_call(meta, tcodes, qfwd, cfg=cfg, safe16=safe16)
    return _dp_xla(
        meta.astype(_I32), unpack_nibbles(tcodes), unpack_nibbles(qfwd),
        cfg=cfg, safe16=safe16,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "safe16", "route"))
def _align_bucket_jit(meta, tcodes, qfwd, *, cfg, safe16, route):
    return align_bucket_impl(meta, tcodes, qfwd, cfg=cfg, safe16=safe16,
                             route=route)


def bucket_safe16(cfg: AlignConfig, tcodes, qfwd,
                  force_strips: bool = False) -> bool:
    """int16-safety of a bucket: its widths bound every pair's length."""
    return (not force_strips) and int16_safe(
        cfg, max_len=wire_width(tcodes) + wire_width(qfwd)
    )


def align_bucket(
    meta: np.ndarray | jax.Array,
    tcodes: np.ndarray | jax.Array,
    qfwd: np.ndarray | jax.Array,
    cfg: AlignConfig,
    *,
    force_strips: bool = False,
    route: str | None = None,
) -> jax.Array:
    """Align one shape-uniform bucket of pairs on the default device.

    Args:
      meta:   (GB, 2) int32 — [qlen, rlen] per pair.  Padding pairs
              should use qlen = rlen = 1.
      tcodes: (GB, W/2) uint8 nibble-packed target codes; W a multiple
              of WIDTH_UNIT and >= the padded target length of every
              pair (ops/bucket.py).
      qfwd:   (GB, QF/2) uint8 nibble-packed query codes, left-aligned,
              zero padded; QF >= the padded query length of every pair.
      cfg:    alignment parameters (static; triggers recompilation).
      force_strips: keep the int16 strip round-trips even when the
              config is provably int16-safe (testing).
      route:  "cuda" or "xla"; None selects by backend (select_route).

    Returns:
      (GB, 4) int32 — [score, query_end, target_end, diagonals_swept].
    """
    route = select_route(requested=route)
    assert tcodes.dtype == np.uint8 and qfwd.dtype == np.uint8
    safe16 = bucket_safe16(cfg, tcodes, qfwd, force_strips)
    return _align_bucket_jit(
        jnp.asarray(meta, _I32), jnp.asarray(tcodes), jnp.asarray(qfwd),
        cfg=cfg, safe16=safe16, route=route,
    )
