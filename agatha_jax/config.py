"""Alignment configuration.

One frozen dataclass replaces the reference's three config layers: CLI
``Parameters`` (args_parser.cpp:8-37), the eight ``__constant__`` device
scalars (gasal_kernels.h:29-36, uploaded by gasal_align.cu:295-309), and
the compile-time Makefile defines.  The reference's kernel geometry flags
(-b/-t) do not apply (block shapes follow the bucket); the CLI accepts
them only for compatibility.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    """Scoring + termination parameters of guided extension alignment.

    Defaults match the reference CLI defaults (args_parser.cpp:12-25).
    The canonical benchmark invocation (AGAThA.sh:44) overrides
    ``match=1, gap_open=6``.
    """

    match: int = 2          # -m : match score (positive)
    mismatch: int = 4       # -x : mismatch penalty (positive magnitude)
    gap_open: int = 4       # -q : gap open penalty (positive magnitude)
    gap_extend: int = 2     # -r : gap extension penalty (positive magnitude)
    slice_width: int = 3    # -s : packed antidiagonals per slice
    z_threshold: int = 400  # -z : Z-drop threshold (< 0 disables Z-drop)
    band_width: int = 751   # -w : band half-width |q - r| <= w

    @property
    def gap_oe(self) -> int:
        """gap_open + gap_extend, the cost of a length-1 gap.

        Reference: gasal_align.cu:300 (_cudaGapOE).
        """
        return self.gap_open + self.gap_extend

    @property
    def total_shm(self) -> int:
        """Size of the per-task antidiagonal max ring.

        Reference: agatha_kernel.h:83 (8 * (slice_width + 1)).  The
        reference indexes the ring with ``& (total_shm - 1)`` and is only
        well-defined when this is a power of two; we support arbitrary
        slice widths by using a modulo with identical results for
        power-of-two sizes.
        """
        return 8 * (self.slice_width + 1)

    def __post_init__(self) -> None:
        if self.slice_width < 1:
            raise ValueError("slice_width must be >= 1")
        if self.band_width < 0:
            raise ValueError("band_width must be >= 0")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Batching / dispatch configuration (driver-level).

    ``aligns_per_batch`` mirrors the reference's -a kernel_align_num
    (args_parser.cpp:23); the other knobs are this engine's own.
    """

    aligns_per_batch: int = 8192   # -a: upper bound on pairs per bucket
                                   # (the engine adaptively targets
                                   # target_buckets buckets per batch)
    cpu_threads: int = 0           # -n: host worker threads for the
                                   # native traceback/encode pools
                                   # (0 = hardware_concurrency), the
                                   # reference's OpenMP -n analogue
    target_buckets: int = 16       # adaptive bucket-count target: the
                                   # batch splits into ~this many
                                   # length-sorted buckets (at least 64
                                   # pairs each) so host packing, upload
                                   # and device compute pipeline, and
                                   # each bucket's sweep is trimmed to
                                   # its own pairs.  Not yet re-derived
                                   # on the GPU.
    use_all_devices: bool = True   # shard each bucket over all local
                                   # devices; False pins dispatch to
                                   # the default device
    dp_route: str | None = None    # "cuda" or "xla"; None picks by
                                   # backend (ops.dp.select_route)


def c_div_trunc(a: int, b: int) -> int:
    """C-style integer division (truncation toward zero).

    The reference's slice clipping arithmetic (agatha_kernel.h:184,186)
    divides possibly-negative ints with C semantics; Python's // floors,
    so this helper is used wherever the two differ.
    """
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q
