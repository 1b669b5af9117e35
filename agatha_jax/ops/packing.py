"""Host-side sequence encoding, padding and reverse/complement.

Replacement for the reference's device-side pack and reverse-complement
kernels (kernels/pack_rc_seqs.h:13-53, :56-212).  These transforms are
cheap one-time host work per batch (vectorised NumPy, or the C++ packer
at scale), which removes two kernel launches and the unpacked-batch H2D
copy from the hot path.

Semantics replicated exactly:

* Encoding: 4-bit code = ASCII byte & 0xF (pack_rc_seqs.h:24-31).  This
  maps a/A -> 1, c/C -> 3, g/G -> 7, t/T -> 4, n/N -> 14 and leaves any
  other character's low nibble as its code.
* Padding: every sequence is padded with 'N' (code 14) to a multiple of 8
  bases (host_batch.cpp:100-102,143-146).
* Reverse: the reference reverses the *padded* nibble array.  (Its
  trailing-N preservation logic is dead: it compares 4-bit nibbles to
  N_CODE=0x4E which never matches, so nbr_N==0 and the tail padding is
  reversed along with the sequence; see pack_rc_seqs.h:111-121 and note
  SASS shift-clamp makes `x<<32`/`x>>32` zero there.)  We reproduce the
  full padded-width reversal bit-for-bit.
* Complement: A<->T, C<->G per nibble, others unchanged
  (pack_rc_seqs.h:176-198).
"""

from __future__ import annotations

import numpy as np

from agatha_jax.constants import N_CODE, PACKED_LEN

# Complement lookup over all 16 nibble codes (identity except A/T, C/G).
_COMPLEMENT_LUT = np.arange(16, dtype=np.uint8)
_COMPLEMENT_LUT[1] = 4   # A -> T
_COMPLEMENT_LUT[4] = 1   # T -> A
_COMPLEMENT_LUT[3] = 7   # C -> G
_COMPLEMENT_LUT[7] = 3   # G -> C


def padded_len(n: int) -> int:
    """Length after padding to a multiple of 8 bases (host_batch.cpp)."""
    return -(-n // PACKED_LEN) * PACKED_LEN


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> 4-bit codes (uint8), unpadded."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8) & 0xF


def encode_padded(seq: str | bytes, op: int = 0) -> np.ndarray:
    """Encode, pad with N to a multiple of 8, and apply the seq op.

    ``op`` bit0 = reverse, bit1 = complement (test_prog.cpp:83-92).
    Returns uint8 codes of length ``padded_len(len(seq))``.
    """
    codes = encode(seq)
    pad = padded_len(len(codes)) - len(codes)
    if pad:
        codes = np.concatenate(
            [codes, np.full(pad, N_CODE & 0xF, dtype=np.uint8)]
        )
    if op & 0x1:  # reverse over the full padded width (see module doc)
        codes = codes[::-1]
    if op & 0x2:  # complement
        codes = _COMPLEMENT_LUT[codes]
    return np.ascontiguousarray(codes)


def pack_words(codes: np.ndarray) -> np.ndarray:
    """4-bit codes (multiple of 8) -> uint32 words, 8 codes per word.

    Base i of word w sits at bits [28-4*(i%8), ...] — first base in the
    highest nibble, matching the reference layout (pack_rc_seqs.h:24-31:
    the base at the lowest byte address lands in bits 31..28).
    """
    assert codes.size % PACKED_LEN == 0
    c = codes.astype(np.uint32).reshape(-1, PACKED_LEN)
    shifts = np.uint32(28) - np.uint32(4) * np.arange(8, dtype=np.uint32)
    return (c << shifts).sum(axis=1, dtype=np.uint32)


def unpack_words(words: np.ndarray, n: int | None = None) -> np.ndarray:
    """Inverse of :func:`pack_words`; optionally truncate to n codes."""
    w = words.astype(np.uint32)[:, None]
    shifts = np.uint32(28) - np.uint32(4) * np.arange(8, dtype=np.uint32)
    codes = ((w >> shifts) & 0xF).astype(np.uint8).reshape(-1)
    return codes[:n] if n is not None else codes
