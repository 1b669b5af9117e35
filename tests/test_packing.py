import numpy as np

from agatha_jax.constants import N_VALUE
from agatha_jax.ops import packing


def test_base_codes():
    codes = packing.encode("ACGTNacgtn")
    assert list(codes) == [1, 3, 7, 4, 14, 1, 3, 7, 4, 14]


def test_padding_to_multiple_of_8():
    codes = packing.encode_padded("ACGTA")
    assert codes.size == 8
    assert list(codes[5:]) == [N_VALUE] * 3


def test_pack_unpack_roundtrip(rng):
    codes = rng.integers(0, 16, size=64).astype(np.uint8)
    words = packing.pack_words(codes)
    assert words.dtype == np.uint32
    assert np.array_equal(packing.unpack_words(words), codes)


def test_pack_layout_first_base_high_nibble():
    # pack_rc_seqs.h:24-31 — first base lands in bits 31..28
    codes = np.array([0xF, 0, 0, 0, 0, 0, 0, 1], dtype=np.uint8)
    (word,) = packing.pack_words(codes)
    assert word == 0xF0000001


def test_reverse_moves_padding_to_front():
    # The reference reverses the full padded width (nbr_N is always 0
    # because it compares nibbles to N_CODE=0x4E; pack_rc_seqs.h:115).
    codes = packing.encode_padded("ACGTA", op=1)
    assert list(codes) == [14, 14, 14, 1, 4, 7, 3, 1]


def test_complement():
    codes = packing.encode_padded("ACGTN" + "AAA", op=2)
    assert list(codes[:5]) == [4, 7, 3, 1, 14]


def test_reverse_complement_order():
    # reverse first, then complement (pack_rc_seqs.h:109,169)
    fwd = packing.encode_padded("ACGTACGT", op=0)
    rc = packing.encode_padded("ACGTACGT", op=3)
    lut = np.array([0, 4, 2, 7, 1, 5, 6, 3, 8, 9, 10, 11, 12, 13, 14, 15])
    assert np.array_equal(rc, lut[fwd[::-1]])
