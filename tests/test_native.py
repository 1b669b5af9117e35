"""Native C++ packer vs the NumPy reference implementation."""

import numpy as np
import pytest

from agatha_jax import native
from agatha_jax.ops.bucket import pack_nibbles
from agatha_jax.ops.packing import encode_padded, padded_len

from .conftest import random_seq


@pytest.fixture(scope="module")
def lib_ok():
    if not native.available():
        pytest.skip("g++ unavailable; native path not built")
    return True


def test_encode_batch_matches_python(rng, lib_ok):
    seqs = []
    ops = []
    for i in range(40):
        n = int(rng.integers(1, 120))
        seqs.append(random_seq(rng, n, 0.05).encode())
        ops.append(i % 4)
    stride = max(padded_len(len(s)) for s in seqs)
    stride = -(-stride // 8) * 8
    out, lens = native.encode_batch(seqs, np.array(ops, np.uint8), stride)
    for i, s in enumerate(seqs):
        exp = encode_padded(s, ops[i])
        assert lens[i] == len(s)
        assert (out[i, : len(exp)] == exp).all(), i
        assert (out[i, len(exp) :] == 0).all()


def test_pack_nibbles_matches_python(rng, lib_ok):
    codes = rng.integers(0, 16, size=(10, 64)).astype(np.uint8)
    assert (
        native.pack_nibbles_rows(codes) == pack_nibbles(codes)
    ).all()


def test_fallback_works(monkeypatch, rng):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    seqs = [random_seq(rng, 20).encode()]
    out, lens = native.encode_batch(seqs, None, 24)
    exp = encode_padded(seqs[0])
    assert (out[0, : len(exp)] == exp).all()
