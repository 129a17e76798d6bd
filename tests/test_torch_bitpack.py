"""Parity of the port's bit-packing codec (``hyperspace_tpu_torch/ops/
bitpack.py``) with the JAX package's on the same numpy-made values: the
plain and FoR-delta specs, the packed words and the host decode, and
``unpack_plain_torch`` (the plain version of K1p's decode) against
``unpack_plain_jnp`` run on the CPU. Tolerance: exact throughout.
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import bitpack as jb

from hyperspace_tpu_torch.ops import bitpack as tb

# (lo, hi, n): every width 1..16 (so every vpw 32, 16, 8, 4, 2), negative
# frames, one-value spans, and lengths that end mid-word
CASES = [(0, 6, 1000), (-50, 13, 8192), (7, 7, 5), (0, 65535, 3000), (-40000, -39000, 777)]
CASES += [(-(1 << b) // 3, -(1 << b) // 3 + (1 << b) - 1, 8192 + 3 * b) for b in range(1, 17)]


def _spec_tuple(s):
    return None if s is None else (s.bits, s.vpw, s.n, s.ref0, s.block, s.n_words,
                                   s.packed_nbytes)


@pytest.mark.parametrize("lo,hi,n", CASES)
def test_plain_pack_matches_reference(lo, hi, n):
    import jax

    rng = np.random.default_rng(n)
    v = rng.integers(lo, hi + 1, n).astype(np.int64)
    v[0], v[-1] = lo, hi
    js, ts = jb.pack_spec(lo, hi, n), tb.pack_spec(lo, hi, n)
    assert _spec_tuple(ts) == _spec_tuple(js)
    assert ts.vpw >= 2 and ts.vpw & (ts.vpw - 1) == 0 and ts.vpw * ts.bits <= 32
    words = tb.pack_plain(v, ts)
    assert words.dtype == np.int32 and np.array_equal(words, jb.pack_plain(v, js))
    assert np.array_equal(tb.unpack_plain_host(words, ts), v)
    assert np.array_equal(tb.unpack_plain_host(words, ts), jb.unpack_plain_host(words, js))
    want = np.asarray(jax.jit(lambda w, s=js: jb.unpack_plain_jnp(w, s))(words))
    got = tb.unpack_plain_torch(torch.from_numpy(words), ts)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(want, v)


def test_spec_declines_match_reference():
    for args in [(0, 1 << 20, 100), (0, 5, 0), (5, 4, 10), (0, (1 << 16) - 1, 9),
                 (0, 1 << 16, 9), (-3, -3, 1)]:
        assert _spec_tuple(tb.pack_spec(*args)) == _spec_tuple(jb.pack_spec(*args)), args
    assert [tb._vpw(b) for b in range(1, 17)] == [jb._vpw(b) for b in range(1, 17)]


@pytest.mark.parametrize("block", [64, 128])
def test_for_delta_matches_reference(block):
    import jax

    rng = np.random.default_rng(block)
    v = np.sort(rng.integers(0, 200_000, 30_000)).astype(np.int64)
    js, ts = jb.for_spec(v, block=block), tb.for_spec(v, block=block)
    assert _spec_tuple(ts) == _spec_tuple(js)
    (tw, tr), (jw, jr) = tb.pack_for(v, ts), jb.pack_for(v, js)
    assert np.array_equal(tw, jw) and np.array_equal(tr, jr)
    got = np.asarray(jax.jit(lambda w, r, s=js: jb.unpack_for_jnp(w, r, s))(tw, tr))
    assert np.array_equal(got, v)
    sparse = np.sort(rng.integers(0, 1 << 30, 5000)).astype(np.int64)
    assert tb.for_spec(sparse, block=block) is None and jb.for_spec(sparse, block=block) is None


def test_sign_bit_words_decode_without_smearing():
    """A 16-bit frame whose top value sets a word's sign bit: the torch
    decode must read the word unsigned."""
    spec = tb.pack_spec(0, 65535, 8)
    v = np.array([65535, 0, 32768, 65535, 1, 65534, 0, 65535], dtype=np.int64)
    words = tb.pack_plain(v, spec)
    assert (words < 0).any()
    assert np.array_equal(tb.unpack_plain_torch(torch.from_numpy(words), spec).numpy(), v)
