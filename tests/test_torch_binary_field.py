"""The port's binary tower GF(2^k) (``math/binary_field.py``) against the
JAX package on CPU, for every level k = 1 .. 128.

Both packages draw the same elements from one numpy seed (``random``), and
every result must be the JAX words bit for bit: the port's ``int32`` words
are the JAX ``uint32`` words reinterpreted, so the tolerance is zero.  Lane
0 is zero (its inverse is zero) and lane 1 is one.
"""
import numpy as np
import pytest
import torch

from tachyon_tpu.math.binary_field import binary_field as jax_binary_field
from tachyon_tpu_torch.math.binary_field import binary_field

torch.set_num_threads(1)

LEVELS = (1, 2, 4, 8, 16, 32, 64, 128)
N = 24
SHORT_EXP = 0b1101011  # pow_const's exponent: JAX's eager ladder costs ~0.5 s a bit at k = 128


def as_words(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)


def operands(k):
    """The JAX and the port field, and (a, b) drawn by each from the same
    seed; lane 0 of a is zero and lane 1 one."""
    J, T = jax_binary_field(k), binary_field(k, "cpu")
    ja, ta = J.random((N,), np.random.default_rng(k)), T.random((N,), np.random.default_rng(k))
    jb = J.random((N,), np.random.default_rng(1000 + k))
    tb = T.random((N,), np.random.default_rng(1000 + k))
    np.testing.assert_array_equal(ta.numpy(), as_words(ja))
    np.testing.assert_array_equal(tb.numpy(), as_words(jb))
    vals = J.decode(ja)
    vals[0], vals[1] = 0, 1
    return J, T, J.encode(vals), T.encode(vals), jb, tb


@pytest.mark.parametrize("k", LEVELS)
def test_arithmetic_words_vs_jax(k):
    J, T, ja, ta, jb, tb = operands(k)
    for name, jout, tout in (
            ("add", J.add(ja, jb), T.add(ta, tb)),
            ("mul", J.mul(ja, jb), T.mul(ta, tb)),
            ("square", J.square(ja), T.square(ta)),
            ("mul_by_alpha", J.mul_by_alpha(ja), T.mul_by_alpha(ta)),
            ("inv", J.inv(ja), T.inv(ta)),
            ("pow_const", J.pow_const(ja, SHORT_EXP), T.pow_const(ta, SHORT_EXP))):
        np.testing.assert_array_equal(tout.numpy(), as_words(jout), err_msg=f"{name} at k = {k}")


@pytest.mark.parametrize("k", LEVELS)
def test_layout_and_inverse(k):
    J, T, ja, ta, _, _ = operands(k)
    assert tuple(ta.shape) == tuple(np.asarray(ja).shape) and ta.dtype == torch.int32
    assert list(T.decode(ta)) == list(J.decode(ja))
    np.testing.assert_array_equal(T.ones((3,)).numpy(), as_words(J.ones((3,))))
    np.testing.assert_array_equal(T.zeros((3,)).numpy(), as_words(J.zeros((3,))))
    np.testing.assert_array_equal(T.is_zero(ta).numpy(), np.asarray(J.is_zero(ja)))
    # a a^-1 = 1 on every nonzero lane, 0 on the zero lane
    prod = T.mul(ta, T.inv(ta))
    nz = ~T.is_zero(ta)
    assert bool(T.is_zero(T.add(prod, T.ones((N,))))[nz].all())
    assert bool(T.is_zero(prod)[~nz].all())


def test_top_bit_words():
    """Elements with the top bit of a word set are negative int32 words; the
    shifts must still act as the JAX uint32 ones (0xFFFFFFFF is -1)."""
    for k in (32, 64, 128):
        J, T = jax_binary_field(k), binary_field(k, "cpu")
        vals = np.array([(1 << k) - 1, 1 << (k - 1), 0x80000001 << (k - 32)], dtype=object)
        ta, ja = T.encode(vals), J.encode(vals)
        assert bool((ta < 0).any())
        for jout, tout in ((J.mul(ja, ja[..., ::-1]), T.mul(ta, ta.flip(-1))),
                           (J.square(ja), T.square(ta)), (J.inv(ja), T.inv(ta))):
            np.testing.assert_array_equal(tout.numpy(), as_words(jout))


def test_constructor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        binary_field(8)
