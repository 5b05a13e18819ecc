"""The port's Fq2 (``math/extfield.py``) against the JAX package on CPU.

Seeded random batches of BN254 Fq2 elements, zeros and p - 1 coefficients
included, go through ``tachyon_tpu``'s ``curves.bn254_fq2()`` (run eagerly)
and the port's ``curves.bn254_fq2("cpu")``; every result must agree word for
word (both return canonical Montgomery residues with the same R), so the
tolerance is zero.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves

torch.set_num_threads(1)

N = 9
P = jcurves.bn254_fq().p


@pytest.fixture(scope="module")
def fields():
    return jcurves.bn254_fq2(), curves.bn254_fq2("cpu")


def rand_coeffs(rng, n=N):
    """Two coefficient lists: lane 0 is zero, lane 1 has c0 = 0, lane 2
    c1 = 0, the last lane p - 1 in both; the rest random."""
    cs = [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)] for _ in range(2)]
    cs[0][0] = cs[1][0] = 0
    cs[0][1] = 0
    cs[1][2] = 0
    cs[0][-1] = cs[1][-1] = P - 1
    return cs


def both(jf, cs):
    """Coefficient lists -> (JAX element (2, 16, n), port element (2, 8, n))."""
    j = jf.encode([np.array(c, dtype=object) for c in cs])
    return j, limbs.from_jax_limbs(np.asarray(j), axis=1)


def assert_same(jax_out, torch_out):
    np.testing.assert_array_equal(limbs.to_jax_limbs(torch_out, axis=1), np.asarray(jax_out))


def test_encode_decode_constants(fields):
    jf, tf = fields
    rng = np.random.default_rng(1)
    cs = rand_coeffs(rng)
    ja, ta = both(jf, cs)
    assert tuple(ta.shape) == (2, 8, N) and tf.coeff_ndim == 2
    assert_same(ja, tf.encode([np.array(c, dtype=object) for c in cs]))
    assert [[int(v) for v in c] for c in tf.decode(ta)] == cs
    assert_same(jf.zeros((3,)), tf.zeros((3,)))
    assert_same(jf.ones((3,)), tf.ones((3,)))
    assert_same(jnp.broadcast_to(jf.encode([5, 7])[..., None], (2, 16, 4)), tf.full((4,), [5, 7]))
    assert tf.order == P * P and tf.p == P


@pytest.mark.parametrize("op", ["add", "sub", "mul", "eq"])
def test_binary_ops(fields, op):
    jf, tf = fields
    rng = np.random.default_rng(2)
    ja, ta = both(jf, rand_coeffs(rng))
    cb = rand_coeffs(rng)
    cb[0][3], cb[1][3] = int(jf.decode(ja[:, :, 3:4])[0][0]), int(jf.decode(ja[:, :, 3:4])[1][0])
    jb, tb = both(jf, cb)  # lane 3 equal to a's
    got, want = getattr(tf, op)(ta, tb), getattr(jf, op)(ja, jb)
    if op == "eq":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool(got[3]) and bool(got[0])
    else:
        assert_same(want, got)


@pytest.mark.parametrize("op", ["neg", "double", "square", "is_zero", "inv", "mul_by_nonresidue"])
def test_unary_ops(fields, op):
    jf, tf = fields
    rng = np.random.default_rng(3)
    ja, ta = both(jf, rand_coeffs(rng))
    if op == "mul_by_nonresidue":  # a base-field op: on coefficient 1
        assert_same(jf.mul_by_nonresidue(ja[1])[None], tf.mul_by_nonresidue(ta[1])[None])
        return
    got, want = getattr(tf, op)(ta), getattr(jf, op)(ja)
    if op == "is_zero":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert bool(got[0]) and not bool(got[1:].any())
    else:
        assert_same(want, got)


def test_inverse_products(fields):
    """a * inv(a) = 1 on nonzero lanes, inv(0) = 0, as host ints."""
    jf, tf = fields
    rng = np.random.default_rng(4)
    _, ta = both(jf, rand_coeffs(rng))
    prod = tf.decode(tf.mul(ta, tf.inv(ta)))
    assert [int(v) for v in prod[0]] == [0] + [1] * (N - 1)
    assert [int(v) for v in prod[1]] == [0] * N


@pytest.mark.parametrize("k", [0, 1, 3, 12])
def test_mul_small_and_base(fields, k):
    jf, tf = fields
    rng = np.random.default_rng(5 + k)
    ja, ta = both(jf, rand_coeffs(rng))
    assert_same(jf.mul_small(ja, k), tf.mul_small(ta, k))
    s = [int.from_bytes(rng.bytes(40), "little") % P for _ in range(N)]
    s[1] = 0
    js = jf.base.encode(np.array(s, dtype=object))
    assert_same(jf.mul_base(ja, js), tf.mul_base(ta, limbs.from_jax_limbs(np.asarray(js))))


def test_select_embed_pow(fields):
    jf, tf = fields
    rng = np.random.default_rng(6)
    ja, ta = both(jf, rand_coeffs(rng))
    jb, tb = both(jf, rand_coeffs(rng))
    mask = rng.integers(0, 2, N).astype(bool)
    assert_same(jf.select(jnp.asarray(mask), ja, jb), tf.select(torch.from_numpy(mask), ta, tb))
    assert_same(jf.embed(ja[0]), tf.embed(ta[0]))
    for e in (0, 1 << 70 | 12345):
        assert_same(jf.pow_const(ja[:, :, :4], e), tf.pow_const(ta[:, :, :4], e))


def test_batch_inverse(fields):
    """Along the to_affine stacking axis (2) of a (2, 8, 2, 6) batch, zeros
    -> zeros, as the JAX scan gives it; along the last axis, the inverse of
    every nonzero element."""
    jf, tf = fields
    rng = np.random.default_rng(7)
    cs = rand_coeffs(rng, 12)
    ja, ta = both(jf, cs)
    ja, ta = ja.reshape(2, 16, 2, 6), ta.reshape(2, 8, 2, 6)
    assert_same(jf.batch_inverse(ja, axis=2), tf.batch_inverse(ta, axis=2))
    inv_last = tf.batch_inverse(ta, axis=-1)
    assert_same(jf.inv(ja), inv_last)
    with pytest.raises(ValueError):
        tf.batch_inverse(ta, axis=1)
