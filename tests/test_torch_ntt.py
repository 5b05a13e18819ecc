"""The port's radix-2 NTT and polynomial helpers against the JAX package on
CPU (bn254_fr).

The same coefficients, made with numpy from a fixed seed, go through
``tachyon_tpu.math.ntt.Radix2Domain`` / ``tachyon_tpu.math.poly`` and
through the port; the Montgomery words must agree bit for bit.  The port's
``divide_by_linear`` is a parallel suffix scan where the JAX package scans
sequentially: exact field arithmetic gives the same words, z = 0 included.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import ntt as jntt
from tachyon_tpu.math import poly as jpoly
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, poly
from tachyon_tpu_torch.math.ntt import Radix2Domain

torch.set_num_threads(1)

JFR = jcurves.bn254_fr()
SHIFT = 5  # the multiplicative generator of bn254_fr, the usual coset shift


def rand_fr(rng, shape):
    """Random bn254_fr ints -> (JAX limbs, port words), zero in lane 0."""
    xs = np.array([int.from_bytes(rng.bytes(40), "little") % JFR.p
                   for _ in range(int(np.prod(shape)))], dtype=object).reshape(shape)
    xs.reshape(-1)[0] = 0
    j = JFR.encode(xs)
    return jnp.asarray(j), limbs.from_jax_limbs(j)


def assert_same(jax_out, torch_out):
    np.testing.assert_array_equal(limbs.to_jax_limbs(torch_out), np.asarray(jax_out))


@pytest.mark.parametrize("n", [8, 16])
def test_fft_ifft_vs_jax(n):
    fr = curves.bn254_fr("cpu")
    ja, ta = rand_fr(np.random.default_rng(40 + n), (n,))
    jd, td = jntt.Radix2Domain(JFR, n), Radix2Domain(fr, n)
    assert_same(jd.twiddles(False), td.twiddles(False))
    evals = td.fft(ta)
    assert_same(jd.fft(ja), evals)
    assert_same(jd.ifft(ja), td.ifft(ta))
    assert torch.equal(td.ifft(evals), ta)


@pytest.mark.parametrize("n", [8, 16])
def test_coset_fft_vs_jax(n):
    fr = curves.bn254_fr("cpu")
    ja, ta = rand_fr(np.random.default_rng(50 + n), (n,))
    jd, td = jntt.Radix2Domain(JFR, n), Radix2Domain(fr, n)
    assert_same(jd.shift_powers(SHIFT), td.shift_powers(SHIFT))
    ev = td.coset_fft(ta, SHIFT)
    assert_same(jd.coset_fft(ja, SHIFT), ev)
    assert_same(jd.coset_ifft(ja, SHIFT), td.coset_ifft(ta, SHIFT))
    assert torch.equal(td.coset_ifft(ev, SHIFT), ta)


def test_fft_batch_axes_and_edges():
    """Trailing batch axes ride along (each column as its own transform,
    held against the JAX package above); n = 1 is the identity; the domain
    refuses sizes that are not powers of two."""
    fr = curves.bn254_fr("cpu")
    _, ta = rand_fr(np.random.default_rng(60), (8, 3))
    dom = Radix2Domain(fr, 8)
    got = dom.fft(ta)
    for c in range(3):
        assert torch.equal(got[:, :, c], dom.fft(ta[:, :, c].contiguous()))
    assert torch.equal(dom.coset_ifft(dom.coset_fft(ta, SHIFT), SHIFT), ta)
    assert torch.equal(Radix2Domain(fr, 1).fft(ta[:, :1, 0]), ta[:, :1, 0])
    with pytest.raises(ValueError):
        Radix2Domain(fr, 12)
    with pytest.raises(ValueError):
        dom.fft(ta[:, :4])


@pytest.mark.parametrize("n", [1, 6, 16])
@pytest.mark.parametrize("z_kind", ["zero", "random"])
def test_divide_by_linear_vs_jax(n, z_kind):
    fr = curves.bn254_fr("cpu")
    rng = np.random.default_rng(70 + n)
    ja, ta = rand_fr(rng, (n,))
    z = 0 if z_kind == "zero" else int.from_bytes(rng.bytes(40), "little") % JFR.p
    jz = jnp.asarray(JFR.encode(np.array(z, dtype=object)))
    jq, jrem = jpoly.divide_by_linear(JFR, ja, jz)
    q, rem = poly.divide_by_linear(fr, ta, fr.encode(z))
    assert tuple(q.shape) == (8, n - 1)
    assert_same(jq, q)
    assert_same(jrem, rem)


@pytest.mark.parametrize("z_kind", ["zero", "random"])
def test_eval_at_vs_jax(z_kind):
    fr = curves.bn254_fr("cpu")
    rng = np.random.default_rng(80)
    ja, ta = rand_fr(rng, (11,))
    z = 0 if z_kind == "zero" else int.from_bytes(rng.bytes(40), "little") % JFR.p
    want = jpoly.eval_at_fast(JFR, ja, z)
    assert_same(want, poly.eval_at_fast(fr, ta, z))
    assert_same(want, poly.eval_at(fr, ta, fr.encode(z)))


def test_poly_add_scale_vs_jax():
    fr = curves.bn254_fr("cpu")
    rng = np.random.default_rng(90)
    ja, ta = rand_fr(rng, (5,))
    jb, tb = rand_fr(rng, (3,))
    assert_same(jpoly.add(JFR, ja, jb), poly.add(fr, ta, tb))
    assert_same(jpoly.add(JFR, jb, ja), poly.add(fr, tb, ta))
    assert_same(jpoly.scale(JFR, ja, jb[:, 1]), poly.scale(fr, ta, tb[:, 1]))
