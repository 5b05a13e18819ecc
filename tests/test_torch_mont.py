"""The port's field layer (tachyon_tpu_torch) against the JAX package on CPU.

Inputs are made with numpy from a fixed seed and go through both
packages; results must agree bit for bit (both return canonical
Montgomery residues, and R is the same in both).
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tachyon_tpu.fields import presets
from tachyon_tpu.fields.spec import int_to_limbs
from tachyon_tpu.ops import mont as jmont
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, field
from tachyon_tpu_torch.ops import cuda_mont, mont

torch.set_num_threads(1)  # tiny tensors; the suite runs several workers


def rand_ints(f, n, rng, zeros=(0,)):
    """n canonical ints of field f with zero (and p - 1) lanes."""
    xs = [int.from_bytes(rng.bytes(48), "little") % f.p for _ in range(n)]
    for k in zeros:
        xs[k] = 0
    xs[-1] = f.p - 1
    return xs


def both(f, xs):
    """Python ints -> (JAX Montgomery limbs, port Montgomery words)."""
    j = f.encode(np.array(xs, dtype=object))
    return jnp.asarray(j), limbs.from_jax_limbs(j)


def assert_same(jax_out, torch_out):
    np.testing.assert_array_equal(limbs.to_jax_limbs(torch_out), np.asarray(jax_out))


@pytest.mark.parametrize("f", presets.ALL_FIELDS, ids=lambda f: f.name)
def test_repack_round_trip(f):
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 16, size=(f.L, 3, 5), dtype=np.uint32)
    w = limbs.from_jax_limbs(a)
    assert w.dtype == torch.int32 and tuple(w.shape) == (f.L // 2, 3, 5)
    np.testing.assert_array_equal(limbs.to_jax_limbs(w), a)
    xs = rand_ints(f, 6, rng)
    assert [int(v) for v in limbs.decode(f, limbs.encode(f, np.array(xs, dtype=object)))] == xs
    # word j = limb 2j | limb 2j+1 << 16, so the words spell the same integer
    words = w[:, 0, 0].numpy().view(np.uint32)
    assert sum(int(v) << (32 * i) for i, v in enumerate(words)) == sum(
        int(v) << (16 * i) for i, v in enumerate(a[:, 0, 0]))


@pytest.mark.parametrize("f", presets.ALL_FIELDS, ids=lambda f: f.name)
def test_n0inv32(f):
    n0 = limbs.n0inv32(f)
    assert 0 <= n0 < 1 << 32
    assert (f.p * n0) % (1 << 32) == (1 << 32) - 1
    assert n0 % (1 << 16) == f.n0inv


FIELDS = [presets.BN254_FQ, presets.BN254_FR]


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "square"])
def test_elementwise_vs_jax(f, op):
    rng = np.random.default_rng(11)
    ja, ta = both(f, rand_ints(f, 40, rng, zeros=(0, 3)))
    jb, tb = both(f, rand_ints(f, 40, rng, zeros=(1, 3)))
    want, got = {
        "add": lambda: (jmont.add(f, ja, jb), mont.add(f, ta, tb)),
        "sub": lambda: (jmont.sub(f, ja, jb), mont.sub(f, ta, tb)),
        "neg": lambda: (jmont.neg(f, ja), mont.neg(f, ta)),
        "mul": lambda: (jmont._mul_jnp(f, ja, jb), mont.mul(f, ta, tb)),
        "square": lambda: (jmont._mul_jnp(f, ja, ja), mont.square(f, ta)),
    }[op]()
    assert_same(want, got)


@pytest.mark.parametrize("f", FIELDS + [presets.SECP256K1_FQ, presets.BLS12_381_FQ],
                         ids=lambda f: f.name)
def test_mul_edge_operands_vs_jax(f):
    """K1's edge operands as the words a kernel sees: 0, 1, mont(1) = R mod
    p, 2 and p - 1, every pair (so (p - 1)^2 too); secp256k1's p is full
    width and BLS12-381's Fq 12 words (the kernels' 64-bit CIOS form of the
    multiply)."""
    vals = [0, 1, f.R_mod_p, 2, f.p - 1]
    xs, ys = [x for x in vals for _ in vals], [y for _ in vals for y in vals]
    ja, jb = (jnp.asarray(np.stack([int_to_limbs(v, f.L) for v in vs], axis=-1))
              for vs in (xs, ys))
    got = mont.mul(f, limbs.from_jax_limbs(np.asarray(ja)), limbs.from_jax_limbs(np.asarray(jb)))
    assert_same(jmont._mul_jnp(f, ja, jb), got)
    r_inv = pow(1 << (32 * f.L // 2), -1, f.p)
    assert limbs.words_to_ints(got.numpy().view(np.uint32)) == [
        x * y * r_inv % f.p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_mul_plain_is_the_cpu_path(f):
    """The CPU path of the K1 wrapper is its plain twin, and no launch counts."""
    rng = np.random.default_rng(12)
    _, ta = both(f, rand_ints(f, 9, rng))
    _, tb = both(f, rand_ints(f, 9, rng))
    before = cuda_mont.mul.launches
    assert torch.equal(cuda_mont.mul(f, ta, tb), cuda_mont.mul_plain(f, ta, tb))
    assert cuda_mont.mul.launches == before
    # batch axes broadcast like the JAX op
    got = mont.mul(f, ta[:, :1, None], tb.reshape(-1, 3, 3))
    assert tuple(got.shape) == (f.L // 2, 3, 3)


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_inverse_vs_jax(f):
    rng = np.random.default_rng(13)
    xs = rand_ints(f, 12, rng, zeros=(0, 5))
    ja, ta = both(f, xs)
    assert_same(jmont.batch_inverse(f, ja), mont.batch_inverse(f, ta))
    assert_same(jmont.inv(f, ja[:, :3]), mont.inv(f, ta[:, :3]))
    got = [int(v) for v in limbs.decode(f, mont.batch_inverse(f, ta))]
    assert got == [pow(x, -1, f.p) if x else 0 for x in xs]


@pytest.mark.parametrize("f", FIELDS, ids=lambda f: f.name)
def test_mont_conversion_and_small(f):
    rng = np.random.default_rng(14)
    xs = rand_ints(f, 8, rng)
    plain = limbs.from_jax_limbs(np.stack([int_to_limbs(x, f.L) for x in xs], axis=-1))
    m = mont.to_mont(f, plain)
    assert [int(v) for v in limbs.decode(f, m)] == xs
    assert torch.equal(mont.mont_reduce(f, m), plain)
    assert [int(v) for v in limbs.decode(f, mont.mul_small(f, m, 11))] == [
        11 * x % f.p for x in xs]
    assert [int(v) for v in limbs.decode(f, mont.pow_const(f, m, 5))] == [
        pow(x, 5, f.p) for x in xs]
    assert bool(mont.is_zero(f, mont.sub(f, m, m)).all())
    assert bool(mont.eq(f, m, m).all())
    assert [int(v) for v in limbs.decode(f, mont.ones(f, (2,), "cpu"))] == [1, 1]


def test_point_repack_and_input_checks():
    f = presets.BN254_FQ
    rng = np.random.default_rng(15)
    x, y = (rng.integers(0, 1 << 16, size=(16, 4), dtype=np.uint32) for _ in range(2))
    inf = np.array([False, True, False, False])
    aff = limbs.affine_from_jax((x, y, inf))
    assert aff.inf.dtype == torch.bool and tuple(aff.x.shape) == (8, 4)
    for got, want in zip(limbs.affine_to_jax(aff), (x, y, inf)):
        np.testing.assert_array_equal(got, want)
    pt = limbs.xyzz_from_jax((x, y, x, y))
    for got, want in zip(limbs.xyzz_to_jax(pt), (x, y, x, y)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        limbs.from_jax_limbs(x[:3])
    with pytest.raises(ValueError):
        limbs.int_to_words(f.p << 256, 8)
    with pytest.raises(ValueError):
        mont.batch_inverse(f, aff.x, axis=0)
    # the kernels take CUDA int32 words of fields of 1, 2, 8 or 12 words only
    with pytest.raises(ValueError):
        cuda_mont.check_cuda(f, aff.x)
    with pytest.raises(ValueError):
        cuda_mont.check_cuda(presets.BLS12_381_FQ, aff.x)
    assert cuda_mont.SUPPORTED_W == (1, 2, 8, 12) and cuda_mont.POINT_W == {8, 12}
    with pytest.raises(ValueError, match="point kernels take W in \\[8, 12\\], not W=2"):
        cuda_mont.check_cuda(presets.GOLDILOCKS, aff.x)
    # the point kernels take a full-width p at W = 8 (secp256k1: the 64-bit
    # CIOS form) as well as a spare bit (the chains), and name the form;
    # the tensors must still be CUDA int32 words
    assert cuda_mont.has_spare_bit(f) and not cuda_mont.has_spare_bit(presets.SECP256K1_FQ)
    assert cuda_mont.check_cuda(presets.SECP256K1_FQ) == cuda_mont.Form(8, False)
    assert cuda_mont.check_cuda(f).tag == "w8_spare"
    assert cuda_mont.check_cuda(presets.BLS12_381_FQ).tag == "w12_full"
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_mont.check_cuda(presets.SECP256K1_FQ, aff.x)
    # Goldilocks (W = 2) has K1 alone (its own kernel, tag w2_full); the
    # tensors must still be CUDA int32 words
    assert cuda_mont.check_cuda(presets.GOLDILOCKS, any_width=True).tag == "w2_full"
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_mont.check_cuda(presets.GOLDILOCKS, aff.x, any_width=True)
    with pytest.raises(ValueError, match="no CUDA kernel for W=3"):
        cuda_mont.check_cuda(dataclasses.replace(presets.GOLDILOCKS, p=(1 << 95) - 1),
                             any_width=True)


def test_entry_points_default_to_the_card(monkeypatch):
    """curves.*, PrimeField and mont.zeros/ones default to CUDA; with no CUDA
    device a call left at its default raises instead of taking the CPU."""
    cuda = torch.device("cuda")
    for fn in (curves.bn254_fq, curves.bn254_fr, curves.bn254_g1, curves.bls12_381_fq,
               curves.bls12_381_g1, curves.bls12_381_g2, field.PrimeField, mont.zeros,
               mont.ones):
        assert inspect.signature(fn).parameters["device"].default == cuda, fn
    no_card = not torch.cuda.is_available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (curves.bn254_fq, curves.bn254_fr, curves.bn254_g1):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    if no_card:
        for fn in (mont.zeros, mont.ones):
            with pytest.raises((RuntimeError, AssertionError)):
                fn(presets.BN254_FR, (2,))
    assert curves.bn254_g1("cpu").device == torch.device("cpu")
