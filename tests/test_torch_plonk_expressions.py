"""The port's PLONK expression evaluator against the JAX package's, on CPU.

Every node type and several rotations, on numpy-seeded bn254_fr columns at
n = 64: the port's ``Evaluator`` (torch, ``torch.roll``) must give the JAX
``Evaluator``'s Montgomery words, word for word (through
``limbs.from_jax_limbs``: 16-bit limbs against 32-bit words, the same R).
"""
import numpy as np
import pytest
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.zk.plonk import expressions as jex
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.zk.plonk import expressions as ex

torch.set_num_threads(1)

N = 64


def columns(rng, count: int, p: int) -> list:
    return [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(N)]
            for _ in range(count)]


def to_jax(e, mod):
    """The same tree in the JAX package's node classes."""
    if isinstance(e, ex.Constant):
        return mod.Constant(e.value)
    if isinstance(e, ex.Fixed):
        return mod.Fixed(e.column, e.rotation)
    if isinstance(e, ex.Advice):
        return mod.Advice(e.column, e.rotation)
    if isinstance(e, ex.Instance):
        return mod.Instance(e.column, e.rotation)
    if isinstance(e, ex.Challenge):
        return mod.Challenge(e.index, e.phase)
    if isinstance(e, ex.Selector):
        return mod.Selector(e.index, e.is_simple)
    if isinstance(e, ex.Negated):
        return mod.Negated(to_jax(e.expr, mod))
    if isinstance(e, ex.Scaled):
        return mod.Scaled(to_jax(e.expr, mod), e.scale)
    return getattr(mod, type(e).__name__)(to_jax(e.left, mod), to_jax(e.right, mod))  # Sum, Product


A0, A1, F0, I0 = ex.Advice(0), ex.Advice(1), ex.Fixed(0), ex.Instance(0)
EXPRS = {
    "constant": ex.Constant(12345),
    "constant_big": ex.Constant((1 << 254) + 77),
    "fixed": F0,
    "fixed_rot_next": ex.Fixed(1, 1),
    "advice_rot_prev": ex.Advice(1, -1),
    "advice_rot_3": ex.Advice(0, 3),
    "instance": I0,
    "instance_rot_2": ex.Instance(0, -2),
    "challenge": ex.Challenge(1, 1),
    "negated": ex.Negated(A0),
    "sum": ex.Sum(A0, ex.Fixed(1, -1)),
    "product": ex.Product(A1, I0),
    "scaled": ex.Scaled(ex.Advice(0, 1), 7),
    "scaled_neg_one": ex.Scaled(A1, -1),
    "gate": ex.Product(F0, ex.Sum(ex.Product(A0, ex.Advice(1, 1)),
                                  ex.Negated(ex.Scaled(ex.Instance(0, -1), 3)))),
    "deep": ex.Sum(ex.Product(ex.Challenge(0), ex.Sum(A0, ex.Constant(1))),
                   ex.Negated(ex.Product(ex.Advice(1, 2), ex.Advice(1, -3)))),
}


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(64)
    Fr = curves.bn254_fr("cpu")
    cols = {kind: columns(rng, count, Fr.p)
            for kind, count in (("fixed", 2), ("advice", 2), ("instance", 1))}
    challenges = {0: 11, 1: int.from_bytes(rng.bytes(40), "little") % Fr.p}
    jF = jcurves.bn254_fr()
    port = ex.Evaluator(Fr, *[[Fr.encode(c) for c in cols[k]]
                              for k in ("fixed", "advice", "instance")], challenges=challenges)
    jax = jex.Evaluator(jF, *[[jF.encode(np.array(c, dtype=object)) for c in cols[k]]
                              for k in ("fixed", "advice", "instance")], challenges=challenges)
    return port, jax


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_evaluator_vs_jax(tables, name):
    port, jax = tables
    e = EXPRS[name]
    got = port.eval(e)
    want = limbs.from_jax_limbs(np.asarray(jax.eval(to_jax(e, jex))))
    assert got.shape == (8, N) and torch.equal(got, want)
    assert ex.degree(e) == jex.degree(to_jax(e, jex))


def test_rot_scale(tables):
    """rot_scale multiplies a rotation (the extended domain's blowup)."""
    port, jax = tables
    port.rot_scale = jax.rot_scale = 4
    try:
        e = ex.Sum(ex.Advice(0, 1), ex.Fixed(1, -2))
        want = limbs.from_jax_limbs(np.asarray(jax.eval(to_jax(e, jex))))
        assert torch.equal(port.eval(e), want)
    finally:
        port.rot_scale = jax.rot_scale = 1


def test_selector_raises(tables):
    """A virtual selector is compressed away at keygen; evaluating one raises."""
    with pytest.raises(TypeError):
        tables[0].eval(ex.Selector(0))
