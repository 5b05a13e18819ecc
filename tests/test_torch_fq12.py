"""The port's BN254 Fq6 and Fq12 towers (``curves.bn254_fq6/fq12``) against
the JAX package.

``tests/fixtures/torch_fq12_jax.json`` holds ``tachyon_tpu.math.curves``'s
``bn254_fq6()`` and ``bn254_fq12()`` outputs, jitted, on
``scripts/make_torch_fq12_fixture.py``'s ``tower_inputs`` (lane 0 zero,
lane 1 an embedded Fq element, lane 2 every coefficient p - 1): mul,
square, inv, pow_const by p and by a short exponent.  Eagerly one JAX Fq12
multiply takes about 100 s on a CPU.  Every port result must be the same
words.  The ring laws and a a^-1 = 1 are checked on the port as well; the
slow test re-records the fixture.
"""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import pytest
import torch

from tachyon_tpu.math import curves as jax_curves
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_fq12_jax.json"
TOWERS = {"fq6": curves.bn254_fq6, "fq12": curves.bn254_fq12}


@lru_cache(maxsize=None)
def maker():
    path = ROOT / "scripts" / "make_torch_fq12_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_fq12_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def jax_words(F, d: dict) -> torch.Tensor:
    """A recorded JAX element (*coeff_axes, L, n) -> the port's words."""
    return limbs.from_jax_limbs(maker().unhexed(d), axis=F.coeff_ndim - 1)


@lru_cache(maxsize=None)
def operands(name: str):
    F = TOWERS[name]("cpu")
    seed = fixture()["seed"] + list(TOWERS).index(name)
    a, b = (F.encode(x) for x in maker().tower_inputs(name, seed, fixture()["n"]))
    return F, a, b


@pytest.mark.parametrize("name", TOWERS)
def test_encode_is_the_jax_encode(name):
    F, a, _ = operands(name)
    jf = getattr(jax_curves, f"bn254_{name}")()
    seed = fixture()["seed"] + list(TOWERS).index(name)
    ja, _ = (jf.encode(x) for x in maker().tower_inputs(name, seed, fixture()["n"]))
    assert torch.equal(a, limbs.from_jax_limbs(maker().unhexed(maker().hexed(ja)),
                                               axis=F.coeff_ndim - 1))
    assert F.coeff_ndim == {"fq6": 3, "fq12": 4}[name]


@pytest.mark.parametrize("name", TOWERS)
@pytest.mark.parametrize("op", ["mul", "square", "inv", "pow_p", "pow_short"])
def test_words_vs_jax(name, op):
    F, a, b = operands(name)
    fx = fixture()
    got = {"mul": lambda: F.mul(a, b), "square": lambda: F.square(a),
           "inv": lambda: F.inv(a), "pow_p": lambda: F.pow_const(a, F.p),
           "pow_short": lambda: F.pow_const(b, fx["short_exp"])}[op]()
    assert torch.equal(got, jax_words(F, fx[name][op]))


@pytest.mark.parametrize("name", TOWERS)
def test_ring_laws(name):
    F, a, b = operands(name)
    n = a.shape[-1]
    lhs = F.square(F.add(a, b))
    rhs = F.add(F.add(F.square(a), F.double(F.mul(a, b))), F.square(b))
    assert bool(F.eq(lhs, rhs).all())
    prod = F.mul(a, F.inv(a))
    nz = ~F.is_zero(a)
    assert not bool(nz[0]) and bool(nz[1:].all())
    assert bool(F.eq(prod, F.ones((n,)))[nz].all()) and bool(F.is_zero(prod)[0])
    # the Frobenius map fixes the embedded Fq element of lane 1
    frob = F.pow_const(a, F.p)
    assert torch.equal(frob[..., 1], a[..., 1])


def test_constructors_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for make in TOWERS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.slow
def test_fixture_recomputed_from_jax():
    """The JAX package, run again, gives the committed fixture (many minutes)."""
    assert maker().record() == fixture()
