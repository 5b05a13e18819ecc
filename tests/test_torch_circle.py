"""The port's M31 circle group (``math/circle.py``) against the JAX package.

``tests/fixtures/torch_math_jax.json`` holds ``tachyon_tpu.math.circle``'s
outputs on ``scripts/make_torch_math_fixture.py``'s ``circle_inputs`` (the
generator, the identity, the order-8 subgroup's generator and random
multiples of the generator, and the same batch reversed): add, double, neg,
antipode, is_on_circle, scalar_mul by 0, 1, 2^30, 2^31 - 1 and a 31-bit k
(each JAX ``scalar_mul`` compiles for ~25 s on a CPU) and
subgroup_generator(22).  The port must give the same words; its group law
is also held against host ints.  The slow test re-records the group.
"""
import importlib.util
import json
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu.math.circle import m31_circle as jax_m31_circle
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math.circle import CirclePoint, m31_circle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_math_jax.json"


@lru_cache(maxsize=None)
def maker():
    path = ROOT / "scripts" / "make_torch_math_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_math_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())["circle"]


def assert_point(pt: CirclePoint, want: dict, what: str):
    for coord in ("x", "y"):
        got = getattr(pt, coord)
        assert torch.equal(got, limbs.from_jax_limbs(maker().unhexed(want[coord]))), \
            f"{what}: {coord}"


@pytest.fixture(scope="module")
def group():
    C = m31_circle("cpu")
    pts = maker().circle_inputs()
    return C, pts, C.encode(pts), C.encode(pts[::-1])


def host_add(a, b, p):
    return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)


def test_group_ops_vs_jax(group):
    C, pts, a, b = group
    fx = fixture()
    assert_point(C.add(a, b), fx["add"], "add")
    assert_point(C.double(a), fx["double"], "double")
    assert_point(C.neg(a), fx["neg"], "neg")
    assert_point(C.antipode(a), fx["antipode"], "antipode")
    assert C.is_on_circle(a).to(torch.int64).tolist() == fx["on_circle"] == [1] * len(pts)
    assert list(C.subgroup_generator(22)) == fx["subgroup_22"]
    # the encode is the JAX encode, and the group law is the host one
    ja = jax_m31_circle().encode(pts)
    assert torch.equal(a.x, limbs.from_jax_limbs(np.asarray(ja.x)))
    xs, ys = C.decode(C.add(a, b))
    p = C.F.p
    assert [(int(x), int(y)) for x, y in zip(xs, ys)] == \
        [host_add(u, v, p) for u, v in zip(pts, pts[::-1])]


@pytest.mark.parametrize("k", maker().CIRCLE_KS)
def test_scalar_mul_vs_jax(group, k):
    C, _, a, _ = group
    assert_point(C.scalar_mul(a, k), fixture()["scalar_mul"][str(k)], f"scalar_mul {k}")


def test_subgroup_orders(group):
    """g^(2^k) is the identity for the order-2^k generator, g^(2^(k-1)) is
    not; the full group has order 2^31."""
    C = group[0]
    for log_size in (3, 10):
        g = C.encode([C.subgroup_generator(log_size)])
        one = C.identity((1,))
        full = C.scalar_mul(g, 1 << log_size)
        half = C.scalar_mul(g, 1 << (log_size - 1))
        assert torch.equal(full.x, one.x) and torch.equal(full.y, one.y)
        assert not torch.equal(half.x, one.x)
    g = C.generator((1,))
    dbl = C.double(C.scalar_mul(g, 1 << 30))
    assert torch.equal(dbl.x, C.identity((1,)).x) and torch.equal(dbl.y, C.identity((1,)).y)


def test_constructor_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m31_circle()


@pytest.mark.slow
def test_fixture_recomputed_from_jax():
    """The JAX package, run again, gives the committed group (minutes)."""
    assert maker().record(("circle",))["circle"] == fixture()
