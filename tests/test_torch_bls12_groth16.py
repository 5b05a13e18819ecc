"""The port's native Groth16 over BLS12-381 (``zk/groth16/r1cs.py`` with
``family="bls12_381"``) against the JAX package, on CPU.

``scripts/make_torch_bls12_groth16_fixture.py`` records the JAX flow in
``tests/fixtures/torch_groth16_bls12_381_jax.json``: the JAX generic G2
group law on a few lanes, and for the toy x * y = z circuit and a square
chain of 130 constraints over BLS12-381's Fr the params from five fixed
secrets, the proof at fixed r and s and the verdicts.  Here the port's
``setup`` must give the params point for point, ``prove`` the proof tuple
for tuple with ``MSM_HOST_THRESHOLD`` lowered to 0 (every MSM on the
port's device path: the plain twins at W = 12 on the CPU, the generic
path over Fq2 for G2), and ``verify`` the verdicts; a wrong witness's
proof fails.  The curves, Fq2 and the pairing copy are held against the
JAX package's.  The chain's proof with its MSMs on the device path is in
``test_torch_bls12_groth16_chain{,_a,_b1,_l,_h,_g2}.py``.  The slow test
re-records the fixture and requires equality.
"""
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import pairing_bls12_381 as jbls
from tachyon_tpu.zk.groth16 import r1cs as jr1cs
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import pairing_bls12_381 as bls
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ
from tachyon_tpu_torch.zk.groth16 import r1cs

from test_torch_groth16 import fixture_params, point

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_groth16_bls12_381_jax.json"
FAMILY = "bls12_381"


def maker():
    """scripts/make_torch_bls12_groth16_fixture.py as a module (its JAX
    imports are inside the recorders it calls)."""
    path = REPO / "scripts" / "make_torch_bls12_groth16_fixture.py"
    mod_spec = importlib.util.spec_from_file_location("make_torch_bls12_groth16_fixture", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


def case(fx, name):
    """(fixture entry, port circuit, public, private, secrets, r, s)."""
    build, secrets, r, s = maker().inputs(name)
    circuit, public, private = build(r1cs.R1CS)
    return fx["circuits"][name], circuit, public, private, secrets, r, s


def test_pairing_copy_vs_jax():
    """The port's pairing module is the JAX one's copy: constants, the
    pairing of the generators, bilinearity, the product check."""
    for k in ("P", "R", "BLS_X", "G1_GEN", "G2_GEN"):
        assert getattr(bls, k) == getattr(jbls, k)
    g1_2, g2_2 = bls.g1_mul(bls.G1_GEN, 2), bls.g2_mul(bls.G2_GEN, 2)
    assert bls.pairing(bls.G1_GEN, bls.G2_GEN) == jbls.pairing(jbls.G1_GEN, jbls.G2_GEN)
    assert bls.pairing(g1_2, bls.G2_GEN) == bls.pairing(bls.G1_GEN, g2_2)
    neg = (g1_2[0], bls.P - g1_2[1])
    assert bls.pairing_product_is_one([(neg, bls.G2_GEN), (bls.G1_GEN, g2_2)])
    assert not bls.pairing_product_is_one([(g1_2, bls.G2_GEN), (bls.G1_GEN, g2_2)])
    # the host G2 ops over this module's Fq2 are its own
    assert host_ec.g2_mul(bls.G2_GEN, 5, bls) == bls.g2_mul(bls.G2_GEN, 5)
    assert r1cs.g1_mul(bls.G1_GEN, 5, bls) == bls.g1_mul(bls.G1_GEN, 5)


def test_fq2_vs_jax():
    """Fq2 = Fq[u]/(u^2 + 1) over the 12-word Fq: mul, square and the
    linear ops equal the JAX ExtField's words, the inverse and the product
    the host's Fq2."""
    rng = np.random.default_rng(150)
    vals = [[int.from_bytes(rng.bytes(48), "little") % bls.P for _ in range(5)] for _ in range(4)]
    vals[0][4] = vals[1][4] = 0  # a zero coefficient
    jF, tF = jcurves.bls12_381_fq2(), curves.bls12_381_fq2("cpu")
    ja, jb = (jF.encode([np.array(v, dtype=object) for v in vals[k:k + 2]]) for k in (0, 2))
    ta, tb = (limbs.from_jax_limbs(np.asarray(t), axis=1) for t in (ja, jb))
    with jax.disable_jit():
        want = [jF.mul(ja, jb), jF.square(ja), jF.sub(ja, jb), jF.add(ja, jb)]
    got = [tF.mul(ta, tb), tF.square(ta), tF.sub(ta, tb), tF.add(ta, tb)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(limbs.to_jax_limbs(g, axis=1), np.asarray(w))
    # the inverse (a power, minutes op by op in JAX) and the product against
    # the host Fq2 of the pairing module
    xs = list(zip(*(tF.decode(tb))))
    assert [tuple(int(c) for c in v) for v in zip(*tF.decode(tF.inv(tb)))] == \
        [bls.f2_inv(tuple(int(c) for c in x)) for x in xs]
    assert [tuple(int(c) for c in v) for v in zip(*tF.decode(got[0]))] == \
        [bls.f2_mul(tuple(int(c) for c in x), tuple(int(c) for c in y))
         for x, y in zip(zip(*tF.decode(ta)), xs)]


def test_generic_g2_group_law_vs_jax(fx):
    """BLS12-381 G2's generic dbl, add and madd on the recorded lanes
    (P = Q, P = -Q, infinity) equal the JAX package's."""
    g2 = curves.bls12_381_g2("cpu")
    assert g2._kernel_ok is False and curves.bls12_381_g1("cpu")._kernel_ok is True
    want = fx["g2_group_law"]
    ps, qs, qa = maker().base.g2_lanes(FAMILY)
    F = g2.F

    def enc(vals):
        return F.encode([np.array([v[d] for v in vals], dtype=object) for d in range(2)])

    def ints(pt):
        return [[[hex(int(v)) for v in c] for c in zip(*F.decode(t))] for t in pt]

    p = PointXYZZ(*(enc([ln[k] for ln in ps]) for k in range(4)))
    q = PointXYZZ(*(enc([ln[k] for ln in qs]) for k in range(4)))
    zero = (0, 0)
    q_aff = AffinePoint(enc([zero if v is None else v[0] for v in qa]),
                        enc([zero if v is None else v[1] for v in qa]),
                        torch.tensor([v is None for v in qa]))
    assert ints(g2.dbl_xyzz(p)) == want["dbl"]
    assert ints(g2.add_xyzz(p, q)) == want["add"]
    assert ints(g2.madd_xyzz(p, q_aff)) == want["madd"]


def test_setup_equals_jax_params_mul(fx):
    """The toy circuit's setup (the chain's: ``test_torch_bls12_groth16_chain.py``)."""
    entry, circuit, _, _, secrets, _, _ = case(fx, "mul")
    assert [hex(v) for v in secrets] == entry["secrets"]
    got = r1cs.setup(circuit, FAMILY, rng=iter(secrets).__next__, device="cpu")
    assert got == fixture_params(entry, circuit)


def test_prove_equals_jax_mul(fx, monkeypatch):
    """Every MSM on the device path; the proof equals the JAX tuple,
    verifies, fails for the public input + 1 and for a wrong witness, and
    rerandomizes."""
    monkeypatch.setattr(r1cs, "MSM_HOST_THRESHOLD", 0)
    entry, circuit, public, private, _, r, s = case(fx, "mul")
    g16 = r1cs.Groth16(fixture_params(entry, circuit), device="cpu")
    assert all(p is not None for p in (g16._a_pts, g16._b1_pts, g16._b2_pts, g16._l_pts,
                                       g16._h_pts))
    assert g16.f is bls and g16.g1.F.W == 12
    proof = g16.prove(public, private, r=r, s=s)
    assert tuple(proof) == tuple(point(p) for p in entry["proof"])
    assert g16.verify(proof, public) is True
    assert g16.verify(proof, [public[0] + 1]) is False
    # a wrong witness (z != x y), proved with the host MSMs
    monkeypatch.setattr(r1cs, "MSM_HOST_THRESHOLD", 1024)
    bad = [private[0] + 1] + private[1:]
    assert g16.verify(g16.prove(public, bad, r=r, s=s), public) is False
    rr = g16.rerandomize(proof)
    assert rr != proof and g16.verify(rr, public) is True


@pytest.mark.parametrize("name", ["mul", "chain"])
def test_verify_verdicts(fx, name):
    """The port's host verify on the recorded proof gives the JAX verdicts."""
    entry, circuit, public, _, _, _, _ = case(fx, name)
    g16 = r1cs.Groth16(fixture_params(entry, circuit), device="cpu")
    proof = r1cs.Groth16Proof(*(point(p) for p in entry["proof"]))
    assert g16.verify(proof, public) is entry["verify"] is True
    assert g16.verify(proof, [v + 1 for v in public]) is entry["verify_public_plus_1"] is False


def test_params_from_jax_round_trip(fx):
    """The JAX package's own params over bls12_381 (its setup on the toy
    circuit, from the recorded secrets) cross over equal to the recorded
    params; an unknown family raises."""
    entry, circuit, _, _, secrets, _, _ = case(fx, "mul")
    jp = jr1cs.setup(maker().inputs("mul")[0](jr1cs.R1CS)[0], FAMILY,
                     rng=iter(secrets).__next__)
    got = r1cs.params_from_jax(jp)
    assert got == fixture_params(entry, circuit) and got.family == FAMILY
    with pytest.raises(ValueError, match="unknown curve family"):
        r1cs.params_from_jax(jp._replace(family="bls12_377"))


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed fixture (minutes)."""
    assert maker().record() == fx
