"""The port's BN254 KZG slice at n = 8 against the JAX package, on CPU.

The JAX package's KZG path takes minutes to compile on a CPU, so its
outputs are recorded by ``scripts/make_torch_kzg_fixture.py`` into
``tests/fixtures/torch_kzg_jax.json``; the port's ``scalar_mul`` words, SRS
points, commitments, opening, verdicts and params bytes must equal them
exactly.  The slow test recomputes the fixture from the JAX package.  Also
here: Pedersen against host ints, and the port's own copies of ``spec``,
``presets`` and ``pairing_bn254`` against the JAX package's modules.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu.fields import presets as jpresets
from tachyon_tpu.math import pairing_bn254 as jpairing
from tachyon_tpu_torch.crypto import kzg, pedersen
from tachyon_tpu_torch.fields import limbs, presets, spec
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.math.ntt import Radix2Domain
from tachyon_tpu_torch.ops import mont

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "torch_kzg_jax.json"
G = (1, 2)


def maker():
    """scripts/make_torch_kzg_fixture.py as a module (its JAX imports are
    inside ``record``)."""
    path = REPO / "scripts" / "make_torch_kzg_fixture.py"
    mod_spec = importlib.util.spec_from_file_location("make_torch_kzg_fixture", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def ints(xs):
    return [int(x, 16) for x in xs]


def point(p):
    return None if p is None else tuple(int(v, 16) for v in p)


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def port(fx):
    """The port's slice on the fixture's inputs, on the CPU."""
    n, tau, z = fx["n"], int(fx["tau"], 16), int(fx["z"], 16)
    coeffs = ints(fx["coeffs"])
    g1 = curves.bn254_g1("cpu")
    Fr = g1.SF
    taus = [pow(tau, i, Fr.p) for i in range(n)]
    tau_std = limbs.from_ints(taus, Fr.W)
    raw = g1.scalar_mul(g1.generator((n,)), tau_std)
    params = kzg.unsafe_setup(n, tau, "cpu")
    cm = Fr.encode(coeffs)
    commit = kzg.to_int_point(kzg.commit(params, mont.mont_reduce(Fr.spec, cm)))
    evals = mont.mont_reduce(Fr.spec, Radix2Domain(Fr, n).fft(cm))
    commit_lagrange = kzg.to_int_point(kzg.commit_lagrange(params, evals))
    proof = kzg.open_at(params, cm, z)
    return {"g1": g1, "raw": raw, "params": params, "commit": commit,
            "commit_lagrange": commit_lagrange, "proof": proof, "coeffs": coeffs,
            "tau": tau, "z": z}


def affine_ints(g1, aff):
    xs, ys = g1.F.decode(aff.x), g1.F.decode(aff.y)
    return [None if i else (int(x), int(y)) for x, y, i in zip(xs, ys, aff.inf.tolist())]


def test_fixture_inputs_are_the_recorders(fx):
    tau, coeffs, z = maker().inputs()
    assert (int(fx["tau"], 16), ints(fx["coeffs"]), int(fx["z"], 16)) == (tau, coeffs, z)


def test_scalar_mul_words_vs_jax(fx, port):
    """The raw XYZZ words of [tau^i]G, lane by lane, as the JAX scan left them."""
    for coord, want in zip(port["raw"], fx["scalar_mul_xyzz"]):
        got = limbs.words_to_ints(coord.numpy().view(np.uint32))
        assert got == ints(want)


def test_srs_vs_jax(fx, port):
    g1, params = port["g1"], port["params"]
    assert affine_ints(g1, params.g1_powers) == [point(p) for p in fx["g1_powers"]]
    assert affine_ints(g1, params.g1_lagrange) == [point(p) for p in fx["g1_lagrange"]]
    assert params.g2_tau == tuple(tuple(ints(c)) for c in fx["g2_tau"])
    r = g1.SF.p
    assert affine_ints(g1, params.g1_powers)[3] == host_ec.scalar_mul(
        G, pow(port["tau"], 3, r), 0, g1.F.p)


def test_commits_vs_jax(fx, port):
    r, P = port["g1"].SF.p, port["g1"].F.p
    want = host_ec.scalar_mul(G, sum(c * pow(port["tau"], i, r)
                                     for i, c in enumerate(port["coeffs"])) % r, 0, P)
    assert port["commit"] == port["commit_lagrange"] == want
    assert port["commit"] == point(fx["commit"]) == point(fx["commit_lagrange"])


def test_open_verify_vs_jax(fx, port):
    proof, params = port["proof"], port["params"]
    assert proof.value == int(fx["open"]["value"], 16)
    assert proof.pi == point(fx["open"]["pi"])
    assert kzg.verify(params, port["commit"], port["z"], proof) is fx["verify"] is True
    bad = kzg.KZGProof((proof.value + 1) % port["g1"].SF.p, proof.pi)
    assert kzg.verify(params, port["commit"], port["z"], bad) is fx["verify_tampered"] is False


def test_dump_and_load_params_vs_jax(fx, port):
    blob = kzg.dump_params(port["params"])
    assert blob.hex() == fx["dump_params"]
    back = kzg.load_params(blob, "cpu")
    for got, want in ((back.g1_powers, port["params"].g1_powers),
                      (back.g1_lagrange, port["params"].g1_lagrange)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (back.g2_gen, back.g2_tau, back.n) == (kzg.G2_GEN, port["params"].g2_tau, 8)
    with pytest.raises(ValueError):
        kzg.load_params(blob[:-1], "cpu")


def test_pedersen_vs_host():
    """setup draws the JAX package's generator scalars; commit equals
    [sum m_i s_i + r s_h]G (two MSMs on the naive path)."""
    g1 = curves.bn254_g1("cpu")
    r_mod, P = g1.SF.p, g1.F.p
    params = pedersen.setup(g1, 4, np.random.default_rng(5))
    seeds = np.random.default_rng(5)
    s = [int.from_bytes(seeds.bytes(40), "little") % r_mod for _ in range(5)]
    assert affine_ints(g1, params.generators) == [host_ec.scalar_mul(G, k, 0, P) for k in s[:4]]
    msgs = [3, 0, r_mod - 1, 1 << 200]
    mw = limbs.from_ints(msgs, g1.SF.W)
    got = kzg.to_int_point(pedersen.commit(g1, params, mw, 77))
    k = (sum(m * si for m, si in zip(msgs, s)) + 77 * s[4]) % r_mod
    assert got == host_ec.scalar_mul(G, k, 0, P)


@pytest.mark.parametrize("name", [f.name for f in jpresets.ALL_FIELDS])
def test_spec_presets_copies_match_jax(name):
    """The port's FieldSpec copy derives every constant the JAX one does, and
    stays frozen and hashable (a key of the port's lru_caches)."""
    jf = next(f for f in jpresets.ALL_FIELDS if f.name == name)
    tf = next(f for f in presets.ALL_FIELDS if f.name == name)
    assert isinstance(tf, spec.FieldSpec)
    assert dataclasses.astuple(tf) == dataclasses.astuple(jf)
    for attr in ("L", "bits", "R", "R_mod_p", "R2_mod_p", "n0inv", "two_adicity", "trace",
                 "two_adic_root"):
        assert getattr(tf, attr) == getattr(jf, attr), attr
    for attr in ("p_limbs", "r_limbs", "r2_limbs", "zero_limbs"):
        np.testing.assert_array_equal(getattr(tf, attr), getattr(jf, attr))
    for k in range(min(tf.two_adicity, 5) + 1):
        assert tf.root_of_unity(1 << k) == jf.root_of_unity(1 << k)
    xs = np.array([0, 1, tf.p - 1, tf.p // 3], dtype=object)
    np.testing.assert_array_equal(tf.encode(xs), jf.encode(xs))
    assert list(tf.decode(tf.encode(xs))) == list(xs)
    assert hash(tf) == hash(dataclasses.replace(tf))
    with pytest.raises(dataclasses.FrozenInstanceError):
        tf.p = 7
    assert [f.name for f in presets.ALL_FIELDS] == [f.name for f in jpresets.ALL_FIELDS]


def test_pairing_copy_matches_jax():
    """The port's pairing module has the JAX module's constants and values,
    and is bilinear."""
    for attr in ("P", "R", "BN_X", "ATE_LOOP_COUNT", "XI", "F12_ONE", "_FROB_TWIST_X",
                 "_FROB_TWIST_Y"):
        assert getattr(pairing, attr) == getattr(jpairing, attr), attr
    g2 = kzg.G2_GEN
    e = pairing.pairing(G, g2)
    assert e == jpairing.pairing(G, g2)
    g1_3 = host_ec.scalar_mul(G, 3, 0, pairing.P)
    assert pairing.pairing(g1_3, g2) == pairing.pairing(G, host_ec.g2_mul(g2, 3))
    assert pairing.pairing_product_is_one([(g1_3, g2), (G, pairing.g2_neg(host_ec.g2_mul(g2, 3)))])


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed fixture (minutes)."""
    assert maker().record() == fx
