"""The port's snarkjs zkey/wtns parsers (``tachyon_tpu_torch/io/zkey.py``)
and the key writer (``scripts/circom_key.py``) against the JAX package's
parsers, on CPU.

The key files in ``tests/fixtures`` (``torch_circom_{mul,chain,bits}.{zkey,wtns}``)
were written by ``scripts/make_torch_circom_fixture.py`` with the writer;
``torch_circom_jax.json`` holds a sha256 of every array the JAX package
parsed from them.  Here both packages parse the same files and must agree
field by field, word for word (the port's 32-bit words repacked to the JAX
16-bit limbs), and the writer, run again on the toy circuit, must give the
same bytes and parse back to the key it was made from.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu.io import zkey as jzkey
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.io import zkey
from tachyon_tpu_torch.math import curves, host_ec

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import circom_key  # noqa: E402
import make_torch_circom_fixture as maker  # noqa: E402

torch.set_num_threads(1)

FIXTURE = REPO / "tests" / "fixtures" / maker.JSON_NAME
SCALARS = ("n8q", "n8r", "q", "r", "num_vars", "num_public", "domain_size")
INDEX_ARRAYS = ("coeff_matrix", "coeff_constraint", "coeff_signal")


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())


@pytest.mark.parametrize("name", maker.CIRCUITS)
def test_parse_zkey_equals_jax(fx, name):
    zpath, _ = maker.paths(name)
    want = jzkey.parse_zkey(str(zpath))
    got = zkey.parse_zkey(str(zpath), device="cpu")
    assert {k: maker.digest(getattr(want, k)) for k in maker.ZKEY_ARRAYS} == \
        fx["circuits"][name]["zkey_sha256"]
    for k in SCALARS:
        assert getattr(got, k) == getattr(want, k), k
    for k in maker.ZKEY_ARRAYS:
        j = getattr(want, k)
        if k in INDEX_ARRAYS:
            assert np.array_equal(getattr(got, k), j), k
            continue
        t = getattr(got, k)
        assert t.dtype == torch.int32 and t.shape[0] == j.shape[0] // 2, k
        assert np.array_equal(limbs.to_jax_limbs(t), j), k


@pytest.mark.parametrize("name", maker.CIRCUITS)
def test_parse_wtns_equals_jax(fx, name):
    _, wpath = maker.paths(name)
    jmod, jw = jzkey.parse_wtns(str(wpath), native=False)
    mod, w = zkey.parse_wtns(str(wpath))
    assert mod == jmod == presets.BN254_FR.p
    assert maker.digest(jw) == fx["circuits"][name]["wtns_sha256"]
    assert np.array_equal(limbs.to_jax_limbs(w), jw)
    assert limbs.words_to_ints(w.numpy().view(np.uint32))[0] == 1


def test_writer_round_trip(tmp_path):
    """write_zkey/write_wtns on the toy circuit give the committed bytes, and
    parse_zkey gives back the key: the native params' points, the circuit's
    coefficients (v R after the normalisation) and H_i = [L_{2i+1}(tau) /
    delta] G."""
    (circuit, public, private), secrets, _, _ = maker.inputs("mul")
    zpath, wpath = maker.paths("mul")
    pp = circom_key.write_zkey(tmp_path / "k.zkey", circuit, secrets, device="cpu")
    witness = [1] + public + private
    circom_key.write_wtns(tmp_path / "k.wtns", witness)
    assert (tmp_path / "k.zkey").read_bytes() == zpath.read_bytes()
    assert (tmp_path / "k.wtns").read_bytes() == wpath.read_bytes()

    got = zkey.parse_zkey(str(tmp_path / "k.zkey"), device="cpu")
    full = circom_key.circom_r1cs(circuit)
    assert (got.num_vars, got.num_public, got.domain_size) == (full.num_vars, 1, pp.n)
    assert len(full.constraints) == len(circuit.constraints) + 2
    Fq, Fr = curves.bn254_fq("cpu"), curves.bn254_fr("cpu")

    def g1(arr):  # (W, n, 2) -> host points
        x, y = Fq.decode(arr[:, :, 0]), Fq.decode(arr[:, :, 1])
        return [None if a == b == 0 else (int(a), int(b)) for a, b in zip(x, y)]

    def g2(arr):
        c = [Fq.decode(arr[:, :, k]) for k in range(4)]
        return [None if not any(v) else ((int(v[0]), int(v[1])), (int(v[2]), int(v[3])))
                for v in zip(*c)]

    assert g1(got.alpha_g1[:, None]) == [pp.alpha1]
    assert g1(got.beta_g1[:, None]) == [pp.beta1]
    assert g1(got.delta_g1[:, None]) == [pp.delta1]
    assert g2(got.beta_g2[:, None]) == [pp.beta2]
    assert g2(got.gamma_g2[:, None]) == [pp.gamma2]
    assert g2(got.delta_g2[:, None]) == [pp.delta2]
    assert g1(got.ic) == pp.ic
    assert g1(got.points_a1) == pp.a_query
    assert g1(got.points_b1) == pp.b1_query
    assert g2(got.points_b2) == pp.b2_query
    assert g1(got.points_c1) == pp.l_query
    G = (1, 2)
    tau, delta = secrets[0], secrets[4]
    assert g1(got.points_h1) == [host_ec.scalar_mul(G, k, 0, Fq.p)
                                 for k in circom_key.h_scalars(pp.n, tau, delta)]
    coeffs = sorted((m, i, j, c % Fr.p) for i, con in enumerate(full.constraints)
                    for m in (0, 1) for j, c in con[m].items())
    vals = Fr.decode(got.coeff_values)
    assert sorted(zip(got.coeff_matrix.tolist(), got.coeff_constraint.tolist(),
                      got.coeff_signal.tolist(), (int(v) for v in vals))) == coeffs

    mod, w = zkey.parse_wtns(str(tmp_path / "k.wtns"))
    assert limbs.words_to_ints(w.numpy().view(np.uint32)) == witness
    (tmp_path / "bad").write_bytes(b"wtnz" + (tmp_path / "k.wtns").read_bytes()[4:])
    with pytest.raises(ValueError, match="bad magic"):
        zkey.parse_wtns(str(tmp_path / "bad"))
