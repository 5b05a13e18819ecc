"""The port's circom Groth16 prove on the committed key of a square chain of
130 constraints (132 with the public-input constraints, domain 256, every
MSM above 128 points: the Pippenger path), at fixed r and s, on CPU: here
with its A and B1 MSMs on the device path.

The JAX package's prove of the chain (its Pippenger MSMs compiled for a
CPU) did not finish in 20 minutes on an 8-core CPU, so
``torch_circom_jax.json`` holds only its witness map; the proof is held
against host-exact ints: ``host_ec`` sums over the parsed queries (the JAX
h for the H sum) combined as the JAX prover combines them.  One MSM path
costs 10-40 s on a CPU, so each file takes some MSMs on the device path
and the others from the host sums: this one A and B1,
``test_torch_circom_chain_ch.py`` C and H, ``test_torch_circom_chain_g2.py``
the G2 sum B2; ``test_torch_circom_chain_native.py`` holds the writer's
chain key and the native prover's tuple.
"""
import json

import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.math.ec import PointXYZZ
from tachyon_tpu_torch.math.msm import MSM_NAIVE_THRESHOLD
from tachyon_tpu_torch.zk.groth16 import prover, r1cs

from test_torch_circom import FIXTURE, load

torch.set_num_threads(1)

MSMS = ("a", "b1", "b2", "c", "h")


def host_sums(pr, w: list, h: list) -> dict:
    """Each MSM of the prove as an exact host sum over the parsed queries."""
    npub1 = pr.zkey.num_public + 1

    def g1(pts, ks):
        return host_ec.msm(r1cs.host_points(pr.g1, pts), ks, 0, pairing.P)

    return {"a": g1(pr.pts_a1, w), "b1": g1(pr.pts_b1, w),
            "b2": host_ec.g2_msm(r1cs.host_points(pr.g2, pr.pts_b2), w),
            "c": g1(pr.pts_c1, w[npub1:]), "h": g1(pr.pts_h1, h)}


def reference_proof(pr, sums: dict, r: int, s: int) -> tuple:
    """The JAX prover's combination of the sums, in host ints."""
    add, mul = r1cs.g1_add, r1cs.g1_mul
    A = add(add(sums["a"], pr._alpha1), mul(pr._delta1, r))
    B = r1cs.g2_add(r1cs.g2_add(sums["b2"], pr._beta2), r1cs.g2_mul(pr._delta2, s))
    b1 = add(add(sums["b1"], pr._beta1), mul(pr._delta1, s))
    C = add(add(add(sums["c"], sums["h"]), mul(A, s)), mul(b1, r))
    return A, B, add(C, mul(pr._delta1, (-r * s) % pairing.R))


def xyzz(curve, pt):
    """One host point as a device XYZZ point."""
    if pt is None:
        return curve.infinity_xyzz(())
    return PointXYZZ(*(t[..., 0] for t in curve.to_xyzz(r1cs._dev_points(curve, [pt]))))


def chain_case():
    """The chain's prover, witness ints, public input, JAX h, r and s."""
    entry = json.loads(FIXTURE.read_text())["circuits"]["chain"]
    zk, w, pr = load("chain")
    wi = limbs.words_to_ints(w.numpy().view("uint32"))
    h = [int(v, 16) for v in entry["witness_map"]]
    return pr, w, wi, prover.public_inputs(zk, w), h, int(entry["r"], 16), int(entry["s"], 16)


def prove_chain(monkeypatch, on_device):
    """Prove the chain at fixed r and s with the MSMs named in ``on_device``
    on the device path and the others from the host sums; the proof must
    equal the host-exact tuple and verify.  Returns the prover, the proof
    and the public input."""
    pr, w, wi, public, h, r, s = chain_case()
    sums = host_sums(pr, wi, h)
    names = {id(pr.pts_a1): "a", id(pr.pts_b1): "b1", id(pr.pts_b2): "b2",
             id(pr.pts_c1): "c", id(pr.pts_h1): "h"}
    real, calls = prover.msm, []

    def hybrid(curve, pts, scalars):
        name = names[id(pts)]
        calls.append(name)
        if name in on_device:
            assert pts.inf.shape[0] > MSM_NAIVE_THRESHOLD
            return real(curve, pts, scalars)
        return xyzz(curve, sums[name])

    monkeypatch.setattr(prover, "msm", hybrid)
    proof = pr.prove(w, r=r, s=s)
    assert sorted(calls) == sorted(MSMS)
    assert tuple(proof) == reference_proof(pr, sums, r, s)
    assert pr.verify(proof, public) is True
    return pr, proof, public


def test_prove_chain_a_b1(monkeypatch):
    prove_chain(monkeypatch, ("a", "b1"))
