#!/usr/bin/env python3
"""Record the JAX package's native Groth16 flow over BN254 as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_groth16_fixture.py \
        [--out tests/fixtures/torch_groth16_jax.json]

Every recorder takes the curve family (``FAMILIES``: bn254 here, bls12_381
in ``scripts/make_torch_bls12_groth16_fixture.py``).
Runs the JAX package's generic G2 group law (``SWCurve._dbl/_add/
_madd_xyzz_jnp`` on ``bn254_g2``, eagerly: over a minute on a CPU) on the
lanes of ``g2_lanes()``, and ``tachyon_tpu``'s ``zk/groth16/r1cs.py`` (``setup`` with a fixed
``rng``, ``Groth16.prove`` at fixed r and s, ``verify``) on two circuits of
``tachyon_tpu_torch/zk/groth16/circuits.py``, built with the JAX package's
``R1CS``: the toy x * y = z circuit, and a square chain of CHAIN_M
constraints, so that every query holds more than 128 points.  It writes
the params, the proof and the verdicts on the true public input and on
that input + 1.  Integers are hex strings, a point a list of them (a G2
point two lists), infinity null.  On a CPU the JAX witness map compiles
for a few minutes.

``tests/test_torch_groth16.py`` holds ``tachyon_tpu_torch`` against the
file; its slow test recomputes the file with ``record()`` and requires
equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SEED = 2026
CHAIN_M = 130
CIRCUITS = ("mul", "chain")
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_groth16_jax.json"
# family -> (the port's pairing module, the G2 constructor of the port's
# and the JAX package's curves), by name: imported where used
FAMILIES = {
    "bn254": ("pairing_bn254", "bn254_g2"),
    "bls12_381": ("pairing_bls12_381", "bls12_381_g2"),
}


def pairing_module(family: str):
    """The port's host pairing module of the family (its R, P and Fq2)."""
    import importlib

    return importlib.import_module(f"tachyon_tpu_torch.math.{FAMILIES[family][0]}")


def inputs(name: str, family: str = "bn254"):
    """One entry of CIRCUITS: a function making its circuit and witness
    (given an R1CS class), the five setup secrets, and r and s; from SEED,
    over the family's scalar field."""
    from tachyon_tpu_torch.zk.groth16 import circuits

    R = pairing_module(family).R
    rng = np.random.default_rng([SEED, CIRCUITS.index(name)])
    secrets = [int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1 for _ in range(5)]
    r, s = (int.from_bytes(rng.bytes(40), "little") % R for _ in range(2))
    if name == "mul":
        return (lambda cls: circuits.mul_circuit(cls, r=R)), secrets, r, s
    x0 = int.from_bytes(rng.bytes(40), "little") % R
    return (lambda cls: circuits.square_chain(CHAIN_M, x0, cls, r=R)), secrets, r, s


def g2_lanes(family: str = "bn254"):
    """XYZZ lanes (P, Q) of the family's G2 as Fq2 int pairs, and Q's affine
    points: generic, P = Q, P = -Q, P = inf, Q = inf, both inf, twice with
    other projective scalings (x l^2, y l^3, l^2, l^3, l in Fq2)."""
    from tachyon_tpu_torch.math import curves, host_ec

    f2 = pairing_module(family)
    g2 = getattr(curves, FAMILIES[family][1])("cpu")
    rng = np.random.default_rng([SEED, len(CIRCUITS)])
    gen = (tuple(g2.gen_x), tuple(g2.gen_y))
    pts = [host_ec.g2_mul(gen, int(k), f2) for k in rng.integers(1, 1 << 30, 4)]

    def lift(pt):
        if pt is None:
            return ((0, 0),) * 4
        lam = (int(rng.integers(2, 1 << 62)), int(rng.integers(0, 1 << 62)))
        l2 = f2.f2_sq(lam)
        l3 = f2.f2_mul(l2, lam)
        return (f2.f2_mul(pt[0], l2), f2.f2_mul(pt[1], l3), l2, l3)

    ps, qs, qa = [], [], []
    for i in range(2):
        a, b = pts[2 * i], pts[2 * i + 1]
        neg = (a[0], f2.f2_neg(a[1]))
        for pa, qq in ((a, b), (a, a), (a, neg), (None, b), (a, None), (None, None)):
            ps.append(lift(pa))
            qs.append(lift(qq))
            qa.append(qq)
    return ps, qs, qa


def record_g2_group_law(family: str = "bn254") -> dict:
    """The JAX generic dbl, add and mixed add on ``g2_lanes()``, each
    coordinate decoded to its Fq2 int pair (imports JAX)."""
    from tachyon_tpu.math import curves
    from tachyon_tpu.math.ec import AffinePoint, PointXYZZ

    g2 = getattr(curves, FAMILIES[family][1])()
    F = g2.F
    ps, qs, qa = g2_lanes(family)

    def enc(vals):
        return F.encode([np.array([v[d] for v in vals], dtype=object) for d in range(2)])

    def xyzz(lanes):
        return PointXYZZ(*(enc([ln[k] for ln in lanes]) for k in range(4)))

    def ints(pt):
        return [[[hex(int(v)) for v in c] for c in zip(*F.decode(t))] for t in pt]

    zero = (0, 0)
    q_aff = AffinePoint(enc([zero if q is None else q[0] for q in qa]),
                        enc([zero if q is None else q[1] for q in qa]),
                        np.array([q is None for q in qa]))
    p, q = xyzz(ps), xyzz(qs)
    return {"dbl": ints(g2._dbl_xyzz_jnp(p)), "add": ints(g2._add_xyzz_jnp(p, q)),
            "madd": ints(g2._madd_xyzz_jnp(p, q_aff))}


def hex_point(pt):
    if pt is None:
        return None
    if isinstance(pt[0], (tuple, list)):
        return [[hex(v) for v in c] for c in pt]
    return [hex(v) for v in pt]


def params_json(pp) -> dict:
    out = {"n": pp.n, "family": pp.family}
    for k in ("alpha1", "beta1", "beta2", "delta1", "delta2", "gamma2"):
        out[k] = hex_point(getattr(pp, k))
    for k in ("a_query", "b1_query", "b2_query", "l_query", "h_query", "ic"):
        out[k] = [hex_point(p) for p in getattr(pp, k)]
    return out


def record(family: str = "bn254", device_msms: tuple = ()) -> dict:
    """The JAX package's outputs on ``inputs()`` (imports JAX).  The proves
    of the circuits named in ``device_msms`` run every MSM on the JAX
    device path (``MSM_HOST_THRESHOLD`` 0: on a CPU, the jnp twins of its
    Pallas kernels); the others its host path, the same points."""
    from tachyon_tpu.zk.groth16 import r1cs as jr1cs

    R = pairing_module(family).R
    host_threshold = jr1cs.MSM_HOST_THRESHOLD
    out = {"seed": SEED, "chain_m": CHAIN_M, "g2_group_law": record_g2_group_law(family),
           "circuits": {}}
    for name in CIRCUITS:
        build, secrets, r, s = inputs(name, family)
        circuit, public, private = build(jr1cs.R1CS)
        pp = jr1cs.setup(circuit, family, rng=iter(secrets).__next__)
        jr1cs.MSM_HOST_THRESHOLD = 0 if name in device_msms else host_threshold
        g16 = jr1cs.Groth16(pp)
        proof = g16.prove(public, private, r=r, s=s)
        jr1cs.MSM_HOST_THRESHOLD = host_threshold
        out["circuits"][name] = {
            "secrets": [hex(v) for v in secrets], "r": hex(r), "s": hex(s),
            "public": [hex(v) for v in public],
            "params": params_json(pp),
            "proof": [hex_point(p) for p in proof],
            "verify": g16.verify(proof, public),
            "verify_public_plus_1": g16.verify(proof, [(v + 1) % R for v in public]),
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(FIXTURE))
    out = Path(ap.parse_args().out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record(), indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
