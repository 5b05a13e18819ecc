#!/usr/bin/env python3
"""Record the JAX package's SHPlonk and GWC opening proofs as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_multiopen_fixture.py \
        [--out tests/fixtures/torch_multiopen_jax.json]

In ``tests/test_multiopen.py``'s setting: ``kzg.unsafe_setup(8,
tau=0x5EED)``, three polynomials of 8 coefficients below 2^30 drawn from a
fixed numpy seed, opened at the point sets (3, 5), (3, 5), (7,).  Runs
``tachyon_tpu``'s ``SHPlonk`` and ``GWC`` (``crypto/multiopen.py``) with the
Blake2b transcript and writes the coefficients, the commitments, the values,
each scheme's proof bytes and its verdicts on the true values and with the
first value + 1.  Integers are hex strings.  On a CPU the JAX KZG setup
compiles for a few minutes.

``tests/test_torch_multiopen.py`` holds ``tachyon_tpu_torch`` against the
file; its slow test recomputes it with ``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 8
TAU = 0x5EED
SEED = 1234
POINT_SETS = ((3, 5), (3, 5), (7,))
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_multiopen_jax.json"
# the BN254 scalar field modulus (presets.BN254_FR.p)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def inputs() -> list:
    """The coefficient lists of the three polynomials, from SEED."""
    rng = np.random.default_rng(SEED)
    return [[int(rng.integers(1, 1 << 30)) for _ in range(N)] for _ in POINT_SETS]


def values(coeffs: list, points: tuple) -> list:
    return [sum(c * pow(pt, i, R) for i, c in enumerate(coeffs)) % R for pt in points]


def _hex_point(pt):
    return None if pt is None else [hex(v) for v in pt]


def record() -> dict:
    """The JAX package's proofs and verdicts on ``inputs()`` (imports JAX)."""
    from tachyon_tpu.crypto import kzg
    from tachyon_tpu.crypto.multiopen import GWC, SHPlonk, ProverOpening, VerifierOpening
    from tachyon_tpu.crypto.transcript import TranscriptReader, TranscriptWriter
    from tachyon_tpu.fields import presets
    from tachyon_tpu.math import curves
    from tachyon_tpu.ops import mont

    params = kzg.unsafe_setup(N, tau=TAU)
    Fr = curves.bn254_fr()
    polys = inputs()
    pro, ver, cms, vals = [], [], [], []
    for coeffs, points in zip(polys, POINT_SETS):
        enc = Fr.encode(np.array(coeffs, dtype=object))
        cm = kzg.to_int_point(kzg.commit(params, mont.mont_reduce(Fr.spec, enc)))
        vs = values(coeffs, points)
        pro.append(ProverOpening(enc, points))
        ver.append(VerifierOpening(cm, points, tuple(vs)))
        cms.append(_hex_point(cm))
        vals.append([hex(v) for v in vs])
    bad = list(ver)
    bad[0] = VerifierOpening(ver[0].commitment, ver[0].points,
                             ((ver[0].values[0] + 1) % R,) + ver[0].values[1:])
    out = {"n": N, "tau": hex(TAU), "point_sets": [list(s) for s in POINT_SETS],
           "coeffs": [[hex(c) for c in cs] for cs in polys], "commitments": cms,
           "values": vals, "schemes": {}}
    for name, cls in (("shplonk", SHPlonk), ("gwc", GWC)):
        scheme = cls(params)
        w = TranscriptWriter(presets.BN254_FR, presets.BN254_FQ)
        scheme.create_opening_proof(pro, w)
        proof = bytes(w.proof)

        def reader():
            return TranscriptReader(proof, presets.BN254_FR, presets.BN254_FQ)

        out["schemes"][name] = {
            "proof": proof.hex(),
            "verified": bool(scheme.verify_opening_proof(ver, reader())),
            "tampered_verified": bool(scheme.verify_opening_proof(bad, reader())),
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    args = ap.parse_args(argv)
    doc = record()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
