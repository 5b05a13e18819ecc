#!/usr/bin/env python3
"""Record the JAX package's BN254 KZG slice at n = 8 as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_kzg_fixture.py \
        [--out tests/fixtures/torch_kzg_jax.json]

Runs ``tachyon_tpu``'s ``SWCurve.scalar_mul`` and ``crypto/kzg.py``
(``unsafe_setup``, ``commit``, ``commit_lagrange``, ``open_at``,
``verify``, ``dump_params``) on inputs drawn from a fixed numpy seed, and
writes what they return: the raw XYZZ words of the setup's first
``scalar_mul`` (each lane's Montgomery integer), the SRS points, both
commitments, the opening, the verdicts and the params bytes.  Integers are
hex strings.  On a CPU the JAX scans compile for a few minutes.

``tests/test_torch_kzg.py`` holds ``tachyon_tpu_torch`` against the file;
its slow test recomputes the file with ``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 8
SEED = 2024
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_kzg_jax.json"
# the BN254 scalar field modulus (presets.BN254_FR.p)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def inputs():
    """tau, the N coefficients and the opening point z, from SEED."""
    rng = np.random.default_rng(SEED)
    tau = int.from_bytes(rng.bytes(40), "little") % R
    coeffs = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(N)]
    z = int.from_bytes(rng.bytes(40), "little") % R
    return tau, coeffs, z


def _hex_point(pt):
    return None if pt is None else [hex(v) for v in pt]


def record() -> dict:
    """The JAX package's outputs on ``inputs()`` (imports JAX)."""
    import jax.numpy as jnp

    from tachyon_tpu.crypto import kzg
    from tachyon_tpu.fields.spec import int_to_limbs, limbs_to_int
    from tachyon_tpu.math import curves
    from tachyon_tpu.math.ntt import Radix2Domain
    from tachyon_tpu.ops import mont

    tau, coeffs, z = inputs()
    g1, Fr = curves.bn254_g1(), curves.bn254_fr()
    Fq = g1.F
    taus = [pow(tau, i, R) for i in range(N)]
    sl = jnp.asarray(np.stack([int_to_limbs(t, Fr.spec.L) for t in taus], -1))
    raw = g1.scalar_mul(g1.generator((N,)), sl)
    params = kzg.unsafe_setup(N, tau)

    cm = Fr.encode(np.array(coeffs, dtype=object))
    commit = kzg.to_int_point(kzg.commit(params, mont.mont_reduce(Fr.spec, cm)))
    evals = mont.mont_reduce(Fr.spec, Radix2Domain(Fr, N).fft(cm))
    commit_lagrange = kzg.to_int_point(kzg.commit_lagrange(params, evals))
    proof = kzg.open_at(params, cm, z)
    tampered = kzg.KZGProof((proof.value + 1) % R, proof.pi)

    def points(aff):
        xs, ys = Fq.decode(aff.x), Fq.decode(aff.y)
        return [None if i else [hex(int(x)), hex(int(y))]
                for x, y, i in zip(xs, ys, np.asarray(aff.inf))]

    return {
        "n": N,
        "seed": SEED,
        "tau": hex(tau),
        "coeffs": [hex(c) for c in coeffs],
        "z": hex(z),
        "scalar_mul_xyzz": [[hex(limbs_to_int(np.asarray(t)[:, i])) for i in range(N)]
                            for t in raw],
        "g1_powers": points(params.g1_powers),
        "g1_lagrange": points(params.g1_lagrange),
        "g2_tau": [[hex(v) for v in c] for c in params.g2_tau],
        "commit": _hex_point(commit),
        "commit_lagrange": _hex_point(commit_lagrange),
        "open": {"value": hex(proof.value), "pi": _hex_point(proof.pi)},
        "verify": kzg.verify(params, commit, z, proof),
        "verify_tampered": kzg.verify(params, commit, z, tampered),
        "dump_params": kzg.dump_params(params).hex(),
    }


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
