#!/usr/bin/env python3
"""Record the JAX package's SimpleFRI proofs as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_simple_fri_fixture.py \
        [--out tests/fixtures/torch_simple_fri_jax.json]

Runs ``tachyon_tpu``'s ``SimpleFRI(baby_bear, baby_bear_p3_w16,
NUM_QUERIES).commit`` with a fresh ``DuplexChallenger(perm, 8)`` on the
evaluations of a random polynomial of degree < n/2 over the 2-adic domain
of size n, for each n of SIZES, from fixed numpy seeds, and writes the
evaluations and the proof: each layer's root, the final value, and each
query's index and openings (rows and siblings, canonical ints).  On a CPU
the JAX package compiles a Poseidon2 graph for every tree level, about two
and a half minutes for n = 16.

``tests/test_torch_simple_fri.py`` holds ``tachyon_tpu_torch`` against the
file; its slow test recomputes it with ``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

SIZES = (16, 32)
NUM_QUERIES = 4
SEED = 71
FIXTURE = (Path(__file__).resolve().parent.parent / "tests" / "fixtures"
           / "torch_simple_fri_jax.json")
P = (1 << 31) - (1 << 27) + 1  # BabyBear


def evaluations(n: int) -> list[int]:
    """p(w^i) for i < n, p of degree < n/2 with coefficients from SEED + n
    (w = BabyBear's canonical 2-adic root of order n, as the JAX package
    takes it)."""
    rng = np.random.default_rng(SEED + n)
    coeffs = [int(c) for c in rng.integers(0, P, n // 2)]
    w = pow(31, (P - 1) // n, P)  # generator 31: the order-n root of the port's spec
    return [sum(c * pow(w, i * j, P) for j, c in enumerate(coeffs)) % P for i in range(n)]


def record() -> dict:
    """The JAX package's proofs on the inputs above (imports JAX)."""
    from tachyon_tpu.crypto import poseidon2
    from tachyon_tpu.crypto.challenger import DuplexChallenger
    from tachyon_tpu.crypto.simple_fri import SimpleFRI
    from tachyon_tpu.fields import presets
    from tachyon_tpu.math.field import PrimeField

    F = PrimeField(presets.BABY_BEAR)
    h = poseidon2.baby_bear_p3_w16()

    def ints(a):
        return [int(v) for v in np.asarray(F.decode(a)).reshape(-1)]

    out = {}
    for n in SIZES:
        evals = evaluations(n)
        proof = SimpleFRI(F, h, NUM_QUERIES).commit(F.encode(np.array(evals, dtype=object)),
                                                    DuplexChallenger(h, 8))
        queries = []
        for idx, path in proof.query_paths:
            queries.append({"index": int(idx), "layers": [
                {side: {"rows": [ints(r) for r in mp.opened_rows],
                        "siblings": [ints(s) for s in mp.siblings]}
                 for side, mp in (("lo", lo), ("hi", hi))} for lo, hi in path]})
        out[str(n)] = {"evals": evals, "roots": [ints(r) for r in proof.layer_roots],
                       "final_value": int(proof.final_value), "queries": queries}
    return {"field": "baby_bear", "hasher": "baby_bear_p3_w16", "num_queries": NUM_QUERIES,
            "proofs": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    args = ap.parse_args()
    args.out.write_text(json.dumps(record(), indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
