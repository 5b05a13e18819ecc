#!/usr/bin/env python3
"""Record the JAX package's BabyBear uni-STARK proof at n = 8 as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_stark_fixture.py \
        [--out tests/fixtures/torch_stark_jax.json]

Proves the Fibonacci AIR of ``tests/test_air_stark.py`` on ``fib_trace(8)``
with ``tachyon_tpu``'s ``UniStark`` over ``TwoAdicFRIPCS(baby_bear,
baby_bear4, baby_bear_p3_w16, FRIConfig(1, 4, 2))`` and a rate-4
``DuplexChallenger``, and writes every field of the proof as canonical
integers (``proof_dict``): both roots, the opened values, the FRI commit
phase's roots, final value and proof-of-work witness, and each query's
Merkle openings and fold siblings.  On a CPU the JAX scans compile for
tens of minutes.

``tests/test_torch_stark.py`` holds ``tachyon_tpu_torch`` against the
file with the same ``proof_dict``; its slow test recomputes the file with
``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 8
CONFIG = (1, 4, 2)  # log_blowup, num_queries, proof_of_work_bits
RATE = 4  # the challenger's rate
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_stark_jax.json"


def fib_trace(n: int):
    """The (n, 2) Fibonacci trace from (0, 1) and its public values
    (first a, first b, last b)."""
    rows, (a, b) = [], (0, 1)
    for _ in range(n):
        rows.append((a, b))
        a, b = b, a + b
    return np.array(rows, dtype=object), [0, 1, rows[-1][1]]


def fib_air(ax):
    """The Fibonacci AIR over an ``expressions`` module (either package's)."""
    air = ax.AirBuilder(width=2, num_public=3)
    a, b = air.local(0), air.local(1)
    an, bn = air.next(0), air.next(1)
    air.assert_zero_first(ax.Sum(a, ax.Negated(ax.Pub(0))))
    air.assert_zero_first(ax.Sum(b, ax.Negated(ax.Pub(1))))
    air.assert_zero_transition(ax.Sum(an, ax.Negated(b)))
    air.assert_zero_transition(ax.Sum(bn, ax.Negated(ax.Sum(a, b))))
    air.assert_zero_last(ax.Sum(b, ax.Negated(ax.Pub(2))))
    return air


def proof_dict(proof, base, ext) -> dict:
    """A STARK proof as canonical integers.  ``base(a)``: a base-field
    array (word or limb axis first) -> its values, flat; ``ext(a)``: an
    extension array -> D such lists, one a coefficient."""
    def ext_rows(a):  # (D, ., C) -> C values of D coefficients
        return [list(c) for c in zip(*ext(a))]

    def ext_one(a):  # (D, .) -> D coefficients
        return [c[0] for c in ext(a)]

    fri = proof.fri
    return {
        "n": int(proof.n),
        "trace_root": base(proof.trace_root),
        "quotient_root": base(proof.quotient_root),
        "opened_values": [[[ext_rows(v) for v in m] for m in r] for r in proof.opened_values],
        "commit_phase_commits": [base(c) for c in fri.commit_phase_commits],
        "final_eval": ext_one(fri.final_eval),
        "pow_witness": int(fri.pow_witness),
        "query_proofs": [{
            "input_proof": [{"opened_values": [base(v) for v in b.opened_values],
                             "opening_proof": [base(d) for d in b.opening_proof]}
                            for b in q.input_proof],
            "commit_phase_openings": [{"sibling_value": ext_one(s.sibling_value),
                                       "opening_proof": [base(d) for d in s.opening_proof]}
                                      for s in q.commit_phase_openings],
        } for q in fri.query_proofs],
    }


def record() -> dict:
    """The JAX package's proof (imports JAX)."""
    from tachyon_tpu.crypto import poseidon2
    from tachyon_tpu.crypto.challenger import DuplexChallenger
    from tachyon_tpu.crypto.fri import FRIConfig, TwoAdicFRIPCS
    from tachyon_tpu.fields import extensions, presets
    from tachyon_tpu.math.field import PrimeField
    from tachyon_tpu.zk.air import expressions as ax
    from tachyon_tpu.zk.air.stark import UniStark

    F = PrimeField(presets.BABY_BEAR)
    pcs = TwoAdicFRIPCS(F, extensions.baby_bear4(), poseidon2.baby_bear_p3_w16(),
                        FRIConfig(*CONFIG))
    stark = UniStark(pcs, fib_air(ax))
    trace, pubs = fib_trace(N)
    proof = stark.prove(trace, pubs, DuplexChallenger(poseidon2.baby_bear_p3_w16(), rate=RATE))

    def base(a):
        return [int(v) for v in np.atleast_1d(F.decode(np.asarray(a))).reshape(-1)]

    def ext(a):
        a = np.asarray(a)
        return [base(a[d]) for d in range(a.shape[0])]

    return {"config": list(CONFIG), "rate": RATE, "public": [int(v) for v in pubs],
            "proof": proof_dict(proof, base, ext)}


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
