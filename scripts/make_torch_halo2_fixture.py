#!/usr/bin/env python3
"""Record the JAX package's halo2 proofs of the example circuits as a fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_halo2_fixture.py \
        [--out tests/fixtures/torch_halo2_jax.json] [--only NAME ...]

For each case of ``CASES`` (an example circuit of ``tests/circuits_halo2.py``
at k = 4 or 5, the Scroll vendor, SHPlonk or GWC, the halo2 or the
log-derivative lookup), runs ``tachyon_tpu``'s ``keygen`` and
``Halo2Prover`` on its ``HostBackend`` (exact host ints, the oracle) over
two circuits, as the reference's golden tests prove two, with the default
``RandomFieldGenerator``, and writes the pinned verifying key, the
``transcript_repr``, the proof bytes, the instance columns, the verdict of
``Halo2Verifier`` and the key as ``save_proving_key`` writes it.  Integers
are hex strings.  About half a minute of host arithmetic a case.

Each case names its circuit class and the constructor arguments of each of
its two circuits, so the port's tests and ``chip_smoke.py`` build the same
circuits from ``tachyon_tpu_torch/zk/plonk/circuits.py``.  The keys are made
from the first circuit.  ``tests/test_torch_halo2*.py`` hold
``tachyon_tpu_torch`` against the file; a slow test re-records it.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "torch_halo2_jax.json"
SHUFFLE_W, SHUFFLE_H = 2, 8  # ShuffleCircuit.W, .H


def shuffle_tables(seed: int) -> dict:
    """A W x H table of distinct values and the same rows in a seeded order."""
    rng = np.random.default_rng(seed)
    original = [[int(v) for v in rng.integers(1, 1 << 30, SHUFFLE_H)]
                for _ in range(SHUFFLE_W)]
    perm = rng.permutation(SHUFFLE_H)
    shuffled = [[col[int(r)] for r in perm] for col in original]
    return {"original": original, "shuffled": shuffled}


# name -> (circuit class, constructor kwargs of each of the two circuits, k,
# keygen kwargs)
CASES = {
    "simple_shplonk": ("SimpleCircuit", [{}, {}], 4, {}),
    "simple_gwc": ("SimpleCircuit", [{}, {}], 4, {"pcs": "gwc"}),
    "lookup_halo2": ("SimpleLookupCircuit", [{}, {}], 5, {}),
    "lookup_log_derivative": ("SimpleLookupCircuit", [{}, {}], 5,
                              {"lookup_type": "log_derivative"}),
    "fibonacci1": ("Fibonacci1Circuit", [{}, {}], 4, {}),
    "multi_lookup": ("MultiLookupCircuit", [{}, {}], 5,
                     {"lookup_type": "log_derivative"}),
    "shuffle": ("ShuffleCircuit", [shuffle_tables(1), shuffle_tables(2)], 4, {}),
}

def build(module, case: dict) -> list:
    """The case's two circuits from ``module`` (the JAX package's
    ``tests/circuits_halo2.py`` or the port's ``circuits.py``)."""
    cls = getattr(module, case["circuit"])
    return [cls(**kw) for kw in case["args"]]


def _hex_point(pt):
    return None if pt is None else [hex(v) for v in pt]


def record_case(name: str) -> dict:
    """One case on the JAX package's host path (imports the JAX package)."""
    from tests import circuits_halo2
    from tachyon_tpu.zk.plonk import halo2

    circuit, args, k, kw = CASES[name]
    case = {"circuit": circuit, "args": args, "k": k, "keygen": kw}
    circuits = build(circuits_halo2, case)
    pk = halo2.keygen(circuits[0], k=k, **kw)
    insts = [c.instance_columns() for c in circuits]
    proof = halo2.Halo2Prover(pk).create_proof(circuits, insts)
    verified = halo2.Halo2Verifier(pk).verify(proof.proof, insts)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "pk.json"
        halo2.save_proving_key(pk, str(path))
        pk_json = path.read_text()
    return {
        **case,
        "pinned_vk": pk.pinned_vk,
        "transcript_repr": hex(pk.transcript_repr),
        "fixed_commitments": [_hex_point(c) for c in pk.fixed_commitments],
        "permutation_commitments": [_hex_point(c) for c in pk.permutation_commitments],
        "instances": [[[hex(v) for v in col] for col in cols] for cols in insts],
        "proof": proof.proof.hex(),
        "verified": bool(verified),
        "proving_key": pk_json,
    }


def record(names=None) -> dict:
    return {"cases": {name: record_case(name) for name in (names or CASES)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    ap.add_argument("--only", nargs="*", choices=sorted(CASES),
                    help="re-record these cases into the existing file")
    args = ap.parse_args(argv)
    if args.only:
        doc = json.loads(args.out.read_text())
        doc["cases"].update(record(args.only)["cases"])
    else:
        doc = record()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {args.out}: {len(doc['cases'])} cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
