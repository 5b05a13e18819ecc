#!/usr/bin/env python3
"""Record the JAX package's standalone PLONK prover (``zk/plonk/prover.py``)
as a fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_plonk_fixture.py \
        [--out tests/fixtures/torch_plonk_jax.json] [--only NAME ...]

For each case of ``CASES`` (the circuits of ``tests/test_plonk.py``,
``test_plonk_lookup.py`` and ``test_plonk_blinding.py`` at n = 16: the
multiplication gate with copies to an instance column under SHPlonk and
GWC, a halo2 and a log-derivative range lookup, a shuffle, and the gate with
four blinding rows), runs the JAX ``kzg.unsafe_setup``, ``keygen``,
``PlonkProver.prove`` and ``PlonkVerifier.verify``, and writes the key's
words (each column's Montgomery values as hex integers), its commitments and
deltas, ``vk_transcript_repr``, the proof bytes and the verdict.  Integers
are hex strings.

The JAX prover draws its blinding from ``secrets.randbelow``.  In this
process only, the prover module's ``secrets`` is replaced by a generator
seeded with the case's seed, and the draws are stored, so the port's
``PlonkProver(rng=...)`` can replay them.  Nothing in the JAX package
changes.  Each case takes 20-50 minutes on a CPU (the XLA:CPU compile of
every field op and MSM shape: the JAX setup and keygen alone took 85 and
324 s): run the cases in parallel processes, each with ``--only NAME`` and
its own ``--out``, and merge the files' ``cases``.

``build_case`` makes a case's circuit over any ``ConstraintSystem`` and
expression module with the same API, so ``tests/test_torch_plonk*.py``
build the same circuit in the port and hold it against the file.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "torch_plonk_jax.json"
N = 16
T = 4  # blinding factors of the "blinding" case

# name -> (circuit, pcs, tau, seed of the blinding draws)
CASES = {
    "mul_shplonk": ("mul", "shplonk", 0xABCDE, 1),
    "mul_gwc": ("mul", "gwc", 0xABCDE, 2),
    "lookup_halo2": ("lookup_halo2", "shplonk", 0x11111, 3),
    "lookup_log_derivative": ("lookup_log_derivative", "shplonk", 0x11111, 4),
    "shuffle": ("shuffle", "shplonk", 0x33333, 5),
    "blinding": ("blinding", "shplonk", 0x77777, 6),
}


def _mul_gate(ex, qm, a, b, c):
    return ex.Product(ex.Fixed(qm.index), ex.Sum(
        ex.Product(ex.Advice(a.index), ex.Advice(b.index)), ex.Negated(ex.Advice(c.index))))


def build_case(circuit: str, ConstraintSystem, ex, n: int = N) -> dict:
    """The circuit named ``circuit`` at n rows: its constraint system, the
    fixed columns' values, and an honest witness (advice and instance
    columns), each column a list of n Python ints."""
    cs = ConstraintSystem()
    if circuit in ("mul", "blinding"):
        if circuit == "blinding":
            cs.blinding_factors = T
        qm = cs.fixed_column()
        a, b, c = cs.advice_column(), cs.advice_column(), cs.advice_column()
        inst = cs.instance_column()
        for col in ((a, b, c, inst) if circuit == "mul" else (a, c, inst)):
            cs.enable_equality(col)
        cs.create_gate("mul", [_mul_gate(ex, qm, a, b, c)])
        if circuit == "mul":
            cs.copy((c, 0), (a, 1))
        cs.copy((c, 3), (inst, 0))
        av = [2, 6, 4, 5] + [0] * (n - 4)
        bv = [3, 5, 7, 8] + [0] * (n - 4)
        cv = [x * y for x, y in zip(av, bv)]
        return {"cs": cs, "fixed": [[1] * 4 + [0] * (n - 4)], "advice": [av, bv, cv],
                "instance": [[cv[3]] + [0] * (n - 1)]}
    if circuit.startswith("lookup_"):
        cs.lookup_type = circuit[len("lookup_"):]
        table = cs.fixed_column()
        a = cs.advice_column()
        cs.lookup("range", [(ex.Advice(a.index), ex.Fixed(table.index))])
        if cs.lookup_type == "log_derivative":
            cs.chunk_lookups()  # the trackers into arguments, as halo2's keygen does
        av = [(3 * i + 1) % (n // 2) for i in range(n)]
        return {"cs": cs, "fixed": [list(range(n))], "advice": [av], "instance": []}
    if circuit == "shuffle":
        a, b = cs.advice_column(), cs.advice_column()
        cs.shuffle("perm", [(ex.Advice(a.index), ex.Advice(b.index))])
        av = [(7 * i + 5) % 97 for i in range(n)]
        bv = av[5:] + av[:5]
        return {"cs": cs, "fixed": [], "advice": [av, bv], "instance": []}
    raise ValueError(circuit)


class SeededRandbelow:
    """``randbelow(p)`` from a seeded ``random.Random``, with the draws kept."""

    def __init__(self, seed: int):
        self._r = random.Random(seed)
        self.draws: list[int] = []

    def randbelow(self, p: int) -> int:
        v = self._r.randrange(p)
        self.draws.append(v)
        return v


def _words(F, cols) -> list:
    """(L, n) Montgomery limb arrays -> per column, hex Montgomery integers."""
    import numpy as np

    from tachyon_tpu.fields.spec import limbs_to_int

    out = []
    for c in cols:
        a = np.asarray(c)
        out.append([hex(limbs_to_int(a[:, i])) for i in range(a.shape[1])])
    return out


def _hex_point(pt):
    return None if pt is None else [hex(v) for v in pt]


def record_case(name: str) -> dict:
    import numpy as np

    from tachyon_tpu.crypto import kzg
    from tachyon_tpu.math import curves
    from tachyon_tpu.zk.plonk import expressions as ex
    from tachyon_tpu.zk.plonk import prover as plonk
    from tachyon_tpu.zk.plonk.constraint_system import ConstraintSystem

    circuit, pcs, tau, seed = CASES[name]
    case = build_case(circuit, ConstraintSystem, ex)
    obj = lambda cols: [np.array(c, dtype=object) for c in cols]  # noqa: E731
    params = kzg.unsafe_setup(N, tau=tau)
    pk = plonk.keygen(params, case["cs"], N, obj(case["fixed"]))
    rng = SeededRandbelow(seed)
    saved = plonk.secrets
    plonk.secrets = rng
    try:
        proof = plonk.PlonkProver(params, pk, pcs=pcs).prove(obj(case["advice"]),
                                                            obj(case["instance"]))
    finally:
        plonk.secrets = saved
    verified = plonk.PlonkVerifier(params, pk, pcs=pcs).verify(proof, obj(case["instance"]))
    Fr = curves.bn254_fr()
    return {
        "circuit": circuit, "pcs": pcs, "n": N, "tau": hex(tau), "seed": seed,
        "key": {
            "fixed_evals": _words(Fr, pk.fixed_evals),
            "fixed_coeffs": _words(Fr, pk.fixed_coeffs),
            "sigma_evals": _words(Fr, pk.sigma_evals),
            "sigma_coeffs": _words(Fr, pk.sigma_coeffs),
            "fixed_commitments": [_hex_point(c) for c in pk.fixed_commitments],
            "sigma_commitments": [_hex_point(c) for c in pk.sigma_commitments],
            "deltas": [hex(d) for d in pk.deltas],
        },
        "vk_transcript_repr": hex(plonk.vk_transcript_repr(pk)),
        "draws": [hex(v) for v in rng.draws],
        "proof": proof.hex(),
        "verified": bool(verified),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    ap.add_argument("--only", nargs="*", choices=sorted(CASES),
                    help="re-record these cases into the existing file")
    args = ap.parse_args(argv)
    doc = (json.loads(args.out.read_text()) if args.only and args.out.exists()
           else {"n": N, "cases": {}})
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name in args.only or CASES:
        doc["cases"][name] = record_case(name)
        args.out.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"recorded {name}", flush=True)
    print(f"wrote {args.out}: {len(doc['cases'])} cases")
    return 0


if __name__ == "__main__":
    sys.exit(main())
