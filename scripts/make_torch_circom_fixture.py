#!/usr/bin/env python3
"""Record the JAX package's circom Groth16 flow over BN254 as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_circom_fixture.py \
        [--out-dir tests/fixtures] [--only NAME ...]

Writes, with ``scripts/circom_key.py`` (the port's setup on the CPU), a
zkey and a wtns for three circuits of
``tachyon_tpu_torch/zk/groth16/circuits.py``: the toy x * y = z circuit
(domain 4, its MSMs on the naive path), a square chain of CHAIN_M
constraints (domain 256, every MSM above 128 points: Pippenger) and a bit
chain of BITS_M constraints (domain 512: linear combinations of 1, 3, 5
and 254 terms, so the witness map's segment sums take eight rounds), each
with its public-input constraints, secrets, r and s from SEED.  Then runs
``tachyon_tpu``'s ``io/zkey.py`` (``parse_zkey``, ``parse_wtns(native=False)``)
and ``zk/groth16/prover.py`` on them and writes ``torch_circom_jax.json``:
a sha256 of every parsed array, the witness map's h, and, for the toy, the
proof tuples at ``deterministic=True`` and at fixed r and s with the
verdicts on the public input and on that input + 1.  The JAX prove of the
chain (its Pippenger MSMs compiled for a CPU) did not finish in 20 minutes
on an 8-core CPU, so only its witness map is recorded, and so for the bit
chain; the tests hold the port's chain proof against host-exact ints and
the native prover.  ``--only`` writes the keys of the named circuits and
records them into the existing JSON, leaving the other entries as they are.
Integers are hex strings, a point a list of them (a G2 point two lists),
infinity null.  A recording takes about 25 minutes on such a CPU: each of
the toy's two JAX proves compiles for about 8.

``tests/test_torch_zkey.py`` and ``tests/test_torch_circom*.py`` read the
files; the slow test of ``test_torch_circom.py`` records them again into a
temporary directory and requires equality.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

SEED = 2027
CHAIN_M = 130
BITS_M = 262
CIRCUITS = ("mul", "chain", "bits")
PROVED = ("mul",)  # circuits whose JAX proofs are recorded
FIXTURES = Path(__file__).resolve().parent.parent / "tests" / "fixtures"
JSON_NAME = "torch_circom_jax.json"
# the BN254 scalar field modulus (presets.BN254_FR.p)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
ZKEY_ARRAYS = ("alpha_g1", "beta_g1", "beta_g2", "gamma_g2", "delta_g1", "delta_g2", "ic",
               "points_a1", "points_b1", "points_b2", "points_c1", "points_h1",
               "coeff_matrix", "coeff_constraint", "coeff_signal", "coeff_values")


def inputs(name: str):
    """One entry of CIRCUITS: (circuit, public, private) of the port's R1CS
    (without the public-input constraints), the five setup secrets, r, s."""
    from tachyon_tpu_torch.zk.groth16 import circuits

    rng = np.random.default_rng([SEED, CIRCUITS.index(name)])
    draw = [int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1 for _ in range(8)]
    secrets, (r, s, x0) = draw[:5], draw[5:]
    if name == "mul":
        return circuits.mul_circuit(), secrets, r, s
    if name == "bits":
        return circuits.bits_chain(BITS_M, x0), secrets, r, s
    return circuits.square_chain(CHAIN_M, x0), secrets, r, s


def paths(name: str, out_dir: Path = FIXTURES) -> tuple[Path, Path]:
    return out_dir / f"torch_circom_{name}.zkey", out_dir / f"torch_circom_{name}.wtns"


def write_keys(out_dir: Path = FIXTURES, names=CIRCUITS) -> None:
    """The zkey and wtns of each circuit, from the port's writer on the CPU."""
    import circom_key

    for name in names:
        (circuit, public, private), secrets, _, _ = inputs(name)
        zpath, wpath = paths(name, out_dir)
        circom_key.write_zkey(zpath, circuit, secrets, device="cpu")
        circom_key.write_wtns(wpath, [1] + public + private)


def digest(a) -> str:
    """sha256 of an array's uint32 bytes (C order) and its shape."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return hashlib.sha256(repr(a.shape).encode() + a.tobytes()).hexdigest()


def hex_point(pt):
    if pt is None:
        return None
    if isinstance(pt[0], (tuple, list)):
        return [[hex(v) for v in c] for c in pt]
    return [hex(v) for v in pt]


def record(key_dir: Path = FIXTURES, names=CIRCUITS) -> dict:
    """The JAX package's outputs on the key files of ``names`` in
    ``key_dir`` (imports JAX)."""
    import jax.numpy as jnp

    from tachyon_tpu.fields.spec import limbs_to_int
    from tachyon_tpu.io.zkey import parse_wtns, parse_zkey
    from tachyon_tpu.ops import mont
    from tachyon_tpu.zk.groth16.prover import CircomGroth16Prover

    out = {"seed": SEED, "chain_m": CHAIN_M, "bits_m": BITS_M, "circuits": {}}
    for name in names:
        (_, public, _), secrets, r, s = inputs(name)
        zpath, wpath = paths(name, key_dir)
        zkey = parse_zkey(str(zpath))
        _, wtns = parse_wtns(str(wpath), native=False)
        pr = CircomGroth16Prover(zkey)
        h = pr.witness_map(mont.to_mont(pr.Fr.spec, jnp.asarray(wtns)))
        entry = {
            "secrets": [hex(v) for v in secrets], "r": hex(r), "s": hex(s),
            "public": [hex(v) for v in public],
            "domain_size": zkey.domain_size, "num_vars": zkey.num_vars,
            "zkey_sha256": {k: digest(getattr(zkey, k)) for k in ZKEY_ARRAYS},
            "wtns_sha256": digest(wtns),
            "witness_map": [hex(int(v)) for v in pr.Fr.decode(h)],
        }
        if name in PROVED:
            pub = [limbs_to_int(wtns[:, i + 1]) for i in range(zkey.num_public)]
            det = pr.prove(wtns, deterministic=True)
            proof = pr.prove(wtns, r=r, s=s)
            entry.update({
                "proof_deterministic": [hex_point(p) for p in det],
                "proof": [hex_point(p) for p in proof],
                "verify": pr.verify(proof, pub),
                "verify_public_plus_1": pr.verify(proof, [(v + 1) % R for v in pub]),
                "verify_deterministic": pr.verify(det, pub),
            })
        out["circuits"][name] = entry
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=str(FIXTURES))
    ap.add_argument("--only", nargs="+", choices=CIRCUITS, default=None)
    args = ap.parse_args()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = args.only or CIRCUITS
    write_keys(out, names)
    got = record(out, names)
    if args.only:
        old = json.loads((out / JSON_NAME).read_text())
        got["circuits"] = {name: got["circuits"].get(name, old["circuits"].get(name))
                           for name in CIRCUITS}
    (out / JSON_NAME).write_text(json.dumps(got, indent=1) + "\n")
    print(f"wrote {out / JSON_NAME} and the keys of {', '.join(names)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
