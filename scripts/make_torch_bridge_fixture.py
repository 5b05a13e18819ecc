#!/usr/bin/env python3
"""Record the JAX package's C ABI bridge (``tachyon_tpu/c/bridge.py``) as a
fixture for the port's bridge.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_bridge_fixture.py \
        [--out tests/fixtures/torch_bridge_jax.json] [--only NAME ...]

Calls the JAX bridge's functions in this process on the CPU and writes what
each returns, as hex (bytes) or as the string itself (JSON, proof hex):

* ``msm_g1`` at n = 3 and n = 64 (``msm_inputs``: multiples of G, one
  base at infinity and one zero scalar);
* ``fft`` forward and inverse at n = 8 and 16 (``fft_inputs``);
* ``poseidon2_hash`` of 1 to 5 inputs;
* ``groth16_prove(no_zk=1, verify=1)`` on ``tests/fixtures/torch_circom_mul.{zkey,wtns}``;
* ``halo2_prove`` of ``HALO2_CIRCUITS``: the multiplication circuit of
  ``tachyon_tpu/c/test_capi.c`` (k = 4) and a log-derivative lookup (k = 5);
* ``sp1_baby_bear_fri_commit`` and ``sp1_baby_bear_fri_prove_verify`` roots
  of ``SP1_STREAMS`` (u32 matrix streams).

About 87 minutes on a CPU beside three other recorders, most of it the
XLA:CPU compile of every field op of the two SP1 ``prove_verify`` runs; the
groups before ``sp1`` take about fifteen (``--only`` re-records one group
into the existing file).
``tests/test_torch_bridge.py`` holds ``tachyon_tpu_torch/c/bridge.py``
against the file.
"""
from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FIXTURE = ROOT / "tests" / "fixtures" / "torch_bridge_jax.json"
CIRCOM = ROOT / "tests" / "fixtures" / "torch_circom_mul"
BN254_P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def _g1_mul(k: int):
    """k G on BN254 G1 as affine ints (None at infinity), double-and-add."""
    p = BN254_P

    def add(a, b):
        if a is None:
            return b
        if b is None:
            return a
        if a[0] == b[0]:
            if (a[1] + b[1]) % p == 0:
                return None
            lam = 3 * a[0] * a[0] * pow(2 * a[1], p - 2, p) % p
        else:
            lam = (b[1] - a[1]) * pow(b[0] - a[0], p - 2, p) % p
        x = (lam * lam - a[0] - b[0]) % p
        return x, (lam * (a[0] - x) - a[1]) % p

    acc, pt = None, (1, 2)
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def msm_inputs(n: int) -> tuple[bytes, bytes]:
    """n bases (x || y, 32-byte LE; the point at infinity as zeros) and n
    scalars: base i is (i + 1) G, base 1 is at infinity, scalar 2 is zero,
    the others full-width."""
    bases, scalars = b"", b""
    for i in range(n):
        pt = None if i == 1 else _g1_mul(i + 1)
        x, y = pt if pt else (0, 0)
        bases += x.to_bytes(32, "little") + y.to_bytes(32, "little")
        s = 0 if i == 2 else pow(7, 100 + 3 * i, BN254_R)
        scalars += s.to_bytes(32, "little")
    return bases, scalars


def fft_inputs(n: int) -> bytes:
    return b"".join(pow(5, 40 + i, BN254_R).to_bytes(32, "little") for i in range(n))


def poseidon2_inputs(n: int) -> bytes:
    return b"".join(pow(3, 50 + i, BN254_R).to_bytes(32, "little") for i in range(n))


MUL_CIRCUIT = {
    "k": 4, "num_advice": 2, "num_fixed": 0, "num_instance": 1,
    "equality": [["advice", 0], ["instance", 0]],
    "selectors": ["simple"],
    "gates": [[["prod", ["selector", 0],
                ["sum", ["prod", ["advice", 0, 0], ["advice", 1, 0]],
                 ["neg", ["advice", 0, 1]]]]]],
    "assignments": {"advice": [[3, 12, 0], [4, 0, 0]], "selectors": [[1]],
                    "copies": [[["advice", 0, 1], ["instance", 0, 0]]]},
    "instances": [[12]],
}
LOOKUP_CIRCUIT = {
    "k": 5, "lookup_type": "log_derivative", "pcs": "gwc",
    "num_advice": 1, "num_fixed": 1, "num_instance": 0,
    "lookups": [{"name": "range", "inputs": [["advice", 0, 0]],
                 "tables": [["fixed", 0, 0]]}],
    "assignments": {"advice": [[3, 1, 7, 0, 5, 5, 2, 6, 1]],
                    "fixed": [list(range(8))]},
    "instances": [],
}
HALO2_CIRCUITS = {"mul": MUL_CIRCUIT, "lookup_log_derivative": LOOKUP_CIRCUIT}


def sp1_stream(shapes) -> bytes:
    """The u32 LE matrix stream of ``api.h``: the count, then per matrix its
    rows, cols and row-major BabyBear values."""
    words = [len(shapes)]
    for m, (rows, cols) in enumerate(shapes):
        words += [rows, cols] + [(v * 7 + 3 + 1000 * m) % 2013265921
                                 for v in range(rows * cols)]
    return struct.pack(f"<{len(words)}I", *words)


# name -> (matrix shapes, log_blowup, num_queries, pow_bits)
SP1_STREAMS = {
    "capi_8x2": (((8, 2),), 1, 2, 1),
    "two_16x4_8x3": (((16, 4), (8, 3)), 1, 3, 2),
}


def record_group(name: str) -> dict:
    from tachyon_tpu.c import bridge

    if name == "msm_g1":
        out = {}
        for n in (3, 64):
            b, s = msm_inputs(n)
            out[str(n)] = bridge.msm_g1(b, s, n).hex()
        return out
    if name == "fft":
        return {f"{n}_{inv}": bridge.fft(fft_inputs(n), n, inv).hex()
                for n in (8, 16) for inv in (0, 1)}
    if name == "poseidon2_hash":
        return {str(n): bridge.poseidon2_hash(poseidon2_inputs(n), n).hex()
                for n in range(1, 6)}
    if name == "groth16_prove":
        proof, public = bridge.groth16_prove(f"{CIRCOM}.zkey", f"{CIRCOM}.wtns", 1, 1)
        return {"proof_json": proof, "public_json": public}
    if name == "halo2_prove":
        return {k: bridge.halo2_prove(json.dumps(c)) for k, c in HALO2_CIRCUITS.items()}
    if name == "sp1":
        out = {}
        for k, (shapes, blowup, queries, pow_bits) in SP1_STREAMS.items():
            blob = sp1_stream(shapes)
            out[k] = {
                "commit": bridge.sp1_baby_bear_fri_commit(blowup, blob).hex(),
                "prove_verify": bridge.sp1_baby_bear_fri_prove_verify(
                    blowup, queries, pow_bits, blob).hex(),
            }
        return out
    raise ValueError(name)


GROUPS = ("msm_g1", "fft", "poseidon2_hash", "groth16_prove", "halo2_prove", "sp1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    ap.add_argument("--only", nargs="*", choices=GROUPS,
                    help="re-record these groups into the existing file")
    args = ap.parse_args(argv)
    doc = json.loads(args.out.read_text()) if args.only else {}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    for name in args.only or GROUPS:
        doc[name] = record_group(name)
        args.out.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"recorded {name}", flush=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
