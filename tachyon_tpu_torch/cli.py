"""Prover command line of the port: the ``prove`` and ``prove-halo2``
subcommands of ``tachyon_tpu/cli.py``.

``prove`` takes the reference's vendors/circom/prover_main.cc flags (zkey,
wtns, proof, public, --curve, --no_zk, --verify, -n/--num_runs,
--trace_path) and writes snarkjs-compatible proof.json and public.json;
``--trace-path`` writes a ``base/profiler.py`` chrome trace with the
``groth16_prove`` and ``groth16_verify`` spans.  ``prove-halo2`` proves a
JSON circuit (the schema of ``c/api.h``'s ``tachyon_tpu_halo2_bn254_prove``)
through ``c/bridge.py`` and writes the hex proof; the proof is verified
before it is written.

    python -m tachyon_tpu_torch.cli prove circuit.zkey circuit.wtns \
        --proof proof.json --public public.json --verify
    python -m tachyon_tpu_torch.cli prove-halo2 circuit.json --proof proof.hex

Both run on the card; ``--device cpu`` runs the plain PyTorch path.  A
failed verification exits 1 (``prove``) or raises (``prove-halo2``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch


def _json_g1(pt) -> list:
    if pt is None:
        return ["0", "1", "0"]
    return [str(pt[0]), str(pt[1]), "1"]


def _json_g2(pt) -> list:
    if pt is None:
        return [["0", "0"], ["1", "0"], ["0", "0"]]
    (x0, x1), (y0, y1) = pt
    return [[str(x0), str(x1)], [str(y0), str(y1)], ["1", "0"]]


def proof_json(proof) -> dict:
    """A proof tuple as snarkjs's proof.json."""
    return {
        "pi_a": _json_g1(proof.a),
        "pi_b": _json_g2(proof.b),
        "pi_c": _json_g1(proof.c),
        "protocol": "groth16",
        "curve": "bn128",
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_prove(args) -> int:
    from tachyon_tpu_torch.base import profiler
    from tachyon_tpu_torch.io.zkey import parse_wtns, parse_zkey
    from tachyon_tpu_torch.zk.groth16.prover import CircomGroth16Prover, public_inputs

    device = torch.device(args.device)
    prof = None
    if args.trace_path:
        prof = profiler.Profiler(args.trace_path, device)
        prof.start()

    def timed(label):
        @contextlib.contextmanager
        def span():
            t0 = time.perf_counter()
            yield
            _sync(device)
            print(f"{label}: {time.perf_counter() - t0:.3f}s", file=sys.stderr)
        return span()

    with timed("parse zkey"):
        zkey = parse_zkey(args.zkey, device)
    with timed("parse wtns"):
        _, wtns = parse_wtns(args.wtns)
    prover = CircomGroth16Prover(zkey, device)
    proof = None
    for i in range(args.num_runs):
        with timed(f"prove[{i}]"), profiler.trace_event(
                profiler.CATEGORY_PROOF_GENERATION, "groth16_prove"):
            # prove() samples fresh CSPRNG r/s unless deterministic
            proof = prover.prove(wtns, deterministic=args.no_zk)

    pub = public_inputs(zkey, wtns)
    if args.verify:
        t0 = time.perf_counter()
        with profiler.trace_event(profiler.CATEGORY_PROOF_VERIFICATION, "groth16_verify"):
            ok = prover.verify(proof, pub)
        print(f"verify: {time.perf_counter() - t0:.3f}s -> {ok}", file=sys.stderr)
        if not ok:
            print("PROOF VERIFICATION FAILED", file=sys.stderr)
            return 1

    with open(args.proof, "w") as f:
        json.dump(proof_json(proof), f, indent=1)
    with open(args.public, "w") as f:
        json.dump([str(v) for v in pub], f, indent=1)
    if prof:
        prof.stop()
        print(f"trace written to {args.trace_path}", file=sys.stderr)
    print(f"proof -> {args.proof}, public -> {args.public}", file=sys.stderr)
    return 0


def cmd_prove_halo2(args) -> int:
    from tachyon_tpu_torch.c import bridge

    bridge.init(args.device)
    with open(args.circuit) as f:
        hexproof = bridge.halo2_prove(f.read())
    with open(args.proof, "w") as f:
        f.write(hexproof + "\n")
    print(f"proof: {args.proof} ({len(hexproof) // 2} bytes, verified)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tachyon_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("prove", help="create a Groth16 proof from zkey+wtns")
    pp.add_argument("zkey", help="path to .zkey (circom/snarkjs)")
    pp.add_argument("wtns", help="path to .wtns witness")
    pp.add_argument("--proof", default="proof.json")
    pp.add_argument("--public", default="public.json")
    pp.add_argument("--curve", default="bn254", choices=["bn254"])
    pp.add_argument("--no-zk", action="store_true",
                    help="deterministic proof (r = s = 0), matches the "
                         "reference's --no_zk")
    pp.add_argument("--verify", action="store_true",
                    help="verify after proving (recommended)")
    pp.add_argument("-n", "--num-runs", type=int, default=1)
    pp.add_argument("--trace-path", default=None,
                    help="write a torch.profiler chrome trace (JSON) to this file "
                         "(base/profiler.py)")
    pp.add_argument("--device", default="cuda",
                    help="torch device of the prover (default: the card; cpu runs "
                         "the plain PyTorch path)")
    pp.set_defaults(fn=cmd_prove)

    hp = sub.add_parser(
        "prove-halo2",
        help="create a halo2 bit-compatible proof from a JSON circuit description "
             "(schema: tachyon_tpu_torch/c/api.h tachyon_tpu_halo2_bn254_prove)")
    hp.add_argument("circuit", help="path to the circuit JSON")
    hp.add_argument("--proof", default="halo2_proof.hex",
                    help="output file for the hex-encoded proof bytes")
    hp.add_argument("--device", default="cuda",
                    help="torch device of the prover (default: the card; cpu runs "
                         "the plain PyTorch path)")
    hp.set_defaults(fn=cmd_prove_halo2)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
