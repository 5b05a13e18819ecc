#!/usr/bin/env python3
"""Write a snarkjs-layout Groth16 key (.zkey) and witness (.wtns) for a
native R1CS from known secrets: test and smoke tooling for the port's
circom flow, not a feature of either package.

    python3 scripts/circom_key.py OUT_DIR [--chain M] [--seed S] [--device cpu]

writes OUT_DIR/circuit.zkey and OUT_DIR/circuit.wtns for the toy
x * y = z circuit, or with ``--chain M`` for ``square_chain(M, x_0)``
(``tachyon_tpu_torch/zk/groth16/circuits.py``), the five secrets and x_0
drawn from the seed; then

    python3 -m tachyon_tpu_torch.cli prove OUT_DIR/circuit.zkey OUT_DIR/circuit.wtns --verify

``write_zkey``/``write_wtns`` are the exact inverse of the port's
``parse_zkey``/``parse_wtns`` (and of the JAX package's): sections 1-9 of
snarkjs's layout; coordinates as Montgomery residues with R = 2^256, G2
coordinates in the order x0 x1 y0 y1, infinity as all-zero coordinates;
coefficient values stored as v R^2 mod r; matrices A (0) and B (1) only.

The key is the native ``r1cs.setup`` on the circuit with circom's
public-input constraints appended (A[m + s][s] = 1 for s = 0..num_public),
so alpha, beta, gamma, delta, IC, A1, B1, B2 and C1 are the native key's.
Only H differs: the circom prover's H MSM takes (A B - C) evaluated on the
odd points w_{2n}^{2i+1}, where the degree <= 2n - 2 product vanishes on the
even points, so H_i = [L_{2i+1}(tau) / delta] G1 with L_j the Lagrange
basis of the 2n domain (n points, against the native n - 1).
"""
from __future__ import annotations

import argparse
import struct
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tachyon_tpu_torch.fields import limbs, presets  # noqa: E402
from tachyon_tpu_torch.io import zkey as zk  # noqa: E402
from tachyon_tpu_torch.math import curves  # noqa: E402
from tachyon_tpu_torch.zk.groth16 import circuits, r1cs  # noqa: E402

Q = presets.BN254_FQ.p
R = presets.BN254_FR.p
N8 = 32
MONT = 1 << 256


def circom_r1cs(circuit: r1cs.R1CS) -> r1cs.R1CS:
    """A copy of ``circuit`` with circom's public-input constraints
    {s: 1} * {} = {} for s = 0..num_public appended."""
    out = r1cs.R1CS(num_public=circuit.num_public, num_private=circuit.num_private,
                    constraints=list(circuit.constraints))
    for s in range(circuit.num_public + 1):
        out.constrain({s: 1}, {}, {})
    return out


def h_scalars(n: int, tau: int, delta: int) -> list[int]:
    """L_{2i+1}(tau) / delta for i < n, over the 2n domain of w_{2n}."""
    omega2 = presets.BN254_FR.root_of_unity(2 * n)
    lag = r1cs._lagrange_at_tau(R, 2 * n, omega2, tau)
    dinv = pow(delta, -1, R)
    return [lag[2 * i + 1] * dinv % R for i in range(n)]


def _coords(points: list, g2: bool) -> list[int]:
    """Host points -> their coordinates in file order (x, y or x0 x1 y0 y1),
    zeros at infinity."""
    k = 4 if g2 else 2
    out = []
    for p in points:
        if p is None:
            out.extend([0] * k)
        elif g2:
            out.extend([p[0][0], p[0][1], p[1][0], p[1][1]])
        else:
            out.extend(p)
    return out


def _mont_bytes(vals: list[int], mod: int) -> bytes:
    """Ints -> little-endian Montgomery residues v R mod ``mod`` (0 stays 0)."""
    return limbs.ints_to_words([v * MONT % mod for v in vals], N8 // 4).T.tobytes()


def _g1_bytes(points: list) -> bytes:
    return _mont_bytes(_coords(points, False), Q)


def _g2_bytes(points: list) -> bytes:
    return _mont_bytes(_coords(points, True), Q)


def _file(magic: bytes, version: int, sections: list) -> bytes:
    out = [magic, struct.pack("<II", version, len(sections))]
    for sid, payload in sections:
        out += [struct.pack("<IQ", sid, len(payload)), payload]
    return b"".join(out)


def _coefficients(circuit: r1cs.R1CS) -> bytes:
    """Section 4: the count, then (matrix, constraint, signal, v R^2 mod r)
    for every A and B entry, constraint by constraint."""
    rows = [(m, i, j, c % R) for i, con in enumerate(circuit.constraints)
            for m in (0, 1) for j, c in con[m].items()]
    nc = len(rows)
    ids = np.array([row[:3] for row in rows], dtype="<u4").reshape(nc, 3)
    vals = limbs.ints_to_words([row[3] * MONT % R * MONT % R for row in rows], N8 // 4)
    entries = np.concatenate([ids.view(np.uint8).reshape(nc, 12),
                              np.ascontiguousarray(vals.T).view(np.uint8).reshape(nc, N8)],
                             axis=1)
    return struct.pack("<I", nc) + entries.tobytes()


def write_zkey(path, circuit: r1cs.R1CS, secrets: list[int],
               device=torch.device("cuda")) -> r1cs.Groth16Params:
    """Write the zkey of ``circuit`` (without its public-input constraints)
    from the secrets tau, alpha, beta, gamma, delta; returns the native
    params of the circom form (``circom_r1cs``), whose prover gives the same
    proof."""
    full = circom_r1cs(circuit)
    pp = r1cs.setup(full, "bn254", rng=iter(secrets).__next__, device=device)
    n, nv, npub = pp.n, full.num_vars, full.num_public
    tau, delta = secrets[0], secrets[4]
    h = r1cs._generator_multiples(curves.bn254_g1(device), h_scalars(n, tau, delta))
    field_bytes = (struct.pack("<I", N8) + Q.to_bytes(N8, "little")
                   + struct.pack("<I", N8) + R.to_bytes(N8, "little"))
    header = (field_bytes + struct.pack("<III", nv, npub, n)
              + _g1_bytes([pp.alpha1, pp.beta1]) + _g2_bytes([pp.beta2, pp.gamma2])
              + _g1_bytes([pp.delta1]) + _g2_bytes([pp.delta2]))
    sections = [
        (zk.S_HEADER, struct.pack("<I", 1)),
        (zk.S_HEADER_GROTH, header),
        (zk.S_IC, _g1_bytes(pp.ic)),
        (zk.S_COEFFS, _coefficients(full)),
        (zk.S_POINTS_A1, _g1_bytes(pp.a_query)),
        (zk.S_POINTS_B1, _g1_bytes(pp.b1_query)),
        (zk.S_POINTS_B2, _g2_bytes(pp.b2_query)),
        (zk.S_POINTS_C1, _g1_bytes(pp.l_query)),
        (zk.S_POINTS_H1, _g1_bytes(h)),
    ]
    Path(path).write_bytes(_file(zk.ZKEY_MAGIC, 1, sections))
    return pp


def write_wtns(path, witness: list[int]) -> None:
    """Write the full assignment (1, public..., private...) in standard form."""
    head = struct.pack("<I", N8) + R.to_bytes(N8, "little") + struct.pack("<I", len(witness))
    body = limbs.ints_to_words([v % R for v in witness], N8 // 4).T.tobytes()
    Path(path).write_bytes(_file(zk.WTNS_MAGIC, 2, [(1, head), (2, body)]))


def seeded(seed: int, count: int) -> list[int]:
    """``count`` nonzero scalars below r from ``seed``."""
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1 for _ in range(count)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--chain", type=int, default=None,
                    help="square_chain of this many constraints (default: the toy circuit)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    tau_to_delta_x0 = seeded(args.seed, 6)
    if args.chain is None:
        circuit, public, private = circuits.mul_circuit()
    else:
        circuit, public, private = circuits.square_chain(args.chain, tau_to_delta_x0[5])
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_zkey(out / "circuit.zkey", circuit, tau_to_delta_x0[:5], torch.device(args.device))
    write_wtns(out / "circuit.wtns", [1] + public + private)
    print(f"wrote {out / 'circuit.zkey'} and {out / 'circuit.wtns'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
