#!/usr/bin/env python3
"""Record the JAX package's native Groth16 flow over BLS12-381 as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_bls12_groth16_fixture.py \
        [--out tests/fixtures/torch_groth16_bls12_381_jax.json]

The recorders of ``scripts/make_torch_groth16_fixture.py`` with the family
``bls12_381`` (Fq of 381 bits, 12 words; Fr of 255 bits): the JAX generic
G2 group law on the lanes of ``g2_lanes("bls12_381")``, then, for the toy
x * y = z circuit and a square chain of CHAIN_M = 130 constraints over
BLS12-381's Fr, the JAX ``setup`` from five recorded secrets, ``prove``
at fixed r and s and ``verify`` on the true public input and on that input
+ 1.  The proves of the circuits in DEVICE_MSMS run every MSM on the JAX
device path (``MSM_HOST_THRESHOLD`` 0), whose XLA:CPU compile is most of
the run.  Last, the JAX G1 ``scalar_mul`` scan on the lanes of
``ladder_lanes()`` (one-word scalars; ~90 s of compile): ``--only ladder``
records that alone into the existing file.

``tests/test_torch_bls12_groth16.py`` holds ``tachyon_tpu_torch`` against
the file; its slow test recomputes it with ``record()`` and requires
equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts import make_torch_groth16_fixture as base  # noqa: E402

FAMILY = "bls12_381"
DEVICE_MSMS = ("mul",)
FIXTURE = base.FIXTURE.parent / "torch_groth16_bls12_381_jax.json"


def inputs(name: str):
    return base.inputs(name, FAMILY)


def ladder_lanes():
    """The G1 ladder's lanes: six multiples of the generator as affine ints
    (the last lane flagged at infinity) and one-word scalars 0, 1,
    2^32 - 1 and three more from SEED."""
    from tachyon_tpu_torch.math import host_ec

    bls = base.pairing_module(FAMILY)
    rng = np.random.default_rng([base.SEED, 10])
    pts = [host_ec.scalar_mul(bls.G1_GEN, int(k), 0, bls.P) for k in rng.integers(1, 1 << 30, 6)]
    ks = [0, 1, (1 << 32) - 1] + [int.from_bytes(rng.bytes(4), "little") for _ in range(3)]
    return pts, [False] * 5 + [True], ks


def record_ladder() -> dict:
    """The JAX package's ``scalar_mul`` (an MSB-first scan of a double, a
    mixed add and a select) of bls12_381_g1 on ``ladder_lanes()``,
    compiled: the lanes and the XYZZ coordinates as Montgomery ints (imports
    JAX)."""
    import jax
    import jax.numpy as jnp

    from tachyon_tpu.math import curves
    from tachyon_tpu.math.ec import AffinePoint
    from tachyon_tpu_torch.fields import limbs

    g1 = curves.bls12_381_g1()
    pts, inf, ks = ladder_lanes()
    p = AffinePoint(*(jnp.asarray(g1.F.encode(np.array([q[k] for q in pts], dtype=object)))
                      for k in range(2)), jnp.asarray(inf))
    sc = jnp.asarray(np.array([[k & 0xFFFF for k in ks], [k >> 16 for k in ks]], dtype=np.uint32))
    out = jax.jit(g1.scalar_mul)(p, sc)
    words = [limbs.words_to_ints(limbs.from_jax_limbs(np.asarray(t)).numpy().view(np.uint32))
             for t in out]
    return {"points": [base.hex_point(q) for q in pts], "inf": inf,
            "scalars": [hex(k) for k in ks], "xyzz": [[hex(v) for v in c] for c in words]}


def record() -> dict:
    return {**base.record(FAMILY, DEVICE_MSMS), "ladder": record_ladder()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(FIXTURE))
    ap.add_argument("--only", choices=("ladder",),
                    help="record only this part into the existing --out file")
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    fx = {**json.loads(out.read_text()), "ladder": record_ladder()} if args.only else record()
    out.write_text(json.dumps(fx, indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
