#!/usr/bin/env python3
"""Record the JAX package's GLV MSM and FixedBaseMSM on secp256k1 as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_glv_fixture.py \
        [--out tests/fixtures/torch_glv_jax.json]

Runs ``tachyon_tpu``'s ``msm_glv`` on N_GLV points and scalars and
``FixedBaseMSM(secp256k1, G, c=FIXED_C).run`` on N_FIXED scalars and a
zero one, all drawn from fixed numpy seeds, and writes what they return:
the GLV MSM's affine point and each FixedBaseMSM lane's raw XYZZ words (its
Montgomery integers).  Integers are hex strings.  On a CPU the JAX package
compiles for about four minutes (its ladder scan and the tree of adds).

``tests/test_torch_glv.py`` and ``tests/test_torch_fixed_msm.py`` hold
``tachyon_tpu_torch`` against the file; their slow test recomputes it with
``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_GLV = 40  # 80 half-scalar points: the naive path
N_FIXED = 16
FIXED_C = 8
GLV_SEED, FIXED_SEED = 61, 62
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_glv_jax.json"
# secp256k1 (presets.SECP256K1_FQ.p, SECP256K1_FR.p) and its generator
P = 115792089237316195423570985008687907853269984665640564039457584007908834671663
R = 115792089237316195423570985008687907852837564279074904382605163141518161494337
G = (55066263022277343669578718895168534326250603453777594175500187360389116729240,
     32670510020758816978083085130507043184471273380659243275938904335757337482424)


def glv_inputs():
    """N_GLV multipliers of G (the points) and N_GLV scalars below r, the
    first three 0, 1 and r - 1."""
    rng = np.random.default_rng(GLV_SEED)
    ks = [int(k) for k in rng.integers(1, 1 << 30, N_GLV)]
    scalars = [0, 1, R - 1] + [int.from_bytes(rng.bytes(40), "little") % R
                               for _ in range(N_GLV - 3)]
    return ks, scalars


def fixed_inputs():
    """N_FIXED scalars below r, then 0."""
    rng = np.random.default_rng(FIXED_SEED)
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(N_FIXED)] + [0]


def record() -> dict:
    """The JAX package's outputs on the inputs above (imports JAX)."""
    import jax.numpy as jnp

    from tachyon_tpu.fields.spec import int_to_limbs, limbs_to_int
    from tachyon_tpu.math import curves
    from tachyon_tpu.math.ec import AffinePoint
    from tachyon_tpu.math.fixed_msm import FixedBaseMSM
    from tachyon_tpu.math.glv import msm_glv
    from tachyon_tpu.math.msm import msm_host_reference

    curve = curves.secp256k1()
    F = curve.F
    ks, scalars = glv_inputs()
    pts = [msm_host_reference(curve, [G], [k]) for k in ks]
    aff = curve.to_affine(msm_glv(curve, AffinePoint(
        F.encode(np.array([p[0] for p in pts], dtype=object)),
        F.encode(np.array([p[1] for p in pts], dtype=object)),
        jnp.zeros(N_GLV, dtype=bool)), scalars))
    glv_point = None if bool(aff.inf) else [hex(int(F.decode(aff.x))), hex(int(F.decode(aff.y)))]

    fixed = fixed_inputs()
    sl = jnp.asarray(np.stack([int_to_limbs(k, curve.SF.spec.L) for k in fixed], -1))
    out = FixedBaseMSM(curve, G, c=FIXED_C).run(sl)
    return {
        "glv": {"n": N_GLV, "seed": GLV_SEED, "point_ks": ks,
                "scalars": [hex(s) for s in scalars], "point": glv_point},
        "fixed": {"c": FIXED_C, "seed": FIXED_SEED, "scalars": [hex(s) for s in fixed],
                  "xyzz": [[hex(limbs_to_int(np.asarray(t)[:, i])) for i in range(len(fixed))]
                           for t in out]},
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
