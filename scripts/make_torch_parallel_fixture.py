#!/usr/bin/env python3
"""Record the JAX package's multi-device MSMs and NTTs as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_parallel_fixture.py \
        [--out tests/fixtures/torch_parallel_jax.json]

Runs ``tachyon_tpu.parallel`` on the 8-way virtual CPU mesh that
``tests/conftest.py`` sets up (``--xla_force_host_platform_device_count=8``,
set here before JAX loads): ``msm_sharded`` on the 8-way "dp" mesh (n = 16,
c = 4, as ``tests/test_parallel.py``), ``msm_sharded_windows`` on a 4-way
"win" mesh and ``msm_sharded_2d`` on a 2 x 4 ("dp", "win") mesh (c = 8),
``DistributedNTT`` fft and ifft over BabyBear at n = 256 and BN254 Fr at
n = 64, ``DistributedCosetLDE`` and ``fft_batch_dist`` (both directions)
over BabyBear on 8 columns.  Inputs come from fixed numpy seeds
(``msm_inputs``, ``ntt_inputs``, which the tests call too).  The MSMs are
stored as affine points (ints), the rest as the JAX uint32 16-bit limb
arrays (hex, with shapes).  The window-sharded MSMs compile for several
minutes on a CPU.

``tests/test_torch_parallel.py`` holds ``tachyon_tpu_torch.parallel`` in
gloo groups of 2 and 4 ranks against the file; its slow test recomputes it
with ``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts.make_torch_fq12_fixture import hexed, unhexed  # noqa: E402,F401

FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_parallel_jax.json"
BN254_P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47
BN254_R = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
BABY_BEAR_P = (1 << 31) - (1 << 27) + 1
MSM_SEED, NTT_SEED = 91, 92
MSM_N = 16
C_POINTS = 4  # msm_sharded's window bits (the naive path below 129 points)
C_WINDOWS = 8  # 32 windows: they split over 2 and 4 ranks
NTT_N = {"baby_bear": 256, "bn254_fr": 64}
LDE = (16, 8, 2, 31)  # rows, columns, log_blowup, shift (BabyBear's generator)


def _g1_mul(k: int):
    """k G on BN254 G1 as affine ints, double-and-add."""
    p = BN254_P

    def add(a, b):
        if a is None:
            return b
        if a[0] == b[0]:
            lam = 3 * a[0] * a[0] * pow(2 * a[1], -1, p) % p
        else:
            lam = (b[1] - a[1]) * pow(b[0] - a[0], -1, p) % p
        x = (lam * lam - a[0] - b[0]) % p
        return x, (lam * (a[0] - x) - a[1]) % p

    acc, pt = None, (1, 2)
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = add(pt, pt)
        k >>= 1
    return acc


def msm_inputs() -> tuple[list, list]:
    """MSM_N points k_i G (k_i < 2^20, affine ints) and MSM_N scalars below r,
    the first two 0 and r - 1."""
    rng = np.random.default_rng(MSM_SEED)
    pts = [_g1_mul(int(k)) for k in rng.integers(1, 1 << 20, MSM_N)]
    scalars = [0, BN254_R - 1] + [int.from_bytes(rng.bytes(40), "little") % BN254_R
                                  for _ in range(MSM_N - 2)]
    return pts, scalars


def ntt_inputs() -> dict:
    """Host ints: an NTT input for each field of NTT_N, and the LDE's and
    fft_batch's (rows, columns) BabyBear matrix."""
    rng = np.random.default_rng(NTT_SEED)
    mods = {"baby_bear": BABY_BEAR_P, "bn254_fr": BN254_R}
    out = {name: [int.from_bytes(rng.bytes(40), "little") % mods[name] for _ in range(n)]
           for name, n in NTT_N.items()}
    rows, cols = LDE[:2]
    out["matrix"] = [[int(v) for v in rng.integers(0, BABY_BEAR_P, cols)] for _ in range(rows)]
    return out


def record() -> dict:
    """The JAX package's outputs on the 8-way CPU mesh (imports JAX)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tachyon_tpu.fields import presets
    from tachyon_tpu.fields.spec import int_to_limbs
    from tachyon_tpu.math import curves
    from tachyon_tpu.math.ec import AffinePoint
    from tachyon_tpu.math.field import PrimeField
    from tachyon_tpu.parallel.mesh import data_mesh
    from tachyon_tpu.parallel.msm_sharded import msm_sharded, msm_sharded_2d, msm_sharded_windows
    from tachyon_tpu.parallel.ntt_dist import DistributedCosetLDE, DistributedNTT, fft_batch_dist

    devs = jax.devices("cpu")
    with jax.default_device(devs[0]):
        curve = curves.bn254_g1()
        F = curve.F
        pts, scalars = msm_inputs()
        points = AffinePoint(F.encode(np.array([p[0] for p in pts], dtype=object)),
                             F.encode(np.array([p[1] for p in pts], dtype=object)),
                             jnp.zeros(MSM_N, bool))
        sl = jnp.asarray(np.stack([int_to_limbs(s, curve.SF.spec.L) for s in scalars], -1))

        def affine(p):
            a = curve.to_affine(p)
            return None if bool(a.inf) else [hex(int(F.decode(a.x))), hex(int(F.decode(a.y)))]

        mesh8 = data_mesh(8, platform="cpu")
        out = {"msm_sharded": affine(msm_sharded(curve, mesh8, points, sl, c=C_POINTS))}
        print("recorded msm_sharded", flush=True)
        meshw = Mesh(np.array(devs[:4]), ("win",))
        out["msm_sharded_windows"] = affine(msm_sharded_windows(curve, meshw, points, sl,
                                                                c=C_WINDOWS))
        print("recorded msm_sharded_windows", flush=True)
        mesh2d = Mesh(np.array(devs[:8]).reshape(2, 4), ("dp", "win"))
        out["msm_sharded_2d"] = affine(msm_sharded_2d(curve, mesh2d, points, sl, c=C_WINDOWS))
        print("recorded msm_sharded_2d", flush=True)

        x = ntt_inputs()
        for name, spec in (("baby_bear", presets.BABY_BEAR), ("bn254_fr", presets.BN254_FR)):
            Fn = PrimeField(spec)
            a = Fn.encode(np.array(x[name], dtype=object))
            d = DistributedNTT(Fn, NTT_N[name], mesh8)
            y = d.fft(a)
            out[f"ntt_{name}"] = {"fft": hexed(y), "ifft": hexed(d.ifft(a))}
        B = PrimeField(presets.BABY_BEAR)
        rows, cols, log_blowup, shift = LDE
        m = B.encode(np.array(x["matrix"], dtype=object))  # (L, rows, cols)
        out["coset_lde"] = hexed(DistributedCosetLDE(B, rows, log_blowup, shift, mesh8)(m))
        out["fft_batch"] = hexed(fft_batch_dist(B, mesh8, m))
        out["ifft_batch"] = hexed(fft_batch_dist(B, mesh8, m, inverse=True))
    return out


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
