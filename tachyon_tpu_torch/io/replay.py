"""Dump and replay tooling for failing MSM and halo2 invocations.

Port of ``tachyon_tpu/io/replay.py`` (reference: tachyon/c/math/
elliptic_curves/msm/msm_gpu_replay.cc:19-95, which reads dumped bases and
scalars and re-runs the GPU MSM; c/zk/plonk/halo2/prover_replay.cc).

Enable dumping with TACHYON_MSM_DUMP_PATH=/some/dir (MSMs) or
TACHYON_HALO2_DUMP_PATH=/some/dir (the C ABI's halo2 proves).  Each dump is
a self-contained file; replay it on the card (``--device cpu`` for the
plain PyTorch path):

    python -m tachyon_tpu_torch.io.replay msm /some/dir/msm_000.npz
    python -m tachyon_tpu_torch.io.replay halo2 /some/dir/halo2_001.json

An MSM dump keeps the JAX package's ``.npz`` keys and layout: ``curve``
(the ``math/curves`` constructor's name), ``x`` and ``y`` as (L, n) 16-bit
Montgomery limbs in uint32, ``inf`` as (n,) bool and ``scalars`` as (L, n)
16-bit standard-form limbs (``fields/limbs.to_jax_limbs``), so a dump from
either package replays in the other.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from tachyon_tpu_torch.fields import limbs

_counter = [0]


def _next_path(env: str, stem: str, ext: str) -> str | None:
    path = os.environ.get(env)
    if not path:
        return None
    os.makedirs(path, exist_ok=True)
    fn = os.path.join(path, f"{stem}_{_counter[0]:03d}.{ext}")
    _counter[0] += 1
    return fn


def dump_msm(curve_name: str, points, scalars: torch.Tensor) -> str | None:
    """Write one MSM invocation (an AffinePoint of (W, n) Montgomery words
    and (W, n) standard scalar words) if TACHYON_MSM_DUMP_PATH is set."""
    fn = _next_path("TACHYON_MSM_DUMP_PATH", "msm", "npz")
    if fn is None:
        return None
    np.savez_compressed(
        fn,
        curve=np.array(curve_name),
        x=limbs.to_jax_limbs(points.x),
        y=limbs.to_jax_limbs(points.y),
        inf=points.inf.cpu().numpy(),
        scalars=limbs.to_jax_limbs(scalars),
    )
    return fn


def _load_msm(fn: str, device=torch.device("cuda")):
    """(curve, AffinePoint, scalar words) of a dump, on ``device``."""
    from tachyon_tpu_torch.math import curves

    data = np.load(fn)
    curve = getattr(curves, str(data["curve"]))(device)
    pts = limbs.affine_from_jax((data["x"], data["y"], data["inf"]), curve.device)
    return curve, pts, limbs.from_jax_limbs(data["scalars"], curve.device)


def replay_msm(fn: str, device=torch.device("cuda")) -> tuple | None:
    """Re-run a dumped MSM; returns (and prints) the affine result as ints,
    None at infinity."""
    from tachyon_tpu_torch.math.msm import msm

    curve, pts, scalars = _load_msm(fn, device)
    aff = curve.to_affine(msm(curve, pts, scalars))
    out = None if bool(aff.inf) else (int(curve.F.decode(aff.x)), int(curve.F.decode(aff.y)))
    print("x =", out and out[0])
    print("y =", out and out[1])
    return out


def dump_halo2(circuit_json: str) -> str | None:
    """Write one halo2 C-ABI prove invocation if TACHYON_HALO2_DUMP_PATH is
    set (the prover_replay / TACHYON_PCS_PARAMS_LOG_PATH analog)."""
    fn = _next_path("TACHYON_HALO2_DUMP_PATH", "halo2", "json")
    if fn is None:
        return None
    with open(fn, "w") as f:
        f.write(circuit_json)
    return fn


def replay_halo2(fn: str, device=torch.device("cuda")) -> str:
    """Re-run a dumped halo2 prove end to end (prove + self-verify)."""
    from tachyon_tpu_torch.c import bridge

    bridge.init(str(torch.device(device).type))
    with open(fn) as f:
        hexproof = bridge.halo2_prove(f.read())
    print(f"proof: {len(hexproof) // 2} bytes (verified)")
    print(hexproof)
    return hexproof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tachyon_tpu_torch.io.replay")
    ap.add_argument("kind", choices=["msm", "halo2"])
    ap.add_argument("dump")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the plain path)")
    args = ap.parse_args(argv)
    (replay_msm if args.kind == "msm" else replay_halo2)(args.dump, torch.device(args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
