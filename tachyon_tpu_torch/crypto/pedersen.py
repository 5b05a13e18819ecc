"""Pedersen vector commitment: <g, m> + r h.

Port of ``tachyon_tpu/crypto/pedersen.py``.  The generators come from
``random_affine`` (``scalar_mul``: one ladder launch); a commitment is two
MSMs, the second over the single point h (the naive path).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math.ec import AffinePoint, SWCurve
from tachyon_tpu_torch.math.msm import msm


class PedersenParams(NamedTuple):
    generators: AffinePoint  # (W, n) coords
    h: AffinePoint           # blinding generator (batch shape ())


def setup(curve: SWCurve, n: int, rng=None) -> PedersenParams:
    """Random generators as multiples of G (dev setup), drawn as the JAX
    package draws them from the same numpy generator."""
    gens, _ = curve.random_affine(n + 1, rng)
    return PedersenParams(AffinePoint(*(t[..., :n] for t in gens)),
                          AffinePoint(*(t[..., n] for t in gens)))


def commit(curve: SWCurve, params: PedersenParams, msgs: torch.Tensor, r: int):
    """msgs: (Ws, n) plain scalar words; r: blinding scalar int."""
    acc = msm(curve, params.generators, msgs)
    h = AffinePoint(params.h.x[..., None], params.h.y[..., None], params.h.inf[None])
    rh = msm(curve, h, limbs.from_ints([r % curve.SF.p], curve.SF.W, curve.device))
    return curve.add_xyzz(acc, rh)
