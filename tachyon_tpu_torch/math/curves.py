"""Concrete curve instances of the port (parameters as in
``tachyon_tpu/math/curves.py``).  BN254 G2 waits for the Fq2 port."""
from __future__ import annotations

from tachyon_tpu.fields import presets
from tachyon_tpu_torch.math.ec import SWCurve
from tachyon_tpu_torch.math.field import PrimeField


def bn254_fq(device="cpu") -> PrimeField:
    return PrimeField(presets.BN254_FQ, device)


def bn254_fr(device="cpu") -> PrimeField:
    return PrimeField(presets.BN254_FR, device)


def bn254_g1(device="cpu") -> SWCurve:
    return SWCurve(
        name="bn254_g1",
        field=bn254_fq(device),
        a=0,
        b=3,
        gen_x=1,
        gen_y=2,
        scalar_field=bn254_fr(device),
    )
