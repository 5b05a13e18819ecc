"""Concrete curve instances of the port (parameters as in
``tachyon_tpu/math/curves.py``).  BN254 G2 waits for the Fq2 port.

Every constructor puts the field's constants on the card unless the caller
passes another device (the CPU tests pass ``"cpu"``)."""
from __future__ import annotations

import torch

from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math.ec import SWCurve
from tachyon_tpu_torch.math.field import PrimeField


def bn254_fq(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.BN254_FQ, device)


def bn254_fr(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.BN254_FR, device)


def bn254_g1(device=torch.device("cuda")) -> SWCurve:
    return SWCurve(
        name="bn254_g1",
        field=bn254_fq(device),
        a=0,
        b=3,
        gen_x=1,
        gen_y=2,
        scalar_field=bn254_fr(device),
    )
