"""Concrete curve instances of the port (parameters as in
``tachyon_tpu/math/curves.py``): BN254 G1 over Fq and G2 over
Fq2 = Fq[u]/(u^2 + 1), with the tower Fq6 = Fq2[v]/(v^3 - (9 + u)) and
Fq12 = Fq6[w]/(w^2 - v) (a pairing's target group); BLS12-381 G1 over its
381-bit Fq (12 words) and G2 on the M-twist y^2 = x^3 + 4(u + 1) over its Fq2 = Fq[u]/(u^2 + 1);
secp256k1, y^2 = x^3 + 7 over a full-width 256-bit p (the point kernels'
64-bit CIOS form); Pallas and Vesta, y^2 = x^3 + 5, each the other's
scalar field (255 bits: the even/odd chains, as BN254).

Every constructor puts the field's constants on the card unless the caller
passes another device (the CPU tests pass ``"cpu"``)."""
from __future__ import annotations

import torch

from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math import pairing_bls12_381 as bls
from tachyon_tpu_torch.math.ec import SWCurve
from tachyon_tpu_torch.math.extfield import ExtField
from tachyon_tpu_torch.math.field import PrimeField


def bn254_fq(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.BN254_FQ, device)


def bn254_fr(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.BN254_FR, device)


def bn254_fq2(device=torch.device("cuda")) -> ExtField:
    # Fq2 = Fq[u]/(u^2 + 1)
    return ExtField(bn254_fq(device), 2, -1, name="bn254_fq2")


def bn254_fq6(device=torch.device("cuda")) -> ExtField:
    # Fq6 = Fq2[v]/(v^3 - (9 + u))
    return ExtField(bn254_fq2(device), 3, [9, 1], name="bn254_fq6")


def bn254_fq12(device=torch.device("cuda")) -> ExtField:
    # Fq12 = Fq6[w]/(w^2 - v): non-residue = v = (0, 1, 0) over Fq2 coeffs
    return ExtField(bn254_fq6(device), 2, [[0, 0], [1, 0], [0, 0]], name="bn254_fq12")


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


def _bn254_g2_params():
    """b2 = 3/(9+u), generator from the standard bn254 G2 spec."""
    p = presets.BN254_FQ.p
    # (9+u)^-1 = (9-u)/82
    inv82 = pow(82, -1, p)
    b0 = (27 * inv82) % p
    b1 = (-3 * inv82) % p
    gx = [
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ]
    gy = [
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ]
    return [b0, b1], gx, gy


def bn254_g2(device=torch.device("cuda")) -> SWCurve:
    b, gx, gy = _bn254_g2_params()
    return SWCurve(
        name="bn254_g2",
        field=bn254_fq2(device),
        a=[0, 0],
        b=b,
        gen_x=gx,
        gen_y=gy,
        scalar_field=bn254_fr(device),
    )


def bls12_381_fq(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.BLS12_381_FQ, device)


def bls12_381_fr(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.BLS12_381_FR, device)


def bls12_381_fq2(device=torch.device("cuda")) -> ExtField:
    # Fq2 = Fq[u]/(u^2 + 1)
    return ExtField(bls12_381_fq(device), 2, -1, name="bls12_381_fq2")


def bls12_381_g1(device=torch.device("cuda")) -> SWCurve:
    return SWCurve(
        name="bls12_381_g1",
        field=bls12_381_fq(device),
        a=0,
        b=4,
        gen_x=bls.G1_GEN[0],
        gen_y=bls.G1_GEN[1],
        scalar_field=bls12_381_fr(device),
    )


def bls12_381_g2(device=torch.device("cuda")) -> SWCurve:
    """BLS12-381 G2 on the M-twist y^2 = x^3 + 4(u + 1)."""
    return SWCurve(
        name="bls12_381_g2",
        field=bls12_381_fq2(device),
        a=[0, 0],
        b=[4, 4],
        gen_x=list(bls.G2_GEN[0]),
        gen_y=list(bls.G2_GEN[1]),
        scalar_field=bls12_381_fr(device),
    )


def secp256k1_fq(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.SECP256K1_FQ, device)


def secp256k1_fr(device=torch.device("cuda")) -> PrimeField:
    return PrimeField(presets.SECP256K1_FR, device)


def secp256k1(device=torch.device("cuda")) -> SWCurve:
    return SWCurve(
        name="secp256k1",
        field=secp256k1_fq(device),
        a=0,
        b=7,
        gen_x=55066263022277343669578718895168534326250603453777594175500187360389116729240,
        gen_y=32670510020758816978083085130507043184471273380659243275938904335757337482424,
        scalar_field=secp256k1_fr(device),
    )


def pallas(device=torch.device("cuda")) -> SWCurve:
    # gen = (-1, 2): (-1)^3 + 5 = 4 = 2^2
    return SWCurve(
        name="pallas",
        field=PrimeField(presets.PALLAS_FP, device),
        a=0,
        b=5,
        gen_x=presets.PALLAS_FP.p - 1,
        gen_y=2,
        scalar_field=PrimeField(presets.VESTA_FP, device),
    )


def vesta(device=torch.device("cuda")) -> SWCurve:
    return SWCurve(
        name="vesta",
        field=PrimeField(presets.VESTA_FP, device),
        a=0,
        b=5,
        gen_x=presets.VESTA_FP.p - 1,
        gen_y=2,
        scalar_field=PrimeField(presets.PALLAS_FP, device),
    )
