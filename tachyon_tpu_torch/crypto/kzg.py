"""KZG polynomial commitment over BN254 G1.

Port of ``tachyon_tpu/crypto/kzg.py``.  A commitment is an MSM on the
params' device: the sweep path (K2, K3, K5, K6) above 128 points, the naive
path (the fused ``scalar_mul`` ladder, K2) at or below.  The unsafe setup
from a test tau is two ``scalar_mul``s over n lanes (one ladder launch
each) and one inverse NTT (K1); ``verify``
is the exact host pairing (``math/pairing_bn254.py``).

Where the JAX package loops over n Python ints, the port builds the words
in one vectorised step (``limbs.from_ints``).  Every function runs on
the device that holds its tensor arguments or the params.  The params'
byte format is the reference's halo2 one (``load_params``): each coordinate
is 4 little-endian u64 words in Montgomery form with R = 2^256, which is
the port's own R, so the wire words are the port's words.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec, poly
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.math.ec import AffinePoint
from tachyon_tpu_torch.math.msm import msm
from tachyon_tpu_torch.math.ntt import Radix2Domain
from tachyon_tpu_torch.ops import mont

G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


class KZGParams(NamedTuple):
    g1_powers: AffinePoint    # (W, n) coords: [tau^i]G1
    g1_lagrange: AffinePoint  # [L_i(tau)]G1 for the domain
    g2_gen: tuple             # G2 affine ints
    g2_tau: tuple             # [tau]G2
    n: int


def unsafe_setup(n: int, tau: int, device=torch.device("cuda")) -> KZGParams:
    """Powers-of-tau SRS from an explicit secret (test/dev only)."""
    g1 = curves.bn254_g1(device)
    Fr = g1.SF
    taus = [0] * n
    acc = 1
    for i in range(n):
        taus[i] = acc
        acc = acc * tau % Fr.p
    tau_std = limbs.from_ints(taus, Fr.W, device)
    pts = g1.to_affine(g1.scalar_mul(g1.generator((n,)), tau_std))

    # [L_0(tau), ..., L_{n-1}(tau)] = IFFT_n of [1, tau, tau^2, ...]
    coeff = Radix2Domain(Fr, n).ifft(mont.to_mont(Fr.spec, tau_std))
    lag_std = mont.mont_reduce(Fr.spec, coeff)
    lag = g1.to_affine(g1.scalar_mul(g1.generator((n,)), lag_std))
    return KZGParams(pts, lag, G2_GEN, host_ec.g2_mul(G2_GEN, tau), n)


def load_params(data: bytes, device=torch.device("cuda")) -> KZGParams:
    """Parse a halo2 KZG params blob (the reference's
    ``c/zk/plonk/halo2/buffer_reader.h:488-523``: u32 k; 2^k G1 powers of
    tau; 2^k Lagrange G1 points; g2; s_g2), as the JAX package does."""
    g1 = curves.bn254_g1(device)
    p = g1.F.p
    buf = memoryview(data)
    k = int.from_bytes(bytes(buf[:4]), "little")
    n = 1 << k
    if len(buf) != 4 + 2 * n * 64 + 2 * 128:
        raise ValueError(f"params blob of {len(buf)} bytes does not hold k = {k}")
    rinv = pow((1 << 256) % p, p - 2, p)

    def read(off, count):
        return [int.from_bytes(bytes(buf[o:o + 32]), "little") % p
                for o in range(off, off + 32 * count, 32)]

    def read_g1_vec(off):
        raw = read(off, 2 * n)  # x0, y0, x1, y1, ...: Montgomery words mod p
        xs, ys = raw[0::2], raw[1::2]
        inf = torch.tensor([x == 0 and y == 0 for x, y in zip(xs, ys)], device=device)
        return AffinePoint(limbs.from_ints(xs, g1.F.W, device),
                           limbs.from_ints(ys, g1.F.W, device), inf)

    def read_g2(off):
        x0, x1, y0, y1 = (v * rinv % p for v in read(off, 4))
        return ((x0, x1), (y0, y1))

    off = 4 + 2 * n * 64
    return KZGParams(read_g1_vec(4), read_g1_vec(4 + n * 64), read_g2(off),
                     read_g2(off + 128), n)


def load_params_file(path: str, device=torch.device("cuda")) -> KZGParams:
    with open(path, "rb") as f:
        return load_params(f.read(), device)


def dump_params(params: KZGParams) -> bytes:
    """Inverse of ``load_params``: the same bytes as the JAX package's."""
    p = pairing.P
    k = params.n.bit_length() - 1
    if 1 << k != params.n:
        raise ValueError(f"params of n = {params.n} points are not a power of two")
    out = bytearray(k.to_bytes(4, "little"))
    for pts in (params.g1_powers, params.g1_lagrange):
        live = (~pts.inf).to(torch.int32)[None]
        xy = torch.stack([pts.x * live, pts.y * live])  # (2, W, n), zero at infinity
        out += xy.permute(2, 0, 1).contiguous().cpu().numpy().view("<u4").tobytes()
    for (x0, x1), (y0, y1) in (params.g2_gen, params.g2_tau):
        for v in (x0, x1, y0, y1):
            out += (int(v) * (1 << 256) % p).to_bytes(32, "little")
    return bytes(out)


def commit(params: KZGParams, coeffs_std: torch.Tensor):
    """coeffs_std: (W, k <= n) plain scalar words -> XYZZ point."""
    k = coeffs_std.shape[1]
    pts = AffinePoint(params.g1_powers.x[:, :k], params.g1_powers.y[:, :k],
                      params.g1_powers.inf[:k])
    return msm(curves.bn254_g1(coeffs_std.device), pts, coeffs_std)


def commit_lagrange(params: KZGParams, evals_std: torch.Tensor):
    if evals_std.shape[1] != params.n:
        raise ValueError(f"{evals_std.shape[1]} evaluations for a domain of {params.n}")
    return msm(curves.bn254_g1(evals_std.device), params.g1_lagrange, evals_std)


def to_int_point(acc) -> tuple | None:
    g1 = curves.bn254_g1(acc.x.device)
    aff = g1.to_affine(acc)
    if bool(aff.inf):
        return None
    return (int(g1.F.decode(aff.x)), int(g1.F.decode(aff.y)))


class KZGProof(NamedTuple):
    value: int  # p(z)
    pi: tuple   # quotient commitment (G1 ints)


def open_at(params: KZGParams, coeffs_mont: torch.Tensor, z_int: int) -> KZGProof:
    """Single-point opening: pi = [(p(x) - p(z)) / (x - z)]_1."""
    Fr = curves.bn254_fr(coeffs_mont.device)
    q, rem = poly.divide_by_linear(Fr, coeffs_mont, Fr.encode(z_int))
    pi = commit(params, mont.mont_reduce(Fr.spec, q))
    return KZGProof(int(Fr.decode(rem)), to_int_point(pi))


def verify(params: KZGParams, commitment: tuple, z_int: int, proof: KZGProof) -> bool:
    """e(C - [v]G1, G2) == e(pi, [tau]G2 - [z]G2), on the host."""
    P = pairing.P
    lhs = host_ec.affine_add(
        commitment, host_ec.scalar_mul((G1_GEN[0], -G1_GEN[1] % P), proof.value, 0, P), 0, P)
    tz = host_ec.g2_add(params.g2_tau, host_ec.g2_mul(pairing.g2_neg(params.g2_gen), z_int))
    neg_pi = (proof.pi[0], -proof.pi[1] % P) if proof.pi else None
    return pairing.pairing_product_is_one([(lhs, params.g2_gen), (neg_pi, tz)])
