#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tachyon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the CUDA kernels from tachyon_tpu_torch/csrc;
3. kernels: each of K1, K2, K3, K5, K6 against its plain PyTorch twin on the
   card, bit-exact on the words, both timed with CUDA events;
4. slice: the BN254 G1 MSM at n = 2^22 (msm + to_affine) on the point set of
   bench.py (256 exact multiples of G, seed 42, tiled; 254-bit scalars),
   checked against the host-exact point, with the kernels' launch counts;
5. prints the kernels' JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", ...}} last.

Imports no JAX: the port is torch-only.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math.ec import AffinePoint
from tachyon_tpu_torch.math.msm import _blind_points, _bcast, msm, optimal_window_bits
from tachyon_tpu_torch.ops import _build, cuda_ec, cuda_mont, cuda_msm, mont

LOG_N = 22
SEED = 42
# shapes the kernels are checked at: those the 2^22 MSM gives them (c = 17)
SIZES = {
    "k1_fq": 1 << 22,       # K1 elements, BN254 Fq
    "k1_fr": 1 << 16,       # K1 elements, BN254 Fr
    "k2": (1 << 17) - 1,    # K2 lanes: the T-gather width 2^c - 1
    "k3": 4096,             # K3 lanes
    "k5": (1024, 4096, 16), # K5 (R, C) and the rows its plain twin runs
    "k6": (256, 512),       # K6 (R2, C2)
}

# name -> (wrapper carrying the launch count, source, TPU kernel it replaces)
KERNELS = {
    "mont_mul": (cuda_mont.mul, "tachyon_tpu_torch/csrc/mont_mul.cu",
                 "tachyon_tpu/ops/pallas_mont.py:90"),
    "add_xyzz": (cuda_ec.add_xyzz, "tachyon_tpu_torch/csrc/ec.cu",
                 "tachyon_tpu/ops/pallas_ec.py:209"),
    "dbl_xyzz": (cuda_ec.dbl_xyzz, "tachyon_tpu_torch/csrc/ec.cu",
                 "tachyon_tpu/ops/pallas_ec.py:232"),
    "suffix_sweep": (cuda_msm.suffix_sweep, "tachyon_tpu_torch/csrc/msm_sweeps.cu",
                     "tachyon_tpu/ops/pallas_msm.py:147"),
    "reduce_sweep": (cuda_msm.reduce_sweep, "tachyon_tpu_torch/csrc/msm_sweeps.cu",
                     "tachyon_tpu/ops/pallas_msm.py:201"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events, one warm-up)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def word_err(a, b) -> int:
    """Largest |a - b| over the uint32 words of two coordinate tuples."""
    err = 0
    for x, y in zip(a, b):
        err = max(err, int((mont.widen(x) - mont.widen(y)).abs().max()))
    return err


def random_elements(f, n: int, g: torch.Generator, device) -> torch.Tensor:
    """n canonical elements (W, n): random words below 2^(bits - 1) < p,
    with zero, one and p - 1 in the first lanes."""
    W = limbs.word_count(f)
    w = torch.randint(0, 1 << 32, (W, n), dtype=torch.int64, generator=g, device=device)
    w[-1] &= (1 << (f.bits - 1 - 32 * (W - 1))) - 1
    for k, v in enumerate((0, 1, f.p - 1)):
        w[:, k] = torch.from_numpy(limbs.int_to_words(v, W).astype(np.int64)).to(device)
    return mont.narrow(w)


def base_points(curve, rng):
    """bench.py's 256 exact multiples of G (Python ints and device words)."""
    G = (int(curve.gen_x), int(curve.gen_y))
    ks = rng.integers(1, 1 << 30, 256)
    pts = [host_ec.scalar_mul(G, int(k), 0, curve.F.p) for k in ks]
    x = curve.F.encode([p[0] for p in pts])
    y = curve.F.encode([p[1] for p in pts])
    return ks, x, y


def tile(t: torch.Tensor, n: int) -> torch.Tensor:
    reps = -(-n // t.shape[-1])
    return t.repeat(1, reps)[:, :n].contiguous()


def check(name, got, want, kernel_ms, plain_ms, shape, plain_shape, results):
    err = word_err(got, want)
    log(f"[kernel] {name}: shape {shape} max_abs_err {err} kernel {kernel_ms:.4f} ms "
        f"plain {plain_ms:.4f} ms (plain at {plain_shape})")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin (max_abs_err {err})")
    # the first (main-path) shape is the one reported for a kernel
    results.setdefault(name, {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                              "shape": shape, "plain_shape": plain_shape})


def phase_kernels(device, base_x, base_y, results):
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    curve = curves.bn254_g1(device)
    fq, fr = curve.F.spec, curve.SF.spec

    # K1 on 2^22 Fq and 2^16 Fr elements
    for f, n in ((fq, SIZES["k1_fq"]), (fr, SIZES["k1_fr"])):
        a, b = random_elements(f, n, g, device), random_elements(f, n, g, device)
        a[:, 3:6] = b[:, 3:6]  # some squares
        got = cuda_mont.mul(f, a, b)
        want = cuda_mont.mul_plain(f, a, b)
        torch.cuda.synchronize()
        check("mont_mul", (got,), (want,), cuda_ms(lambda: cuda_mont.mul(f, a, b), 20),
              cuda_ms(lambda: cuda_mont.mul_plain(f, a, b), 2), f"{f.name} (8, {n})",
              f"{f.name} (8, {n})", results)
        del want

    # K2 on the T-gather width at c = 17: 2^17 - 1 lanes, with P = Q, P = -Q
    # and infinity lanes.  P has zz != 1 (a plain doubling of affine points).
    n = SIZES["k2"]
    one = mont.ones(fq, (n,), device)
    lane = torch.arange(n, device=device)
    p = cuda_ec.dbl_xyzz_plain(fq, (tile(base_x, n), tile(base_y, n), one, one))
    q = tuple(torch.roll(t, 1, dims=1) for t in p)
    q = list(mont.select((lane % 7 == 1) | (lane % 7 == 2), pc, qc) for pc, qc in zip(p, q))
    q[1] = mont.select(lane % 7 == 2, mont.neg(fq, p[1]), q[1])
    zero = torch.zeros_like(p[0])
    p = tuple(mont.select((lane % 7 == 3) | (lane % 7 == 5), zero, t) for t in p)
    q = tuple(mont.select((lane % 7 == 4) | (lane % 7 == 5), zero, t) for t in q)
    got = cuda_ec.add_xyzz(fq, p, q)
    want = cuda_ec.add_xyzz_plain(fq, p, q)
    if not bool(mont.is_zero(fq, got[2])[lane % 7 == 2].all()):
        raise AssertionError("add_xyzz: P + (-P) is not infinity")
    check("add_xyzz", got, want, cuda_ms(lambda: cuda_ec.add_xyzz(fq, p, q), 20),
          cuda_ms(lambda: cuda_ec.add_xyzz_plain(fq, p, q), 2), f"4 x (8, {n})",
          f"4 x (8, {n})", results)

    # K3 on 4096 lanes (the Horner doublings run on one), with infinity lanes
    n3 = SIZES["k3"]
    d_in = tuple(mont.select(lane[:n3] % 5 == 0, zero[:, :n3], t[:, :n3].contiguous())
                 for t in got)
    got3 = cuda_ec.dbl_xyzz(fq, d_in)
    want3 = cuda_ec.dbl_xyzz_plain(fq, d_in)
    check("dbl_xyzz", got3, want3, cuda_ms(lambda: cuda_ec.dbl_xyzz(fq, d_in), 20),
          cuda_ms(lambda: cuda_ec.dbl_xyzz_plain(fq, d_in), 2), f"4 x (8, {n3})",
          f"4 x (8, {n3})", results)

    # K5 at R = 1024, C = 4096 (2^22 points) with infinity lanes.  The sweep
    # runs bottom-up, so rows R - r0 .. R - 1 of its output depend only on
    # those input rows: the plain twin runs on them alone.
    R, C, r0 = SIZES["k5"]
    (d1, _), (d2, _) = _blind_points(curve)
    x = tile(base_x, R * C).view(8, R, C).permute(1, 0, 2).contiguous()
    y = tile(base_y, R * C).view(8, R, C).permute(1, 0, 2).contiguous()
    inf = (torch.rand((R, 1, C), generator=g, device=device) < 0.05).to(torch.int32)
    dc = tuple(_bcast(d1, (C,)))
    suf = cuda_msm.suffix_sweep(fq, x, y, inf, dc)
    want5 = cuda_msm.suffix_sweep_plain(fq, x[R - r0:], y[R - r0:], inf[R - r0:], dc)
    check("suffix_sweep", tuple(t[R - r0:] for t in suf), want5,
          cuda_ms(lambda: cuda_msm.suffix_sweep(fq, x, y, inf, dc), 3),
          cuda_ms(lambda: cuda_msm.suffix_sweep_plain(
              fq, x[R - r0:], y[R - r0:], inf[R - r0:], dc), 1),
          f"({R}, 8, {C})", f"({r0}, 8, {C})", results)

    # K6 at R = 256, C = 512 (the c = 17 bucket reduce) over XYZZ rows cut
    # from the suffix sums, with infinity entries.
    R6, C6 = SIZES["k6"]
    rows = tuple(t[:R6, :, :C6].contiguous() for t in suf)
    hole = (torch.rand((R6, 1, C6), generator=g, device=device) < 0.05)
    rows = tuple(torch.where(hole, 0, t) for t in rows)
    dc6 = tuple(_bcast(d2, (C6,)))
    got6 = cuda_msm.reduce_sweep(fq, rows, dc6)
    t0 = time.perf_counter()
    want6 = cuda_msm.reduce_sweep_plain(fq, rows, dc6)
    torch.cuda.synchronize()
    plain6 = (time.perf_counter() - t0) * 1e3
    check("reduce_sweep", got6, want6, cuda_ms(lambda: cuda_msm.reduce_sweep(fq, rows, dc6), 10),
          plain6, f"({R6}, 8, {C6})", f"({R6}, 8, {C6})", results)


def slice_inputs(curve, n: int):
    """bench.py's MSM inputs for n points: the 256 multiples of G tiled, and
    254-bit scalars as 16-bit limbs.  Returns (points, scalar words, ks, limbs)."""
    rng = np.random.default_rng(SEED)
    ks, bx, by = base_points(curve, rng)
    sc = rng.integers(0, 1 << 16, size=(curve.SF.L, n), dtype=np.uint32)
    sc[-1] &= 0x3FFF  # below the scalar modulus, as in bench.py
    points = AffinePoint(tile(bx, n), tile(by, n),
                         torch.zeros(n, dtype=torch.bool, device=curve.device))
    return points, limbs.from_jax_limbs(sc, curve.device), ks, sc


def phase_slice(device):
    """The MSM at 2^22 through the port's entry points; returns its record."""
    curve = curves.bn254_g1(device)
    F, SF = curve.F, curve.SF
    n = 1 << LOG_N
    points, scalars, ks, sc = slice_inputs(curve, n)
    t0 = time.perf_counter()
    G = (int(curve.gen_x), int(curve.gen_y))
    expected = host_ec.msm_tiled(G, ks, sc, 0, F.p, SF.p)
    host_s = time.perf_counter() - t0
    del sc

    def run():
        return curve.to_affine(msm(curve, points, scalars))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    aff = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: k[0].launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()

    if aff.x.shape != (F.W,) or bool(aff.inf):
        raise AssertionError(f"MSM result malformed: shape {tuple(aff.x.shape)} inf {bool(aff.inf)}")
    if not bool(curve.is_on_curve(aff)):
        raise AssertionError("MSM result is not on the curve")
    got = (int(F.decode(aff.x)), int(F.decode(aff.y)))
    if got != expected:
        raise AssertionError(f"MSM result {got} != host-exact {expected}")
    missing = [name for name, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aff = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    if (int(F.decode(aff.x)), int(F.decode(aff.y))) != expected:
        raise AssertionError("MSM result changed between runs")
    c = optimal_window_bits(SF.spec.bits, n)
    log(f"[slice] bn254_g1 msm+to_affine n=2^{LOG_N} c={c} verified=True "
        f"first_s={first_s:.4f} runs_s={[round(t, 4) for t in times]} best_s={min(times):.4f} "
        f"peak_mem_bytes={peak} host_expected_s={host_s:.3f} launches={json.dumps(launches)}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s, key {_build.build_key()}")
    for line in _build.nvcc_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")

    rng = np.random.default_rng(SEED)
    _, base_x, base_y = base_points(curves.bn254_g1(device), rng)
    results: dict = {}
    phase_kernels(device, base_x, base_y, results)
    torch.cuda.empty_cache()
    launches = phase_slice(device)

    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "shape": r["shape"],
                        "plain_shape": r["plain_shape"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
