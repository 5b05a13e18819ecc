#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's BN254 G1 MSM (msm + to_affine) on one GPU.

    python3 scripts/profile_msm_torch.py [--log-n 22] [--out chiprun_out]

Builds the kernels, makes chip_smoke.py's 2^log_n point set, warms up once,
then traces one run with torch.profiler.  Prints the device time by kernel
name, the device busy and idle shares of the traced window, and writes the
Chrome trace to <out>/msm_trace.json.  Needs CUDA; imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tachyon_tpu_torch.math import curves  # noqa: E402
from tachyon_tpu_torch.math.msm import msm  # noqa: E402
from tachyon_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--out", default="chiprun_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_msm_torch: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"[device] {card}")
    _build.library()
    device = torch.device("cuda", 0)
    curve = curves.bn254_g1(device)
    points, scalars, _, _ = chip_smoke.slice_inputs(curve, 1 << args.log_n)

    def run():
        return curve.to_affine(msm(curve, points, scalars))

    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = sorted(((e.key, e.device_time_total, e.count) for e in events
                  if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda t: -t[1])
    busy_us = sum(t for _, t, _ in dev)
    print(f"[profile] n=2^{args.log_n} wall_s={wall:.4f} device_busy_s={busy_us / 1e6:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.3f}")
    for name, t, cnt in dev[:25]:
        print(f"[kernel-time] {t / 1e3:10.3f} ms  {100 * t / busy_us:5.1f}%  x{cnt:<6d} {name[:90]}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "msm_trace.json"))
    cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)[:12]
    for e in cpu:
        print(f"[host-op] {e.self_cpu_time_total / 1e3:10.3f} ms self x{e.count:<6d} {e.key[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
