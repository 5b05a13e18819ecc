#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's paths on one GPU with torch.profiler.

    python3 scripts/profile_msm_torch.py [--log-n 22] [--kzg-log-n 20]
        [--groth16-log-n 18] [--circom-log-n 18] [--stark-log-n 20]
        [--bls12-log-n 17] [--secp-log-n 22] [--goldilocks-log-n 20]
        [--halo2-log-n 16] [--abi-log-n 20] [--abi-halo2-k 16]
        [--plonk-log-n 16] [--out DIR]

Builds the kernels, then traces, each after one warm-up run (a size of 0
skips its path):
- the G1 MSM (msm + to_affine) on chip_smoke.py's 2^log_n point set;
- the KZG unsafe setup at 2^kzg_log_n;
- one KZG commit (msm + to_affine) of 2^kzg_log_n coefficients;
- one Groth16 prove (at fixed r and s) on chip_smoke.py's square chain of
  2^groth16_log_n constraints, after its setup (0 skips it);
- one circom Groth16 prove (at fixed r and s) on chip_smoke.py's key of a
  2^circom_log_n domain, written to a temporary directory, parsed and
  loaded into CircomGroth16Prover (0 skips it);
- the BabyBear STARK path of chip_smoke.py phase 8 at 2^stark_log_n rows:
  one PCS commit of a 2^stark_log_n x 100 matrix (its trace written), the
  whole PCS path (four commits, the opening, verify) and the Fibonacci
  uni-STARK's prove and verify (device activity only);
- one Groth16 prove over BLS12-381 (at fixed r and s) on a square chain
  of 2^bls12_log_n constraints, after its setup (the W = 12 kernels;
  device activity only);
- the secp256k1 MSM (msm + to_affine) on chip_smoke.py phase 10's 2^secp_log_n
  point set (the full-width W = 8 kernels);
- the Goldilocks path of chip_smoke.py phase 11: coset_lde_batch of a
  2^goldilocks_log_n x 100 matrix at log_blowup 3 and Poseidon2
  goldilocks_w8 on 2^(goldilocks_log_n + 2) states (K1 at W = 2; device
  activity only);
- the halo2 path of chip_smoke.py phase 12: one create_proof of
  SimpleCircuit and one of SimpleLookupCircuit (2^(halo2_log_n - 1) rows,
  log-derivative lookup) in a 2^halo2_log_n domain on TorchBackend, after
  keygen (device activity only: the prover's host loops and
  the eager quotient build's launches);
- the C ABI's bridge (``tachyon_tpu_torch/c/bridge.py``, the code the
  library's entries run) in this process: ``msm_g1`` on chip_smoke.py
  phase 13's 2^abi_log_n points, bytes in and out (the marshalling with
  the MSM), and ``halo2_prove`` of phase 13's JSON circuit at
  k = abi_halo2_k, keygen and self-verify included (device activity only);
- the standalone PLONK prover (``zk/plonk/prover.py``): one SHPlonk
  ``prove`` of phase 13's circuit at 2^plonk_log_n after its setup and
  keygen (device activity only).
For each it prints the device time by kernel name and the device busy and
idle shares of the traced window, and writes the Chrome trace to
<out>/<name>_trace.json; the proves' G2 MSM launches millions of small
kernels (the generic path), so their traces record the device activity
only and are not written.  Needs CUDA; imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from tachyon_tpu_torch.crypto import kzg  # noqa: E402
from tachyon_tpu_torch.io.zkey import parse_wtns, parse_zkey  # noqa: E402
from tachyon_tpu_torch.math import curves  # noqa: E402
from tachyon_tpu_torch.math.msm import msm  # noqa: E402
from tachyon_tpu_torch.ops import _build  # noqa: E402
from tachyon_tpu_torch.zk.groth16 import circuits, prover, r1cs  # noqa: E402
from tachyon_tpu_torch.zk.plonk import circuits as plonk_circuits, halo2  # noqa: E402
from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend  # noqa: E402


def device_events(prof) -> list:
    """(name, ns) of every device activity a ``torch.profiler`` pass
    recorded, from its raw results: ``key_averages`` builds a Python event
    per activity and takes minutes over the ~2M of a G2 MSM."""
    return [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def profile(name: str, run, out: Path, host: bool = True) -> None:
    """Warm up once, then trace one run of ``run``; with ``host`` false
    only the device activity is recorded and no trace is written."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for key, ns in device_events(prof):
        us, cnt = by_name.get(key, (0.0, 0))
        by_name[key] = (us + ns / 1e3, cnt + 1)
    dev = sorted(((k, us, cnt) for k, (us, cnt) in by_name.items()), key=lambda t: -t[1])
    busy_us = sum(t for _, t, _ in dev)
    print(f"[profile] {name} wall_s={wall:.4f} device_busy_s={busy_us / 1e6:.4f} "
          f"idle_share={1 - busy_us / 1e6 / wall:.3f} launches={sum(c for _, _, c in dev)}")
    for key, t, cnt in dev[:20]:
        print(f"[kernel-time] {t / 1e3:10.3f} ms  {100 * t / busy_us:5.1f}%  x{cnt:<6d} {key[:90]}")
    if not host:
        return
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"{name}_trace.json"))
    cpu = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    for e in cpu:
        print(f"[host-op] {e.self_cpu_time_total / 1e3:10.3f} ms self x{e.count:<6d} {e.key[:70]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--kzg-log-n", type=int, default=20)
    ap.add_argument("--groth16-log-n", type=int, default=18)
    ap.add_argument("--circom-log-n", type=int, default=18)
    ap.add_argument("--stark-log-n", type=int, default=20)
    ap.add_argument("--bls12-log-n", type=int, default=17)
    ap.add_argument("--secp-log-n", type=int, default=22)
    ap.add_argument("--goldilocks-log-n", type=int, default=20)
    ap.add_argument("--halo2-log-n", type=int, default=16)
    ap.add_argument("--abi-log-n", type=int, default=20)
    ap.add_argument("--abi-halo2-k", type=int, default=16)
    ap.add_argument("--plonk-log-n", type=int, default=16)
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
    out = Path(args.out)
    if args.log_n:
        curve = curves.bn254_g1(device)
        points, scalars, _, _ = chip_smoke.slice_inputs(curve, 1 << args.log_n)
        profile(f"msm_2^{args.log_n}", lambda: curve.to_affine(msm(curve, points, scalars)),
                out)
        del points, scalars
        torch.cuda.empty_cache()
    if args.secp_log_n:
        secp = curves.secp256k1(device)
        points, scalars, *_ = chip_smoke.tiled_inputs(secp, 1 << args.secp_log_n,
                                                      chip_smoke.SEED + 12)
        profile(f"secp256k1_msm_2^{args.secp_log_n}",
                lambda: secp.to_affine(msm(secp, points, scalars)), out)
        del points, scalars
        torch.cuda.empty_cache()
    if args.goldilocks_log_n:
        k = args.goldilocks_log_n
        g = torch.Generator(device=device)
        g.manual_seed(chip_smoke.SEED + 15)
        dom, _, evals = chip_smoke.lde_inputs(device, g, k)
        profile(f"goldilocks_lde_2^{k}",
                lambda: chip_smoke.coset_lde_batch(dom, evals, chip_smoke.GL_LDE[2],
                                                   chip_smoke.GL_SHIFT), out, host=False)
        del dom, evals
        torch.cuda.empty_cache()
        h = chip_smoke.poseidon2.goldilocks_w8(device)
        st = chip_smoke.mont.to_mont(h.F.spec, chip_smoke.gl_random((h.t, 1 << (k + 2)), g, device))
        profile(f"goldilocks_w8_2^{k + 2}", lambda: h.permute(st), out, host=False)
        del st
        torch.cuda.empty_cache()
    if args.kzg_log_n:
        n = 1 << args.kzg_log_n
        params = {}
        profile(f"kzg_setup_2^{args.kzg_log_n}",
                lambda: params.update(p=kzg.unsafe_setup(n, 0x1234567, device)), out)
        coeffs = torch.randint(0, 1 << 29, (8, n), dtype=torch.int32, device=device)
        profile(f"kzg_commit_2^{args.kzg_log_n}",
                lambda: kzg.to_int_point(kzg.commit(params["p"], coeffs)), out)
        del params, coeffs
        torch.cuda.empty_cache()
    if args.stark_log_n:
        k = args.stark_log_n
        pcs, mats = chip_smoke.stark_pcs_inputs(device, k)
        profile(f"pcs_commit_2^{k}", lambda: pcs.commit([mats[0]]), out)
        profile(f"pcs_2^{k}", lambda: chip_smoke.pcs_path(pcs, mats), out, host=False)
        del pcs, mats
        torch.cuda.empty_cache()
        stark, trace, pubs = chip_smoke.stark_air_inputs(device, k)

        def prove_verify():
            h = stark.pcs.h
            proof = stark.prove(trace, pubs, chip_smoke.DuplexChallenger(h, rate=8))
            assert stark.verify(proof, pubs, chip_smoke.DuplexChallenger(h, rate=8))

        profile(f"stark_2^{k}", prove_verify, out, host=False)
        del stark, trace
        torch.cuda.empty_cache()
    if args.groth16_log_n:
        rr = r1cs.pairing.R
        circuit, public, private = circuits.square_chain(1 << args.groth16_log_n, 0x1234567)
        t0 = time.perf_counter()
        g16 = r1cs.Groth16(r1cs.setup(circuit, rng=iter([11, 12, 13, 14, 15]).__next__,
                                      device=device), device)
        print(f"[groth16] setup + Groth16(...) {time.perf_counter() - t0:.2f} s")
        profile(f"groth16_prove_2^{args.groth16_log_n}",
                lambda: g16.prove(public, private, r=rr - 5, s=rr - 7), out, host=False)
        del g16
        torch.cuda.empty_cache()
    if args.circom_log_n:
        with tempfile.TemporaryDirectory() as tmp:
            (_, _, r, s), _, zpath, wpath, writer_s = chip_smoke.write_circom_key(
                Path(tmp), args.circom_log_n, chip_smoke.SEED + 4, device)
            t0 = time.perf_counter()
            pr = prover.CircomGroth16Prover(parse_zkey(str(zpath), device), device)
            _, wtns = parse_wtns(str(wpath))
        print(f"[circom] writer {writer_s:.2f} s, parse + CircomGroth16Prover(...) "
              f"{time.perf_counter() - t0:.2f} s")
        profile(f"circom_prove_2^{args.circom_log_n}",
                lambda: pr.prove(wtns, r=r, s=s), out, host=False)
        del pr
        torch.cuda.empty_cache()
    if args.bls12_log_n:
        rr = r1cs.pairing_bls12_381.R
        circuit, public, private = circuits.square_chain(1 << args.bls12_log_n, 0x1234567, r=rr)
        t0 = time.perf_counter()
        g16 = r1cs.Groth16(r1cs.setup(circuit, "bls12_381", rng=iter([11, 12, 13, 14, 15]).__next__,
                                      device=device), device)
        print(f"[groth16-bls12] setup + Groth16(...) {time.perf_counter() - t0:.2f} s")
        profile(f"groth16_bls12_381_prove_2^{args.bls12_log_n}",
                lambda: g16.prove(public, private, r=rr - 5, s=rr - 7), out, host=False)
    if args.halo2_log_n:
        k = args.halo2_log_n
        cases = (("halo2_prove", plonk_circuits.SimpleCircuit, {}),
                 ("halo2_lookup_prove", lambda: plonk_circuits.SimpleLookupCircuit(k=k - 1),
                  {"lookup_type": "log_derivative"}))
        for name, make, kw in cases:
            t0 = time.perf_counter()
            pk = halo2.keygen(make(), k, device=device, **kw)
            backend = TorchBackend(pk, device)
            circ = [make()]
            insts = [c.instance_columns() for c in circ]
            print(f"[halo2] {name} keygen + TorchBackend "
                  f"{time.perf_counter() - t0:.2f} s")
            profile(f"{name}_2^{k}",
                    lambda: halo2.Halo2Prover(pk, backend=backend).create_proof(circ, insts),
                    out, host=False)
    if args.abi_log_n or args.abi_halo2_k:
        from tachyon_tpu_torch.c import bridge

        bridge.init("cuda")
    if args.abi_log_n:
        n = 1 << args.abi_log_n
        bases, scalars, _, _, _ = chip_smoke.abi_msm_inputs(curves.bn254_g1(device), n,
                                                            chip_smoke.SEED + 13)
        profile(f"abi_msm_2^{args.abi_log_n}", lambda: bridge.msm_g1(bases, scalars, n), out)
        del bases, scalars
    if args.abi_halo2_k:
        k = args.abi_halo2_k
        spec = chip_smoke.halo2_mul_json(k, (1 << k) - 64, chip_smoke.SEED + 15)
        profile(f"abi_halo2_prove_2^{k}", lambda: bridge.halo2_prove(spec), out, host=False)
    if args.plonk_log_n:
        from tachyon_tpu_torch.zk.plonk import prover as plonk

        n = 1 << args.plonk_log_n
        cs, fixed, advice, instance = chip_smoke.plonk_circuit(n, chip_smoke.SEED + 16)
        t0 = time.perf_counter()
        params = kzg.unsafe_setup(n, 0x5EED + chip_smoke.SEED, device)
        pk = plonk.keygen(params, cs, n, fixed)
        print(f"[plonk] setup + keygen {time.perf_counter() - t0:.2f} s")
        profile(f"plonk_prove_2^{args.plonk_log_n}",
                lambda: plonk.PlonkProver(params, pk).prove(advice, instance), out, host=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
