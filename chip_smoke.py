#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tachyon_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles the CUDA kernels from tachyon_tpu_torch/csrc (one nvcc
   per source, all started together);
3. kernels: each of K1-K6, the fused scalar_mul ladder, the lane scan
   and fold, the Horner kernel and the bucket kernel against its plain
   PyTorch twin on the card, bit-exact on the words, both timed with CUDA
   events, beside its
   bound: the larger of its bytes over 3.35 TB/s and its 32x32-bit word
   products (136 a field multiply, whatever the multiply compiles to) over
   64 per clock per SM x 132 SMs x the card's max SM clock, and the field
   multiplies per second it ran at.  K1 also on edge operands and on a
   full-width field (secp256k1's Fq), word for word, with its host cost
   per call at n = 1 beside the bare ctypes launcher's.  K5, redesigned into three
   launches over S row segments, is also held as points, over all 1024
   rows of a 256-lane slice, against the sequential twin of the TPU kernel,
   with its segment count and the time of each launch, and timed at the
   smaller MSMs' layouts against one segment (S = 1).  K6, redesigned into
   segment partials and a tree combine, is held as points against the
   sequential twin at both main paths' shapes, with each launch's time and
   the chain combine's, and timed by segment count at three layouts.  The
   lane scan (C = 4096, 512) and fold (512) are also held against, and
   timed beside, the loop of K2 launches they replace, and with the blind
   as their bias against the unbiased kernel between the two K2 launches
   the bias replaces; the Horner kernel (15 windows, c = 17, with an
   infinite window and adds that double and cancel) against the loop of
   K3 and K2 launches it replaces; the bucket kernel at the 2^22 window's
   shapes (T (1024, 8, 4096), 2^17 buckets into (256, 8, 512) rows, with
   absent digits and adds that double, cancel and take infinity) against
   its twin and the gathers, K2 launch and glue it replaces, with the 32-byte
   sectors its T loads touch; K2 at its remaining shape (the naive MSM's
   tree reduce, 32 lanes) and at 2^17 - 1 lanes;
4. MSM: the BN254 G1 MSM at n = 2^22 (msm + to_affine) on the point set of
   bench.py (256 exact multiples of G, seed 42, tiled; 254-bit scalars),
   checked against the host-exact point, timed MSM_RUNS times, with the
   kernels' launch counts (K2 K2_PER_WINDOW = 0 times a window, the bucket
   kernel once; one Horner launch, no K3);
5. KZG: the BN254 KZG path at n = 2^20 (unsafe setup, commit,
   commit_lagrange, open, verify; a 64-coefficient commit on the naive MSM
   path; Pedersen setup(64) + commit), each step checked against host ints,
   with its time and the kernels' launch counts (K2 only in the naive
   MSMs' tree reduces and Pedersen's last add); then SHPlonk and GWC
   (crypto/multiopen.py) over the 2^20 params on three of its polynomials
   (p, its evaluations and their product, as coefficients) at the point
   sets (3, 5), (3, 5), (7,): each proof verifies and refuses a tampered
   value, with their launches (the path multiopen_2^20);
6. Groth16: the native BN254 Groth16 prover on a square chain of 2^18
   constraints built from SEED (zk/groth16/circuits.py; domain 2^18, 2^18
   + 2 variables): setup (every G1 point of the key in one ladder launch,
   every G2 point in one generic ladder over Fq2), Groth16(...) with its
   device-point uploads, prove at fixed r and s (the witness map, the four
   G1 MSMs and the G2 MSM each timed by CUDA events), verify; the proof
   verifies with the host pairing and fails for the public output + 1; on
   a chain of 2^6 constraints (GROTH16_CHECK_LOG_N: every MSM on the host,
   at most r1cs.MSM_HOST_THRESHOLD points) a second prove at the same r and
   s gives the same tuple and a wrong witness's proof fails; 64
   sampled a_query and b2_query points are on their curves, and the G2 MSM
   alone at n = 2^18 (256 exact multiples of the G2
   generator, tiled) equals the host point; with peak memory and the
   kernels' launch counts;
7. circom: the circom Groth16 pipeline at a 2^18 domain.  A snarkjs-layout
   key and witness of square_chain(2^18 - 2) and its two public-input
   constraints, from seeded secrets, are written to a temporary directory
   by scripts/circom_key.py (timed apart: not the user's path); then
   parse_zkey, parse_wtns, CircomGroth16Prover(...), prove at fixed r and s
   (the witness map and each MSM timed by CUDA events) and verify.  The
   proof verifies and fails for the output + 1 (scripts/profile_msm_torch.py
   traces this prove for the device's idle share); at 2^12, on bits_chain
   (linear combinations of 1, 3, 5 and 254 terms, as a circom bit
   decomposition has), a repeat gives the same tuple, a wrong witness's
   proof fails, the deterministic proof verifies and the tuple equals the
   native prover's on the same setup; with peak memory and launch counts;
8. stark: the BabyBear STARK path.  K1 at one word (W = 1) on baby_bear at
   (1, 2^24) and with broadcast operands, word for word against its twin
   and timed beside its bound (12 bytes an element), and on koala_bear and
   mersenne31 edge operands, with its host cost per call at n = 1;
   Poseidon2 (baby_bear_p3_w16) on 2^22 states, 64 sampled states equal to
   permute_host; the pinned transcript of tests/test_fri_pinned.py on the
   card, equal to tests/fixtures/fri_babybear_pinned.json; then the main
   path: TwoAdicFRIPCS over 4 rounds of a 2^20 x 100 matrix made on the
   card from SEED (log_blowup 2, 100 queries, 16 proof-of-work bits): each
   commit, the opening at one sampled extension point, verify, each step
   timed; the proof verifies and fails for one tampered opened value, and
   16 sampled leaves of each round's tree, rehashed with permute_host,
   equal its leaf digests; then the Fibonacci uni-STARK at n = 2^20 (the
   same FRI config): prove and verify, timed; it verifies and fails for the
   public output + 1; get_evaluations_on_domain (SP1's quotient-domain
   read) on round 0's matrix at 2^20, 8 sampled values against the host
   interpolant of the column on the coset; with peak memory and K1's
   launches;
9. groth16_bls12_381: every kernel's W = 12 instantiation (BLS12-381's
   381-bit Fq) against its plain twin on the card, word for word, at the
   BLS12-381 path's shapes (BLS_SIZES: K1 at (12, 2^22) and on edge
   operands; K2, K3 and K4 at (12, 2^20); the ladder at 2^19 lanes; K5 at
   (33, 12, 4096) and (32, 12, 4096), also as points against the sequential
   twin; K6 at (16, 12, 512); the lane scan at 4096 and the fold at 512
   lanes; the bucket kernel at 2^13 buckets; Horner at 20 windows of 13
   bits), each timed beside its bound at 2 W^2 + W = 300 word products a
   field multiply; then the native Groth16 prover over BLS12-381 on a
   square chain of 2^17 constraints (the domain of a Zcash Sapling Spend
   circuit), from SEED: setup from five secrets, Groth16(...), prove at
   fixed r and s (the witness map and each MSM timed), verify; the proof
   verifies and fails for the output + 1, a second prove gives the same
   tuple, a wrong witness's proof fails, 64 sampled a_query and b2_query
   points are on their curves; with peak memory and the launch counts by
   word count (the ladder once, Horner 4 times, K2 never at W = 12);
10. secp256k1: every kernel's full-width instantiation (W = 8 on a p of a
   full 256 bits: the 64-bit CIOS multiply) against its plain twin on the
   card, word for word, at the 2^22 MSM's shapes (SECP_SIZES: K1 at
   (8, 2^22); K2, K3 and K4 at (8, 2^20); the ladder at 2^20 lanes; K5 at
   (1024, 8, 4096); K6 at (256, 8, 512); the lane scan at 4096 and the fold
   at 512 lanes; the bucket kernel at 2^17 buckets; Horner at 16 windows of
   17 bits), each timed beside its bound; then the secp256k1 MSM at 2^22
   (256 multiples of G tiled, scalars uniform below the group order)
   against the host-exact point, timed MSM_RUNS times, with no spare-bit
   kernel launched and each sweep kernel full-width; the naive MSM of 128
   points (the ladder and K2's tree) against host ints; GLV at 2^20 (2^21
   points of 130 bits), its host decomposition timed apart, against the
   plain MSM and the host point; FixedBaseMSM on G at 2^20 scalars (c = 8),
   64 sampled results against host multiples; the MSM at 2^20 over Pallas
   and over Vesta (spare-bit kernels only) against host points;
11. goldilocks: K1 at W = 2 (Goldilocks, p = 2^64 - 2^32 + 1: its own
   kernel, a 64-bit Montgomery round that keeps the carry into bit 64) at
   (2, 2^24) against its twin, word for word, timed beside its bound (24
   bytes an element), on every pair of edge operands (0, 1, mont(1), values
   of 2^63 and above, p - 1; some carry into bit 64), with an NTT stage's
   twiddles read in place, and its host cost per call at n = 1;
   goldilocks2's mul, square and inv on 2^20 elements, 64 of each against
   host ints; Poseidon2 goldilocks_w8 on 2^22 states, 64 against
   permute_host; then the main path: coset_lde_batch of a 2^20 x 100
   Goldilocks matrix (the evaluations on H of random polynomials from SEED)
   at log_blowup 3, shift 7, 16 sampled outputs against host Horner at
   7 w^i, with its time, peak memory and K1's W = 2 launches (no kernel of
   another width); MixedRadixDomain over Goldilocks at 3 x 2^20 and
   bn254_fr at 9 x 2^18 (ifft(fft(x)) == x, 4 outputs each against a host
   DFT sum, DomainCache's types); SimpleFRI over BabyBear at 2^20
   evaluations and 16 queries (verifies, refuses a tampered layer value);
   the sumcheck over Goldilocks on 3 MLEs of 2^22 entries (verifies, its
   claim is the host sum, a claim + 1 is refused);
12. halo2: the Scroll halo2 pipeline (zk/plonk/halo2.py, SHPlonk) through
   its entry points, keygen, TorchBackend(pk), create_proof
   and Halo2Verifier.verify, each timed by a synchronized host clock, with
   every launch count set to 0 before keygen (the SRS built inside it):
   SimpleCircuit at k = 16 (gates, copy constraints, the permutation
   argument, an instance column) and SimpleLookupCircuit's 2^15 rows, each
   looked up with the log-derivative lookup, in the same 2^16 domain; each
   proof verifies, fails with a byte flipped and (SimpleCircuit) for the
   instance + 1, and a fresh RandomFieldGenerator repeats its bytes; the
   backend's steps (commits, IFFTs, the quotient build) timed apart, the
   quotient build run again under torch.profiler for its device launches
   (the same h coefficients), with peak memory and the launches by instantiation (the paths halo2_2^16,
   halo2_lookup_2^16); then every case of tests/fixtures/torch_halo2_jax.json
   (the example circuits at k = 4 and 5, SHPlonk and GWC, both lookups, a
   shuffle) on the card: pinned VK, transcript_repr and proof bytes equal
   to the JAX HostBackend's;
13. surfaces: the port's C ABI and CLI and the standalone PLONK prover.
   ``make -C tachyon_tpu_torch/c`` builds libtachyon_tpu_c.so and
   test_capi, and ``test_capi cuda`` runs every step in its embedded
   interpreter (a subprocess); then, through ctypes in this process after
   tachyon_tpu_init("cuda"): the MSM at 2^20 points (tiled multiples of G,
   seed 55) equal to the host-exact point, the marshalling timed apart from
   the MSM; the FFT at 2^20 equal to Radix2Domain.fft and inverted back;
   Poseidon2 against the host sponge; the SP1 commit of a 2^20 x 100
   BabyBear matrix at log_blowup 2 equal to TwoAdicFRIPCS.commit's root in
   this process, and prove_verify on 2^16 x 16 with SP1's 100 queries and
   16 grinding bits; groth16_prove (no_zk) on the circom mul fixture equal
   to ``cli.py prove --no-zk``'s JSON; halo2_prove of a JSON circuit at
   k = 16 (2^16 - 64 rows of mul gates, copies to an instance column;
   self-verified) equal to ``cli.py prove-halo2 --device cuda``'s hex (a
   subprocess); one 2^16 ABI MSM dumped (TACHYON_MSM_DUMP_PATH) and
   replayed by io/replay.py to the same, host-exact, point; ``cli.py prove
   --trace-path`` writing a chrome trace with the
   ProofGeneration span and K1's kernel; then the standalone PLONK prover
   (zk/plonk/prover.py) at 2^16: unsafe_setup, keygen, prove and verify
   with SHPlonk and GWC on test_plonk.py's gate over every usable row,
   1024 chained copies and an instance, 5 blinding rows; each proof
   refuses a flipped byte and the instance + 1; with peak memory and
   launches (the paths abi_msm_2^20, abi_sp1_commit_2^20, abi_halo2_2^16,
   plonk_2^16).  Phase 7 also holds the mmap parser (io/native) against
   the Python parse on its 2^18 key, both timed;
14. math: the last modules of the JAX package at full width, each
   checked, with its seconds, peak memory and launches (paths circle_2^22,
   binary_merkle_2^20, lincomb_2^22, sparse_2^16, fq12_2^16): the M31
   circle's order-2^22 subgroup built by 22 batched adds of the doubling
   table, every point on the circle, add, double, neg, antipode and
   scalar_mul by a 31-bit k on the batch against the subgroup's own points,
   g^(2^22) the identity, 1024 lanes against host ints (K1 at W = 1); the
   GF(2^k) tower (PyTorch bitwise ops, no kernel): GF(2^128) mul, square
   and inv on 2^22 elements, GF(2^32) and GF(2^8) mul on 2^24, 1024 lanes
   against the host scalar tower, a a^-1 = 1 on every nonzero lane; the
   binary Merkle tree over baby_bear_p3_w16's compress at 2^20 leaves of
   8-element digests, 8 first-layer nodes rehashed on the host, 64
   openings verified, a tampered leaf refused; a LinearCombination of 3
   Goldilocks MLEs of 2^22 (combine and evaluate against the combined
   table and mle.evaluate); a SparseUnivariate over BN254 Fr of 2^10 terms
   of degree below 2^22 at 2^16 points, 64 against host ints; BN254 Fq12
   mul, square and inv on 2^16 elements and pow_const by p on 2^10, sampled
   lanes against a host-int tower, the ring laws and a a^-1 = 1 on all;
15. cc: ``make -C tachyon_tpu_torch/cc`` builds test_cc, the C++ binding's
   test program, and ``test_cc cuda`` runs MsmG1 at 2^20 (phase 13's points and
   scalars), Fft at 2^20, Poseidon2Hash, the circom mul key's Groth16Prove
   and Halo2Prove at k = 10 in its embedded interpreter (a subprocess),
   beside the same calls through ctypes here: the bytes equal, the MSM the
   host-exact point;
16. parallel: ``init_process_group("nccl")`` with a file:// store, one
   rank: msm_sharded, msm_sharded_windows and msm_sharded_2d (a 1 x 1
   mesh, c = 17) on the 2^22 MSM's inputs, each the host-exact point and
   the single-device MSM's; DistributedNTT fft and ifft at 2^22 over
   bn254_fr, DistributedCosetLDE on BabyBear 2^20 x 100 at log_blowup 2 and
   fft_batch_dist, word for word with Radix2Domain and coset_lde_batch;
   with launches (paths msm_sharded_2^22, msm_sharded_windows_2^22,
   msm_sharded_2d_2^22, ntt_dist_2^22, coset_lde_dist_2^20,
   fft_batch_dist_2^20); the group destroyed at the end;
17. prints the card's line, the kernels' JSON line (an entry for every
   kernel at W = 8 on a spare bit, K1 at W = 1 and W = 2, every kernel at
   W = 12 named ``<name>_w12`` and every full-width W = 8 instantiation
   named ``<name>_w8_full``), then the result line
   {"ok": true, "device": {"platform": "gpu", ...}} last.

Each main path (4, 5 and its multiopen, 6, 7, 8's PCS and uni-STARK runs,
9, 10's and 11's LDE, 12's two circuits, 13's ABI MSM, SP1 commit, halo2
and PLONK, 14's and 16's paths) runs with every launch count set
to 0 just before it, and fails if a kernel of that path (MSM_PATH,
KZG_PATH, GROTH16_PATH, CIRCOM_PATH, STARK_PATH, GOLDILOCKS_PATH,
HALO2_PATH, PLONK_PATH) was launched no time; the launches are also
counted by instantiation (``cuda_mont.Form.tag``: w8_spare, w8_full,
w12_full, w1_full, w2_full).  Phase 3 also holds, at
the 2^18 paths' shapes (c = 14), K5 at the Groth16 path's (65, 8, 4096)
and the circom path's (64, 8, 4096), K6 at their (32, 8, 512), the bucket
kernel on T rows (64, 8, 4096) and (65, 8, 4096) with 2^14 buckets into
(32, 8, 512), and Horner at 19 windows of 14 bits.  Imports no JAX and
nothing of the JAX package: the port is torch-only.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from scripts import circom_key, fri_pinned, make_torch_halo2_fixture
from scripts.make_torch_stark_fixture import fib_air
from tachyon_tpu_torch import cli
from tachyon_tpu_torch.crypto import (binary_merkle, kzg, multiopen, pedersen, poseidon2, sumcheck,
                                      transcript)
from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.crypto.simple_fri import SimpleFRI
from tachyon_tpu_torch.crypto.fri import FRIConfig, TwoAdicFRIPCS
from tachyon_tpu_torch.fields import extensions, limbs, presets
from tachyon_tpu_torch.io import replay
from tachyon_tpu_torch.io.zkey import parse_wtns, parse_zkey
from tachyon_tpu_torch.math import curves, fixed_msm, glv, host_ec, mle, pairing_bn254, poly
from tachyon_tpu_torch.math import msm as msm_mod
from tachyon_tpu_torch.math.binary_field import binary_field
from tachyon_tpu_torch.math.circle import CirclePoint, m31_circle
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ
from tachyon_tpu_torch.math.msm import _blind_points, _bcast, msm, optimal_window_bits
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.math.extfield import HostExt
from tachyon_tpu_torch.math.ntt import DomainCache, MixedRadixDomain, Radix2Domain, coset_lde_batch
from tachyon_tpu_torch.math.sparse import LinearCombination, SparseUnivariate
from tachyon_tpu_torch.ops import _build, cuda_ec, cuda_mont, cuda_msm, mont
from tachyon_tpu_torch.parallel import mesh, msm_sharded, ntt_dist
from tachyon_tpu_torch.zk.air import expressions as air_expr
from tachyon_tpu_torch.zk.air.stark import UniStark
from tachyon_tpu_torch.zk.groth16 import circuits, prover, r1cs
from tachyon_tpu_torch.zk.plonk import circuits as plonk_circuits, halo2
from tachyon_tpu_torch.zk.plonk import expressions as plonk_expr, prover as plonk
from tachyon_tpu_torch.zk.plonk.constraint_system import ConstraintSystem
from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

LOG_N = 22      # the MSM path
KZG_LOG_N = 20  # the KZG path
KZG_SAMPLES = 64  # SRS points checked against host ints, of each kind
GROTH16_LOG_N = 18  # the Groth16 path: 2^18 constraints, a domain of 2^18
GROTH16_SAMPLES = 64  # a_query and b2_query points checked on their curves
# phase 6's repeat and wrong-witness proves: at 2^6 constraints every MSM
# is one of at most MSM_HOST_THRESHOLD points, where a generic G2 MSM of
# 2^12 points costs 20-27 s a prove (its window path is host-issued)
GROTH16_CHECK_LOG_N = 6
CIRCOM_LOG_N = 18  # the circom path: a domain of 2^18 (square chain + public-input constraints)
CIRCOM_CHECK_LOG_N = 12  # the circom checks against a repeat, a wrong witness, the native prover
# the STARK path: the reference's benchmark/fri row at 2^20 (BabyBear,
# Poseidon2, 100 columns x 4 rounds, log_blowup 2), SP1's 100 queries and 16
# proof-of-work bits; the Fibonacci uni-STARK at the same height and config
STARK_LOG_N = 20
STARK_ROUNDS = 4
STARK_COLS = 100
STARK_FRI = (2, 100, 16)  # log_blowup, num_queries, proof_of_work_bits
STARK_LEAVES = 16  # leaves of each round's tree rehashed on the host
POSEIDON2_LOG_STATES = 22  # the permutation check's batch (a 2^22-row LDE's leaves)
POSEIDON2_SAMPLES = 64
SEED = 42
# shapes the kernels are checked at: those the 2^22 MSM (c = 17) and the
# 2^20 KZG setup give them
SIZES = {
    "k1_fq": 1 << 22,       # K1 elements, BN254 Fq
    "k1_fr": 1 << 16,       # K1 elements, BN254 Fr
    "k1_w1": 1 << 24,       # K1 elements at W = 1, BabyBear
    "k1_w2": 1 << 24,       # K1 elements at W = 2, Goldilocks
    # K2 lanes: the widest add of the naive MSM's tree reduce (64 points),
    # then the former T-gather width 2^c - 1
    "k2": (32, (1 << 17) - 1),
    "k3": 4096,             # K3 lanes (the standalone double; no main path launches it)
    "horner": (15, 17),     # Horner's windows and c at 2^22 (c = 17)
    "k4": 1 << 20,          # K4 lanes
    "ladder": (1 << 20, 4096),  # scalar_mul lanes (the 2^20 SRS), lanes of its plain twin
    "k5": (1024, 4096, 16, 256),  # K5 (R, C), top rows and lanes its plain twins run
    # K5 (R, C) of smaller MSMs: n = 2^14, 2^15 - 2^9, 2^16, 2^18, and the
    # Groth16 path's 2^18 + 2 (a_query, b1_query: an odd row count)
    "k5_small": ((32, 512), (64, 512), (16, 4096), (64, 4096), (65, 4096)),
    # K6 (R2, C2): 2^22 (c = 17), 2^20 (c = 15) and the Groth16 path's 2^18
    # (c = 14); then the S sweep's, R2 = 2^c / 512 for c = 13, 15, 17
    "k6": ((256, 512), (64, 512), (32, 512)),
    "k6_sweep": ((16, 512), (64, 512), (256, 512)),
    "scan": (4096, 512),    # lane scan widths: C for n >= 2^15 (both paths), and below
    "fold": 512,            # lane fold width C2
    "bucket": (1 << 17, 512),  # the bucket kernel's B = 2^c and C2, on K5's (R, C)
    # the 2^18 paths' (c = 14): the bucket kernel's (R, B, C2) on T rows from
    # K5's (64, 8, 4096) (circom, n <= 2^18) and (65, 8, 4096) (Groth16,
    # 2^18 + 2 points); Horner's windows and c
    "bucket_2^18": ((64, 1 << 14, 512), (65, 1 << 14, 512)),
    "horner_2^18": (19, 14),
}
K5_SMALL_S = (1, 2, 4, 8)  # segment counts timed beside the one K5 picks there
K6_S = (1, 2, 4, 8, 16, 32, 64)  # K6 segment counts timed (64 at R = 256 only)
MSM_RUNS = 5  # timed runs of the 2^22 MSM after the checked one
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at 700 W
IMAD_PER_CLK_SM = 64       # 32-bit integer multiply-adds per clock per SM, cc 9.0
SMS = 132


def word_products(W: int) -> int:
    """Word products of one W-word Montgomery multiply (CIOS: W^2 for a*b,
    W^2 + W for m*p), 136 at W = 8 and 300 at W = 12: the work of the
    function, for every operations bound, whatever instructions the
    kernels' multiply compiles to (the SASS counts are printed as
    information only)."""
    return 2 * W * W + W


WORD_PRODUCTS = word_products(8)
K1_CALLS = 1000  # back-to-back K1 calls at n = 1 for its host cost per call

# name -> (wrapper carrying the launch count, source, TPU kernel it replaces)
KERNELS = {
    "mont_mul": (cuda_mont.mul, "tachyon_tpu_torch/csrc/mont_mul.cu",
                 "tachyon_tpu/ops/pallas_mont.py:90"),
    "mont_mul_w1": (cuda_mont.mul1, "tachyon_tpu_torch/csrc/mont_mul.cu",
                    "tachyon_tpu/ops/pallas_mont.py:90"),
    "mont_mul_w2": (cuda_mont.mul2, "tachyon_tpu_torch/csrc/mont_mul.cu",
                    "tachyon_tpu/ops/pallas_mont.py:90"),
    "add_xyzz": (cuda_ec.add_xyzz, "tachyon_tpu_torch/csrc/ec.cu",
                 "tachyon_tpu/ops/pallas_ec.py:209"),
    "dbl_xyzz": (cuda_ec.dbl_xyzz, "tachyon_tpu_torch/csrc/ec.cu",
                 "tachyon_tpu/ops/pallas_ec.py:232"),
    "madd_xyzz": (cuda_ec.madd_xyzz, "tachyon_tpu_torch/csrc/ec.cu",
                  "tachyon_tpu/ops/pallas_ec.py:257"),
    "scalar_mul_xyzz": (cuda_ec.scalar_mul, "tachyon_tpu_torch/csrc/ladder.cu",
                        "tachyon_tpu/ops/pallas_ec.py:257"),
    "suffix_sweep": (cuda_msm.suffix_sweep, "tachyon_tpu_torch/csrc/msm_sweeps.cu",
                     "tachyon_tpu/ops/pallas_msm.py:147"),
    "reduce_sweep": (cuda_msm.reduce_sweep, "tachyon_tpu_torch/csrc/msm_sweeps.cu",
                     "tachyon_tpu/ops/pallas_msm.py:201"),
    "lane_suffix_scan": (cuda_ec.lane_suffix_scan, "tachyon_tpu_torch/csrc/lanes.cu",
                         "tachyon_tpu/ops/pallas_ec.py:209"),
    "lane_fold": (cuda_ec.lane_fold, "tachyon_tpu_torch/csrc/lanes.cu",
                  "tachyon_tpu/ops/pallas_ec.py:209"),
    "horner": (cuda_ec.horner, "tachyon_tpu_torch/csrc/horner.cu",
               "tachyon_tpu/ops/pallas_ec.py:232"),
    "bucket_add": (cuda_msm.bucket_add, "tachyon_tpu_torch/csrc/buckets.cu",
                   "tachyon_tpu/ops/pallas_ec.py:209"),
}

# what the fused ladder replaces beside K4: K3 and the scan's select per
# bit; what the lane kernels replace beside K2: the JAX loops over it; what
# the Horner kernel replaces beside K3: K2's add and the JAX loop; what the
# bucket kernel replaces beside K2: the T-gather's XLA glue
ALSO_REPLACES = {"bucket_add": ["tachyon_tpu/math/msm.py:348-361"],
                 "scalar_mul_xyzz": ["tachyon_tpu/ops/pallas_ec.py:232",
                                     "tachyon_tpu/math/ec.py:313-338"],
                 "lane_suffix_scan": ["tachyon_tpu/math/msm.py:196-206",
                                      "tachyon_tpu/math/msm.py:340-344"],
                 "lane_fold": ["tachyon_tpu/math/msm.py:209-222", "tachyon_tpu/math/msm.py:363"],
                 "horner": ["tachyon_tpu/ops/pallas_ec.py:209", "tachyon_tpu/math/msm.py:418-428"]}
# K5 at (1024, 8, 4096) and K6 at (256, 8, 512) with one thread per lane,
# before the segments (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
K5_OLD_MS = 8.4759
K6_OLD_MS = 2.2606


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


def same_points(f, a, b) -> torch.Tensor:
    """Per lane: XYZZ a and b (4-tuples of (W, *batch)) are the same point,
    X ZZ' = X' ZZ and Y ZZZ' = Y' ZZZ (Montgomery products, K1 on the card),
    both at infinity (zz = 0) or both finite."""
    W = a[0].shape[0]
    ax, ay, azz, azzz = (t.reshape(W, -1) for t in a)
    bx, by, bzz, bzzz = (t.reshape(W, -1) for t in b)
    n = ax.shape[1]
    lhs = mont.mul(f, torch.cat([ax, ay], 1), torch.cat([bzz, bzzz], 1))
    rhs = mont.mul(f, torch.cat([bx, by], 1), torch.cat([azz, azzz], 1))
    eq = mont.eq(f, lhs, rhs)
    a_inf, b_inf = mont.is_zero(f, azz), mont.is_zero(f, bzz)
    return (a_inf & b_inf) | (~a_inf & ~b_inf & eq[:n] & eq[n:])


def ladder_muls(scalars: torch.Tensor, pinf: torch.Tensor) -> int:
    """Field multiplies the ladder's lanes need: from a lane's top set bit t
    (its madd from infinity is a copy), t doublings of 9 and popcount - 1
    mixed adds of 10; none where P is infinity or the scalar is 0."""
    w = mont.widen(scalars)
    Ws = w.shape[0]
    top = torch.full(w.shape[1:], -1, dtype=torch.int64, device=w.device)
    pop = torch.zeros_like(top)
    base = 32 * torch.arange(Ws, device=w.device).reshape(Ws, *(1,) * (w.ndim - 1))
    for j in range(32):
        bit = (w >> j) & 1
        pop += bit.sum(0)
        top = torch.maximum(top, torch.where(bit == 1, base + j, -1).amax(0))
    live = (top >= 0) & ~pinf
    return int(torch.where(live, 9 * top + 10 * (pop - 1), 0).sum())


def k1_edges(f, device):
    """Every pair of the edge operands 0, 1, mont(1) = R mod p, 2 and p - 1
    (so (p - 1)^2 among them) as two (W, 25) word arrays."""
    vals = [0, 1, f.R_mod_p, 2, f.p - 1]
    W = limbs.word_count(f)
    return (limbs.from_ints([x for x in vals for _ in vals], W, device),
            limbs.from_ints([y for _ in vals for y in vals], W, device))


def k1_call_us(f, device) -> tuple[float, float]:
    """Host microseconds per call, over K1_CALLS calls back to back and one
    synchronize: K1's wrapper at n = 1, and its ctypes launcher alone with
    the arguments made once."""
    a = mont.ones(f, (1,), device)
    b, out = a.clone(), torch.empty_like(a)
    stream = torch.cuda.current_stream().cuda_stream
    if limbs.word_count(f) in (1, 2):
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, 1, 1, cuda_mont.consts_ptr(f),
                stream)
        launcher = _build.launcher(f"tt_mont_mul{limbs.word_count(f)}")
    else:
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), 1, cuda_mont.consts_ptr(f),
                limbs.word_count(f), stream)
        launcher = _build.launcher("tt_mont_mul")

    def per_call(call) -> float:
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(K1_CALLS):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / K1_CALLS * 1e6

    return per_call(lambda: cuda_mont.mul(f, a, b)), per_call(lambda: launcher(*args))


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
    """t's last axis repeated to length n."""
    reps = -(-n // t.shape[-1])
    return t.repeat(*(1,) * (t.ndim - 1), reps)[..., :n].contiguous()


def timed_once(fn):
    """fn's result and its milliseconds on the card, one call (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound_ms(nbytes: int, products: int, clock_hz: float) -> tuple[float, str]:
    """Least time for the work: bytes over the memory rate, or word products
    over the integer multiply-add rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products / (IMAD_PER_CLK_SM * SMS * clock_hz)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(name, got, want, kernel_ms, plain_ms, shape, plain_shape, work, results,
          per_mul=WORD_PRODUCTS):
    """Hold a kernel's output against its twin's; record the first (main
    path) shape's numbers.  work = (bytes, word products, clock in Hz); the
    field multiplies per second are the products' multiplies (per_mul word
    products each) over the kernel's time.  Returns this shape's numbers."""
    err = word_err(got, want)
    bms, by = bound_ms(*work)
    rate = work[1] / per_mul / (kernel_ms / 1e3)
    log(f"[kernel] {name}: shape {shape} max_abs_err {err} kernel {kernel_ms:.4f} ms "
        f"plain {plain_ms:.4f} ms (plain at {plain_shape}) bound {bms:.4f} ms ({by}; "
        f"{work[0]} bytes, {work[1]} word products); {rate:.4g} field multiplies per s")
    if err != 0:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin (max_abs_err {err})")
    rec = {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bms,
           "bound_by": by, "shape": shape, "plain_shape": plain_shape, "fmul_per_s": rate}
    results.setdefault(name, rec)
    return rec


def row_tiled(base_x, base_y, R: int, C: int, fixed: int = 0):
    """Sweep rows (R, W, C) of the base points: row r of lane c holds base
    point (c + r) % 256, so a lane's rows differ and so do the lanes of a
    row; lanes below ``fixed`` hold base point c on every row."""
    rr = torch.arange(R, device=base_x.device)[:, None]
    cc = torch.arange(C, device=base_x.device)[None, :]
    idx = torch.where(cc < fixed, cc, (cc + rr) % base_x.shape[1])
    return tuple(b[:, idx].permute(1, 0, 2).contiguous() for b in (base_x, base_y))


def k5_rows(base_x, base_y, R: int, C: int, g, fixed: int = 0):
    """K5's rows (R, W, C): ``row_tiled`` rows of the base points, 5% of
    them at infinity."""
    x, y = row_tiled(base_x, base_y, R, C, fixed)
    inf = (torch.rand((R, 1, C), generator=g, device=x.device) < 0.05).to(torch.int32)
    return x, y, inf


def k5_work(x, inf, clock_hz):
    """K5's bytes (rows, inf and D read, the suffix sums written) and the
    field multiplies its live rows need (10 each)."""
    R, W, C = x.shape
    eb = 4 * W  # bytes an element
    return (R * C * (2 * eb + 4) + 4 * eb * C + 4 * eb * R * C,
            word_products(W) * 10 * (R * C - int(inf.sum())), clock_hz)


def k5_check(f, x, y, inf, dc, clock_hz, results, c0: int = 0, reps: int = 20) -> tuple:
    """K5 on rows (x, y, inf) at the segment count it picks: its rows on the
    first c0 lanes (all by default) word for word against the segmented
    twin (timed once) and as points against the sequential twin; each
    launch and the whole timed beside the bound.  Returns the suffix sums,
    the sequential twin's rows on those lanes and its numbers."""
    R, W, C = x.shape
    c0 = c0 or C
    plan = cuda_msm.suffix_sweep_plan(f, x, y, inf, dc)
    S, L = plan.S, -(-R // plan.S)
    suf = cuda_msm.suffix_sweep(f, x, y, inf, dc)
    sl = (slice(None), slice(None), slice(0, c0))
    xs, ys, infs = (t[sl].contiguous() for t in (x, y, inf))
    ds = tuple(t[:, :c0].contiguous() for t in dc)
    want, plain_ms = timed_once(lambda: cuda_msm.suffix_sweep_segmented_plain(
        f, xs, ys, infs, ds, S))
    seq = cuda_msm.suffix_sweep_plain(f, xs, ys, infs, ds)
    got = tuple(t[sl] for t in suf)
    same = same_points(f, tuple(t.permute(1, 0, 2) for t in got),
                       tuple(t.permute(1, 0, 2) for t in seq)).view(R, c0)
    if not bool(same.all()):
        bad = same.logical_not().nonzero()[:4].tolist()
        raise AssertionError(f"suffix_sweep at ({R}, {W}, {C}): rows differ as points from "
                             f"the sequential twin at (row, lane) {bad}")
    phase_ms = [cuda_ms(lambda a=args, nm=name: _build.launch(nm, *a), reps)
                for name, args in plan.launches]
    del plan
    ms = cuda_ms(lambda: cuda_msm.suffix_sweep(f, x, y, inf, dc), reps)
    work = k5_work(x, inf, clock_hz)
    log(f"[k5] ({R}, {W}, {C}): S={S} segments of {L} rows; each launch (totals, carries, "
        f"emit) {phase_ms} ms; whole {ms:.4f} ms, bound {bound_ms(*work)[0]:.4f} ms; {R} x {c0} "
        f"rows equal to the segmented twin word for word, to the sequential twin as points")
    rec = check("suffix_sweep", got, want, ms, plain_ms, f"({R}, {W}, {C})", f"({R}, {W}, {c0})",
                work, results, word_products(W))
    return suf, seq, {**rec, "S": S, "rows_per_segment": L, "phase_ms": phase_ms}


def k5_small(f, base_x, base_y, d1, g, clock_hz, results) -> list:
    """K5 at the smaller MSMs' (R, C): ``k5_check`` at the S that
    ``segments`` picks, then each S of K5_SMALL_S, timed (CUDA events, 20
    calls); the S = 1 rows word for word equal to the sequential twin's,
    every S's equal to them as points."""
    out = []
    for R, C in SIZES["k5_small"]:
        x, y, inf = k5_rows(base_x, base_y, R, C, g)
        dc = tuple(_bcast(d1, (C,)))
        _, seq, rec = k5_check(f, x, y, inf, dc, clock_hz, results)
        ms = {rec["S"]: rec["ms"]}
        for S in K5_SMALL_S:
            plan = cuda_msm.suffix_sweep_plan(f, x, y, inf, dc, S)
            cuda_msm.run_plan(plan)
            if S == 1 and word_err(plan.outs, seq) != 0:
                raise AssertionError(f"suffix_sweep at ({R}, {C}), S = 1: words differ "
                                     f"from the sequential twin")
            if not bool(same_points(f, tuple(t.permute(1, 0, 2) for t in plan.outs),
                                    tuple(t.permute(1, 0, 2) for t in seq)).all()):
                raise AssertionError(f"suffix_sweep at ({R}, {C}): S = {S} and the sequential "
                                     f"twin differ as points")
            ms.setdefault(S, cuda_ms(lambda plan=plan: cuda_msm.run_plan(plan), 20))
        log(f"[k5-small] ({R}, 8, {C}): picked S={rec['S']} {rec['ms']:.4f} ms (plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms, {rec['bound_by']}); by S "
            + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(ms.items())))
        out.append({"shape": [R, 8, C], "S": rec["S"], "ms": rec["ms"],
                    "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                    "ms_by_S": {str(k): v for k, v in sorted(ms.items())}})
    return out


def k2_inputs(f, base_x, base_y, n: int):
    """K2's check inputs on n lanes: P has zz != 1 (a plain doubling of
    affine points); by lane % 7: 1 P = Q, 2 P = -Q, 3 p = inf, 4 q = inf,
    5 both, else generic.  Returns p, q and the field multiplies the lanes
    need: 14 for an add, 4 + 9 where P = Q doubles, 4 where P = -Q, none
    where an input is infinity."""
    device = base_x.device
    one = mont.ones(f, (n,), device)
    lane = torch.arange(n, device=device)
    p = cuda_ec.dbl_xyzz_plain(f, (tile(base_x, n), tile(base_y, n), one, one))
    q = tuple(torch.roll(t, 1, dims=1) for t in p)
    q = list(mont.select((lane % 7 == 1) | (lane % 7 == 2), pc, qc) for pc, qc in zip(p, q))
    q[1] = mont.select(lane % 7 == 2, mont.neg(f, p[1]), q[1])
    zero = torch.zeros_like(p[0])
    p = tuple(mont.select((lane % 7 == 3) | (lane % 7 == 5), zero, t) for t in p)
    q = tuple(mont.select((lane % 7 == 4) | (lane % 7 == 5), zero, t) for t in q)
    cls = torch.bincount(lane % 7, minlength=7).tolist()
    return p, q, 14 * (cls[0] + cls[6]) + 13 * cls[1] + 4 * cls[2]


def horner_windows(curve, nwin: int, c: int, seed: int):
    """nwin window sums for Horner as 4 (W, nwin) XYZZ coords, lifted (zz
    != 1), from the top window: a multiple P of G, then 2^c P (the add
    doubles), infinity, the negation of the accumulator 2^c acc (the add
    cancels to infinity), then multiples of G.  Returns the coords, the
    host's affine sum and the field multiplies Horner needs on them (9 a
    doubling of a finite point, 14 an add of two, 13 where it doubles, 4
    where it cancels)."""
    mod = curve.F.p
    G = (int(curve.gen_x), int(curve.gen_y))
    rng = np.random.default_rng(seed)
    pts = [host_ec.scalar_mul(G, int(k), 0, mod) for k in rng.integers(1, 1 << 30, nwin)]
    acc, muls = None, 0
    for j, k in enumerate(range(nwin - 1, -1, -1)):
        muls += 0 if acc is None else 9 * c
        acc = host_ec.scalar_mul(acc, 1 << c, 0, mod)
        if j == 1:
            pts[k] = acc
        elif j == 2:
            pts[k] = None
        elif j == 3:
            pts[k] = (acc[0], -acc[1] % mod)
        if acc is not None and pts[k] is not None:
            muls += 13 if pts[k] == acc else 4 if pts[k][0] == acc[0] else 14
        acc = host_ec.affine_add(acc, pts[k], 0, mod)
    lam = [int(v) for v in rng.integers(2, 1 << 62, nwin)]
    rows = [(0, 0, 0, 0) if q is None else
            (q[0] * l * l % mod, q[1] * l ** 3 % mod, l * l % mod, l ** 3 % mod)
            for q, l in zip(pts, lam)]
    return tuple(curve.F.encode([r[i] for r in rows]) for i in range(4)), acc, muls


def horner_loop(f, wins, c: int):
    """Horner as the MSM ran it before the Horner kernel: c K3 launches and
    one K2 launch a window, on one point."""
    acc = tuple(torch.zeros_like(wins[0][:, 0]) for _ in range(4))
    for k in range(wins[0].shape[1] - 1, -1, -1):
        for _ in range(c):
            acc = cuda_ec.dbl_xyzz(f, acc)
        acc = cuda_ec.add_xyzz(f, acc, tuple(t[:, k].contiguous() for t in wins))
    return acc


def horner_check(curve, clock_hz, results, nwin: int, c: int) -> dict:
    """The Horner kernel on nwin windows of c bits, word for word against
    its twin and the loop of K3 and K2 launches it replaces, its result
    against the host's point, timed beside that loop.  Returns check's
    numbers with the loop's time and the chain's length."""
    f, W = curve.F.spec, curve.F.W
    wins, want_aff, muls = horner_windows(curve, nwin, c, SEED)
    got = cuda_ec.horner(f, wins, c)
    want, plain_ms = timed_once(lambda: cuda_ec.horner_plain(f, wins, c))
    if word_err(got, horner_loop(f, wins, c)) != 0:
        raise AssertionError("horner: words differ from the loop of K3 and K2 launches")
    if sampled_points(curve, curve.to_affine(PointXYZZ(*(t[:, None] for t in got))), [0]) \
            != [want_aff]:
        raise AssertionError("horner: the sum differs from the host's point")
    loop_ms = cuda_ms(lambda: horner_loop(f, wins, c), 20)
    ms = cuda_ms(lambda: cuda_ec.horner(f, wins, c), 20)
    work = (4 * 4 * W * (nwin + 1), word_products(W) * muls, clock_hz)
    log(f"[horner] {nwin} windows, c = {c}: one launch {ms:.4f} ms, the loop of {c * nwin} K3 "
        f"and {nwin} K2 launches it replaces {loop_ms:.4f} ms; operations bound "
        f"{bound_ms(*work)[0]:.6f} ms; the floor is a serial chain of {c * nwin} doublings "
        f"and {nwin} adds: {muls} field multiplies in a row, {ms * 1e6 / muls:.1f} ns each")
    rec = check("horner", got, want, ms, plain_ms, f"4 x ({W}, {nwin}), c = {c}",
                f"4 x ({W}, {nwin}), c = {c}", work, results, word_products(W))
    return {**rec, "k3_k2_loop_ms": loop_ms,
            "chain": {"doublings": c * nwin, "adds": nwin, "field_multiplies": muls}}


def lifted(f, x, y, lam):
    """Affine (x, y) as XYZZ (x l^2, y l^3, l^2, l^3): zz != 1."""
    l2 = mont.mul(f, lam, lam)
    l3 = mont.mul(f, l2, lam)
    return (mont.mul(f, x, l2), mont.mul(f, y, l3), l2, l3)


def k1_random_check(f, n: int, g, device, clock_hz, results) -> None:
    """K1 on n random elements of f (some squares) against its twin, timed
    beside its bound."""
    W = limbs.word_count(f)
    a, b = random_elements(f, n, g, device), random_elements(f, n, g, device)
    a[:, 3:6] = b[:, 3:6]  # some squares
    got = cuda_mont.mul(f, a, b)
    want = cuda_mont.mul_plain(f, a, b)
    torch.cuda.synchronize()
    check("mont_mul", (got,), (want,), cuda_ms(lambda: cuda_mont.mul(f, a, b), 20),
          cuda_ms(lambda: cuda_mont.mul_plain(f, a, b), 2), f"{f.name} ({W}, {n})",
          f"{f.name} ({W}, {n})", (3 * 4 * W * n, word_products(W) * n, clock_hz), results,
          word_products(W))


def k1_edges_check(f, device, extra=None) -> None:
    """K1 on its edge operands (0, 1, mont(1), 2, p - 1 pairwise), then the
    operands ``extra`` if given, word for word against its twin."""
    a, b = k1_edges(f, device)
    if extra is not None:
        a, b = torch.cat([a, extra[0]], 1), torch.cat([b, extra[1]], 1)
    err = word_err((cuda_mont.mul(f, a, b),), (cuda_mont.mul_plain(f, a, b),))
    log(f"[k1-edges] {f.name}: {a.shape[1]} products (0, 1, mont(1), 2, p - 1 pairwise"
        f"{', then random' if extra is not None else ''}) max_abs_err {err}")
    if err != 0:
        raise AssertionError(f"mont_mul: {f.name} edge operands differ from the plain twin")


def k1_check(fq, fr, g, device, clock_hz, results) -> None:
    """K1 at both main paths' shapes against its twin; its edge operands and
    a full-width field word for word; its host cost per call."""
    # K1 on 2^22 Fq and 2^16 Fr elements
    for f, n in ((fq, SIZES["k1_fq"]), (fr, SIZES["k1_fr"])):
        k1_random_check(f, n, g, device, clock_hz, results)
    # edge operands word for word, and a full-width p (secp256k1's Fq), which
    # takes the 64-bit CIOS form of the multiply
    secp = presets.SECP256K1_FQ
    k1_edges_check(fq, device)
    k1_edges_check(fr, device)
    k1_edges_check(secp, device, tuple(random_elements(secp, SIZES["k1_fr"], g, device)
                                       for _ in range(2)))
    wrapper_us, launcher_us = k1_call_us(fr, device)
    log(f"[k1-call] {K1_CALLS} calls at n = 1, back to back: the wrapper {wrapper_us:.2f} us "
        f"per call, its ctypes launcher alone {launcher_us:.2f} us")
    results["mont_mul_call_us"] = {"wrapper": wrapper_us, "launcher": launcher_us}


def k2_check(f, base_x, base_y, n: int, clock_hz, results):
    """K2 on n lanes with P = Q, P = -Q and infinity lanes (``k2_inputs``)
    against its twin, timed; returns its output."""
    W = limbs.word_count(f)
    p, q, muls = k2_inputs(f, base_x, base_y, n)
    lane = torch.arange(n, device=base_x.device)
    got = cuda_ec.add_xyzz(f, p, q)
    want = cuda_ec.add_xyzz_plain(f, p, q)
    if not bool(mont.is_zero(f, got[2])[lane % 7 == 2].all()):
        raise AssertionError("add_xyzz: P + (-P) is not infinity")
    ms = cuda_ms(lambda: cuda_ec.add_xyzz(f, p, q), 20)
    results.setdefault("add_xyzz_by_width", {})[str(n)] = ms
    check("add_xyzz", got, want, ms,
          cuda_ms(lambda: cuda_ec.add_xyzz_plain(f, p, q), 2), f"4 x ({W}, {n})",
          f"4 x ({W}, {n})", (12 * 4 * W * n, word_products(W) * muls, clock_hz), results,
          word_products(W))
    return got


def k3_check(f, pts, n3: int, clock_hz, results) -> None:
    """K3 on the first n3 lanes of ``pts``, every fifth at infinity (the
    standalone double; Horner's doublings run in the Horner kernel)."""
    W = limbs.word_count(f)
    lane = torch.arange(n3, device=pts[0].device)
    d_in = tuple(mont.select(lane % 5 == 0, torch.zeros_like(t[:, :n3]), t[:, :n3].contiguous())
                 for t in pts)
    got3 = cuda_ec.dbl_xyzz(f, d_in)
    want3 = cuda_ec.dbl_xyzz_plain(f, d_in)
    live3 = int((~mont.is_zero(f, d_in[2])).sum())
    check("dbl_xyzz", got3, want3, cuda_ms(lambda: cuda_ec.dbl_xyzz(f, d_in), 20),
          cuda_ms(lambda: cuda_ec.dbl_xyzz_plain(f, d_in), 2), f"4 x ({W}, {n3})",
          f"4 x ({W}, {n3})", (8 * 4 * W * n3, word_products(W) * 9 * live3, clock_hz), results,
          word_products(W))


def k4_check(f, base_x, base_y, n4: int, g, clock_hz, results) -> None:
    """K4 on n4 lanes: P lifted with zz != 1; lanes by lane % 7: 1 P = Q,
    2 P = -Q, 3 p = inf, 4 q = inf, 5 both inf, else generic."""
    W, device = limbs.word_count(f), base_x.device
    lane4 = torch.arange(n4, device=device)
    ax, ay = tile(base_x, n4), tile(base_y, n4)
    lam = random_elements(f, n4, g, device)
    lam = mont.select(mont.is_zero(f, lam), mont.ones(f, (n4,), device), lam)
    p4 = lifted(f, ax, ay, lam)
    cls4 = lane4 % 7
    qx = mont.select((cls4 == 1) | (cls4 == 2), ax, torch.roll(ax, 1, dims=1))
    qy = mont.select(cls4 == 1, ay, torch.roll(ay, 1, dims=1))
    qy = mont.select(cls4 == 2, mont.neg(f, ay), qy)
    qinf = (cls4 == 4) | (cls4 == 5)
    p4 = tuple(mont.select((cls4 == 3) | (cls4 == 5), torch.zeros_like(t), t) for t in p4)
    del lam, ax, ay
    got4 = cuda_ec.madd_xyzz(f, p4, qx, qy, qinf)
    want4 = cuda_ec.madd_xyzz_plain(f, p4, qx, qy, qinf)
    if not bool(mont.is_zero(f, got4[2])[(cls4 == 2) | (cls4 == 5)].all()):
        raise AssertionError("madd_xyzz: P + (-P) or inf + inf is not infinity")
    if not bool((got4[2][:, cls4 == 3] == mont.ones(f, (1,), device)).all()):
        raise AssertionError("madd_xyzz: inf + Q does not lift Q with zz = mont(1)")
    # 10 multiplies for a mixed add, 2 + 9 where P = Q, 2 where P = -Q
    c4 = torch.bincount(cls4, minlength=7).tolist()
    muls4 = 10 * (c4[0] + c4[6]) + 11 * c4[1] + 2 * c4[2]
    eb = 4 * W  # bytes an element
    check("madd_xyzz", got4, want4, cuda_ms(lambda: cuda_ec.madd_xyzz(f, p4, qx, qy, qinf), 20),
          cuda_ms(lambda: cuda_ec.madd_xyzz_plain(f, p4, qx, qy, qinf), 2),
          f"4 x ({W}, {n4}) + 2 x ({W}, {n4}) + ({n4},)", f"({W}, {n4})",
          ((6 * eb + 4 + 4 * eb) * n4, word_products(W) * muls4, clock_hz), results,
          word_products(W))


def ladder_check(curve, base_x, base_y, nl: int, nchk: int, g, clock_hz, results) -> None:
    """The fused ladder on nl lanes: P = G, but the odd lanes from 8 on take
    base point lane % 256; some lanes with P at infinity, scalars 0, 1 and
    r - 1 in lanes 0-2, the rest random below 2^(bits - 1); its plain twin
    on the first nchk lanes, host ints on lanes 0-15."""
    f, fr, W, device = curve.F.spec, curve.SF.spec, curve.F.W, base_x.device
    gen = curve.generator((nl,))
    lane_l = torch.arange(nl, device=device)
    other = (lane_l % 2 == 1) & (lane_l >= 8)
    px = mont.select(other, tile(base_x, nl), gen.x)
    py = mont.select(other, tile(base_y, nl), gen.y)
    del gen
    sc = random_elements(fr, nl, g, device)
    pinf = (lane_l % 1021 == 5) | (lane_l == 6)
    got_l = cuda_ec.scalar_mul(f, px, py, pinf, sc)
    want_l, plain_l = timed_once(lambda: cuda_ec.scalar_mul_plain(
        f, px[:, :nchk], py[:, :nchk], pinf[:nchk], sc[:, :nchk]))
    nh = 16
    aff = curve.to_affine(PointXYZZ(*(t[:, :nh].contiguous() for t in got_l)))
    ps = zip(curve.F.decode(px[:, :nh]), curve.F.decode(py[:, :nh]))
    ks = limbs.words_to_ints(sc[:, :nh].cpu().numpy().view(np.uint32))
    want_aff = [None if bool(pinf[i]) else host_ec.scalar_mul((int(a), int(b)), k, 0, curve.F.p)
                for i, ((a, b), k) in enumerate(zip(ps, ks))]
    if sampled_points(curve, aff, list(range(nh))) != want_aff:
        raise AssertionError(f"scalar_mul: lanes 0-{nh - 1} (0, 1, r - 1, P = inf, P != G) "
                             f"differ from host ints")
    eb, Ws = 4 * W, sc.shape[0]
    check("scalar_mul_xyzz", tuple(t[:, :nchk] for t in got_l), want_l,
          cuda_ms(lambda: cuda_ec.scalar_mul(f, px, py, pinf, sc), 3), plain_l,
          f"2 x ({W}, {nl}) + ({nl},) + ({Ws}, {nl})", f"({W}, {nchk})",
          ((2 * eb + 4 + 4 * Ws + 4 * eb) * nl, word_products(W) * ladder_muls(sc, pinf),
           clock_hz), results, word_products(W))


def phase_kernels(device, base_x, base_y, clock_hz, results):
    g = torch.Generator(device=device)
    g.manual_seed(SEED)
    curve = curves.bn254_g1(device)
    fq, fr = curve.F.spec, curve.SF.spec

    k1_check(fq, fr, g, device, clock_hz, results)

    # K2 at its remaining main-path width (the naive MSM's first tree level,
    # recorded), then at the former T-gather width at c = 17, 2^17 - 1
    # lanes; with P = Q, P = -Q and infinity lanes
    for n in SIZES["k2"]:
        got = k2_check(fq, base_x, base_y, n, clock_hz, results)
    k3_check(fq, got, SIZES["k3"], clock_hz, results)

    # Horner at the 2^22 MSM's windows and c (recorded), then the 2^18 paths'
    main = horner_check(curve, clock_hz, results, *SIZES["horner"])
    results["horner_loop_ms"], results["horner_chain"] = main["k3_k2_loop_ms"], main["chain"]
    results["horner_2^18"] = horner_check(curve, clock_hz, results, *SIZES["horner_2^18"])

    # K4 on 2^20 lanes (scalar_mul's width in the KZG setup), then the fused
    # ladder at 2^20 lanes (the setup's width)
    k4_check(fq, base_x, base_y, SIZES["k4"], g, clock_hz, results)
    ladder_check(curve, base_x, base_y, *SIZES["ladder"], g, clock_hz, results)

    # K5 at R = 1024, C = 4096 (2^22 points) with infinity lanes; row r of
    # lane c holds base point (c + r) % 256.  Lanes 0-3 hold one point on
    # all rows, with: the top segment all at infinity (the carry doubles D),
    # segment 1 all at infinity (T = D), every row at infinity, and the two
    # top segments with sums equal (the carry doubles).
    R, C, r0, c0 = SIZES["k5"]
    (d1, _), (d2, _) = _blind_points(curve)
    x, y, inf = k5_rows(base_x, base_y, R, C, g, fixed=4)
    dc = tuple(_bcast(d1, (C,)))
    S = cuda_msm.suffix_sweep_plan(fq, x, y, inf, dc).S
    L = -(-R // S)
    top = (S - 1) * L  # first row of the top (ragged) segment
    if S < 3 or R - top < r0:
        raise AssertionError(f"K5 at ({R}, {C}): S = {S} segments of {L} rows, top {R - top}")
    inf[top:, 0, 0] = 1
    inf[L:2 * L, 0, 1] = 1
    inf[:, 0, 2] = 1
    inf[top - L:, 0, 3] = 0
    inf[top - L:top - L + (L - (R - top)), 0, 3] = 1
    suf, seq5, rec = k5_check(fq, x, y, inf, dc, clock_hz, results, c0, reps=3)
    got5 = tuple(t[:, :, :c0] for t in suf)
    if word_err(tuple(t[top:] for t in got5), tuple(t[top:] for t in seq5)) != 0:
        raise AssertionError("suffix_sweep: the top segment's words differ from the sequential twin")
    want_top = cuda_msm.suffix_sweep_plain(fq, x[R - r0:], y[R - r0:], inf[R - r0:], dc)
    if word_err(tuple(t[R - r0:] for t in suf), want_top) != 0:
        raise AssertionError(f"suffix_sweep: the top {r0} rows differ from the sequential twin")
    moved = sum(int((a != b).any(dim=1).sum()) for a, b in zip(got5, seq5))
    log(f"[k5] top segment {R - top} rows; before the redesign {K5_OLD_MS} ms; {moved} "
        f"coordinate rows with other words than the sequential twin's")
    results["suffix_sweep_phases"] = {"S": S, "rows_per_segment": L, "phase_ms": rec["phase_ms"],
                                      "small_shapes": k5_small(fq, base_x, base_y, d1, g,
                                                               clock_hz, results)}

    # K6 at the two main paths' (R2, C2), with its segment sweep, over XYZZ
    # rows cut from the suffix sums; then the lane scan and fold over lanes
    # cut from them
    results["reduce_sweep_segments"] = k6_check(fq, suf, d2, g, clock_hz, results)
    (_, nd1), (_, nd2) = _blind_points(curve)
    for C in SIZES["scan"]:
        lane_check(fq, "lane_suffix_scan", suf, C, tuple(nd1), g, clock_hz, results)
    lane_check(fq, "lane_fold", suf, SIZES["fold"], tuple(nd2), g, clock_hz, results)
    # the bucket kernel at the 2^22 window's shapes (recorded), then at the
    # 2^18 paths' on T rows cut from the same suffix sums
    results["bucket_add_info"] = bucket_check(fq, suf, g, clock_hz, results,
                                              *SIZES["bucket"])[1]
    results["bucket_add_2^18"] = [
        {**rec, **info} for rec, info in
        (bucket_check(fq, tuple(x[:R] for x in suf), g, clock_hz, results, B, C2)
         for R, B, C2 in SIZES["bucket_2^18"])]


def k6_rows(suf, R: int, C: int, L: int, g):
    """K6 rows (R, W, C) cut from K5's suffix sums (XYZZ, zz != 1) with 5%
    infinity holes.  Lane 0: segment 1 (rows L .. 2L - 1) all at infinity,
    so T[1] = D; lane 1: segment 1 holds segment 0's rows, so the combine
    adds two equal partial sums (a double)."""
    hole = torch.rand((R, 1, C), generator=g, device=suf[0].device) < 0.05
    rows = [torch.where(hole, 0, t[:R, :, :C]) for t in suf]
    n1 = min(2 * L, R) - L
    for t in rows:
        t[L:L + n1, :, 0] = 0
        t[L:L + n1, :, 1] = t[:n1, :, 1]
    return tuple(rows)


def k6_work(rows, clock_hz):
    """K6's bytes (rows and D read, the totals written) and the field
    multiplies its live rows need (14 each)."""
    R, W, C = rows[0].shape
    live = int((rows[2] != 0).any(dim=1).sum())  # zz != 0
    return (4 * 4 * W * R * C + 2 * 4 * 4 * W * C, word_products(W) * 14 * live, clock_hz)


def k6_check(f, suf, d2, g, clock_hz, results, shapes=None, sweep=True) -> dict:
    """K6 at each (R, C) of ``shapes`` (SIZES["k6"]) at the segment count it
    picks: word for word against the segmented twin, as points against the
    sequential twin, each phase timed, the chain combine (one thread per
    lane) timed as the tree's rival; then, with ``sweep``, every S of K6_S
    at SIZES["k6_sweep"].  Returns the per-shape numbers."""
    W = suf[0].shape[1]
    sms = torch.cuda.get_device_properties(suf[0].device).multi_processor_count
    lib = _build.library()
    threads = lib.tt_reduce_sweep_threads()
    info = {"shapes": []}
    for R, C in shapes or SIZES["k6"]:
        S = cuda_msm.reduce_segments(R, C, sms, threads)
        L = -(-R // S)
        F = cuda_msm.combine_fan(S, lib.tt_reduce_combine_threads())
        rows = k6_rows(suf, R, C, L, g)
        dc = tuple(_bcast(d2, (C,)))
        got = cuda_msm.reduce_sweep(f, rows, dc)
        want, plain_ms = timed_once(
            lambda: cuda_msm.reduce_sweep_segmented_plain(f, rows, dc, S, F))
        seq = cuda_msm.reduce_sweep_plain(f, rows, dc)
        if not bool(same_points(f, got, seq).all()):
            raise AssertionError(f"reduce_sweep at ({R}, {W}, {C}): totals differ as points "
                                 f"from the sequential twin")
        plan = cuda_msm.reduce_sweep_plan(f, rows, dc)
        phase_ms = [cuda_ms(lambda a=args, nm=name: _build.launch(nm, *a), 20)
                    for name, args in plan.launches]
        chain_ms = None
        if plan.S > 1:  # the chain combine, one thread per lane, as the tree's rival
            chain = cuda_msm.reduce_sweep_plan(f, rows, dc, S, 1)
            cuda_msm.run_plan(chain)
            if not bool(same_points(f, chain.outs, seq).all()):
                raise AssertionError(f"reduce_sweep at ({R}, {W}, {C}): the chain combine's "
                                     f"totals differ as points from the sequential twin")
            combine, combine_args = chain.launches[1]
            chain_ms = cuda_ms(lambda: _build.launch(combine, *combine_args), 20)
        k6_ms = cuda_ms(lambda: cuda_msm.reduce_sweep(f, rows, dc), 20)
        work = k6_work(rows, clock_hz)
        log(f"[k6] ({R}, {W}, {C}): S={plan.S} segments of {L} rows, F={F} "
            f"threads per lane; each launch (partials, then the tree combine) {phase_ms} ms, "
            f"the chain combine {chain_ms} ms; whole {k6_ms:.4f} ms (one thread per lane "
            f"before: {K6_OLD_MS} ms at (256, 8, 512); bound {bound_ms(*work)[0]:.4f} ms); "
            f"equal to the segmented twin word for word, to the sequential twin as points")
        info["shapes"].append({"shape": [R, W, C], "S": plan.S, "phase_ms": phase_ms,
                               "chain_combine_ms": chain_ms, "ms": k6_ms})
        check("reduce_sweep", got, want, k6_ms, plain_ms, f"({R}, {W}, {C})",
              f"({R}, {W}, {C})", work, results, word_products(W))
    # no rows (the last shape's lanes): D itself, with no launch
    n = cuda_msm.reduce_sweep.launches
    if word_err(cuda_msm.reduce_sweep(f, tuple(t[:0] for t in rows), dc), dc) != 0:
        raise AssertionError("reduce_sweep with no rows: the totals are not D")
    if cuda_msm.reduce_sweep.launches != n:
        raise AssertionError("reduce_sweep with no rows launched a kernel")
    if sweep:
        info["sweep"] = [k6_sweep(f, suf, d2, R, C, sms, threads, g)
                         for R, C in SIZES["k6_sweep"]]
    return info


def k6_sweep(f, suf, d2, R: int, C: int, sms: int, threads: int, g) -> dict:
    """K6 at (R, 8, C) at the S it picks and each S of K6_S up to R (64
    only at R >= 256), timed (CUDA events, 20 calls); every S's totals
    equal as points to S = 1's, S = 1's word for word to the sequential
    twin."""
    S0 = cuda_msm.reduce_segments(R, C, sms, threads)
    rows = k6_rows(suf, R, C, -(-R // S0), g)
    dc = tuple(_bcast(d2, (C,)))
    Ss = [S for S in K6_S if S <= R and (S < 64 or R >= 256)]
    plans = [cuda_msm.reduce_sweep_plan(f, rows, dc, S) for S in [S0] + Ss]
    ms = {}
    for plan in plans:
        cuda_msm.run_plan(plan)
        ms.setdefault(plan.S, cuda_ms(lambda plan=plan: cuda_msm.run_plan(plan), 20))
    one = next(p for p in plans if p.S == 1).outs
    if word_err(one, cuda_msm.reduce_sweep_plain(f, rows, dc)) != 0:
        raise AssertionError(f"reduce_sweep at ({R}, {C}), S = 1: words differ from the "
                             f"sequential twin")
    for plan in plans:
        if not bool(same_points(f, plan.outs, one).all()):
            raise AssertionError(f"reduce_sweep at ({R}, {C}): S = {plan.S} and S = 1 differ "
                                 f"as points")
    S = plans[0].S
    log(f"[k6-sweep] ({R}, 8, {C}): picked S={S} {ms[S]:.4f} ms; by S "
        + ", ".join(f"{k}: {v:.4f}" for k, v in sorted(ms.items())))
    return {"shape": [R, 8, C], "S": S, "ms": ms[S],
            "ms_by_S": {str(k): v for k, v in sorted(ms.items())}}


def lane_inputs(f, suf, C: int, g, eq, neg):
    """(W, C) XYZZ lanes cut from row 0 of K5's suffix sums (zz != 1), 5%
    at infinity; lane eq[1] := lane eq[0] and lane neg[1] := -lane neg[0],
    the pairs the kernel's first step adds (a double, a cancel)."""
    hole = torch.rand((C,), generator=g, device=suf[0].device) < 0.05
    hole[[*eq, *neg]] = False
    u = [torch.where(hole, 0, t[0, :, :C]) for t in suf]
    for t in u:
        t[:, eq[1]] = t[:, eq[0]]
        t[:, neg[1]] = t[:, neg[0]]
    u[1][:, neg[1]] = mont.neg(f, u[1][:, neg[0]])
    return tuple(u)


def k2_steps(f, name: str, u):
    """The lane reduction as a loop of K2 launches and lane shifts, the
    path the lane kernels replace (the JAX package's loop on the card)."""
    C = u[0].shape[-1]
    if name == "lane_suffix_scan":
        wk = cuda_ec.shift_lanes(u, 1)
        for i in range(max(C - 1, 0).bit_length()):
            wk = cuda_ec.add_xyzz(f, wk, cuda_ec.shift_lanes(wk, 1 << i))
        return wk
    for i in range(C.bit_length() - 1):
        u = cuda_ec.add_xyzz(f, u, cuda_ec.shift_lanes(u, C >> (i + 1)))
    return tuple(t[:, 0] for t in u)


def lane_adds(name: str, fin: torch.Tensor) -> tuple[int, int]:
    """Adds of two finite points on lanes whose finiteness is ``fin`` (a sum
    counts as finite if a term is: the one cancelling pair aside): those
    the function needs (the finite terms less one, as a serial sum makes
    them) and those the scan's or fold's schedule makes."""
    C = fin.shape[0]
    sched = 0
    if name == "lane_suffix_scan":
        need = max(int(fin[1:].sum()) - 1, 0)  # a serial sum from the top makes every suffix
        fk = torch.cat([fin[1:], fin[:1] & False])
        for i in range(max(C - 1, 0).bit_length()):
            s = min(1 << i, C)
            other = torch.cat([fk[s:], fk[:s] & False])
            sched += int((fk & other).sum())
            fk = fk | other
        return need, sched
    need = max(int(fin.sum()) - 1, 0)
    fk = fin
    while fk.shape[0] > 1:
        half = fk.shape[0] // 2
        sched += int((fk[:half] & fk[half:]).sum())
        fk = fk[:half] | fk[half:]
    return need, sched


def biased_k2_path(f, name: str, u, bias):
    """The lane scan or fold with a bias as K2 launches around the unbiased
    kernel, the path the bias replaces: K2 over the bias broadcast on the
    lanes (u + bias, then for the scan + bias again)."""
    bc = tuple(_bcast(PointXYZZ(*bias), (u[0].shape[-1],)))
    if name == "lane_fold":
        return cuda_ec.lane_fold(f, cuda_ec.add_xyzz(f, u, bc))
    return cuda_ec.add_xyzz(f, cuda_ec.lane_suffix_scan(f, cuda_ec.add_xyzz(f, u, bc)), bc)


def lane_check(f, name: str, suf, C: int, bias, g, clock_hz, results) -> None:
    """The lane scan or fold on C lanes with the blind as its bias (the
    main path's call, recorded), word for word against its plain twin and
    the unbiased kernel between K2 launches, timed beside them;
    then without a bias against its twin and the loop of K2 launches it
    replaces, timed beside that loop."""
    wrapper, _, _ = KERNELS[name]
    W, wp = suf[0].shape[1], word_products(suf[0].shape[1])
    twin = cuda_ec.lane_suffix_scan_plain if name == "lane_suffix_scan" else cuda_ec.lane_fold_plain
    eq, neg = ((10, 11), (20, 21)) if name == "lane_suffix_scan" else ((7, 7 + C // 2),
                                                                        (9, 9 + C // 2))
    u = lane_inputs(f, suf, C, g, eq, neg)
    out_pts = C if name == "lane_suffix_scan" else 1
    fin = ~mont.is_zero(f, u[2])
    adds, sched = lane_adds(name, fin)
    # with the bias: an add in on every finite lane, then every lane is
    # finite, and for the scan an add out on every lane but the last
    # (whose sum is infinity)
    biased_adds = int(fin.sum()) + lane_adds(name, torch.ones_like(fin))[0] + (
        C - 1 if name == "lane_suffix_scan" else 0)
    work = (4 * 4 * W * (C + out_pts + 1), wp * 14 * biased_adds, clock_hz)

    def call(b=None):
        return wrapper(f, u, bias=b)

    got = call(bias)
    if word_err(got, biased_k2_path(f, name, u, bias)) != 0:
        raise AssertionError(f"{name} at C = {C} with a bias: words differ from the unbiased "
                             f"kernel between K2 launches")
    want, plain_ms = timed_once(lambda: twin(f, u, bias))
    k2_path_ms = cuda_ms(lambda: biased_k2_path(f, name, u, bias), 20)
    ms = cuda_ms(lambda: call(bias), 20)
    log(f"[lanes] {name} C={C} with a bias: one launch {ms:.4f} ms, the unbiased kernel "
        f"between K2 launches {k2_path_ms:.4f} ms")
    results.setdefault(f"{name}_k2_path_ms", k2_path_ms)
    check(name, got, want, ms, plain_ms, f"4 x ({W}, {C}) + bias 4 x ({W},)",
          f"4 x ({W}, {C}) + bias 4 x ({W},)", work, results, wp)

    got = call()
    want = twin(f, u)
    if word_err(got, k2_steps(f, name, u)) != 0:
        raise AssertionError(f"{name} at C = {C}: words differ from the K2 loop it replaces")
    steps_ms = cuda_ms(lambda: k2_steps(f, name, u), 20)
    work = (4 * 4 * W * (C + out_pts), wp * 14 * adds, clock_hz)
    ms = cuda_ms(call, 20)
    log(f"[lanes] {name} C={C}: one launch {ms:.4f} ms, the loop of K2 launches and shifts it "
        f"replaces {steps_ms:.4f} ms; {adds} adds of finite points needed, {sched} made in "
        f"its order (bound at those: {bound_ms(work[0], wp * 14 * sched, clock_hz)[0]:.4f} ms)")
    results.setdefault(f"{name}_before_ms", steps_ms)
    results.setdefault(f"{name}_schedule_adds", sched)
    check(name, got, want, ms, cuda_ms(lambda: twin(f, u), 2), f"4 x ({W}, {C})",
          f"4 x ({W}, {C})", work, results, wp)


def add_muls(f, p, q) -> tuple[int, dict]:
    """The field multiplies the complete adds p + q need, lane by lane: 14
    for two finite points, 13 where P = Q (4 to find it, 9 to double), 4
    where P = -Q, none where an input is infinity; and the lanes of each
    case."""
    u1, u2, s1, s2 = (mont.mul(f, a, b) for a, b in ((p[0], q[2]), (q[0], p[2]),
                                                     (p[1], q[3]), (q[1], p[3])))
    same_x, same_y = mont.eq(f, u1, u2), mont.eq(f, s1, s2)
    inf = mont.is_zero(f, p[2]) | mont.is_zero(f, q[2])
    cases = {"infinity_in": int(inf.sum()), "doubles": int((~inf & same_x & same_y).sum()),
             "cancels": int((~inf & same_x & ~same_y).sum())}
    cases["generic"] = int((~inf & ~same_x).sum())
    return 14 * cases["generic"] + 13 * cases["doubles"] + 4 * cases["cancels"], cases


def bucket_inputs(f, suf, g, B: int):
    """The bucket kernel's inputs for B buckets: T, a copy of K5's suffix
    sums (R, W, C); W'' from row 5's lanes; pos, the bucket
    starts of R C sorted digits below B - 64 (the top 63 digits absent:
    pos = R C).  At the first bucket of lane c (row r), by c % 64: 1
    W''[c] = T[r, c] (P = Q), 2 W''[c] = -T[r, c] (P = -Q), 3 W''[c] at
    infinity (every bucket of the lane), 4 T[r, c] at infinity, 5 both."""
    R, W, C = suf[0].shape
    t = tuple(x.clone() for x in suf)
    wpp = [x[5].clone() for x in suf]
    digits = torch.randint(0, B - 64, (R * C,), generator=g, device=suf[0].device,
                           dtype=torch.int32)
    bq = torch.arange(1, B, dtype=torch.int32, device=digits.device)
    pos = torch.searchsorted(torch.sort(digits).values, bq, out_int32=True)
    k = pos[pos < R * C].long()
    new_lane = torch.ones_like(k, dtype=torch.bool)
    new_lane[1:] = k[1:] // R != k[:-1] // R
    r, c = k[new_lane] % R, k[new_lane] // R
    m = [c % 64 == j for j in range(6)]
    for i in range(4):
        wpp[i][:, c[m[1]]] = t[i][r[m[1]], :, c[m[1]]].t()
        opp = t[i][r[m[2]], :, c[m[2]]].t()
        wpp[i][:, c[m[2]]] = mont.neg(f, opp) if i == 1 else opp
        wpp[i][:, c[m[3] | m[5]]] = 0
        t[i][r[m[4] | m[5]], :, c[m[4] | m[5]]] = 0
    return t, tuple(wpp), pos


def bucket_k2_path(f, t, wpp, pos, C2: int):
    """The T-gather add as the bucket kernel's launch replaces it on the
    card: index gathers on the permuted (W, R, C) view of K5's output, a K2
    launch, where, pad, reshape, then the permute into K6's rows."""
    R, W, C = t[0].shape
    valid = pos < R * C
    posc = torch.where(valid, pos, 0)
    tg = tuple(x.permute(1, 0, 2)[:, posc % R, posc // R] for x in t)
    wg = tuple(x[:, posc // R] for x in wpp)
    tv = cuda_ec.add_xyzz(f, tg, wg)
    tv = tuple(torch.where(valid[None], x, 0) for x in tv)
    B = pos.shape[0] + 1
    return tuple(torch.nn.functional.pad(x, (0, 1)).reshape(W, B // C2, C2)
                 .permute(1, 0, 2).contiguous() for x in tv)


def bucket_check(f, suf, g, clock_hz, results, B: int, C2: int) -> tuple[dict, dict]:
    """The bucket kernel for B buckets from K5's rows ``suf`` into rows of
    C2 lanes, word for word against its plain twin and the gathers, K2
    launch and glue it replaces, timed beside them; its bound, and the
    32-byte sectors its loads touch beside the bytes the function needs.
    Returns check's numbers and the rest."""
    R, W, C = suf[0].shape
    t, wpp, pos = bucket_inputs(f, suf, g, B)
    got = cuda_msm.bucket_add(f, t, wpp, pos, C2)
    want, plain_ms = timed_once(lambda: cuda_msm.bucket_add_plain(f, t, wpp, pos, C2))
    if word_err(got, bucket_k2_path(f, t, wpp, pos, C2)) != 0:
        raise AssertionError("bucket_add: words differ from the gathers and K2 it replaces")
    valid = pos < R * C
    k = pos[valid].long()
    r, c = k % R, k // R
    muls, cases = add_muls(f, tuple(x[r, :, c].t() for x in t), tuple(x[:, c] for x in wpp))
    if min(cases.values()) == 0 or int((~valid).sum()) < 63:
        raise AssertionError(f"bucket_add: the inputs miss a case: {cases}, "
                             f"{int((~valid).sum())} absent digits")
    zz = got[2].permute(1, 0, 2).reshape(W, B)
    absent = torch.cat([~valid, torch.ones(1, dtype=torch.bool, device=valid.device)])
    if not bool((zz[:, absent] == 0).all()):
        raise AssertionError("bucket_add: an absent digit or the pad bucket is not infinity")
    # bytes: pos, the T points and W'' lanes the buckets read, the rows out
    t_pts = int(torch.unique(k).numel())
    lanes = int(torch.unique(c).numel())
    nbytes = 4 * (B - 1) + 4 * 4 * W * (t_pts + lanes) + 4 * 4 * W * B
    # the 32-byte sectors of the loads: word i of T[r, :, c] is element
    # (r W + i) C + c of a coordinate, 8 to a sector
    words = (r * W)[None] * C + torch.arange(W, device=k.device)[:, None] * C + c[None]
    sectors = {"t": 4 * int(torch.unique(words // 8).numel()),
               "wpp": 4 * int(torch.unique((torch.arange(W, device=k.device)[:, None] * C
                                            + c[None]) // 8).numel()),
               "pos": -(-4 * (B - 1) // 32), "out": 4 * 4 * W * B // 32}
    ms = cuda_ms(lambda: cuda_msm.bucket_add(f, t, wpp, pos, C2), 20)
    k2_path_ms = cuda_ms(lambda: bucket_k2_path(f, t, wpp, pos, C2), 20)
    work = (nbytes, word_products(W) * muls, clock_hz)
    log(f"[bucket] B={B} buckets from T ({R}, {W}, {C}) into ({B // C2}, {W}, {C2}) rows: one "
        f"launch {ms:.4f} ms, the gathers, K2 and glue it replaces {k2_path_ms:.4f} ms; cases "
        f"{cases}, {int((~valid).sum())} absent digits; {nbytes} bytes needed, the loads touch "
        f"{sectors} 32-byte sectors ({32 * sum(sectors.values())} bytes)")
    shape = f"4 x ({R}, {W}, {C}) + 4 x ({W}, {C}) + ({B - 1},) -> 4 x ({B // C2}, {W}, {C2})"
    rec = check("bucket_add", got, want, ms, plain_ms, shape, shape, work, results,
                word_products(W))
    return rec, {"k2_path_ms": k2_path_ms, "cases": cases, "sectors": sectors,
                 "sector_bytes": 32 * sum(sectors.values())}


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


MSM_PATH = ("mont_mul", "bucket_add", "horner", "suffix_sweep", "reduce_sweep",
            "lane_suffix_scan", "lane_fold")
# the window's blind adds run in the lane kernels, its T-gather add in the
# bucket kernel (once a window)
K2_PER_WINDOW = 0
# madd_xyzz and dbl_xyzz are on neither path: scalar_mul is one ladder
# launch, Horner's doublings run in the Horner kernel.  K2 stays on the KZG
# path in the naive MSMs' tree reduces (64 points: 6 levels, in the commit
# of 64 coefficients and Pedersen's commit) and Pedersen's last add.
KZG_PATH = ("scalar_mul_xyzz", "add_xyzz") + MSM_PATH
KZG_SWEEP_MSMS = 3  # commit, commit_lagrange, open_at; the 64-point MSMs are naive
KZG_K2 = 2 * 6 + 1


def reset_launches() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
        wrapper.launches_by_form = {}


def read_launches(path) -> dict:
    """The launch counts of a main path's run; raise if one of its kernels
    was launched no time."""
    launches = {name: k[0].launches for name, k in KERNELS.items()}
    missing = [name for name in path if launches[name] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    return launches


def affine_ints(curve, aff) -> tuple:
    return int(curve.F.decode(aff.x)), int(curve.F.decode(aff.y))


def verified_msm(curve, name: str, run, expected, path, runs: int) -> dict:
    """``run()`` (an MSM, XYZZ) with every launch count set to 0 just
    before it: its affine point must be on the curve and equal ``expected``
    and every kernel of ``path`` must have launched; then timed ``runs``
    times (CUDA events).  Returns its numbers and launches by instantiation."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    aff = curve.to_affine(run())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches(path)
    by_form = {tag: launches_at(tag) for tag in FORM_TAGS}
    peak = torch.cuda.max_memory_allocated()
    if aff.x.shape != (curve.F.W,) or bool(aff.inf) or not bool(curve.is_on_curve(aff)):
        raise AssertionError(f"{name}: the result is malformed or off the curve")
    if affine_ints(curve, aff) != expected:
        raise AssertionError(f"{name}: {affine_ints(curve, aff)} != host-exact {expected}")
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aff = curve.to_affine(run())
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    if affine_ints(curve, aff) != expected:
        raise AssertionError(f"{name}: the result changed between runs")
    rec = {"first_s": first_s, "runs_s": times, "best_s": min(times, default=first_s),
           "peak_mem_bytes": peak, "launches": launches, "launches_by_form": by_form}
    log(f"[msm] {name} verified=True {json.dumps(rec)}")
    return rec


def phase_slice(device):
    """The MSM at 2^22 through the port's entry points; returns its launches."""
    curve = curves.bn254_g1(device)
    F, SF = curve.F, curve.SF
    n = 1 << LOG_N
    points, scalars, ks, sc = slice_inputs(curve, n)
    t0 = time.perf_counter()
    G = (int(curve.gen_x), int(curve.gen_y))
    expected = host_ec.msm_tiled(G, ks, sc, 0, F.p, SF.p)
    host_s = time.perf_counter() - t0
    del sc
    rec = verified_msm(curve, f"bn254_g1 msm 2^{LOG_N}", lambda: msm(curve, points, scalars),
                       expected, MSM_PATH, MSM_RUNS)
    launches = rec["launches"]
    c = optimal_window_bits(SF.spec.bits, n)
    nwin = -(-SF.spec.bits // c)
    if launches["add_xyzz"] != K2_PER_WINDOW * nwin or launches["bucket_add"] != nwin:
        raise AssertionError(f"K2 launched {launches['add_xyzz']} times and the bucket kernel "
                             f"{launches['bucket_add']} times on {nwin} windows, not "
                             f"{K2_PER_WINDOW} and 1 a window")
    if launches["horner"] != 1 or launches["dbl_xyzz"] != 0:
        raise AssertionError(f"one MSM launched Horner {launches['horner']} times and K3 "
                             f"{launches['dbl_xyzz']} times, not 1 and 0")
    log(f"[slice] bn254_g1 msm+to_affine n=2^{LOG_N} c={c} verified=True "
        f"first_s={rec['first_s']:.4f} runs_s={rec['runs_s']} best_s={rec['best_s']:.4f} "
        f"peak_mem_bytes={rec['peak_mem_bytes']} host_expected_s={host_s:.3f} "
        f"launches={json.dumps(launches)}")
    return launches


def horner(cs, x: int, mod: int) -> int:
    acc = 0
    for c in reversed(cs):
        acc = (acc * x + c) % mod
    return acc


def sampled_points(curve, pts: AffinePoint, idx) -> list:
    """Affine ints of the points at idx (None at infinity)."""
    sel = torch.as_tensor(idx, device=curve.device)
    xs, ys = curve.F.decode(pts.x[:, sel]), curve.F.decode(pts.y[:, sel])
    inf = pts.inf[sel].tolist()
    return [None if i else (int(x), int(y)) for x, y, i in zip(xs, ys, inf)]


def phase_kzg(device):
    """The KZG path at 2^20 through the port's entry points, each step held
    against host ints; returns its launches."""
    g1 = curves.bn254_g1(device)
    Fr, P = g1.SF, g1.F.p
    r = Fr.p
    G = (1, 2)
    n = 1 << KZG_LOG_N
    rng = np.random.default_rng(SEED)
    tau = int.from_bytes(rng.bytes(40), "little") % r
    z = int.from_bytes(rng.bytes(40), "little") % r
    w = rng.integers(0, 1 << 32, size=(Fr.W, n), dtype=np.uint32)
    w[-1] &= (1 << (Fr.spec.bits - 1 - 32 * (Fr.W - 1))) - 1  # below 2^253 < r
    coeffs = limbs.words_to_ints(w)
    coeffs_std = torch.from_numpy(w.view(np.int32)).to(device)
    msgs = [int.from_bytes(rng.bytes(40), "little") % r for _ in range(64)]
    blind = int.from_bytes(rng.bytes(40), "little") % r
    msgs_std = limbs.from_ints(msgs, Fr.W, device)
    steps = {}

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        steps[name] = {"ms": round(start.elapsed_time(end), 4),
                       "host_s": round(time.perf_counter() - t0, 4)}
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    params = timed("unsafe_setup", lambda: kzg.unsafe_setup(n, tau, device))
    coeffs_mont = timed("to_mont", lambda: mont.to_mont(Fr.spec, coeffs_std))
    c_commit = timed("commit", lambda: kzg.to_int_point(kzg.commit(params, coeffs_std)))
    evals_std = timed("fft", lambda: mont.mont_reduce(
        Fr.spec, Radix2Domain(Fr, n).fft(coeffs_mont)))
    c_lagrange = timed("commit_lagrange",
                       lambda: kzg.to_int_point(kzg.commit_lagrange(params, evals_std)))
    proof = timed("open_at", lambda: kzg.open_at(params, coeffs_mont, z))
    c_naive = timed("commit_64_naive",
                    lambda: kzg.to_int_point(kzg.commit(params, coeffs_std[:, :64])))
    ped = timed("pedersen_setup_64",
                lambda: pedersen.setup(g1, 64, np.random.default_rng(SEED + 1)))
    c_ped = timed("pedersen_commit_64",
                  lambda: kzg.to_int_point(pedersen.commit(g1, ped, msgs_std, blind)))
    launches = read_launches(KZG_PATH)
    peak = torch.cuda.max_memory_allocated()
    if launches["horner"] != KZG_SWEEP_MSMS or launches["dbl_xyzz"] != 0:
        raise AssertionError(f"the KZG path launched Horner {launches['horner']} times and K3 "
                             f"{launches['dbl_xyzz']} times, not {KZG_SWEEP_MSMS} and 0")
    if launches["add_xyzz"] != KZG_K2 or launches["bucket_add"] != launches["lane_fold"]:
        raise AssertionError(f"the KZG path launched K2 {launches['add_xyzz']} times (not "
                             f"{KZG_K2}) and the bucket kernel {launches['bucket_add']} times on "
                             f"{launches['lane_fold']} windows")

    t0 = time.perf_counter()
    ok = kzg.verify(params, c_commit, z, proof)
    tampered = kzg.verify(params, c_commit, z, kzg.KZGProof((proof.value + 1) % r, proof.pi))
    verify_s = time.perf_counter() - t0

    # host-exact checks
    t0 = time.perf_counter()
    idx = rng.choice(n, KZG_SAMPLES, replace=False)
    idx[:2] = (0, n - 1)
    omega = Fr.spec.root_of_unity(n)
    z_tau = (pow(tau, n, r) - 1) % r
    want_pow = [host_ec.scalar_mul(G, pow(tau, int(i), r), 0, P) for i in idx]
    want_lag = []
    for i in idx:
        wi = pow(omega, int(i), r)
        li = z_tau * wi * pow(n * (tau - wi) % r, r - 2, r) % r
        want_lag.append(host_ec.scalar_mul(G, li, 0, P))
    if sampled_points(g1, params.g1_powers, idx) != want_pow:
        raise AssertionError("KZG setup: sampled [tau^i]G differ from host ints")
    if sampled_points(g1, params.g1_lagrange, idx) != want_lag:
        raise AssertionError("KZG setup: sampled [L_i(tau)]G differ from host ints")
    want_commit = host_ec.scalar_mul(G, horner(coeffs, tau, r), 0, P)
    if not c_commit == c_lagrange == want_commit:
        raise AssertionError(f"KZG commit {c_commit} / commit_lagrange {c_lagrange} "
                             f"!= [p(tau)]G {want_commit}")
    if proof.value != horner(coeffs, z, r):
        raise AssertionError("KZG open: value != p(z)")
    if ok is not True or tampered is not False:
        raise AssertionError(f"KZG verify: {ok} on the proof, {tampered} on value + 1")
    if c_naive != host_ec.scalar_mul(G, horner(coeffs[:64], tau, r), 0, P):
        raise AssertionError("KZG commit of 64 coefficients (naive MSM) differs from host")
    seeds = np.random.default_rng(SEED + 1)
    s = [int.from_bytes(seeds.bytes(40), "little") % r for _ in range(65)]
    k_ped = (sum(m * si for m, si in zip(msgs, s)) + blind * s[64]) % r
    if c_ped != host_ec.scalar_mul(G, k_ped, 0, P):
        raise AssertionError("Pedersen commit differs from host")
    host_s = time.perf_counter() - t0
    log(f"[kzg] bn254 n=2^{KZG_LOG_N} verified=True srs_samples={2 * KZG_SAMPLES} "
        f"verify_s={verify_s:.3f} host_checks_s={host_s:.3f} peak_mem_bytes={peak} "
        f"steps={json.dumps(steps)} launches={json.dumps(launches)}")
    evals_mont = mont.to_mont(Fr.spec, evals_std)
    polys = [coeffs_mont, evals_mont, Fr.mul(coeffs_mont, evals_mont)]
    mo_launches = multiopen_check(device, params, polys, coeffs)
    return launches, mo_launches


MULTIOPEN_POINT_SETS = ((3, 5), (3, 5), (7,))  # tests/test_multiopen.py's


def multiopen_check(device, params, polys, coeffs) -> dict:
    """SHPlonk and GWC (``crypto/multiopen.py``) over the 2^20 params: the
    three polynomials (Montgomery coefficients; the first is ``coeffs``)
    opened at MULTIOPEN_POINT_SETS, with every launch count set to 0 just
    before; each proof verifies and refuses the first value + 1.  Returns
    the launches."""
    Fr = curves.bn254_fr(device)
    r = Fr.p
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pro, ver = [], []
    for po, pts in zip(polys, MULTIOPEN_POINT_SETS):
        cm = kzg.to_int_point(kzg.commit(params, mont.mont_reduce(Fr.spec, po)))
        vals = tuple(int(Fr.decode(poly.eval_at_fast(Fr, po, pt))) for pt in pts)
        pro.append(multiopen.ProverOpening(po, pts))
        ver.append(multiopen.VerifierOpening(cm, pts, vals))
    torch.cuda.synchronize()
    steps = {"commit_and_evals_s": round(time.perf_counter() - t0, 3)}
    if [horner(coeffs, pt, r) for pt in MULTIOPEN_POINT_SETS[0]] != list(ver[0].values):
        raise AssertionError("multiopen: the device evaluations of p differ from host Horner")
    bad = list(ver)
    bad[0] = multiopen.VerifierOpening(ver[0].commitment, ver[0].points,
                                       ((ver[0].values[0] + 1) % r,) + ver[0].values[1:])
    fr_spec, fq_spec = presets.BN254_FR, presets.BN254_FQ
    for name, cls in (("shplonk", multiopen.SHPlonk), ("gwc", multiopen.GWC)):
        scheme = cls(params)
        w = transcript.TranscriptWriter(fr_spec, fq_spec)
        t0 = time.perf_counter()
        scheme.create_opening_proof(pro, w)
        torch.cuda.synchronize()
        steps[f"{name}_prove_s"] = round(time.perf_counter() - t0, 3)
        proof = bytes(w.proof)
        t0 = time.perf_counter()
        ok = scheme.verify_opening_proof(ver, transcript.TranscriptReader(proof, fr_spec, fq_spec))
        steps[f"{name}_verify_s"] = round(time.perf_counter() - t0, 3)
        tampered = scheme.verify_opening_proof(
            bad, transcript.TranscriptReader(proof, fr_spec, fq_spec))
        if ok is not True or tampered is not False:
            raise AssertionError(f"multiopen {name}: {ok} on the proof, {tampered} on a "
                                 f"tampered value")
        steps[f"{name}_proof_bytes"] = len(proof)
    launches = read_launches(MSM_PATH)
    log(f"[multiopen] shplonk, gwc n=2^{KZG_LOG_N} point_sets={MULTIOPEN_POINT_SETS} "
        f"verified=True tampered_rejected=True steps={json.dumps(steps)} "
        f"launches={json.dumps(launches)}")
    return launches


# the Groth16 prove: four G1 MSMs above 128 points (no naive MSM, so no
# K2), one setup ladder launch for every G1 point of the key; the G2 points
# and the G2 MSM run the generic path, K1 for every base multiply
GROTH16_PATH = ("mont_mul", "scalar_mul_xyzz", "suffix_sweep", "bucket_add", "reduce_sweep",
                "lane_suffix_scan", "lane_fold", "horner")
GROTH16_G1_MSMS = 4  # A, B1, L, H


def cuda_timer(out: dict):
    """A step timer for ``Groth16.prove``: CUDA events and the host clock
    around each step, recorded into out[name]."""
    @contextlib.contextmanager
    def step(name):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        yield
        end.record()
        torch.cuda.synchronize()
        out[name] = {"ms": round(start.elapsed_time(end), 4),
                     "host_s": round(time.perf_counter() - t0, 4)}
    return step


def g2_msm_check(device) -> dict:
    """The G2 MSM alone at n = 2^18: 256 exact multiples [k_i] of the G2
    generator tiled, 254-bit scalars as in bench.py's set; the expected
    point is one host g2_mul.  Returns its time and the host's."""
    g2 = curves.bn254_g2(device)
    n = 1 << GROTH16_LOG_N
    rng = np.random.default_rng(SEED + 2)
    G2 = (tuple(g2.gen_x), tuple(g2.gen_y))
    ks = rng.integers(1, 1 << 30, 256)
    t0 = time.perf_counter()
    base = r1cs._dev_points(g2, [host_ec.g2_mul(G2, int(k)) for k in ks])
    sc = rng.integers(0, 1 << 16, size=(g2.SF.L, n), dtype=np.uint32)
    sc[-1] &= 0x3FFF  # below the scalar modulus
    expected = host_ec.g2_mul(G2, host_ec.tiled_scalar(ks, sc, g2.SF.p))
    host_s = time.perf_counter() - t0
    points = AffinePoint(tile(base.x, n), tile(base.y, n), tile(base.inf[None], n)[0])
    scalars = limbs.from_jax_limbs(sc, device)
    t0 = time.perf_counter()
    aff, ms = timed_once(lambda: g2.to_affine(msm(g2, points, scalars)))
    wall_s = time.perf_counter() - t0
    if aff.x.shape != (2, g2.F.base.W) or not bool(g2.is_on_curve(aff)):
        raise AssertionError("G2 MSM result malformed or off the curve")
    got = r1cs.host_points(g2, AffinePoint(aff.x[..., None], aff.y[..., None], aff.inf[None]))
    if got[0] != expected:
        raise AssertionError(f"G2 MSM at 2^{GROTH16_LOG_N}: {got[0]} != host {expected}")
    return {"n": n, "ms": round(ms, 4), "wall_s": round(wall_s, 4), "host_expected_s": round(host_s, 4)}


def groth16_checks(family: str, device, seed: int) -> float:
    """Phase 6's checks beyond the main path, on a square chain of
    2^GROTH16_CHECK_LOG_N constraints (the main path's prove takes 30-40 s
    at 2^18, nearly all of it the host-bound G2 MSM): a second prove at the
    same r and s gives the same tuple, and a wrong witness's proof fails.
    Returns their seconds."""
    R = r1cs.CURVE_FAMILIES[family]["pairing"].R
    rng = np.random.default_rng(seed)
    x0, r, s, *secrets = (int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1
                          for _ in range(8))
    t0 = time.perf_counter()
    circuit, public, private = circuits.square_chain(1 << GROTH16_CHECK_LOG_N, x0, r=R)
    g16 = r1cs.Groth16(r1cs.setup(circuit, family, rng=iter(secrets).__next__, device=device),
                       device)
    proof = g16.prove(public, private, r=r, s=s)
    if g16.verify(proof, public) is not True or g16.prove(public, private, r=r, s=s) != proof:
        raise AssertionError(f"{family} Groth16 at 2^{GROTH16_CHECK_LOG_N}: the proof does not "
                             "verify, or a second prove at the same r and s gives another tuple")
    bad = list(private)
    bad[0] = (bad[0] + 1) % R  # x_0 * x_0 = x_1 no longer holds
    if g16.verify(g16.prove(public, bad, r=r, s=s), public) is not False:
        raise AssertionError(f"{family} Groth16 at 2^{GROTH16_CHECK_LOG_N}: a wrong witness's "
                             "proof verifies")
    return time.perf_counter() - t0


def phase_groth16(device):
    """The native Groth16 prover at 2^18 constraints through the port's
    entry points (setup, Groth16, prove at fixed r and s, verify), each
    step timed and the proof checked; returns its launches."""
    R = r1cs.pairing.R
    rng = np.random.default_rng(SEED + 3)

    def draw():
        return int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1

    x0, r, s = draw(), draw(), draw()
    secrets = [draw() for _ in range(5)]
    t0 = time.perf_counter()
    circuit, public, private = circuits.square_chain(1 << GROTH16_LOG_N, x0)
    circuit_s = time.perf_counter() - t0
    steps, prove_steps = {}, {}

    def timed(name, fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        steps[name] = {"ms": round(start.elapsed_time(end), 4),
                       "host_s": round(time.perf_counter() - t0, 4)}
        return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    pp = timed("setup", lambda: r1cs.setup(circuit, "bn254", rng=iter(secrets).__next__,
                                           device=device))
    g16 = timed("groth16_init", lambda: r1cs.Groth16(pp, device))
    proof = timed("prove", lambda: g16.prove(public, private, r=r, s=s,
                                             timer=cuda_timer(prove_steps)))
    launches = read_launches(GROTH16_PATH)
    peak = torch.cuda.max_memory_allocated()
    if launches["scalar_mul_xyzz"] != 1 or launches["horner"] != GROTH16_G1_MSMS \
            or launches["add_xyzz"] != 0:
        raise AssertionError(f"the Groth16 path launched the ladder {launches['scalar_mul_xyzz']} "
                             f"times, Horner {launches['horner']} and K2 {launches['add_xyzz']}, "
                             f"not 1, {GROTH16_G1_MSMS} and 0")
    ok = timed("verify", lambda: g16.verify(proof, public))

    # checks, beyond the main path's run
    t0 = time.perf_counter()
    if ok is not True or g16.verify(proof, [(public[0] + 1) % R]) is not False:
        raise AssertionError("Groth16: the proof does not verify, or verifies for output + 1")
    nv = circuit.num_vars
    idx = sorted(set(rng.choice(nv, GROTH16_SAMPLES - 2, replace=False).tolist()) | {0, nv - 1})
    for curve, query in ((g16.g1, pp.a_query), (g16.g2, pp.b2_query)):
        pts = r1cs._dev_points(curve, [query[i] for i in idx])
        if not bool(curve.is_on_curve(pts).all()) or bool(pts.inf.all()):
            raise AssertionError(f"Groth16 setup: sampled {curve.name} query points are off "
                                 f"the curve")
    checks_s = time.perf_counter() - t0
    small_s = groth16_checks("bn254", device, SEED + 11)
    g2_alone = g2_msm_check(device)
    log(f"[groth16] bn254 constraints=2^{GROTH16_LOG_N} domain={pp.n} vars={nv} verified=True "
        f"repeat_equal_and_wrong_witness_rejected_2^{GROTH16_CHECK_LOG_N}_s={small_s:.3f} "
        f"circuit_s={circuit_s:.3f} checks_s={checks_s:.3f} peak_mem_bytes={peak} "
        f"steps={json.dumps(steps)} prove_steps={json.dumps(prove_steps)} "
        f"g2_msm={json.dumps(g2_alone)} launches={json.dumps(launches)}")
    return launches


# the circom prove: four G1 MSMs above 128 points (A, C, H, and B1 at
# nonzero r and s), the G2 MSM on the generic path (K1 for every base
# multiply), the parse's coefficient normalisation and the witness map's
# products and NTTs (K1); no naive MSM (no K2), no ladder (the key writer's
# setup runs before the counts are set to 0)
CIRCOM_PATH = ("mont_mul", "suffix_sweep", "bucket_add", "reduce_sweep", "lane_suffix_scan",
               "lane_fold", "horner")
CIRCOM_G1_MSMS = 4


def circom_case(log_n: int, seed: int, circuit_fn=circuits.square_chain):
    """``circuit_fn``(2^log_n - 2, x_0) (square_chain or bits_chain), which
    its two public-input constraints bring to a domain of 2^log_n, with its
    witness, secrets, r and s from ``seed``."""
    R = r1cs.pairing.R
    rng = np.random.default_rng(seed)
    x0, r, s, *secrets = (int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1
                          for _ in range(8))
    circuit, public, private = circuit_fn((1 << log_n) - 2, x0)
    return circuit, public, private, secrets, r, s


def write_circom_key(tmp: Path, log_n: int, seed: int, device,
                     circuit_fn=circuits.square_chain):
    """Write the key and witness of ``circom_case``; returns the case, the
    native params, the two paths and the writer's seconds."""
    circuit, public, private, secrets, r, s = circom_case(log_n, seed, circuit_fn)
    zpath, wpath = tmp / f"chain_{log_n}.zkey", tmp / f"chain_{log_n}.wtns"
    t0 = time.perf_counter()
    pp = circom_key.write_zkey(zpath, circuit, secrets, device)
    circom_key.write_wtns(wpath, [1] + public + private)
    return (public, private, r, s), pp, zpath, wpath, time.perf_counter() - t0


def phase_circom(device):
    """The circom Groth16 pipeline at a 2^18 domain through the port's entry
    points (parse_zkey, parse_wtns, CircomGroth16Prover, prove at fixed r
    and s, verify) on a key written from known secrets, each step timed and
    the proof checked; then the checks at 2^12.  Returns its launches."""
    R = r1cs.pairing.R
    steps, prove_steps = {}, {}
    step = cuda_timer(steps)
    with tempfile.TemporaryDirectory() as tmp:
        (public, private, r, s), _, zpath, wpath, writer_s = write_circom_key(
            Path(tmp), CIRCOM_LOG_N, SEED + 4, device)
        key_bytes = zpath.stat().st_size
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with step("parse_zkey"):
            zkey = parse_zkey(str(zpath), device)
        with step("parse_wtns"):
            _, wtns = parse_wtns(str(wpath))
        with step("init"):
            pr = prover.CircomGroth16Prover(zkey, device)
        with step("prove"):
            proof = pr.prove(wtns, r=r, s=s, timer=cuda_timer(prove_steps))
        with step("verify"):
            ok = pr.verify(proof, public)
        launches = read_launches(CIRCOM_PATH)
        peak = torch.cuda.max_memory_allocated()
        mmap = mmap_check(zpath, wpath, device)
    log(f"[surfaces-mmap] the mmap parse of the 2^{CIRCOM_LOG_N} key ({key_bytes} bytes) and "
        f"witness equals the Python parse: {json.dumps(mmap)}")
    if launches["horner"] != CIRCOM_G1_MSMS or launches["add_xyzz"] != 0 \
            or launches["scalar_mul_xyzz"] != 0:
        raise AssertionError(f"the circom path launched Horner {launches['horner']} times, K2 "
                             f"{launches['add_xyzz']} and the ladder "
                             f"{launches['scalar_mul_xyzz']}, not {CIRCOM_G1_MSMS}, 0 and 0")
    if prover.public_inputs(zkey, wtns) != public or zkey.domain_size != 1 << CIRCOM_LOG_N:
        raise AssertionError("circom: the parsed key or witness is not the written one")
    if ok is not True or pr.verify(proof, [(public[0] + 1) % R]) is not False:
        raise AssertionError("circom: the proof does not verify, or verifies for output + 1")
    del pr, zkey, wtns
    torch.cuda.empty_cache()

    # at 2^12, on the bit chain (segments of 1, 3, 5 and 254 terms): a
    # repeat, a wrong witness, the native prover on the same setup
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        (pub2, priv2, r2, s2), pp, zpath, wpath, _ = write_circom_key(
            Path(tmp), CIRCOM_CHECK_LOG_N, SEED + 5, device, circuits.bits_chain)
        small = prover.CircomGroth16Prover(parse_zkey(str(zpath), device), device)
        _, w2 = parse_wtns(str(wpath))
    got = small.prove(w2, r=r2, s=s2)
    if small.verify(got, pub2) is not True or small.prove(w2, r=r2, s=s2) != got:
        raise AssertionError(f"circom at 2^{CIRCOM_CHECK_LOG_N}: the proof does not verify, "
                             "or a repeat gives another tuple")
    bad = w2.clone()
    bad[:, 2] = limbs.from_ints([priv2[0] + 1], w2.shape[0])[:, 0]  # b_0 + 1: the bit sum breaks
    if small.verify(small.prove(bad, r=r2, s=s2), pub2) is not False:
        raise AssertionError(f"circom at 2^{CIRCOM_CHECK_LOG_N}: a wrong witness's proof verifies")
    if small.verify(small.prove(w2, deterministic=True), pub2) is not True:
        raise AssertionError(f"circom at 2^{CIRCOM_CHECK_LOG_N}: the deterministic proof does "
                             "not verify")
    native = r1cs.Groth16(pp, device).prove(pub2, priv2, r=r2, s=s2)
    if tuple(native) != tuple(got):
        raise AssertionError(f"circom at 2^{CIRCOM_CHECK_LOG_N}: the tuple differs from the "
                             "native prover's on the same setup")
    checks_s = time.perf_counter() - t0
    log(f"[circom] bn254 domain=2^{CIRCOM_LOG_N} vars={len(public) + len(private) + 1} "
        f"verified=True writer_s={writer_s:.3f} key_bytes={key_bytes} "
        f"checks_2^{CIRCOM_CHECK_LOG_N}_s={checks_s:.3f} peak_mem_bytes={peak} "
        f"steps={json.dumps(steps)} prove_steps={json.dumps(prove_steps)} "
        f"launches={json.dumps(launches)}")
    return launches


# the STARK path's one kernel: every BabyBear multiply (Poseidon2's S-boxes
# and internal matrix, the NTTs, the extension ops, the folds) is K1 at W = 1
STARK_PATH = ("mont_mul_w1",)
K1_W1_PRODUCTS = 3  # word products of a one-word Montgomery multiply (2 W^2 + W)


def k1_w1_check(g, device, clock_hz, results) -> None:
    """K1 at W = 1: BabyBear at (1, 2^24) and with broadcast operands
    against its twin, timed beside its bound; KoalaBear and Mersenne-31 on
    edge operands; its host cost per call."""
    f, n = presets.BABY_BEAR, SIZES["k1_w1"]
    a, b = random_elements(f, n, g, device), random_elements(f, n, g, device)
    a[:, 3:6] = b[:, 3:6]  # some squares
    got, want = cuda_mont.mul(f, a, b), cuda_mont.mul_plain(f, a, b)
    torch.cuda.synchronize()
    check("mont_mul_w1", (got,), (want,), cuda_ms(lambda: cuda_mont.mul(f, a, b), 20),
          cuda_ms(lambda: cuda_mont.mul_plain(f, a, b), 2), f"{f.name} (1, {n})",
          f"{f.name} (1, {n})", (12 * n, K1_W1_PRODUCTS * n, clock_hz), results,
          per_mul=K1_W1_PRODUCTS)
    del got, want
    # b read in place: a weight per column, a constant per Poseidon2 lane
    for a_shape, b_shape in (((1, n // 16, 16), (1, 1, 16)), ((1, 16, n // 16), (1, 16, 1))):
        x = a.reshape(a_shape)
        y = b[:, :b_shape[1] * b_shape[2]].reshape(b_shape)
        err = word_err((cuda_mont.mul(f, x, y),), (cuda_mont.mul_plain(f, x, y),))
        ms = cuda_ms(lambda: cuda_mont.mul(f, x, y), 20)
        full = y.expand(a_shape).contiguous()
        ms_full = cuda_ms(lambda: cuda_mont.mul(f, x, full), 20)
        bms, by = bound_ms(8 * n + 4 * y.numel(), K1_W1_PRODUCTS * n, clock_hz)
        log(f"[k1-w1-broadcast] {a_shape} x {b_shape}: max_abs_err {err}; {ms:.4f} ms, "
            f"{ms_full:.4f} ms with b expanded; bound {bms:.4f} ms ({by})")
        if err:
            raise AssertionError(f"mont_mul_w1: the broadcast {b_shape} differs from the twin")
        results.setdefault("mont_mul_w1_broadcast", []).append(
            {"shape": [list(a_shape), list(b_shape)], "ms": ms, "expanded_ms": ms_full,
             "bound_ms": bms, "bound_by": by})
    for f in (presets.BABY_BEAR, presets.KOALA_BEAR, presets.MERSENNE31):
        a, b = k1_edges(f, device)
        a = torch.cat([a, random_elements(f, SIZES["k1_fr"], g, device)], 1)
        b = torch.cat([b, random_elements(f, SIZES["k1_fr"], g, device)], 1)
        err = word_err((cuda_mont.mul(f, a, b),), (cuda_mont.mul_plain(f, a, b),))
        log(f"[k1-w1-edges] {f.name}: {a.shape[1]} products (0, 1, mont(1), 2, p - 1 pairwise, "
            f"then random) max_abs_err {err}")
        if err:
            raise AssertionError(f"mont_mul_w1: {f.name} differs from the plain twin")
    wrapper_us, launcher_us = k1_call_us(presets.BABY_BEAR, device)
    log(f"[k1-w1-call] {K1_CALLS} calls at n = 1, back to back: the wrapper {wrapper_us:.2f} "
        f"us per call, its ctypes launcher alone {launcher_us:.2f} us")
    results["mont_mul_w1_call_us"] = {"wrapper": wrapper_us, "launcher": launcher_us}


def host_leaf(h, row: list) -> list:
    """The Merkle leaf digest of one row on host ints: the rate-8 sponge."""
    st = [0] * h.t
    for off in range(0, len(row), 8):
        chunk = row[off:off + 8]
        st[:len(chunk)] = chunk
        st = h.permute_host(st)
    return st[:8]


def poseidon2_check(device) -> dict:
    """baby_bear_p3_w16 on 2^POSEIDON2_LOG_STATES states from SEED, timed;
    POSEIDON2_SAMPLES sampled states equal to permute_host."""
    h = poseidon2.baby_bear_p3_w16(device)
    F = h.F
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 7)
    n = 1 << POSEIDON2_LOG_STATES
    vals = torch.randint(0, F.p, (h.t, n), generator=g, device=device)
    st = F.encode_canonical(vals)
    out, first_ms = timed_once(lambda: h.permute(st))
    ms = cuda_ms(lambda: h.permute(st), 3)
    idx = torch.randint(0, n, (POSEIDON2_SAMPLES,), generator=g, device=device)
    ins = vals[:, idx].T.tolist()
    outs = [[int(v) for v in col] for col in F.decode(out[:, :, idx]).T]
    bad = sum(h.permute_host(x) != y for x, y in zip(ins, outs))
    if bad:
        raise AssertionError(f"Poseidon2: {bad} of {POSEIDON2_SAMPLES} sampled states differ "
                             "from permute_host")
    return {"states": n, "first_ms": round(first_ms, 4), "ms": round(ms, 4),
            "ns_per_state": round(ms * 1e6 / n, 3), "sampled": POSEIDON2_SAMPLES}


def fib_trace_mod_p(n: int, p: int) -> tuple[torch.Tensor, list]:
    """The (n, 2) Fibonacci trace from (0, 1) mod p and its public values."""
    rows = np.empty((n, 2), dtype=np.int64)
    a, b = 0, 1
    for i in range(n):
        rows[i] = a, b
        a, b = b, (a + b) % p
    return torch.from_numpy(rows), [0, 1, int(rows[-1, 1])]


def stark_pcs_inputs(device, log_n: int = None):
    """The PCS of the STARK path (BabyBear, baby_bear4, baby_bear_p3_w16,
    STARK_FRI) and its STARK_ROUNDS matrices of 2^log_n x STARK_COLS
    canonical values, made on the device from SEED."""
    F = PrimeField(presets.BABY_BEAR, device)
    h = poseidon2.baby_bear_p3_w16(device)
    pcs = TwoAdicFRIPCS(F, extensions.baby_bear4(device), h, FRIConfig(*STARK_FRI))
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 8)
    n = 1 << (STARK_LOG_N if log_n is None else log_n)
    return pcs, [F.encode_canonical(torch.randint(0, F.p, (n, STARK_COLS), generator=g,
                                                  device=device))
                 for _ in range(STARK_ROUNDS)]


def pcs_challenger(h, roots):
    """A rate-8 transcript that has observed the roots, and its zeta."""
    ch = DuplexChallenger(h, rate=8)
    for root in roots:
        ch.observe_many(int(v) for v in h.F.decode(root))
    return ch, ch.sample_ext(4)


def pcs_path(pcs, mats, step=None):
    """The PCS's main path: commit each round, observe the roots, open
    every round at one sampled extension point, verify; each step inside
    ``step(name)`` (a timer) where one is given."""
    step = step or (lambda name: contextlib.nullcontext())
    datas = []
    for r, m in enumerate(mats):
        with step(f"commit_{r}"):
            datas.append(pcs.commit([m]))
    roots = [d.root() for d in datas]
    with step("observe"):
        ch, zeta = pcs_challenger(pcs.h, roots)
    points = [[[zeta]]] * len(mats)
    with step("open"):
        opened, proof = pcs.create_opening_proof(datas, points, ch)
    dims = [[tuple(m.shape[1:])] for m in mats]
    with step("verify"):
        ok = pcs.verify_opening_proof(roots, dims, points, opened, proof,
                                      pcs_challenger(pcs.h, roots)[0])
    return datas, roots, points, dims, opened, proof, ok


def stark_air_inputs(device, log_n: int = None):
    """The Fibonacci uni-STARK over the STARK path's PCS, its 2^log_n trace
    (canonical values) and public values."""
    h = poseidon2.baby_bear_p3_w16(device)
    pcs = TwoAdicFRIPCS(h.F, extensions.baby_bear4(device), h, FRIConfig(*STARK_FRI))
    trace, pubs = fib_trace_mod_p(1 << (STARK_LOG_N if log_n is None else log_n), h.F.p)
    return UniStark(pcs, fib_air(air_expr)), trace, pubs


QUOTIENT_SAMPLES = 8  # get_evaluations_on_domain values checked on the host


def pow_mod_vec(x: np.ndarray, e: int, p: int) -> np.ndarray:
    """x^e mod p elementwise, int64, for p < 2^31 (products below 2^62)."""
    acc = np.ones_like(x)
    while e:
        if e & 1:
            acc = acc * x % p
        x = x * x % p
        e >>= 1
    return acc


def interpolant_at(vals: np.ndarray, x: int, w: int, p: int) -> int:
    """The value at x, off H, of the polynomial of degree < n with values
    vals (int64, canonical) on H = <w>, n = len(vals) a power of two:
    (x^n - 1) / n * sum_j vals_j w^j / (x - w^j), in int64 numpy (p < 2^31)."""
    n = len(vals)
    lo_n = min(n, 1024)
    lo = np.array([pow(w, j, p) for j in range(lo_n)], dtype=np.int64)
    hi = np.array([pow(w, lo_n * j, p) for j in range(n // lo_n)], dtype=np.int64)
    wj = (hi[:, None] * lo[None, :] % p).reshape(-1)  # w^j, j = i lo_n + l
    inv = pow_mod_vec((x - wj) % p, p - 2, p)
    s = int(((vals * wj % p) * inv % p).sum()) % p
    return (pow(x, n, p) - 1) * pow(n, p - 2, p) % p * s % p


def quotient_domain_check(pcs, data, mat, device) -> dict:
    """get_evaluations_on_domain on a committed (1, n, C) BabyBear matrix at
    size n, timed: QUOTIENT_SAMPLES sampled values against host evaluations
    of the column's interpolant (from the matrix's values on H) at g w_n^k."""
    F, n = pcs.F, mat.shape[1]
    ev, ms = timed_once(lambda: pcs.get_evaluations_on_domain(data, 0, n))
    if tuple(ev.shape) != tuple(mat.shape):
        raise AssertionError(f"get_evaluations_on_domain: shape {tuple(ev.shape)}")
    rng = np.random.default_rng(SEED + 16)
    ks = rng.integers(0, n, QUOTIENT_SAMPLES).tolist()
    cs = rng.integers(0, mat.shape[2], QUOTIENT_SAMPLES).tolist()
    p, g, w = F.p, F.spec.generator, F.spec.root_of_unity(n)
    got = F.to_canonical(ev[:, ks, cs]).tolist()
    for k, c, v in zip(ks, cs, got):
        col = F.to_canonical(mat[:, :, c]).cpu().numpy().astype(np.int64)
        if v != interpolant_at(col, g * pow(w, k, p) % p, w, p):
            raise AssertionError(f"get_evaluations_on_domain: row {k} column {c} differs from "
                                 "the interpolant on the coset")
    return {"size": n, "ms": round(ms, 4), "sampled": QUOTIENT_SAMPLES}


def phase_stark(device, clock_hz, results):
    """Phase 8: K1 at W = 1, Poseidon2 and the pinned transcript on the card,
    then the PCS and the uni-STARK through the port's entry points, each
    step timed and checked.  Returns the two runs' launches, summed."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 6)
    k1_w1_check(g, device, clock_hz, results)
    perm = poseidon2_check(device)
    log(f"[poseidon2] baby_bear_p3_w16 {json.dumps(perm)}")
    t0 = time.perf_counter()
    if fri_pinned.artifacts(device) != json.loads(fri_pinned.FIXTURE.read_text()):
        raise AssertionError("the pinned FRI transcript on the card differs from "
                             "tests/fixtures/fri_babybear_pinned.json")
    log(f"[fri-pinned] every artifact equals the fixture ({time.perf_counter() - t0:.2f} s)")

    pcs, mats = stark_pcs_inputs(device)
    F, h, cfg = pcs.F, pcs.h, pcs.cfg
    n, C = 1 << STARK_LOG_N, STARK_COLS
    steps: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    datas, roots, points, dims, opened, proof, ok = pcs_path(pcs, mats, cuda_timer(steps))
    pcs_launches = read_launches(STARK_PATH)
    pcs_peak = torch.cuda.max_memory_allocated()
    pcs_s = sum(v["host_s"] for v in steps.values())

    # checks, beyond the main path's run
    t0 = time.perf_counter()
    bad_val = opened[0][0][0].clone()
    bad_val[0, 0, 0] = (bad_val[0, 0, 0] + 1) % F.p
    tampered = (((bad_val,),),) + tuple(opened[1:])
    if ok is not True or pcs.verify_opening_proof(roots, dims, points, tampered, proof,
                                                  pcs_challenger(h, roots)[0]) is not False:
        raise AssertionError("PCS: the proof does not verify, or verifies a tampered value")
    rng = np.random.default_rng(SEED + 8)
    leaves = sorted(rng.choice(n << cfg.log_blowup, STARK_LEAVES, replace=False).tolist())
    lidx = torch.tensor(leaves, device=device)
    for r, d in enumerate(datas):
        rows = F.decode(d.ldes[0].index_select(1, lidx))  # (STARK_LEAVES, C)
        digests = F.decode(d.tree.digest_layers[0].index_select(2, lidx))  # (8, STARK_LEAVES)
        for j in range(STARK_LEAVES):
            if host_leaf(h, [int(v) for v in rows[j]]) != [int(v) for v in digests[:, j]]:
                raise AssertionError(f"PCS round {r}: leaf {leaves[j]}'s digest differs from "
                                     "its host hash")
    quotient = quotient_domain_check(pcs, datas[0], mats[0], device)
    checks_s = time.perf_counter() - t0
    log(f"[stark-quotient] get_evaluations_on_domain(round 0, 2^{STARK_LOG_N}) "
        f"{json.dumps(quotient)}")
    log(f"[stark-pcs] baby_bear rounds={STARK_ROUNDS} rows=2^{STARK_LOG_N} cols={C} "
        f"fri={json.dumps(dataclasses.asdict(cfg))} verified=True tampered_rejected=True "
        f"leaves_checked={STARK_LEAVES * STARK_ROUNDS} "
        f"pcs_s={pcs_s:.3f} checks_s={checks_s:.3f} peak_mem_bytes={pcs_peak} "
        f"pow_witness={proof.pow_witness} steps={json.dumps(steps)} "
        f"launches={json.dumps(pcs_launches)}")
    results["stark_pcs"] = {"steps": steps, "pcs_s": pcs_s, "peak_mem_bytes": pcs_peak,
                            "quotient_domain": quotient}
    del datas, opened, proof, mats, roots, tampered, bad_val

    # the Fibonacci uni-STARK at 2^STARK_LOG_N
    t0 = time.perf_counter()
    stark, trace, pubs = stark_air_inputs(device)
    trace_s = time.perf_counter() - t0
    air_steps: dict = {}
    step = cuda_timer(air_steps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with step("prove"):
        sp = stark.prove(trace, pubs, DuplexChallenger(h, rate=8))
    with step("verify"):
        ok = stark.verify(sp, pubs, DuplexChallenger(h, rate=8))
    air_launches = read_launches(STARK_PATH)
    air_peak = torch.cuda.max_memory_allocated()
    wrong = pubs[:2] + [(pubs[2] + 1) % F.p]
    if ok is not True or stark.verify(sp, wrong, DuplexChallenger(h, rate=8)) is not False:
        raise AssertionError("uni-STARK: the proof does not verify, or verifies for output + 1")
    log(f"[stark-air] fibonacci n=2^{STARK_LOG_N} verified=True wrong_public_rejected=True "
        f"trace_s={trace_s:.3f} peak_mem_bytes={air_peak} steps={json.dumps(air_steps)} "
        f"launches={json.dumps(air_launches)}")
    results["stark_air"] = {"steps": air_steps, "peak_mem_bytes": air_peak}
    return {k: pcs_launches[k] + air_launches[k] for k in pcs_launches}



# phase 9, the BLS12-381 path: the native Groth16 prover over BLS12-381 (Fq of
# 381 bits, 12 words; Fr of 255 bits, 8 words) on a square chain of
# 2^BLS_LOG_N constraints, the domain of a Zcash Sapling Spend circuit (~100k
# constraints); the W = 12 kernels checked at its shapes first
BLS_LOG_N = 17
BLS_SAMPLES = 64  # a_query and b2_query points checked on their curves
BLS_SIZES = {
    "k1": 1 << 22,              # K1 elements of Fq
    "point": 1 << 20,           # K2, K3 and K4 lanes (standalone, off the path)
    "ladder": (1 << 19, 1024),  # the setup's G1 ladder (~4 x 2^17 points), its twin's lanes
    # K5's (R, C): A and B1 (2^17 + 2 points), then L and H (2^17 and 2^17 - 1)
    "k5": ((33, 4096), (32, 4096)),
    "k6": ((16, 512),),         # K6's (R2, C2): 2^13 buckets of c = 13 over 512 lanes
    "scan": 4096,               # the lane scan's C, the fold's C2
    "fold": 512,
    "bucket": (1 << 13, 512),   # B = 2^c and C2
    "horner": (20, 13),         # windows and c of a 2^17-point MSM of 255-bit scalars
}
# the kernels of every instantiation, by JSON name, registers by their
# ptxas names and template arguments: W and the multiply's form (1 for the
# spare-bit chains, 0 for the 64-bit CIOS)
DEVICE_KERNELS = {
    "mont_mul": ["mont_mul_kernel<{W},{spare}>"],
    "mont_mul_w1": ["mont_mul1_kernel<0>", "mont_mul1_kernel<1>"],
    "mont_mul_w2": ["mont_mul2_kernel<0>", "mont_mul2_kernel<1>"],
    "add_xyzz": ["add_xyzz_kernel<{W},{spare}>"], "dbl_xyzz": ["dbl_xyzz_kernel<{W},{spare}>"],
    "madd_xyzz": ["madd_xyzz_kernel<{W},{spare}>"],
    "scalar_mul_xyzz": ["scalar_mul_xyzz_kernel<{W},{spare}>"],
    "suffix_sweep": ["suffix_totals_kernel<{W},{spare}>", "suffix_carries_kernel<{W},{spare}>",
                     "suffix_emit_kernel<{W},{spare}>"],
    "reduce_sweep": ["reduce_partials_kernel<{W},{spare}>",
                     "reduce_combine_kernel<{W},{spare}>"],
    "lane_suffix_scan": ["lane_suffix_scan_kernel<{W},{spare}>"],
    "lane_fold": ["lane_fold_kernel<{W},{spare}>"],
    "horner": ["horner_xyzz_kernel<{W},{spare}>"],
    "bucket_add": ["bucket_add_kernel<{W},{spare}>"],
}


def width_kernels(curve, sizes, seed: int, clock_hz, results) -> dict:
    """Every kernel's instantiation for ``curve``'s field against its plain
    twin on the card, word for word, at ``sizes`` (BLS_SIZES, SECP_SIZES:
    a path's shapes), timed beside its bound at 2 W^2 + W word products a
    field multiply; K1 also on edge operands and on the scalar field, K5
    also as points against the sequential twin (on the first c0 lanes where
    a K5 shape gives a third number).  Returns the extra numbers of the
    JSON entries."""
    device = curve.device
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    fq = curve.F.spec
    _, base_x, base_y = base_points(curve, np.random.default_rng(seed))
    extra = {}

    k1_random_check(fq, sizes["k1"], g, device, clock_hz, results)
    k1_edges_check(fq, device)
    k1_edges_check(curve.SF.spec, device)

    got = k2_check(fq, base_x, base_y, sizes["point"], clock_hz, results)
    k3_check(fq, got, sizes["point"], clock_hz, results)
    del got
    k4_check(fq, base_x, base_y, sizes["point"], g, clock_hz, results)
    ladder_check(curve, base_x, base_y, *sizes["ladder"], g, clock_hz, results)

    (d1, nd1), (d2, nd2) = _blind_points(curve)
    shapes = []
    for R, C, *c0 in sizes["k5"]:
        suf, _, rec = k5_check(fq, *k5_rows(base_x, base_y, R, C, g), tuple(_bcast(d1, (C,))),
                               clock_hz, results, *c0, reps=3 if c0 else 20)
        shapes.append(rec)
    extra["suffix_sweep"] = {"shapes": shapes}
    extra["reduce_sweep"] = k6_check(fq, suf, d2, g, clock_hz, results, sizes["k6"],
                                     sweep=False)
    lane_check(fq, "lane_suffix_scan", suf, sizes["scan"], tuple(nd1), g, clock_hz, results)
    lane_check(fq, "lane_fold", suf, sizes["fold"], tuple(nd2), g, clock_hz, results)
    extra["bucket_add"] = bucket_check(fq, suf, g, clock_hz, results, *sizes["bucket"])[1]
    hr = horner_check(curve, clock_hz, results, *sizes["horner"])
    extra["horner"] = {"k3_k2_loop_ms": hr["k3_k2_loop_ms"], "chain": hr["chain"]}
    return extra


FORM_TAGS = ("w1_full", "w2_full", "w8_spare", "w8_full", "w12_full")  # every cuda_mont.Form.tag


def launches_at(tag: str) -> dict:
    """Each kernel's launches at one instantiation (``cuda_mont.Form.tag``:
    w8_spare, w8_full, w12_full, w1_full, w2_full) since the counts were set to 0."""
    return {name: k[0].launches_by_form.get(tag, 0) for name, k in KERNELS.items()}


def phase_groth16_bls12(device, clock_hz, results):
    """Phase 9: the W = 12 kernels against their twins (``width_kernels``),
    then the native Groth16 prover over BLS12-381 at 2^BLS_LOG_N
    constraints through the port's entry points (setup, Groth16, prove at
    fixed r and s, verify), each step timed and the proof checked.  Returns
    the extra kernel numbers and the path's launches by instantiation."""
    extra = width_kernels(curves.bls12_381_g1(device), BLS_SIZES, SEED + 9, clock_hz, results)
    R = r1cs.pairing_bls12_381.R
    rng = np.random.default_rng(SEED + 10)

    def draw():
        return int.from_bytes(rng.bytes(40), "little") % (R - 1) + 1

    x0, r, s = draw(), draw(), draw()
    secrets = [draw() for _ in range(5)]
    t0 = time.perf_counter()
    circuit, public, private = circuits.square_chain(1 << BLS_LOG_N, x0, r=R)
    circuit_s = time.perf_counter() - t0
    steps, prove_steps = {}, {}
    step = cuda_timer(steps)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with step("setup"):
        pp = r1cs.setup(circuit, "bls12_381", rng=iter(secrets).__next__, device=device)
    with step("groth16_init"):
        g16 = r1cs.Groth16(pp, device)
    with step("prove"):
        proof = g16.prove(public, private, r=r, s=s, timer=cuda_timer(prove_steps))
    launches = read_launches(GROTH16_PATH)
    by_form = {tag: launches_at(tag) for tag in FORM_TAGS}
    peak = torch.cuda.max_memory_allocated()
    w12 = by_form["w12_full"]
    if w12["scalar_mul_xyzz"] != 1 or w12["horner"] != GROTH16_G1_MSMS \
            or launches["add_xyzz"] != 0 or w12["mont_mul"] == 0 \
            or any(w12[name] != launches[name] for name in GROTH16_PATH if name != "mont_mul"):
        raise AssertionError(f"the BLS12-381 path's launches at W = 12 {w12} (all {launches}): "
                             f"not the ladder once, Horner {GROTH16_G1_MSMS} times, K2 never")
    with step("verify"):
        ok = g16.verify(proof, public)

    # checks, beyond the main path's run
    t0 = time.perf_counter()
    if ok is not True or g16.verify(proof, [(public[0] + 1) % R]) is not False:
        raise AssertionError("BLS12-381 Groth16: the proof does not verify, or verifies for "
                             "output + 1")
    if g16.prove(public, private, r=r, s=s) != proof:
        raise AssertionError("BLS12-381 Groth16: a second prove at the same r and s gives "
                             "another tuple")
    bad = list(private)
    bad[0] = (bad[0] + 1) % R  # x_0 * x_0 = x_1 no longer holds
    if g16.verify(g16.prove(public, bad, r=r, s=s), public) is not False:
        raise AssertionError("BLS12-381 Groth16: a wrong witness's proof verifies")
    nv = circuit.num_vars
    idx = sorted(set(rng.choice(nv, BLS_SAMPLES - 2, replace=False).tolist()) | {0, nv - 1})
    for curve, query in ((g16.g1, pp.a_query), (g16.g2, pp.b2_query)):
        pts = r1cs._dev_points(curve, [query[i] for i in idx])
        if not bool(curve.is_on_curve(pts).all()) or bool(pts.inf.all()):
            raise AssertionError(f"BLS12-381 Groth16 setup: sampled {curve.name} query points "
                                 f"are off the curve")
    checks_s = time.perf_counter() - t0
    log(f"[groth16-bls12] bls12_381 constraints=2^{BLS_LOG_N} domain={pp.n} vars={nv} "
        f"verified=True wrong_public_rejected=True repeat_equal=True wrong_witness_rejected=True "
        f"circuit_s={circuit_s:.3f} checks_s={checks_s:.3f} peak_mem_bytes={peak} "
        f"steps={json.dumps(steps)} prove_steps={json.dumps(prove_steps)} "
        f"launches={json.dumps(launches)} launches_by_form={json.dumps(by_form)}")
    results["groth16_bls12_381"] = {"steps": steps, "prove_steps": prove_steps,
                                    "peak_mem_bytes": peak}
    return extra, by_form


# phase 10, the secp256k1 path: the variable-base MSM over secp256k1 (a batch
# verification of ECDSA or BIP-340 signatures is a sum of 2n multiples: 2^22
# points for 2^21 signatures) on the full-width kernels (W = 8, the 64-bit
# CIOS), each checked at the MSM's shapes first; the naive MSM of a batch of
# 64 signatures (128 points); GLV at 2^20 scalars (2^21 points of 130
# bits); FixedBaseMSM on G (a batch of nonce commitments k_i G) at 2^20; and
# the 2^20 MSM over Pallas and over Vesta, which take the spare-bit kernels
SECP_LOG_N = 22
SECP_NAIVE_N = 128
SECP_GLV_LOG_N = 20
SECP_FIXED = (20, 8, 64)  # log2 of the scalars, c, results checked against host ints
PASTA_LOG_N = 20
SECP_RUNS = 3  # timed runs of each 2^20 MSM after the checked one
SECP_SIZES = {
    "k1": 1 << 22,              # K1 elements of Fq
    "point": 1 << 20,           # K2, K3 and K4 lanes
    "ladder": (1 << 20, 4096),  # the ladder's lanes, its twin's lanes
    "k5": ((1024, 4096, 256),),  # K5's (R, C) at 2^22 (c = 17), lanes of its twins
    "k6": ((256, 512),),        # K6's (R2, C2): 2^17 buckets over 512 lanes
    "scan": 4096,               # the lane scan's C, the fold's C2
    "fold": 512,
    "bucket": (1 << 17, 512),   # B = 2^c and C2
    "horner": (16, 17),         # windows and c of 256-bit scalars at c = 17
}
FULL_PATH = ("suffix_sweep", "reduce_sweep", "bucket_add", "lane_suffix_scan", "lane_fold",
             "horner")


def scalar_limbs(order: int, L: int, n: int, rng) -> np.ndarray:
    """(L, n) uint32 16-bit limbs of n scalars uniform below ``order``: the
    top limb masked to the order's bit length, the lanes at or above the
    order drawn again."""
    top = (1 << (order.bit_length() - 16 * (L - 1))) - 1
    want = np.array([(order >> (16 * i)) & 0xFFFF for i in range(L)], dtype=np.uint32)
    sc = np.empty((L, n), dtype=np.uint32)
    redo = np.ones(n, dtype=bool)
    while redo.any():
        k = int(redo.sum())
        sc[:, redo] = rng.integers(0, 1 << 16, size=(L, k), dtype=np.uint32)
        sc[-1, redo] &= top
        gt, eq = np.zeros(n, dtype=bool), np.ones(n, dtype=bool)
        for i in range(L - 1, -1, -1):
            gt |= eq & (sc[i] > want[i])
            eq &= sc[i] == want[i]
        redo = gt | eq
    return sc


def limb_ints(sc: np.ndarray) -> list:
    """(L, n) 16-bit limbs -> n Python ints."""
    return limbs.words_to_ints(sc[0::2] | (sc[1::2] << np.uint32(16)))


def tiled_inputs(curve, n: int, seed: int):
    """n points P_i = [ks[i % 256]] G (base_points, tiled) and n scalars
    uniform below the group order, from seed; the host-exact MSM.  Returns
    (points, scalar words, scalar limbs, base multipliers, expected point)."""
    rng = np.random.default_rng(seed)
    ks, bx, by = base_points(curve, rng)
    sc = scalar_limbs(curve.SF.p, curve.SF.L, n, rng)
    points = AffinePoint(tile(bx, n), tile(by, n),
                         torch.zeros(n, dtype=torch.bool, device=curve.device))
    G = (int(curve.gen_x), int(curve.gen_y))
    expected = host_ec.msm_tiled(G, ks, sc, 0, curve.F.p, curve.SF.p)
    return points, limbs.from_jax_limbs(sc, curve.device), sc, ks, expected


def only_form(name: str, by_form: dict, tag: str, other: str) -> None:
    """No kernel of the other instantiation launched on a path."""
    if any(by_form[other].values()):
        raise AssertionError(f"{name}: {other} kernels launched on a {tag} path: "
                             f"{by_form[other]}")


def phase_secp256k1(device, clock_hz, results):
    """Phase 10: the full-width kernels against their twins
    (``width_kernels`` at SECP_SIZES), then secp256k1's MSM at 2^22, the
    naive MSM of 128 points, GLV and FixedBaseMSM at 2^20, and the MSM at
    2^20 over Pallas and over Vesta, each through the port's entry points
    with its launch counts set to 0 just before it and checked against
    host ints.  Returns the extra kernel numbers and each path's launches
    by instantiation."""
    curve = curves.secp256k1(device)
    F, SF = curve.F, curve.SF
    G = (int(curve.gen_x), int(curve.gen_y))
    marks = [time.perf_counter()]

    def lap(step):  # each step's seconds, for the phase's budget
        marks.append(time.perf_counter())
        info.setdefault("step_s", {})[step] = round(marks[-1] - marks[-2], 1)

    paths, info = {}, {}
    extra = width_kernels(curve, SECP_SIZES, SEED + 12, clock_hz, results)
    lap("kernels")

    # (b) the MSM at 2^22: no spare-bit kernel, each sweep kernel full-width
    n = 1 << SECP_LOG_N
    points, scalars, sc, ks, expected = tiled_inputs(curve, n, SEED + 12)
    rec = verified_msm(curve, f"secp256k1 msm 2^{SECP_LOG_N}",
                       lambda: msm(curve, points, scalars), expected, MSM_PATH, MSM_RUNS)
    full = rec["launches_by_form"]["w8_full"]
    only_form("secp256k1 msm", rec["launches_by_form"], "w8_full", "w8_spare")
    nwin = -(-SF.spec.bits // optimal_window_bits(SF.spec.bits, n))
    if any(full[k] == 0 for k in FULL_PATH) or full["bucket_add"] != nwin \
            or full["horner"] != 1 or full["add_xyzz"] or full["dbl_xyzz"]:
        raise AssertionError(f"secp256k1 msm: full-width launches {full}: not each of "
                             f"{FULL_PATH}, the bucket kernel {nwin} times, Horner once, "
                             f"no K2, no K3")
    paths[f"secp256k1_msm_2^{SECP_LOG_N}"] = rec["launches_by_form"]
    info["msm"] = rec
    lap("msm")

    # (c) the naive path: 128 points (64 signatures), the ladder and K2's tree
    k = SECP_NAIVE_N
    pts = [host_ec.scalar_mul(G, int(ks[i % 256]), 0, F.p) for i in range(k)]
    want = host_ec.msm(pts, limb_ints(sc[:, :k]), 0, F.p)
    small = AffinePoint(*(t[..., :k].contiguous() for t in points))
    rec = verified_msm(curve, f"secp256k1 naive msm {k}",
                       lambda: msm(curve, small, scalars[:, :k].contiguous()), want,
                       ("scalar_mul_xyzz", "add_xyzz", "mont_mul"), SECP_RUNS)
    only_form("secp256k1 naive msm", rec["launches_by_form"], "w8_full", "w8_spare")
    if rec["launches"]["scalar_mul_xyzz"] != 1 or rec["launches"]["add_xyzz"] != 7:
        raise AssertionError(f"secp256k1 naive msm: launches {rec['launches']}: not the "
                             f"ladder once and K2 7 times")
    paths[f"secp256k1_naive_{k}"] = rec["launches_by_form"]
    info["naive"] = rec
    lap("naive")

    # (d) GLV at 2^20 on the same points and scalars: the host's decomposition
    # timed apart from the device MSM, against the plain MSM and the host
    n2 = 1 << SECP_GLV_LOG_N
    pts2 = AffinePoint(*(t[..., :n2].contiguous() for t in points))
    sc2 = scalars[:, :n2].contiguous()
    want = host_ec.msm_tiled(G, ks, sc[:, :n2], 0, F.p, SF.p)
    ints = limb_ints(sc[:, :n2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    allp, gsc, half_bits = glv.glv_inputs(curve, pts2, ints)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    c = optimal_window_bits(half_bits, 2 * n2)
    rec = verified_msm(curve, f"secp256k1 glv 2^{SECP_GLV_LOG_N}",
                       lambda: msm(curve, allp, gsc, total_bits=half_bits), want, MSM_PATH,
                       SECP_RUNS)
    only_form("secp256k1 glv", rec["launches_by_form"], "w8_full", "w8_spare")
    glv_launches = rec["launches_by_form"]
    plain = verified_msm(curve, f"secp256k1 msm 2^{SECP_GLV_LOG_N} (GLV's plain rival)",
                         lambda: msm(curve, pts2, sc2), want, MSM_PATH, SECP_RUNS)
    t0 = time.perf_counter()
    if affine_ints(curve, curve.to_affine(glv.msm_glv(curve, pts2, ints))) != want:
        raise AssertionError("secp256k1: msm_glv differs from the host point")
    torch.cuda.synchronize()
    info["glv"] = {**rec, "host_decompose_s": host_s, "msm_glv_s": time.perf_counter() - t0,
                   "c": c, "half_bits": half_bits, "plain_best_s": plain["best_s"]}
    log(f"[secp] glv 2^{SECP_GLV_LOG_N}: host decomposition and packing {host_s:.3f} s; "
        f"device MSM of {2 * n2} points of {half_bits} bits at c = {c} best "
        f"{rec['best_s']:.4f} s; the plain MSM (256 bits, c = "
        f"{optimal_window_bits(SF.spec.bits, n2)}) best {plain['best_s']:.4f} s; msm_glv "
        f"whole {info['glv']['msm_glv_s']:.3f} s")
    paths[f"secp256k1_glv_2^{SECP_GLV_LOG_N}"] = glv_launches
    del allp, gsc, pts2
    lap("glv")

    # (e) FixedBaseMSM on G at 2^20 scalars, c = 8: sampled results against
    # host scalar multiples
    log_f, cf, samples = SECP_FIXED
    nf = 1 << log_f
    t0 = time.perf_counter()
    fb = fixed_msm.FixedBaseMSM(curve, G, c=cf)
    table_s = time.perf_counter() - t0
    scf = scalars[:, :nf].contiguous()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = fb.run(scf)
    torch.cuda.synchronize()
    launches = read_launches(("add_xyzz",))
    by_form = {tag: launches_at(tag) for tag in FORM_TAGS}
    only_form("secp256k1 fixed-base msm", by_form, "w8_full", "w8_spare")
    peak = torch.cuda.max_memory_allocated()
    idx = sorted(set(np.random.default_rng(SEED + 13).choice(nf, samples - 2,
                                                             replace=False).tolist())
                 | {0, nf - 1})
    got = sampled_points(curve, curve.to_affine(PointXYZZ(*(t[:, idx] for t in out))),
                         list(range(len(idx))))
    ints = limb_ints(sc[:, idx])
    if got != [host_ec.scalar_mul(G, k_, 0, F.p) for k_ in ints]:
        raise AssertionError("secp256k1 FixedBaseMSM: sampled results differ from host ints")
    del out
    ms = cuda_ms(lambda: fb.run(scf), SECP_RUNS)
    info["fixed"] = {"table_s": table_s, "ms": ms, "peak_mem_bytes": peak, "c": cf,
                     "windows": fb.nwin, "launches": launches}
    log(f"[secp] fixed-base msm c={cf} n=2^{log_f} verified=True ({len(idx)} sampled) "
        f"table {table_s:.3f} s, run {ms:.4f} ms, peak {peak} bytes, "
        f"launches={json.dumps(launches)}")
    paths[f"secp256k1_fixed_2^{log_f}"] = by_form
    del fb, scf, points, scalars
    lap("fixed")

    # (f) the MSM at 2^20 over Pallas and over Vesta: spare-bit kernels only
    for name, mk in (("pallas", curves.pallas), ("vesta", curves.vesta)):
        pc = mk(device)
        pts_, sc_, _, _, want = tiled_inputs(pc, 1 << PASTA_LOG_N, SEED + 14)
        rec = verified_msm(pc, f"{name} msm 2^{PASTA_LOG_N}", lambda: msm(pc, pts_, sc_),
                           want, MSM_PATH, SECP_RUNS)
        only_form(f"{name} msm", rec["launches_by_form"], "w8_spare", "w8_full")
        paths[f"{name}_msm_2^{PASTA_LOG_N}"] = rec["launches_by_form"]
        info[name] = rec
        lap(name)
    log(f"[secp] steps' seconds {json.dumps(info['step_s'])}")
    results["secp256k1"] = info
    return extra, paths


# phase 11, the Goldilocks path: K1 at W = 2 (p = 2^64 - 2^32 + 1, no spare
# bit), goldilocks2 and Poseidon2 goldilocks_w8 on the card, then the main
# path, the coset LDE of a 2^20 x 100 trace at log_blowup 3 (Plonky2's
# rate_bits = 3, Polygon's eSTARK over Goldilocks), shift 7; then
# MixedRadixDomain (Goldilocks at 3 x 2^20, bn254_fr at 9 x 2^18), SimpleFRI
# over BabyBear at 2^20 evaluations, and the sumcheck over Goldilocks on a
# product of 3 MLEs of 2^22 entries
GL_LDE = (20, 100, 3)  # log2 rows, columns, log_blowup
GL_SHIFT = 7  # Goldilocks' multiplicative generator
GL_LDE_SAMPLES = (4, 4)  # columns, rows a column checked against host Horner
GL_POSEIDON2_LOG_STATES = 22
GL_EXT_LOG_N = 20
GL_SAMPLES = 64  # goldilocks2 products and Poseidon2 states checked on the host
GL_MIXED = (("goldilocks", 3 << 20), ("bn254_fr", 9 << 18))
GL_MIXED_SAMPLES = 4
SIMPLE_FRI = (20, 16)  # log2 evaluations, queries
SUMCHECK = (22, 3)  # log2 entries, tables
GOLDILOCKS_PATH = ("mont_mul_w2",)
K1_W2_PRODUCTS = 10  # word products of a two-word Montgomery multiply (2 W^2 + W)
# 0, 1, mont(1), 2^32 - 1, 2^32, 2^63 - 1, 2^63, 2^63 + 2^32, p - 2^32, p - 2, p - 1
GL_EDGES = (0, 1, presets.GOLDILOCKS.R_mod_p, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
            (1 << 63) + (1 << 32), presets.GOLDILOCKS.p - (1 << 32), presets.GOLDILOCKS.p - 2,
            presets.GOLDILOCKS.p - 1)


def gl_random(shape, g: torch.Generator, device) -> torch.Tensor:
    """Canonical Goldilocks words (2, *shape), uniform below (2^32 - 1) 2^32
    < p: a high word below 2^32 - 1, any low word."""
    lo = torch.randint(0, 1 << 32, shape, dtype=torch.int64, generator=g, device=device)
    hi = torch.randint(0, (1 << 32) - 1, shape, dtype=torch.int64, generator=g, device=device)
    return mont.narrow(torch.stack([lo, hi]))


def u64_ints(words: torch.Tensor) -> list:
    """(2, n) words of 64-bit values -> n Python ints."""
    w = mont.widen(words.reshape(2, -1)).cpu()
    return (w[0] + (w[1] << 32)).numpy().astype(np.uint64).tolist()


def carries_past_64(x: int, y: int) -> bool:
    """The W = 2 kernel's carry into bit 64 of (t + m p) / 2^64 for words x, y."""
    p = presets.GOLDILOCKS.p
    t = x * y
    m = (t % (1 << 64)) * (-pow(p, -1, 1 << 64) % (1 << 64)) % (1 << 64)
    return (t + m * p) >> 128 != 0


def k1_w2_check(g, device, clock_hz, results) -> None:
    """K1 at W = 2: Goldilocks at (2, 2^24) against its twin, timed beside
    its bound (24 bytes an element); every pair of the edge operands, some of
    whose products carry into bit 64; a broadcast b; its host cost per call."""
    f, n = presets.GOLDILOCKS, SIZES["k1_w2"]
    a, b = gl_random((n,), g, device), gl_random((n,), g, device)
    a[:, 3:6] = b[:, 3:6]  # some squares
    got, want = cuda_mont.mul(f, a, b), cuda_mont.mul_plain(f, a, b)
    torch.cuda.synchronize()
    check("mont_mul_w2", (got,), (want,), cuda_ms(lambda: cuda_mont.mul(f, a, b), 20),
          cuda_ms(lambda: cuda_mont.mul_plain(f, a, b), 2), f"{f.name} (2, {n})",
          f"{f.name} (2, {n})", (24 * n, K1_W2_PRODUCTS * n, clock_hz), results,
          per_mul=K1_W2_PRODUCTS)
    del got, want
    xs = [x for x in GL_EDGES for _ in GL_EDGES]
    ys = [y for _ in GL_EDGES for y in GL_EDGES]
    carries = sum(carries_past_64(x, y) for x, y in zip(xs, ys))
    ea, eb = limbs.from_ints(xs, 2, device), limbs.from_ints(ys, 2, device)
    err = word_err((cuda_mont.mul(f, ea, eb),), (cuda_mont.mul_plain(f, ea, eb),))
    host = [x * y * pow(1 << 64, -1, f.p) % f.p for x, y in zip(xs, ys)]
    host_ok = u64_ints(cuda_mont.mul(f, ea, eb)) == host
    log(f"[k1-w2-edges] {len(xs)} products of the edge operands pairwise, {carries} of them "
        f"carrying into bit 64: max_abs_err {err}, equal to host ints {host_ok}")
    if err or not host_ok or not carries:
        raise AssertionError("mont_mul_w2: the edge operands differ from the twin or host ints")
    # an NTT stage's twiddles (one per row) over 16 columns, read in place
    x, y = a.reshape(2, n // 16, 16), b[:, :n // 16].reshape(2, n // 16, 1)
    err = word_err((cuda_mont.mul(f, x, y),), (cuda_mont.mul_plain(f, x, y),))
    ms = cuda_ms(lambda: cuda_mont.mul(f, x, y), 20)
    full = y.expand(x.shape).contiguous()
    ms_full = cuda_ms(lambda: cuda_mont.mul(f, x, full), 20)
    bms, by = bound_ms(16 * n + 8 * y[0].numel(), K1_W2_PRODUCTS * n, clock_hz)
    log(f"[k1-w2-broadcast] {tuple(x.shape)} x {tuple(y.shape)}: max_abs_err {err}; "
        f"{ms:.4f} ms, {ms_full:.4f} ms with b expanded; bound {bms:.4f} ms ({by})")
    if err:
        raise AssertionError("mont_mul_w2: the broadcast b differs from the twin")
    results["mont_mul_w2_broadcast"] = [{"shape": [list(x.shape), list(y.shape)], "ms": ms,
                                         "expanded_ms": ms_full, "bound_ms": bms,
                                         "bound_by": by}]
    results["mont_mul_w2_edges"] = {"products": len(xs), "carry_past_64": carries}
    wrapper_us, launcher_us = k1_call_us(f, device)
    log(f"[k1-w2-call] {K1_CALLS} calls at n = 1, back to back: the wrapper {wrapper_us:.2f} "
        f"us per call, its ctypes launcher alone {launcher_us:.2f} us")
    results["mont_mul_w2_call_us"] = {"wrapper": wrapper_us, "launcher": launcher_us}


def goldilocks2_check(g, device) -> dict:
    """goldilocks2's mul, square and inv on 2^GL_EXT_LOG_N elements, timed;
    GL_SAMPLES of each against host ints."""
    ext = extensions.goldilocks2(device)
    hx = HostExt(ext)
    n = 1 << GL_EXT_LOG_N
    a, b = (mont.to_mont(presets.GOLDILOCKS, gl_random((2, n), g, device)).movedim(1, 0)
            for _ in range(2))  # (2 coefficients, 2 words, n)
    out, times = {}, {}
    for name, fn in (("mul", lambda: ext.mul(a, b)), ("square", lambda: ext.square(a)),
                     ("inv", lambda: ext.inv(a))):
        out[name], times[name] = timed_once(fn)
    idx = torch.randint(0, n, (GL_SAMPLES,), generator=g, device=device)

    def host(t):
        return [[int(c[j]) for c in ext.decode(t[:, :, idx])] for j in range(GL_SAMPLES)]

    ha, hb = host(a), host(b)
    want = {"mul": [hx.mul(x, y) for x, y in zip(ha, hb)],
            "square": [hx.mul(x, x) for x in ha], "inv": [hx.inv(x) for x in ha]}
    bad = [name for name in out if host(out[name]) != want[name]]
    if bad:
        raise AssertionError(f"goldilocks2: {bad} differ from host ints")
    return {"elements": n, "ms": {k: round(v, 4) for k, v in times.items()},
            "sampled": GL_SAMPLES}


def goldilocks_poseidon2_check(g, device) -> dict:
    """goldilocks_w8 on 2^GL_POSEIDON2_LOG_STATES states, timed;
    GL_SAMPLES states equal to permute_host."""
    h = poseidon2.goldilocks_w8(device)
    n = 1 << GL_POSEIDON2_LOG_STATES
    plain = gl_random((h.t, n), g, device)
    st = mont.to_mont(presets.GOLDILOCKS, plain)
    out, first_ms = timed_once(lambda: h.permute(st))
    ms = cuda_ms(lambda: h.permute(st), 3)
    idx = torch.randint(0, n, (GL_SAMPLES,), generator=g, device=device)
    ins = np.array(u64_ints(plain[:, :, idx].reshape(2, -1)), dtype=object).reshape(h.t, -1).T
    outs = [[int(v) for v in col] for col in h.F.decode(out[:, :, idx]).T]
    bad = sum(h.permute_host(list(x)) != y for x, y in zip(ins, outs))
    if bad:
        raise AssertionError(f"Poseidon2 goldilocks_w8: {bad} of {GL_SAMPLES} sampled states "
                             "differ from permute_host")
    return {"states": n, "first_ms": round(first_ms, 4), "ms": round(ms, 4),
            "ns_per_state": round(ms * 1e6 / n, 3), "sampled": GL_SAMPLES}


def host_horner(cs: list, xs: list, p: int) -> list:
    """The polynomial with coefficients cs (lowest first) at each x."""
    acc = [0] * len(xs)
    for c in reversed(cs):
        acc = [(v * x + c) % p for v, x in zip(acc, xs)]
    return acc


def lde_inputs(device, g, log_n: int = None):
    """The main path's domain and matrix: a 2^log_n x C Goldilocks matrix of
    the evaluations on H of random polynomials of degree < 2^log_n, and
    their coefficients (plain words, from g)."""
    log_n = GL_LDE[0] if log_n is None else log_n
    dom = Radix2Domain(PrimeField(presets.GOLDILOCKS, device), 1 << log_n)
    coeffs = gl_random((1 << log_n, GL_LDE[1]), g, device)
    return dom, coeffs, dom.fft(mont.to_mont(presets.GOLDILOCKS, coeffs))


def lde_path(device, g):
    """The main path: coset_lde_batch of ``lde_inputs``'s matrix at
    log_blowup, shift 7, with every launch count set to 0 just before it.
    Returns the coefficients, the matrix, the LDE, its milliseconds, the
    peak memory and the launches."""
    lb = GL_LDE[2]
    dom, coeffs, evals = lde_inputs(device, g)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    lde, ms = timed_once(lambda: coset_lde_batch(dom, evals, lb, GL_SHIFT))
    launches = read_launches(GOLDILOCKS_PATH)
    by_form = {tag: launches_at(tag) for tag in FORM_TAGS}
    peak = torch.cuda.max_memory_allocated()
    if any(by_form[t][k] for t in FORM_TAGS if t != "w2_full" for k in KERNELS):
        raise AssertionError(f"the Goldilocks LDE launched a kernel of another width: {by_form}")
    return coeffs, evals, lde, ms, peak, launches


def lde_check(F, coeffs, lde, g) -> int:
    """GL_LDE_SAMPLES (column, row) outputs against host Horner evaluations
    of the known coefficients at 7 w^i, w of order 2^(log_n + log_blowup)."""
    log_n, C, lb = GL_LDE
    p, big = F.p, 1 << (log_n + lb)
    if tuple(lde.shape) != (2, big, C):
        raise AssertionError(f"the LDE's shape {tuple(lde.shape)} is not (2, {big}, {C})")
    w = F.spec.root_of_unity(big)
    cols = torch.randperm(C, generator=g, device=g.device)[:GL_LDE_SAMPLES[0]].tolist()
    checked = 0
    for c in cols:
        rows = torch.randint(0, big, (GL_LDE_SAMPLES[1],), generator=g, device=g.device).tolist()
        got = u64_ints(mont.mont_reduce(F.spec, lde[:, rows, c]))
        want = host_horner(u64_ints(coeffs[:, :, c]), [GL_SHIFT * pow(w, i, p) % p for i in rows], p)
        if got != want:
            raise AssertionError(f"LDE column {c}: rows {rows} differ from host Horner")
        checked += len(rows)
    return checked


def mixed_radix_check(device, g) -> dict:
    """MixedRadixDomain over each GL_MIXED field and size: ifft(fft(x)) == x
    word for word, GL_MIXED_SAMPLES outputs against a host DFT sum, and
    DomainCache's domain types; each transform timed."""
    out = {}
    for name, n in GL_MIXED:
        spec = getattr(presets, name.upper())
        F = PrimeField(spec, device)
        cache = DomainCache(F)
        dom = cache.get(n)
        if not isinstance(dom, MixedRadixDomain) or cache.get(n) is not dom \
                or not isinstance(cache.get(n & -n), Radix2Domain):
            raise AssertionError(f"DomainCache({name}): wrong domain types")
        if name == "goldilocks":
            plain = gl_random((n,), g, device)
        else:
            plain = random_elements(spec, n, g, device)
        x = mont.to_mont(spec, plain)
        ev, fft_ms = timed_once(lambda: dom.fft(x))
        back, ifft_ms = timed_once(lambda: dom.ifft(ev))
        if not torch.equal(back, x):
            raise AssertionError(f"MixedRadixDomain({name}, {n}): ifft(fft(x)) != x")
        cs = limbs.words_to_ints(plain.cpu().numpy().view(np.uint32))
        ks = torch.randint(0, n, (GL_MIXED_SAMPLES,), generator=g, device=device).tolist()
        p, w = spec.p, dom.omega_int
        got = [int(v) for v in F.decode(ev[:, ks])]
        if got != host_horner(cs, [pow(w, k, p) for k in ks], p):
            raise AssertionError(f"MixedRadixDomain({name}, {n}): outputs {ks} differ from the "
                                 "host DFT sum")
        out[f"{name}_{n}"] = {"n1": dom.n1, "n2": dom.n2, "fft_ms": round(fft_ms, 4),
                              "ifft_ms": round(ifft_ms, 4), "sampled": len(ks)}
        del x, ev, back
    return out


def simple_fri_check(device, g) -> dict:
    """SimpleFRI over BabyBear (baby_bear_p3_w16, DuplexChallenger(perm, 8))
    on the 2^log_n evaluations of a random polynomial of degree < 2^(log_n
    - 1): commit timed; verify accepts; one tampered layer value refused."""
    log_n, queries = SIMPLE_FRI
    h = poseidon2.baby_bear_p3_w16(device)
    F = h.F
    n = 1 << log_n
    cs = torch.zeros((n,), dtype=torch.int64, device=device)
    cs[:n // 2] = torch.randint(0, F.p, (n // 2,), generator=g, device=device)
    evals = Radix2Domain(F, n).fft(F.encode_canonical(cs))
    fri = SimpleFRI(F, h, queries)
    proof, commit_ms = timed_once(lambda: fri.commit(evals, DuplexChallenger(h, 8)))
    t0 = time.perf_counter()
    ok = fri.verify(n, proof, DuplexChallenger(h, 8))
    verify_s = time.perf_counter() - t0
    idx, path = proof.query_paths[0]
    lo, hi = path[1]
    row = lo.opened_rows[0].clone()
    row[0, 0] = (row[0, 0] + 1) % F.p
    path = [*path[:1], (lo._replace(opened_rows=(row,)), hi), *path[2:]]
    bad = proof._replace(query_paths=[(idx, path), *proof.query_paths[1:]])
    if ok is not True or fri.verify(n, bad, DuplexChallenger(h, 8)) is not False:
        raise AssertionError("SimpleFRI: the proof does not verify, or verifies a tampered "
                             "layer value")
    return {"evaluations": n, "queries": queries, "layers": len(proof.layer_roots),
            "commit_s": round(commit_ms / 1e3, 4), "verify_s": round(verify_s, 4)}


def sumcheck_check(device, g) -> dict:
    """The sumcheck over Goldilocks on the product of SUMCHECK[1] MLEs of
    2^SUMCHECK[0] entries, challenges from a Poseidon2 goldilocks_w8 duplex
    transcript: prove timed, verify accepts with the tables' values at the
    challenges, the claimed sum equals a host sum, a claim + 1 is refused."""
    log_n, d = SUMCHECK
    F = PrimeField(presets.GOLDILOCKS, device)
    h = poseidon2.goldilocks_w8(device)
    plain = [gl_random((1 << log_n,), g, device) for _ in range(d)]
    tabs = [mont.to_mont(F.spec, t) for t in plain]

    def sampler():
        ch = DuplexChallenger(h, 4)

        def sample(evals):
            ch.observe_many(evals)
            return ch.sample()
        return sample

    (proof, chals), prove_ms = timed_once(lambda: sumcheck.prove(F, tabs, sampler()))
    pts = [F.full((), c) for c in chals]
    finals = [int(F.decode(mle.evaluate(F, t, pts))) for t in tabs]
    ok = sumcheck.verify(F, proof, finals, sampler())
    bad = sumcheck.SumcheckProof(proof.round_evals, (proof.claimed_sum + 1) % F.p)
    if ok is not True or sumcheck.verify(F, bad, finals, sampler()) is not False:
        raise AssertionError("sumcheck: the proof does not verify, or verifies a claim + 1")
    cols = [u64_ints(t) for t in plain]
    p, total = F.p, 0
    for i in range(1 << log_n):
        v = 1
        for c in cols:
            v = v * c[i] % p
        total += v
    if proof.claimed_sum != total % p:
        raise AssertionError("sumcheck: the claimed sum differs from the host sum")
    return {"entries": 1 << log_n, "tables": d, "rounds": len(proof.round_evals),
            "prove_s": round(prove_ms / 1e3, 4)}


def phase_goldilocks(device, clock_hz, results):
    """Phase 11: K1 at W = 2, goldilocks2 and Poseidon2 goldilocks_w8 on the
    card, then the main path (``lde_path``), MixedRadixDomain, SimpleFRI and
    the sumcheck, each checked.  Returns the main path's launches."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 15)
    steps = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        steps[name] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()

    k1_w2_check(g, device, clock_hz, results)
    lap("k1")
    ext = goldilocks2_check(g, device)
    log(f"[goldilocks2] {json.dumps(ext)}")
    lap("goldilocks2")
    perm = goldilocks_poseidon2_check(g, device)
    log(f"[poseidon2] goldilocks_w8 {json.dumps(perm)}")
    lap("poseidon2")

    coeffs, evals, lde, ms, peak, launches = lde_path(device, g)
    F = PrimeField(presets.GOLDILOCKS, device)
    del evals
    checked = lde_check(F, coeffs, lde, g)
    log_n, C, lb = GL_LDE
    log(f"[goldilocks-lde] coset_lde_batch rows=2^{log_n} cols={C} log_blowup={lb} "
        f"shift={GL_SHIFT} out={tuple(lde.shape)} ({lde.numel() * 4} bytes) ms={ms:.4f} "
        f"peak_mem_bytes={peak} checked={checked} launches={json.dumps(launches)}")
    results["goldilocks_lde"] = {"ms": ms, "peak_mem_bytes": peak, "checked": checked,
                                 "w2_launches": launches["mont_mul_w2"]}
    del coeffs, lde
    torch.cuda.empty_cache()
    lap("lde")
    mixed = mixed_radix_check(device, g)
    log(f"[mixed-radix] {json.dumps(mixed)}")
    lap("mixed_radix")
    sfri = simple_fri_check(device, g)
    log(f"[simple-fri] baby_bear verified=True tampered_rejected=True {json.dumps(sfri)}")
    lap("simple_fri")
    sc = sumcheck_check(device, g)
    log(f"[sumcheck] goldilocks verified=True host_sum_equal=True claim_plus_one_rejected=True "
        f"{json.dumps(sc)}")
    lap("sumcheck")
    log(f"[goldilocks] steps' seconds {json.dumps(steps)}")
    results["goldilocks"] = {"goldilocks2": ext, "poseidon2": perm, "mixed_radix": mixed,
                             "simple_fri": sfri, "sumcheck": sc, "step_s": steps}
    return launches


# phase 12, the halo2 path (Scroll vendor, SHPlonk): SimpleCircuit (custom
# gates, copy constraints, the permutation argument, an instance column) at
# k = 16, the halo2 bench's circuit, and SimpleLookupCircuit's 2^15 rows,
# each looked up in a 3-bit table with the log-derivative lookup, in the
# same 2^16 domain; then every case of the JAX fixture on the card
HALO2_LOG_N = 16
HALO2_LOOKUP_K = 15
HALO2_FIXTURE = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_halo2_jax.json"
# keygen's SRS (the ladder, twice), the commitments above 128 points (the
# sweep path) and the vanishing argument's one-point commitment (the ladder)
HALO2_PATH = ("mont_mul", "scalar_mul_xyzz", "suffix_sweep", "bucket_add", "reduce_sweep",
              "lane_suffix_scan", "lane_fold", "horner")
HALO2_BACKEND_STEPS = ("commit", "commit_lagrange", "ifft", "coset_evals", "build_h_coeffs",
                       "make_compressor")


def timed_backend(backend, out: dict):
    """Wrap the backend's methods to add each call's synchronized host
    seconds, its K1 launches and its count into out[name]; the last
    quotient build's method, arguments and result stay in
    ``backend.quotient_call``."""
    for name in HALO2_BACKEND_STEPS:
        fn = getattr(backend, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            rec = out.setdefault(_name, {"calls": 0, "s": 0.0, "k1_launches": 0})
            k1 = KERNELS["mont_mul"][0].launches
            t0 = time.perf_counter()
            res = _fn(*a, **kw)
            torch.cuda.synchronize()
            rec["s"] = round(rec["s"] + time.perf_counter() - t0, 4)
            rec["k1_launches"] += KERNELS["mont_mul"][0].launches - k1
            rec["calls"] += 1
            if _name == "build_h_coeffs":
                backend.quotient_call = (_fn, kw, res)
            return res

        setattr(backend, name, wrapped)
    return backend


def quotient_launches(backend) -> int:
    """The device launches of the path's quotient build, run again under
    torch.profiler (CUDA activity only); the h coefficients must repeat."""
    fn, kw, h = backend.quotient_call
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        again = fn(**kw)
        torch.cuda.synchronize()
    if again != h:
        raise AssertionError("halo2: the quotient build gives other h coefficients when rerun")
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA)


def halo2_path(device, name: str, make, k: int, keygen_kw: dict) -> dict:
    """One circuit through the port's entry points, with every launch count
    set to 0 just before it: keygen (its KZG setup too),
    TorchBackend, create_proof, each timed by a synchronized host clock;
    then Halo2Verifier's verify, and the checks (a flipped byte and the
    public instance + 1 refused; a fresh RandomFieldGenerator repeats the
    bytes; the quotient build, traced again, repeats its h).  Returns its
    numbers and launches by instantiation."""
    steps, backend_steps = {}, {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()

    def lap(step):
        nonlocal t0
        torch.cuda.synchronize()
        steps[step] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()

    pk = halo2.keygen(make(), k, device=device, **keygen_kw)
    lap("keygen")
    backend = timed_backend(TorchBackend(pk, device), backend_steps)
    lap("backend")
    circuits_ = [make()]
    insts = [c.instance_columns() for c in circuits_]
    proof = halo2.Halo2Prover(pk, backend=backend).create_proof(circuits_, insts).proof
    lap("prove")
    launches = read_launches(HALO2_PATH)
    by_form = {tag: launches_at(tag) for tag in FORM_TAGS}
    peak = torch.cuda.max_memory_allocated()
    if any(by_form[tag][kn] for tag in FORM_TAGS if tag != "w8_spare" for kn in KERNELS):
        raise AssertionError(f"{name}: a kernel of another instantiation launched: {by_form}")
    verifier = halo2.Halo2Verifier(pk)
    lap("verifier_init")
    ok = verifier.verify(proof, insts)
    lap("verify")

    # checks, beyond the main path's run
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    flipped = verifier.verify(bytes(bad), insts)
    wrong = None
    if any(cols for cols in insts):
        wrong = verifier.verify(proof, [[[(v + 1) % halo2.FR for v in col] for col in cols]
                                        for cols in insts])
    again = halo2.Halo2Prover(pk, rng=halo2.RandomFieldGenerator(),
                              backend=TorchBackend(pk, device)).create_proof(circuits_, insts)
    backend_steps["build_h_coeffs"]["device_launches"] = quotient_launches(backend)
    lap("checks")
    if ok is not True or flipped is not False or wrong not in (None, False):
        raise AssertionError(f"{name}: verify gives {ok} on the proof, {flipped} with a byte "
                             f"flipped, {wrong} for the instance + 1")
    if again.proof != proof:
        raise AssertionError(f"{name}: a fresh RandomFieldGenerator gives other proof bytes")
    cs = pk.cs
    rec = {"n": pk.n, "extended_k": pk.extended_k, "usable_rows": pk.usable_rows,
           "advice": cs.num_advice, "fixed": len(pk.fixed_columns),
           "lookups": len(cs.lookups), "lookup_type": cs.lookup_type,
           "proof_bytes": len(proof), "steps_s": steps, "backend_steps": backend_steps,
           "peak_mem_bytes": peak, "launches": launches,
           "launches_w8_spare": by_form["w8_spare"]}
    log(f"[halo2] {name} verified=True flipped_byte_rejected=True "
        f"wrong_instance_rejected={wrong is False if wrong is not None else 'no instance'} "
        f"repeat_equal=True {json.dumps(rec)}")
    return rec


def halo2_fixture_check(device) -> dict:
    """Every case of the JAX fixture (keygen and TorchBackend
    on the card): the pinned VK, transcript_repr and proof bytes equal the
    JAX HostBackend's, and the port's verifier accepts.  Returns each
    case's seconds."""
    fx = json.loads(HALO2_FIXTURE.read_text())
    secs = {}
    for name, case in fx["cases"].items():
        t0 = time.perf_counter()
        circuits_ = make_torch_halo2_fixture.build(plonk_circuits, case)
        pk = halo2.keygen(circuits_[0], case["k"], device=device,
                          **case["keygen"])
        insts = [[[int(v, 16) for v in col] for col in cols] for cols in case["instances"]]
        proof = halo2.Halo2Prover(pk, backend=TorchBackend(pk, device)).create_proof(
            circuits_, insts).proof
        if pk.pinned_vk != case["pinned_vk"] or hex(pk.transcript_repr) != case["transcript_repr"]:
            raise AssertionError(f"halo2 fixture {name}: the pinned VK differs from the JAX one")
        if proof.hex() != case["proof"]:
            raise AssertionError(f"halo2 fixture {name}: the proof bytes differ from the JAX ones")
        if halo2.Halo2Verifier(pk).verify(proof, insts) is not True:
            raise AssertionError(f"halo2 fixture {name}: the proof does not verify")
        secs[name] = round(time.perf_counter() - t0, 3)
    return secs


def phase_halo2(device):
    """Phase 12: SimpleCircuit at 2^HALO2_LOG_N and SimpleLookupCircuit
    (2^HALO2_LOOKUP_K rows, log-derivative lookup) in the same domain, each
    through ``halo2_path``; then the fixture's cases byte for byte.  Returns
    the two paths' launches."""
    simple = halo2_path(device, f"SimpleCircuit k={HALO2_LOG_N}", plonk_circuits.SimpleCircuit,
                        HALO2_LOG_N, {})
    lookup = halo2_path(device, f"SimpleLookupCircuit(k={HALO2_LOOKUP_K}) log_derivative "
                        f"k={HALO2_LOG_N}",
                        lambda: plonk_circuits.SimpleLookupCircuit(k=HALO2_LOOKUP_K),
                        HALO2_LOG_N, {"lookup_type": "log_derivative"})
    torch.cuda.empty_cache()
    secs = halo2_fixture_check(device)
    log(f"[halo2-fixture] {len(secs)} cases byte-equal to the JAX HostBackend's "
        f"(pinned VK, transcript_repr, proof) and verified; seconds {json.dumps(secs)}")
    return {f"halo2_2^{HALO2_LOG_N}": simple["launches"],
            f"halo2_lookup_2^{HALO2_LOG_N}": lookup["launches"]}


# --- phase 13: the surfaces (the C ABI, the CLI, replay, the profiler) and
# the standalone PLONK prover

C_DIR = Path(__file__).resolve().parent / "tachyon_tpu_torch" / "c"
CIRCOM_MUL = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_circom_mul"
ABI_MSM_LOG_N = 20  # a halo2 k = 20 commitment's size
ABI_FFT_LOG_N = 20
ABI_HALO2_K = 16  # phase 12's domain
ABI_HALO2_ROWS = (1 << ABI_HALO2_K) - 64  # mul-gate rows, below the blinding rows
ABI_HALO2_INSTANCES = 16  # c cells copied to the instance column
REPLAY_LOG_N = 16
SP1_COMMIT = (20, 100, 2)  # log2 rows, columns, log_blowup: the reference's fri row
SP1_PROVE = (16, 16, 1, 100, 16)  # log2 rows, columns, log_blowup, SP1's queries and grind
PLONK_LOG_N = 16
PLONK_BLINDING = 5
PLONK_CHAIN = 1024  # rows whose c is copied to the next row's a
# the SRS ladder, the commitments (the sweep path), every column op (K1)
PLONK_PATH = ("mont_mul", "scalar_mul_xyzz", "suffix_sweep", "bucket_add", "reduce_sweep",
              "lane_suffix_scan", "lane_fold", "horner")


def subprocess_env() -> dict:
    """The environment of a subprocess that runs the port: the repository and
    this interpreter's package directories on PYTHONPATH (an embedded
    interpreter starts from its own prefix, not from a virtual environment)."""
    site = [p for p in sys.path if p.endswith("-packages") and Path(p).is_dir()]
    root = str(Path(__file__).resolve().parent)
    return {**os.environ, "PYTHONPATH": os.pathsep.join([root, *site])}


def build_capi() -> tuple[Path, float]:
    """``make -C tachyon_tpu_torch/c`` (the library and test_capi, into
    tachyon_tpu_torch/_build/c); raises with make's output."""
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", str(C_DIR)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"the C library did not build ({r.returncode}):\n{r.stdout}{r.stderr}")
    return C_DIR.parent / "_build" / "c", time.perf_counter() - t0


def load_capi(lib_path: Path):
    """The library through ctypes, each entry declared as the rs crate does."""
    lib = ctypes.CDLL(str(lib_path))
    u8p, size, i, u32 = (ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t, ctypes.c_int,
                         ctypes.c_uint32)
    cpp = ctypes.POINTER(ctypes.c_char_p)
    for name, args in (
            ("tachyon_tpu_init", [ctypes.c_char_p]),
            ("tachyon_tpu_bn254_g1_msm", [u8p, u8p, size, u8p]),
            ("tachyon_tpu_bn254_fft", [u8p, size, i, u8p]),
            ("tachyon_tpu_bn254_poseidon2_hash", [u8p, size, u8p]),
            ("tachyon_tpu_bn254_groth16_prove", [ctypes.c_char_p, ctypes.c_char_p, i, i, cpp,
                                                 cpp]),
            ("tachyon_tpu_halo2_bn254_prove", [ctypes.c_char_p, cpp]),
            ("tachyon_tpu_sp1_baby_bear_fri_commit", [u32, u8p, size, u8p]),
            ("tachyon_tpu_sp1_baby_bear_fri_prove_verify", [u32, u32, u32, u8p, size, u8p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    lib.tachyon_tpu_last_error.restype = ctypes.c_char_p
    lib.tachyon_tpu_free_string.argtypes = [ctypes.c_void_p]
    return lib


def abi_call(lib, name: str, *args) -> None:
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise AssertionError(f"{name} returned {rc}: {lib.tachyon_tpu_last_error().decode()}")


def abi_bytes(data: bytes):
    return (ctypes.c_uint8 * len(data)).from_buffer_copy(data)


def abi_strings(lib, name: str, count: int, *args) -> list[str]:
    """Call the entry ``name``, which returns ``count`` strings through
    char** out-parameters after ``args``."""
    outs = [ctypes.c_char_p() for _ in range(count)]
    abi_call(lib, name, *args, *(ctypes.byref(o) for o in outs))
    vals = [o.value.decode() for o in outs]
    for o in outs:
        lib.tachyon_tpu_free_string(o)
    return vals


def abi_msm_inputs(curve, n: int, seed: int):
    """tiled_inputs as the ABI's bytes: n bases (x || y, 32-byte LE standard
    form) and n scalars, and the host-exact point."""
    _, _, sc, ks, expected = tiled_inputs(curve, n, seed)
    G = (int(curve.gen_x), int(curve.gen_y))
    base = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little")
                    for x, y in (host_ec.scalar_mul(G, int(k), 0, curve.F.p) for k in ks))
    scalars = limbs.from_jax_limbs(sc).numpy().view("<u4").T.tobytes()
    return base * (n // len(ks)), scalars, sc, ks, expected


def point_bytes(pt) -> bytes:
    x, y = pt if pt else (0, 0)
    return x.to_bytes(32, "little") + y.to_bytes(32, "little")


def abi_msm_check(lib, curve, bases: bytes, scalars: bytes, n: int, expected) -> dict:
    """tachyon_tpu_bn254_g1_msm on n points, the MSM timed apart from the
    marshalling (the bridge's ``msm`` wrapped by a synchronized clock)."""
    inner = {}
    orig = msm_mod.msm

    def timed_msm(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        inner["msm_s"] = time.perf_counter() - t
        return out

    out = (ctypes.c_uint8 * 64)()
    b, s = abi_bytes(bases), abi_bytes(scalars)
    msm_mod.msm = timed_msm
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        abi_call(lib, "tachyon_tpu_bn254_g1_msm", b, s, n, out)
        total = time.perf_counter() - t0
    finally:
        msm_mod.msm = orig
    if bytes(out) != point_bytes(expected):
        raise AssertionError(f"ABI msm at n = {n}: not the host-exact point")
    return {"n": n, "call_s": round(total, 4), "msm_s": round(inner["msm_s"], 4),
            "marshal_s": round(total - inner["msm_s"], 4)}


def abi_fft_check(lib, device, rng) -> dict:
    n = 1 << ABI_FFT_LOG_N
    words = rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32)
    words[7] &= 0x0FFFFFFF  # below r
    data = words.T.tobytes()
    Fr = curves.bn254_fr(device)
    want = mont.mont_reduce(Fr.spec, Radix2Domain(Fr, n).fft(mont.to_mont(
        Fr.spec, torch.from_numpy(words.view(np.int32)).to(device))))
    fwd, back = (ctypes.c_uint8 * (32 * n))(), (ctypes.c_uint8 * (32 * n))()
    t0 = time.perf_counter()
    abi_call(lib, "tachyon_tpu_bn254_fft", abi_bytes(data), n, 0, fwd)
    fwd_s = time.perf_counter() - t0
    if bytes(fwd) != want.cpu().numpy().view("<u4").T.tobytes():
        raise AssertionError("ABI fft at 2^20: not Radix2Domain.fft's values")
    abi_call(lib, "tachyon_tpu_bn254_fft", fwd, n, 1, back)
    if bytes(back) != data:
        raise AssertionError("ABI fft at 2^20: the inverse does not give the input back")
    return {"n": n, "fft_s": round(fwd_s, 4)}


def abi_poseidon2_check(lib, device) -> dict:
    h = poseidon2.bn254_w3(device)
    vals = [pow(3, 50 + i, h.F.p) for i in range(5)]
    st = [0, 0, 0]
    for off in range(0, len(vals), 2):  # the ABI's sponge: rate 2, squeeze state[1]
        for i, v in enumerate(vals[off:off + 2]):
            st[i + 1] = (st[i + 1] + v) % h.F.p
        st = h.permute_host(st)
    out = (ctypes.c_uint8 * 32)()
    abi_call(lib, "tachyon_tpu_bn254_poseidon2_hash",
             abi_bytes(b"".join(v.to_bytes(32, "little") for v in vals)), len(vals), out)
    if bytes(out) != st[1].to_bytes(32, "little"):
        raise AssertionError("ABI poseidon2: not the host sponge's digest")
    return {"inputs": len(vals)}


def sp1_blob(mats: list[np.ndarray]) -> bytes:
    head = [np.array([len(mats)], dtype="<u4")]
    for m in mats:
        head += [np.array(m.shape, dtype="<u4"), m.reshape(-1).astype("<u4")]
    return np.concatenate(head).tobytes()


def abi_sp1_check(lib, device, rng) -> dict:
    """The commit entry on the reference's fri row against the port's
    in-process TwoAdicFRIPCS commit; prove_verify on SP1's FRI settings."""
    log_rows, cols, blowup = SP1_COMMIT
    h = poseidon2.baby_bear_p3_w16(device)
    p = h.F.p
    m = rng.integers(0, p, size=(1 << log_rows, cols), dtype=np.uint32)
    pcs = TwoAdicFRIPCS(h.F, extensions.baby_bear4(device), h, FRIConfig(log_blowup=blowup))

    def in_process():
        data = pcs.commit([h.F.encode_canonical(torch.from_numpy(m.view(np.int32)))])
        return struct.pack("<8I", *(int(v) for v in h.F.decode(data.root()).reshape(-1)))

    in_process()  # the warm-up: the LDE's twiddles, Poseidon2's constants
    blob = sp1_blob([m])
    buf = abi_bytes(blob)
    root = (ctypes.c_uint8 * 32)()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    abi_call(lib, "tachyon_tpu_sp1_baby_bear_fri_commit", blowup, buf, len(blob), root)
    commit_s = time.perf_counter() - t0
    launches = read_launches(STARK_PATH)
    t0 = time.perf_counter()
    want = in_process()
    inproc_s = time.perf_counter() - t0
    if bytes(root) != want:
        raise AssertionError("ABI sp1 commit: the root differs from TwoAdicFRIPCS.commit's")
    del pcs, buf
    log_rows2, cols2, blowup2, queries, pow_bits = SP1_PROVE
    m2 = rng.integers(0, p, size=(1 << log_rows2, cols2), dtype=np.uint32)
    blob2 = sp1_blob([m2])
    root_c, root_pv = (ctypes.c_uint8 * 32)(), (ctypes.c_uint8 * 32)()
    abi_call(lib, "tachyon_tpu_sp1_baby_bear_fri_commit", blowup2, abi_bytes(blob2),
             len(blob2), root_c)
    t0 = time.perf_counter()
    abi_call(lib, "tachyon_tpu_sp1_baby_bear_fri_prove_verify", blowup2, queries, pow_bits,
             abi_bytes(blob2), len(blob2), root_pv)
    pv_s = time.perf_counter() - t0
    if bytes(root_c) != bytes(root_pv):
        raise AssertionError("ABI sp1: prove_verify's root differs from the commit's")
    return {"commit": {"shape": [1 << log_rows, cols], "log_blowup": blowup,
                       "abi_s": round(commit_s, 3), "in_process_s": round(inproc_s, 3)},
            "prove_verify": {"shape": [1 << log_rows2, cols2], "log_blowup": blowup2,
                             "queries": queries, "pow_bits": pow_bits, "s": round(pv_s, 3)},
            "launches": launches}


def abi_groth16_check(lib, tmp: Path, device) -> dict:
    """groth16_prove (no_zk, verify) on the circom mul fixture against
    ``cli.py prove --no-zk``'s files."""
    zkey, wtns = f"{CIRCOM_MUL}.zkey", f"{CIRCOM_MUL}.wtns"
    t0 = time.perf_counter()
    proof, public = abi_strings(lib, "tachyon_tpu_bn254_groth16_prove", 2, zkey.encode(),
                               wtns.encode(), 1, 1)
    abi_s = time.perf_counter() - t0
    pp, pub = tmp / "proof.json", tmp / "public.json"
    if cli.main(["prove", zkey, wtns, "--no-zk", "--verify", "--device", device.type,
                 "--proof", str(pp), "--public", str(pub)]) != 0:
        raise AssertionError("cli.py prove --no-zk failed on the circom mul fixture")
    if json.loads(proof) != json.loads(pp.read_text()) or \
            json.loads(public) != json.loads(pub.read_text()):
        raise AssertionError("ABI groth16: the JSON differs from cli.py prove --no-zk's")
    return {"abi_s": round(abi_s, 3)}


def halo2_mul_json(k: int, rows: int, seed: int) -> str:
    """A JSON circuit of ``api.h``'s schema at 2^k: a mul gate
    s * (a * b - c) on ``rows`` rows, the first ABI_HALO2_INSTANCES c cells
    copied to an instance column."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 32, rows, dtype=np.uint64)
    b = rng.integers(1, 1 << 32, rows, dtype=np.uint64)
    c = [int(x) * int(y) for x, y in zip(a, b)]
    k_inst = ABI_HALO2_INSTANCES
    return json.dumps({
        "k": k, "num_advice": 3, "num_fixed": 0, "num_instance": 1,
        "equality": [["advice", 2], ["instance", 0]], "selectors": ["simple"],
        "gates": [[["prod", ["selector", 0],
                    ["sum", ["prod", ["advice", 0, 0], ["advice", 1, 0]],
                     ["neg", ["advice", 2, 0]]]]]],
        "assignments": {"advice": [a.tolist(), b.tolist(), c], "selectors": [[1] * rows],
                        "copies": [[["advice", 2, i], ["instance", 0, i]] for i in range(k_inst)]},
        "instances": [c[:k_inst]],
    })


def abi_halo2_check(lib, tmp: Path, device) -> dict:
    """halo2_prove through the ABI at k = 16 (self-verified inside), and
    ``cli.py prove-halo2 --device cuda`` on the same file as a subprocess:
    the same hex."""
    spec = halo2_mul_json(ABI_HALO2_K, ABI_HALO2_ROWS, SEED + 15)
    path = tmp / "halo2_k16.json"
    path.write_text(spec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    (hexproof,) = abi_strings(lib, "tachyon_tpu_halo2_bn254_prove", 1, spec.encode())
    abi_s = time.perf_counter() - t0
    launches = read_launches(HALO2_PATH)
    peak = torch.cuda.max_memory_allocated()
    out = tmp / "halo2_k16.hex"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tachyon_tpu_torch.cli", "prove-halo2", str(path),
                        "--proof", str(out), "--device", device.type], capture_output=True,
                       text=True,
                       env=subprocess_env(), timeout=600)
    cli_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"cli.py prove-halo2 failed ({r.returncode}): {r.stderr[-2000:]}")
    if out.read_text().strip() != hexproof:
        raise AssertionError("cli.py prove-halo2 wrote another hex than the ABI's")
    return {"k": ABI_HALO2_K, "rows": ABI_HALO2_ROWS, "proof_bytes": len(hexproof) // 2,
            "abi_s": round(abi_s, 3), "cli_subprocess_s": round(cli_s, 3),
            "peak_mem_bytes": peak, "launches": launches}


def replay_check(lib, curve, bases: bytes, scalars: bytes, sc, ks, tmp: Path) -> dict:
    """One ABI MSM of 2^REPLAY_LOG_N points with TACHYON_MSM_DUMP_PATH set,
    its dump replayed through ``io/replay.py``: the same point, the host's."""
    n = 1 << REPLAY_LOG_N
    dump_dir = tmp / "msm_dumps"
    os.environ["TACHYON_MSM_DUMP_PATH"] = str(dump_dir)
    out = (ctypes.c_uint8 * 64)()
    try:
        abi_call(lib, "tachyon_tpu_bn254_g1_msm", abi_bytes(bases[:64 * n]),
                 abi_bytes(scalars[:32 * n]), n, out)
    finally:
        del os.environ["TACHYON_MSM_DUMP_PATH"]
    dumps = sorted(dump_dir.glob("msm_*.npz"))
    if len(dumps) != 1:
        raise AssertionError(f"replay: {len(dumps)} dumps of one MSM")
    t0 = time.perf_counter()
    pt = replay.replay_msm(str(dumps[0]), curve.device)
    replay_s = time.perf_counter() - t0
    expected = host_ec.msm_tiled((int(curve.gen_x), int(curve.gen_y)), ks, sc[:, :n], 0,
                                 curve.F.p, curve.SF.p)
    if point_bytes(pt) != bytes(out) or pt != expected:
        raise AssertionError("replay: the replayed MSM differs from the ABI's or the host's")
    return {"n": n, "dump_bytes": dumps[0].stat().st_size, "replay_s": round(replay_s, 3)}


def trace_check(tmp: Path, device) -> dict:
    """``cli.py prove --trace-path`` on the circom mul fixture: the chrome
    trace holds the ProofGeneration span and the port's kernels."""
    trace = tmp / "trace.json"
    t0 = time.perf_counter()
    if cli.main(["prove", f"{CIRCOM_MUL}.zkey", f"{CIRCOM_MUL}.wtns", "--no-zk", "--verify",
                 "--device", device.type, "--proof", str(tmp / "p.json"),
                 "--public", str(tmp / "q.json"), "--trace-path", str(trace)]) != 0:
        raise AssertionError("cli.py prove --trace-path failed")
    names = Counter(e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"])
    kernels = {k: sum(c for nm, c in names.items() if k in nm)
               for k in ("mont_mul_kernel", "scalar_mul", "add_xyzz")}
    if "ProofGeneration/groth16_prove" not in names or (
            device.type == "cuda" and not kernels["mont_mul_kernel"]):
        raise AssertionError(f"the trace lacks the groth16_prove span or K1's kernel: {kernels}")
    return {"s": round(time.perf_counter() - t0, 3), "trace_bytes": trace.stat().st_size,
            "events": sum(names.values()), "kernel_events": kernels}


def plonk_circuit(n: int, seed: int):
    """test_plonk.py's gate q_m (a b - c) on every usable row of 2^log_n,
    PLONK_CHAIN copies c_i = a_{i+1}, the chain's last c copied to the
    instance column, PLONK_BLINDING blinding rows; an honest witness."""
    R = presets.BN254_FR.p
    cs = ConstraintSystem()
    cs.blinding_factors = PLONK_BLINDING
    qm = cs.fixed_column()
    a, b, c = cs.advice_column(), cs.advice_column(), cs.advice_column()
    inst = cs.instance_column()
    for col in (a, c, inst):
        cs.enable_equality(col)
    cs.create_gate("mul", [plonk_expr.Product(plonk_expr.Fixed(qm.index), plonk_expr.Sum(
        plonk_expr.Product(plonk_expr.Advice(a.index), plonk_expr.Advice(b.index)),
        plonk_expr.Negated(plonk_expr.Advice(c.index))))])
    u = cs.usable_rows(n)
    rng = np.random.default_rng(seed)
    av = [int(v) for v in rng.integers(1, 1 << 62, u)]
    bv = [int(v) for v in rng.integers(1, 1 << 62, u)]
    cv = [0] * u
    for i in range(u):
        if 0 < i <= PLONK_CHAIN:
            av[i] = cv[i - 1]
        cv[i] = av[i] * bv[i] % R
    for i in range(PLONK_CHAIN):
        cs.copy((c, i), (a, i + 1))
    cs.copy((c, PLONK_CHAIN), (inst, 0))
    pad = [0] * (n - u)
    return (cs, [[1] * u + pad], [av + pad, bv + pad, cv + pad],
            [[cv[PLONK_CHAIN]] + [0] * (n - 1)])


def plonk_path(device) -> dict:
    """The standalone PLONK prover (zk/plonk/prover.py) at 2^PLONK_LOG_N with
    every launch count set to 0 before the SRS: unsafe_setup, keygen, prove
    (SHPlonk), verify; then GWC; each proof refuses a flipped byte and the
    instance + 1."""
    n = 1 << PLONK_LOG_N
    cs, fixed, advice, instance = plonk_circuit(n, SEED + 16)
    steps = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        steps[name] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()

    params = kzg.unsafe_setup(n, 0x5EED + SEED, device)
    lap("setup")
    pk = plonk.keygen(params, cs, n, fixed)
    lap("keygen")
    proof = plonk.PlonkProver(params, pk).prove(advice, instance)
    lap("prove_shplonk")
    launches = read_launches(PLONK_PATH)
    peak = torch.cuda.max_memory_allocated()
    verdicts = {}
    for pcs in ("shplonk", "gwc"):
        if pcs == "gwc":
            proof = plonk.PlonkProver(params, pk, pcs="gwc").prove(advice, instance)
            lap("prove_gwc")
        ver = plonk.PlonkVerifier(params, pk, pcs=pcs)
        ok = ver.verify(proof, instance)
        lap(f"verify_{pcs}")
        bad = bytearray(proof)
        bad[len(bad) // 2] ^= 1
        wrong = [[(instance[0][0] + 1) % presets.BN254_FR.p] + instance[0][1:]]
        verdicts[pcs] = (ok, ver.verify(bytes(bad), instance), ver.verify(proof, wrong))
        lap(f"checks_{pcs}")
        if verdicts[pcs] != (True, False, False):
            raise AssertionError(f"PLONK {pcs} at 2^{PLONK_LOG_N}: verify gives {verdicts[pcs]} "
                                 "(proof, flipped byte, instance + 1)")
    rec = {"n": n, "blinding_factors": PLONK_BLINDING, "copies": len(cs.copies),
           "proof_bytes": len(proof), "steps_s": steps, "peak_mem_bytes": peak,
           "launches": launches}
    log(f"[plonk] 2^{PLONK_LOG_N} verified=True flipped_byte_rejected=True "
        f"wrong_instance_rejected=True {json.dumps(rec)}")
    return rec


def phase_surfaces(device):
    """Phase 13: the port's C library built and driven (test_capi cuda as a
    subprocess; in this process through ctypes: the MSM at 2^20, the FFT at
    2^20, Poseidon2, the SP1 commit on the fri row and prove_verify, circom
    Groth16 against the CLI, halo2 at k = 16 against the CLI's subprocess),
    replay, the CLI's trace, and the PLONK prover at 2^16.  Returns the
    paths' launches."""
    lib_dir, build_s = build_capi()
    # test_capi runs in its own process beside this one's ABI calls (the
    # script's time limit); its seconds include the overlap
    t_capi = time.perf_counter()
    capi = subprocess.Popen([str(lib_dir / "test_capi"), device.type], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=subprocess_env())
    try:
        lib = load_capi(lib_dir / "libtachyon_tpu_c.so")
        abi_call(lib, "tachyon_tpu_init", device.type.encode())
        curve = curves.bn254_g1(device)
        rng = np.random.default_rng(SEED + 13)
        rec = {}
        n = 1 << ABI_MSM_LOG_N
        bases, scalars, sc, ks, expected = abi_msm_inputs(curve, n, SEED + 13)
        reset_launches()
        rec["msm"] = abi_msm_check(lib, curve, bases, scalars, n, expected)
        paths = {f"abi_msm_2^{ABI_MSM_LOG_N}": read_launches(MSM_PATH)}
        rec["msm_again"] = abi_msm_check(lib, curve, bases, scalars, n, expected)
        rec["fft"] = abi_fft_check(lib, device, rng)
        rec["poseidon2"] = abi_poseidon2_check(lib, device)
        sp1 = abi_sp1_check(lib, device, rng)
        paths[f"abi_sp1_commit_2^{SP1_COMMIT[0]}"] = sp1.pop("launches")
        rec["sp1"] = sp1
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            rec["groth16"] = abi_groth16_check(lib, tmp, device)
            halo = abi_halo2_check(lib, tmp, device)
            paths[f"abi_halo2_2^{ABI_HALO2_K}"] = halo.pop("launches")
            rec["halo2"] = halo
            rec["replay"] = replay_check(lib, curve, bases, scalars, sc, ks, tmp)
            rec["trace"] = trace_check(tmp, device)
        out, err = capi.communicate(timeout=600)
    finally:
        if capi.poll() is None:  # an ABI check failed: stop test_capi too
            capi.kill()
            capi.wait()
    capi_s = time.perf_counter() - t_capi
    if capi.returncode != 0 or not out.strip().endswith("OK"):
        raise AssertionError(f"test_capi cuda failed ({capi.returncode}): {out}{err}")
    log(f"[surfaces] C library built in {build_s:.1f} s; test_capi cuda (every step, embedded "
        f"interpreter) OK in {capi_s:.1f} s beside the calls below: {out.splitlines()[0]}")
    log(f"[surfaces] verified=True {json.dumps(rec)}")
    del bases, scalars
    torch.cuda.empty_cache()
    paths[f"plonk_2^{PLONK_LOG_N}"] = plonk_path(device)["launches"]
    return paths


def mmap_check(zpath: Path, wpath: Path, device) -> dict:
    """The mmap parser (io/native) against the pure-Python parse of the same
    key and witness: every field equal; both timed."""
    t = {}
    parsed = {}
    for native in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parsed[native] = (parse_zkey(str(zpath), device, native=native),
                          parse_wtns(str(wpath), native=native))
        torch.cuda.synchronize()
        t["native_s" if native else "python_s"] = round(time.perf_counter() - t0, 3)
    (zn, (mn, wn)), (zp, (mp, wp)) = parsed[True], parsed[False]
    for f in dataclasses.fields(zn):
        a, b = getattr(zn, f.name), getattr(zp, f.name)
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else (
            np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
        if not same:
            raise AssertionError(f"mmap parse: {f.name} differs from the Python parse")
    if mn != mp or not torch.equal(wn, wp):
        raise AssertionError("mmap parse: the witness differs from the Python parse")
    return t


# phase 14, math and crypto (the last modules of the JAX package): the M31
# circle's order-2^22 subgroup (a Circle-STARK trace domain), the GF(2^k)
# tower at Binius's top level, the binary Merkle tree over BabyBear
# Poseidon2, a LinearCombination of three Goldilocks MLEs (the sumcheck's
# field and size), a sparse univariate over BN254 Fr and the BN254 Fq12
# tower (a batch verifier's Miller-loop accumulators)
CIRCLE_LOG_N = 22
CIRCLE_SAMPLES = 1024
CIRCLE_K = 1868121971  # a 31-bit scalar
TOWER = ((128, 22), (32, 24), (8, 24))  # GF(2^k) and log2 of its batch
TOWER_SAMPLES = 1024
MERKLE_LOG_LEAVES = 20
MERKLE_DIGEST = 8
MERKLE_OPENINGS = 64
LINCOMB_LOG_N = 22
SPARSE = (10, 22, 16)  # log2 of the terms, of the degree bound, of the points
SPARSE_SAMPLES = 64
FQ12_LOG_N = 16
FQ12_POW_LOG_N = 10
FQ12_SAMPLES = 16
FQ12_POW_SAMPLES = 4
CIRCLE_PATH = ("mont_mul_w1",)
MERKLE_PATH = ("mont_mul_w1",)
LINCOMB_PATH = ("mont_mul_w2",)
SPARSE_PATH = ("mont_mul",)
FQ12_PATH = ("mont_mul",)


def counted_path(path, fn):
    """fn() with every launch count set to 0 and the peak memory reset just
    before it, synchronized: (result, seconds, peak bytes, launches); raises
    if a kernel of ``path`` was launched no time."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(), read_launches(path)


def circle_host_mul(a, b, p: int) -> tuple:
    return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)


def circle_host_pow(g, k: int, p: int) -> tuple:
    acc = (1, 0)
    while k:
        if k & 1:
            acc = circle_host_mul(acc, g, p)
        g = circle_host_mul(g, g, p)
        k >>= 1
    return acc


def circle_check(device) -> tuple[dict, dict]:
    """The order-2^CIRCLE_LOG_N subgroup built on the card from
    subgroup_generator by CIRCLE_LOG_N batched adds of the doubling table
    (point i = g^i); every point on the circle; add, double, neg and
    antipode on the batch; scalar_mul by a 31-bit k equal to the subgroup's
    own points at i k (every lane); g^(2^CIRCLE_LOG_N) the identity;
    CIRCLE_SAMPLES lanes equal host ints."""
    C = m31_circle(device)
    p, n = C.F.p, 1 << CIRCLE_LOG_N
    g = C.subgroup_generator(CIRCLE_LOG_N)
    table = [g]
    for _ in range(CIRCLE_LOG_N - 1):
        table.append(circle_host_mul(table[-1], table[-1], p))

    def build():
        pts = C.identity((1,))
        for b in range(CIRCLE_LOG_N):  # [pts, pts + g^(2^b)]: point i is g^i
            step = C.add(pts, C.encode([table[b]]))
            pts = CirclePoint(torch.cat([pts.x, step.x], 1), torch.cat([pts.y, step.y], 1))
        return pts

    pts, build_s, peak, launches = counted_path(CIRCLE_PATH, build)
    one = C.identity((n,))
    times = {"build_s": round(build_s, 4)}
    if not bool(C.is_on_circle(pts).all()):
        raise AssertionError("circle: a point of the subgroup is off the circle")

    def ops():
        tripled = C.add(pts, C.double(pts))  # g^(3i)
        cancel = C.add(pts, C.neg(pts))
        anti = C.antipode(pts)
        return tripled, cancel, anti, C.scalar_mul(pts, CIRCLE_K)

    (tripled, cancel, anti, powk), ops_s, _, ops_launches = counted_path(CIRCLE_PATH, ops)
    times["ops_s"] = round(ops_s, 4)
    launches = {k: v + ops_launches[k] for k, v in launches.items()}  # the build's and the ops
    i = torch.arange(n, device=device)
    for name, got, idx in (("add(P, double(P))", tripled, (3 * i) % n),
                           ("scalar_mul", powk, (CIRCLE_K * i) % n)):
        if not (torch.equal(got.x, pts.x[:, idx]) and torch.equal(got.y, pts.y[:, idx])):
            raise AssertionError(f"circle: {name} is not the subgroup's own point")
    if not (torch.equal(cancel.x, one.x) and torch.equal(cancel.y, one.y)):
        raise AssertionError("circle: P + neg(P) is not the identity")
    half = n // 2  # the antipode is the shift by the point of order 2, g^(n/2)
    if not (torch.equal(anti.x[:, :half], pts.x[:, half:]) and
            torch.equal(anti.y[:, :half], pts.y[:, half:])):
        raise AssertionError("circle: antipode(g^i) is not g^(i + n/2)")
    gen, ident = C.encode([g]), C.identity((1,))

    def is_identity(q):
        return torch.equal(q.x, ident.x) and torch.equal(q.y, ident.y)

    if not is_identity(C.scalar_mul(gen, n)) or is_identity(C.scalar_mul(gen, n // 2)):
        raise AssertionError("circle: g^(2^22) is not the identity, or g^(2^21) is")
    idx = torch.randint(0, n, (CIRCLE_SAMPLES,), device=device)
    xs, ys = C.decode(CirclePoint(pts.x[:, idx], pts.y[:, idx]))
    want = [circle_host_pow(g, int(k), p) for k in idx.tolist()]
    if [(int(x), int(y)) for x, y in zip(xs, ys)] != want:
        raise AssertionError("circle: sampled points differ from host ints")
    return ({"points": n, **times, "peak_mem_bytes": peak, "sampled": CIRCLE_SAMPLES},
            launches)


@functools.lru_cache(maxsize=None)
def tower_mul_alpha(x: int, k: int) -> int:
    """The JAX test's scalar reference (tests/test_binary_field.py)."""
    if k == 1:
        return x
    h = k // 2
    m = (1 << h) - 1
    x0, x1 = x & m, x >> h
    return x1 | ((x0 ^ tower_mul_alpha(x1, h)) << h)


@functools.lru_cache(maxsize=None)
def tower_mul(a: int, b: int, k: int) -> int:
    """GF(2^k) product on host ints (the same test's ``ref_mul``; cached, so
    the low levels' products are looked up)."""
    if k == 1:
        return a & b
    h = k // 2
    m = (1 << h) - 1
    a0, a1, b0, b1 = a & m, a >> h, b & m, b >> h
    z0 = tower_mul(a0, b0, h)
    z1 = tower_mul(a1, b1, h)
    z2 = tower_mul(a0 ^ a1, b0 ^ b1, h) ^ z0 ^ z1
    return (z0 ^ z1) | ((z2 ^ tower_mul_alpha(z1, h)) << h)


def binary_tower_check(device) -> dict:
    """GF(2^128) mul, square and inv on 2^22 elements, GF(2^32) and GF(2^8)
    mul on 2^24 (PyTorch bitwise ops on the card: the JAX package has no
    kernel here); TOWER_SAMPLES lanes against the host scalar tower, and
    a a^-1 = 1 on every nonzero lane of GF(2^128)."""
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 16)
    out = {}
    for k, log_n in TOWER:
        T = binary_field(k, device)
        shape = ((T.words,) if k > 32 else ()) + (1 << log_n,)
        a, b = (mont.narrow(torch.randint(0, 1 << min(k, 32), shape, dtype=torch.int64,
                                          generator=g, device=device)) for _ in range(2))
        a[..., 0] = 0
        ops = {"mul": lambda: T.mul(a, b)}
        if k == 128:
            ops.update(square=lambda: T.square(a), inv=lambda: T.inv(a))
        res, rec = {}, {"n": 1 << log_n}
        for name, fn in ops.items():
            res[name], ms = timed_once(fn)
            rec[f"{name}_ms"] = round(ms, 3)
        idx = torch.randint(0, 1 << log_n, (TOWER_SAMPLES,), generator=g, device=device)
        idx[0] = 0
        av, bv = T.decode(a[..., idx]), T.decode(b[..., idx])
        got = {name: T.decode(r[..., idx]) for name, r in res.items()}
        for j in range(TOWER_SAMPLES):
            x, y = int(av[j]), int(bv[j])
            if int(got["mul"][j]) != tower_mul(x, y, k):
                raise AssertionError(f"GF(2^{k}) mul: lane {int(idx[j])} differs from the host")
            if k == 128 and (int(got["square"][j]) != tower_mul(x, x, k) or
                             tower_mul(x, int(got["inv"][j]), k) != (1 if x else 0)):
                raise AssertionError(f"GF(2^128) square or inv: lane {int(idx[j])} is wrong")
        if k == 128:
            prod = T.mul(a, res["inv"])
            nz = ~T.is_zero(a)
            if not bool(T.is_zero(T.add(prod, T.ones((1 << log_n,))))[nz].all()) or \
                    not bool(T.is_zero(res["inv"][..., 0])):
                raise AssertionError("GF(2^128): a a^-1 != 1 on a nonzero lane, or inv(0) != 0")
        out[f"gf2^{k}"] = rec
    return out


def merkle_check(device) -> tuple[dict, dict]:
    """build over 2^MERKLE_LOG_LEAVES leaves of MERKLE_DIGEST BabyBear
    elements with baby_bear_p3_w16's compress; 8 sampled nodes of the first
    layer rehashed with permute_host; MERKLE_OPENINGS openings verify; a
    tampered leaf is refused."""
    h = poseidon2.baby_bear_p3_w16(device)
    F = h.F
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 17)
    n = 1 << MERKLE_LOG_LEAVES
    vals = torch.randint(0, F.p, (MERKLE_DIGEST, n), generator=g, device=device)
    leaves = F.encode_canonical(vals)
    tree, build_s, peak, launches = counted_path(MERKLE_PATH,
                                                 lambda: binary_merkle.build(h.compress, leaves))
    nodes = torch.randint(0, n // 2, (8,), generator=g, device=device).tolist()
    layer1 = F.decode(tree.layers[1][:, :, nodes])
    for j, node in enumerate(nodes):
        st = vals[:, 2 * node].tolist() + vals[:, 2 * node + 1].tolist()
        if h.permute_host(st)[:MERKLE_DIGEST] != [int(v) for v in layer1[:, j]]:
            raise AssertionError(f"binary Merkle: node {node} of layer 1 is not the host hash")
    root = tree.root()
    t0 = time.perf_counter()
    idx = torch.randint(0, n, (MERKLE_OPENINGS,), generator=g, device=device).tolist()
    for i in idx:
        if not binary_merkle.verify(h.compress, root, i, leaves[:, :, i],
                                    binary_merkle.open_at(tree, i)):
            raise AssertionError(f"binary Merkle: the opening of leaf {i} does not verify")
    open_s = time.perf_counter() - t0
    bad = leaves[:, :, idx[0]].clone()
    bad[:, 0] = F.encode((int(F.decode(bad[:, 0])) + 1) % F.p)
    if binary_merkle.verify(h.compress, root, idx[0], bad, binary_merkle.open_at(tree, idx[0])):
        raise AssertionError("binary Merkle: a tampered leaf verifies")
    return ({"leaves": n, "build_s": round(build_s, 4), "peak_mem_bytes": peak,
             "openings": MERKLE_OPENINGS, "open_verify_s": round(open_s, 3)}, launches)


def lincomb_check(device) -> tuple[dict, dict]:
    """LinearCombination over 3 Goldilocks MLEs of 2^LINCOMB_LOG_N entries
    with product terms: combine equals the field sum of the combined
    table; evaluate equals the terms of mle.evaluate's values (host ints).
    Its linear part: evaluate equals mle.evaluate of the combined table,
    and combine equals 2^nv times that table's value at (1/2, ..., 1/2)."""
    F = PrimeField(presets.GOLDILOCKS, device)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 18)
    nv = LINCOMB_LOG_N
    rng = np.random.default_rng(SEED + 18)
    tables = [mont.to_mont(F.spec, gl_random((1 << nv,), g, device)) for _ in range(3)]
    cs = [int(v) for v in rng.integers(1, 1 << 62, 4)]
    terms = [(cs[0], [0, 1]), (cs[1], [2]), (cs[2], [0, 1, 2]), (cs[3], [])]
    point = [int(v) for v in rng.integers(0, 1 << 62, nv)]
    pt = [F.encode(v) for v in point]
    lc = LinearCombination(F, nv)
    for t in tables:
        lc.add_mle(t)
    for c, idx in terms:
        lc.add_term(c, idx)
    (claim, value), seconds, peak, launches = counted_path(
        LINCOMB_PATH, lambda: (lc.combine(), lc.evaluate(pt)))
    combined = F.zeros((1 << nv,))
    for c, idx in terms:
        prod = F.full((1 << nv,), c)
        for t in idx:
            prod = F.mul(prod, tables[t])
        combined = F.add(combined, prod)
    if not torch.equal(claim, F.sum(combined)):
        raise AssertionError("LinearCombination: combine is not the sum of the combined table")
    vals = [int(F.decode(mle.evaluate(F, t, pt))) for t in tables]
    want = 0
    for c, idx in terms:
        term = c
        for t in idx:
            term = term * vals[t] % F.p
        want = (want + term) % F.p
    if int(F.decode(value)) != want:
        raise AssertionError("LinearCombination: evaluate differs from the MLEs' values")
    lin = LinearCombination(F, nv)
    for t in tables:
        lin.add_mle(t)
    lin.add_term(cs[1], [2])
    lin.add_term(cs[0], [0])
    table = F.add(F.mul(F.full((1 << nv,), cs[1]), tables[2]),
                  F.mul(F.full((1 << nv,), cs[0]), tables[0]))
    half = [F.encode((F.p + 1) // 2)] * nv
    centre = int(F.decode(mle.evaluate(F, table, half)))
    if not torch.equal(lin.evaluate(pt), mle.evaluate(F, table, pt)) or \
            int(F.decode(lin.combine())) != centre * (1 << nv) % F.p:
        raise AssertionError("LinearCombination: the linear part disagrees with mle.evaluate")
    return ({"entries": 1 << nv, "mles": 3, "terms": len(terms), "s": round(seconds, 4),
             "peak_mem_bytes": peak}, launches)


def sparse_check(device) -> tuple[dict, dict]:
    """A SparseUnivariate over BN254 Fr of 2^SPARSE[0] terms of degree below
    2^SPARSE[1] (0 and 2^SPARSE[1] - 1 among them) evaluated at 2^SPARSE[2]
    points in one call; SPARSE_SAMPLES points against host ints."""
    log_k, log_d, log_z = SPARSE
    F = curves.bn254_fr(device)
    rng = np.random.default_rng(SEED + 19)
    degs = {0, (1 << log_d) - 1}
    while len(degs) < 1 << log_k:
        degs.add(int(rng.integers(1, 1 << log_d)))
    terms = {d: int.from_bytes(rng.bytes(40), "little") % F.p for d in degs}
    sp = SparseUnivariate.from_dict(F, terms)
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 19)
    z = random_elements(F.spec, 1 << log_z, g, device)
    vals, seconds, peak, launches = counted_path(SPARSE_PATH, lambda: sp.evaluate(z))
    idx = torch.randint(0, 1 << log_z, (SPARSE_SAMPLES,), generator=g, device=device)
    idx[:3] = torch.arange(3, device=device)  # 0, 1 and p - 1
    zs, got = F.decode(z[:, idx]), F.decode(vals[:, idx])
    for zi, v in zip(zs, got):
        zi = int(zi)
        if int(v) != sum(c * pow(zi, d, F.p) for d, c in terms.items()) % F.p:
            raise AssertionError("SparseUnivariate: a sampled value differs from host ints")
    return ({"terms": 1 << log_k, "degree_below": 1 << log_d, "points": 1 << log_z,
             "s": round(seconds, 4), "peak_mem_bytes": peak, "sampled": SPARSE_SAMPLES},
            launches)


def fq12_lane(F12, x, i: int):
    """Lane i of an Fq12 tensor as host ints in pairing_bn254's nesting,
    ((c0, c1) * 3) * 2."""
    d = F12.decode(x[..., i:i + 1])
    return tuple(tuple((int(d[h][c][0][0]), int(d[h][c][1][0])) for c in range(3))
                 for h in range(2))


def fq12_check(device) -> tuple[dict, dict]:
    """BN254 Fq12 mul, square and inv on 2^FQ12_LOG_N elements and pow_const
    by p (the Frobenius map) on 2^FQ12_POW_LOG_N; sampled lanes against
    pairing_bn254's host-int tower; (a + b)^2 = a^2 + 2ab + b^2 and a a^-1 = 1 on every
    lane."""
    F12 = curves.bn254_fq12(device)
    p, n = F12.p, 1 << FQ12_LOG_N
    g = torch.Generator(device=device)
    g.manual_seed(SEED + 20)

    def rand():
        w = random_elements(presets.BN254_FQ, 12 * n, g, device)  # (8, 12 n)
        return w.reshape(8, 2, 3, 2, n).permute(1, 2, 3, 0, 4).contiguous()

    a, b = rand(), rand()

    def ops():
        return (F12.mul(a, b), F12.square(a), F12.inv(a),
                F12.pow_const(a[..., :1 << FQ12_POW_LOG_N], p))

    (ab, aa, ainv, frob), seconds, peak, launches = counted_path(FQ12_PATH, ops)
    times = {name: round(timed_once(fn)[1], 3) for name, fn in (
        ("mul_ms", lambda: F12.mul(a, b)), ("square_ms", lambda: F12.square(a)),
        ("inv_ms", lambda: F12.inv(a)))}
    lhs = F12.square(F12.add(a, b))
    rhs = F12.add(F12.add(aa, F12.double(ab)), F12.square(b))
    if not bool(F12.eq(lhs, rhs).all()):
        raise AssertionError("Fq12: (a + b)^2 != a^2 + 2ab + b^2 on some lane")
    if not bool(F12.eq(F12.mul(a, ainv), F12.ones((n,))).all()):
        raise AssertionError("Fq12: a a^-1 != 1 on some lane")
    for i in torch.randint(0, n, (FQ12_SAMPLES,), generator=g, device=device).tolist():
        x, y = fq12_lane(F12, a, i), fq12_lane(F12, b, i)
        if fq12_lane(F12, ab, i) != pairing_bn254.f12_mul(x, y) or \
                fq12_lane(F12, aa, i) != pairing_bn254.f12_mul(x, x) or \
                pairing_bn254.f12_mul(x, fq12_lane(F12, ainv, i)) != pairing_bn254.F12_ONE:
            raise AssertionError(f"Fq12: lane {i} differs from the host tower")
    for i in range(FQ12_POW_SAMPLES):
        if fq12_lane(F12, frob, i) != pairing_bn254.f12_pow(fq12_lane(F12, a, i), p):
            raise AssertionError(f"Fq12 pow_const by p: lane {i} differs from the host tower")
    return ({"n": n, "pow_n": 1 << FQ12_POW_LOG_N, "s": round(seconds, 4), **times,
             "peak_mem_bytes": peak}, launches)


def phase_math(device):
    """Phase 14: the circle, the binary tower, the binary Merkle tree, the
    LinearCombination, the sparse univariate and Fq12, each checked.
    Returns the paths' launches."""
    rec, paths = {}, {}
    for name, path, fn in (("circle", f"circle_2^{CIRCLE_LOG_N}", circle_check),
                           ("binary_merkle", f"binary_merkle_2^{MERKLE_LOG_LEAVES}", merkle_check),
                           ("lincomb", f"lincomb_2^{LINCOMB_LOG_N}", lincomb_check),
                           ("sparse", f"sparse_2^{SPARSE[2]}", sparse_check),
                           ("fq12", f"fq12_2^{FQ12_LOG_N}", fq12_check)):
        t0 = time.perf_counter()
        rec[name], paths[path] = fn(device)
        rec[name]["check_s"] = round(time.perf_counter() - t0, 3)
        log(f"[math] {name} verified=True {json.dumps(rec[name])} "
            f"launches={json.dumps({k: v for k, v in paths[path].items() if v})}")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec["binary_tower"] = binary_tower_check(device)
    log(f"[math] binary_tower verified=True {json.dumps(rec['binary_tower'])} "
        f"check_s={time.perf_counter() - t0:.3f} (PyTorch bitwise ops; no kernel)")
    return paths


# phase 15, the C++ binding: test_cc (tachyon_tpu_torch/cc) under
# Runtime("cuda") in its embedded interpreter, beside the same calls through
# ctypes in this process; its bytes must equal theirs
CC_DIR = Path(__file__).resolve().parent / "tachyon_tpu_torch" / "cc"
CC_HALO2_K = 10


def build_cc() -> tuple[Path, float]:
    """``make -C tachyon_tpu_torch/cc`` (the C library if needed, then
    test_cc, into tachyon_tpu_torch/_build/c); raises with make's output."""
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", str(CC_DIR)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"test_cc did not build ({r.returncode}):\n{r.stdout}{r.stderr}")
    return C_DIR.parent / "_build" / "c", time.perf_counter() - t0


def phase_cc(device):
    """Phase 15: test_cc cuda runs MsmG1 at 2^ABI_MSM_LOG_N (phase 13's
    points and scalars), Fft at 2^ABI_FFT_LOG_N, Poseidon2Hash, the circom
    mul key's Groth16Prove (no_zk) and Halo2Prove at k = CC_HALO2_K in a
    subprocess; this process makes the same calls through ctypes (the MSM
    also against the host-exact point); every output's bytes equal."""
    lib_dir, build_s = build_cc()
    curve = curves.bn254_g1(device)
    n = 1 << ABI_MSM_LOG_N
    bases, scalars, _, _, expected = abi_msm_inputs(curve, n, SEED + 13)
    rng = np.random.default_rng(SEED + 21)
    words = rng.integers(0, 1 << 32, size=(8, 1 << ABI_FFT_LOG_N), dtype=np.uint32)
    words[7] &= 0x0FFFFFFF  # below r
    fft_in = words.T.tobytes()
    pos_in = b"".join(pow(3, 50 + i, curve.SF.p).to_bytes(32, "little") for i in range(5))
    spec = halo2_mul_json(CC_HALO2_K, (1 << CC_HALO2_K) - 64, SEED + 21)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "msm.bases").write_bytes(bases)
        (tmp / "msm.scalars").write_bytes(scalars)
        (tmp / "fft.in").write_bytes(fft_in)
        (tmp / "poseidon2.in").write_bytes(pos_in)
        for ext in ("zkey", "wtns"):
            (tmp / f"mul.{ext}").write_bytes(Path(f"{CIRCOM_MUL}.{ext}").read_bytes())
        (tmp / "halo2.json").write_text(spec)
        jobs = ["msm:msm", "fft:fft:0", "poseidon2:poseidon2", "groth16:mul", "halo2:halo2"]
        t0 = time.perf_counter()
        proc = subprocess.Popen([str(lib_dir / "test_cc"), device.type, str(tmp), *jobs],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=subprocess_env())
        try:
            lib = load_capi(lib_dir / "libtachyon_tpu_c.so")
            abi_call(lib, "tachyon_tpu_init", device.type.encode())
            # the ctypes call's bytes are the host-exact point's (checked)
            want = {"msm": abi_msm_check(lib, curve, bases, scalars, n, expected),
                    "msm.out": point_bytes(expected)}
            fwd = (ctypes.c_uint8 * len(fft_in))()
            abi_call(lib, "tachyon_tpu_bn254_fft", abi_bytes(fft_in), 1 << ABI_FFT_LOG_N, 0, fwd)
            want["fft.out"] = bytes(fwd)
            dig = (ctypes.c_uint8 * 32)()
            abi_call(lib, "tachyon_tpu_bn254_poseidon2_hash", abi_bytes(pos_in), 5, dig)
            want["poseidon2.out"] = bytes(dig)
            proof, public = abi_strings(lib, "tachyon_tpu_bn254_groth16_prove", 2,
                                        str(tmp / "mul.zkey").encode(),
                                        str(tmp / "mul.wtns").encode(), 1, 1)
            want["mul.proof.json"], want["mul.public.json"] = proof.encode(), public.encode()
            (hexproof,) = abi_strings(lib, "tachyon_tpu_halo2_bn254_prove", 1, spec.encode())
            want["halo2.hex"] = hexproof.encode()
            ctypes_s = time.perf_counter() - t0
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:  # a ctypes call failed: stop test_cc too
                proc.kill()
                proc.wait()
        cc_s = time.perf_counter() - t0
        if proc.returncode != 0 or not stdout.strip().endswith("OK"):
            raise AssertionError(f"test_cc cuda failed ({proc.returncode}): {stdout}{stderr}")
        for name, data in want.items():
            if name != "msm" and (tmp / name).read_bytes() != data:
                raise AssertionError(f"test_cc: {name} differs from the ctypes call's bytes")
    job_s = dict(line.rsplit(" ", 1) for line in stdout.splitlines()[1:-1])
    rec = {"build_s": round(build_s, 1), "subprocess_s": round(cc_s, 1),
           "ctypes_beside_s": round(ctypes_s, 1), "msm_ctypes": want["msm"],
           "halo2_k": CC_HALO2_K, "job_s": {k: round(float(v), 3) for k, v in job_s.items()}}
    log(f"[cc] test_cc cuda verified=True (bytes equal to ctypes) {json.dumps(rec)}")
    return {}


# phase 16, parallel/ in a one-rank nccl group on the one card, each result
# held against the single-device path
PAR_LOG_N = 22
PAR_WINDOW_C = 17
PAR_LDE = (20, 100, 2, 31)  # log2 rows, columns, log_blowup, shift (BabyBear's generator)


def phase_parallel(device):
    """Phase 16: init_process_group("nccl") with a file:// store under a
    temporary directory (rank 0 of 1); msm_sharded, msm_sharded_windows and
    msm_sharded_2d (a 1 x 1 mesh, c = 17) on slice_inputs(2^22) against the
    host-exact point and the single-device MSM; DistributedNTT fft and ifft
    at 2^22 over bn254_fr against Radix2Domain, DistributedCosetLDE on
    BabyBear 2^20 x 100 at log_blowup 2 against coset_lde_batch and
    fft_batch_dist against Radix2Domain, word for word.  The group is
    destroyed at the end.  Returns the paths' launches."""
    torch.cuda.set_device(device)
    paths, rec = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            dp = mesh.data_mesh(device=device)
            win = mesh.data_mesh(axis="win", device=device)
            grid = mesh.grid_mesh((1, 1), ("dp", "win"), device=device)
            rec["init_s"] = round(time.perf_counter() - t0, 3)
            curve = curves.bn254_g1(device)
            n = 1 << PAR_LOG_N
            points, scalars, ks, sc = slice_inputs(curve, n)
            G = (int(curve.gen_x), int(curve.gen_y))
            expected = host_ec.msm_tiled(G, ks, sc, 0, curve.F.p, curve.SF.p)
            single = curve.to_affine(msm(curve, points, scalars))
            for name, run in (
                    ("msm_sharded", lambda: msm_sharded.msm_sharded(curve, dp, points, scalars)),
                    ("msm_sharded_windows", lambda: msm_sharded.msm_sharded_windows(
                        curve, win, points, scalars, PAR_WINDOW_C)),
                    ("msm_sharded_2d", lambda: msm_sharded.msm_sharded_2d(
                        curve, grid, points, scalars, PAR_WINDOW_C))):
                r = verified_msm(curve, f"{name} 2^{PAR_LOG_N}", run, expected, MSM_PATH, 1)
                aff = curve.to_affine(run())
                if not (torch.equal(aff.x, single.x) and torch.equal(aff.y, single.y)):
                    raise AssertionError(f"{name}: not the single-device MSM's point")
                paths[f"{name}_2^{PAR_LOG_N}"] = r["launches"]
                rec[name] = {k: r[k] for k in ("first_s", "best_s", "peak_mem_bytes")}
            del points, scalars
            Fr = curves.bn254_fr(device)
            g = torch.Generator(device=device)
            g.manual_seed(SEED + 22)
            x = random_elements(Fr.spec, n, g, device)
            dn = ntt_dist.DistributedNTT(Fr, n, dp)
            def fft_ifft():
                y = dn.fft(x)
                return y, dn.ifft(y)

            (y, back), s, peak, launches = counted_path(("mont_mul",), fft_ifft)
            if not torch.equal(y, Radix2Domain(Fr, n).fft(x)) or not torch.equal(back, x):
                raise AssertionError("DistributedNTT: not Radix2Domain's words, or no round trip")
            paths[f"ntt_dist_2^{PAR_LOG_N}"] = launches
            rec["ntt_dist"] = {"n": n, "fft_ifft_s": round(s, 4), "peak_mem_bytes": peak}
            del x, y, back
            log_rows, cols, log_blowup, shift = PAR_LDE
            B = PrimeField(presets.BABY_BEAR, device)
            evals = B.encode_canonical(torch.randint(0, B.p, (1 << log_rows, cols), generator=g,
                                                     device=device))
            dlde = ntt_dist.DistributedCosetLDE(B, 1 << log_rows, log_blowup, shift, dp)
            lde, s, peak, launches = counted_path(("mont_mul_w1",), lambda: dlde(evals))
            if not torch.equal(lde, coset_lde_batch(Radix2Domain(B, 1 << log_rows), evals,
                                                    log_blowup, shift)):
                raise AssertionError("DistributedCosetLDE: not coset_lde_batch's words")
            paths[f"coset_lde_dist_2^{log_rows}"] = launches
            rec["coset_lde_dist"] = {"rows": 1 << log_rows, "cols": cols, "s": round(s, 4),
                                     "peak_mem_bytes": peak}
            del lde
            torch.cuda.empty_cache()
            fb, s, peak, launches = counted_path(("mont_mul_w1",),
                                                 lambda: ntt_dist.fft_batch_dist(B, dp, evals))
            if not torch.equal(fb, Radix2Domain(B, 1 << log_rows)._transform(evals, False)):
                raise AssertionError("fft_batch_dist: not Radix2Domain's words")
            paths[f"fft_batch_dist_2^{log_rows}"] = launches
            rec["fft_batch_dist"] = {"s": round(s, 4), "peak_mem_bytes": peak}
        finally:
            dist.destroy_process_group()
    log(f"[parallel] nccl world_size=1 verified=True {json.dumps(rec)}")
    return paths


def ptxas_registers(nvcc_log: str) -> dict:
    """Registers and spill-store bytes of each kernel from ptxas's -v
    lines, by the kernel's unmangled name and its template arguments
    (``add_xyzz_kernel<12,0>``, ``mont_mul_kernel<8,1>``)."""
    regs, name = {}, None
    for line in nvcc_log.splitlines():
        if m := re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line):
            k = int(m.group(1))
            name = m.group(2)[:k]
            if t := re.match(r"I((?:L[a-z]+\d+E)+)E", m.group(2)[k:]):
                name += "<" + ",".join(re.findall(r"L[a-z]+(\d+)E", t.group(1))) + ">"
            regs[name] = {"registers": None, "spill_stores": 0}
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            regs[name]["spill_stores"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            regs[name]["registers"] = int(m.group(1))
    return regs


SASS_OP = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_opcodes() -> dict:
    """Opcode counts (with their modifiers) per kernel in the built
    library's SASS, when cuobjdump is there."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    lib = _build.BUILD / _build.build_key() / "libtachyon_kernels.so"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = Counter()
        elif name and (m := SASS_OP.search(line)):
            counts[name][m.group(1)] += 1
    return counts


def sass_mix(ops: Counter) -> dict:
    """A kernel's instructions by group: IMAD.WIDE(.U32), IMAD.HI, IMAD.X,
    the other IMADs, IADD3(.X), the rest."""
    mix = Counter()
    for op, n in ops.items():
        group = ("IMAD.WIDE" if op.startswith("IMAD.WIDE") else
                 "IMAD.HI" if op.startswith("IMAD.HI") else
                 "IMAD.X" if op.startswith("IMAD") and op.endswith(".X") else
                 "IMAD" if op.startswith("IMAD") else
                 "IADD3" if op.startswith("IADD3") else "other")
        mix[group] += n
    return dict(mix)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    clock_hz = float(clk) * 1e6
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda} clocks.max.sm={clk} MHz")

    t0 = time.perf_counter()
    _build.library()
    log(f"[build] {time.perf_counter() - t0:.1f} s, key {_build.build_key()}")
    for line in _build.nvcc_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            log(f"[ptxas] {line.strip()}")
    regs = ptxas_registers(_build.nvcc_log())
    for fn, r in regs.items():
        log(f"[regs] {fn}: {r['registers']} registers, {r['spill_stores']} bytes of spill stores")
    sass = sass_opcodes()
    for fn, ops in sass.items():
        wide = sum(n for op, n in ops.items() if op.startswith("IMAD.WIDE"))
        log(f"[sass] {wide} IMAD.WIDE of {sum(ops.values())} instructions in {fn}")
    # K1's kernel is one field multiply and its loads and stores
    for fn, ops in sass.items():
        if "mont_mul_kernel" in fn:
            total = sum(ops.values())
            log(f"[sass-mix] {fn}: {sass_mix(ops)}; {total} instructions, "
                f"{total / WORD_PRODUCTS:.2f} per word product; by opcode "
                f"{dict(ops.most_common())}")
    log(f"[bound] {WORD_PRODUCTS} word products per field multiply (2 W^2 + W at W = 8; "
        f"{word_products(12)} at W = 12), "
        f"{IMAD_PER_CLK_SM} per clock per SM x {SMS} SMs x {clock_hz / 1e6:.0f} MHz; "
        f"{HBM_BYTES_PER_S / 1e12} TB/s")

    rng = np.random.default_rng(SEED)
    _, base_x, base_y = base_points(curves.bn254_g1(device), rng)
    results: dict = {}
    results12: dict = {}  # the W = 12 instantiations' numbers
    results_full: dict = {}  # the full-width W = 8 instantiations' numbers (secp256k1)
    phase_s = {}

    def phase(name, fn, *args):
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out = fn(device, *args)
        phase_s[name] = round(time.perf_counter() - t1, 1)
        return out

    phase("kernels", phase_kernels, base_x, base_y, clock_hz, results)
    msm_launches = phase("msm", phase_slice)
    kzg_launches, multiopen_launches = phase("kzg", phase_kzg)
    groth16_launches = phase("groth16", phase_groth16)
    circom_launches = phase("circom", phase_circom)
    stark_launches = phase("stark", phase_stark, clock_hz, results)
    bls_extra, bls_by_form = phase("groth16_bls12_381", phase_groth16_bls12, clock_hz,
                                   results12)
    secp_extra, secp_paths = phase("secp256k1", phase_secp256k1, clock_hz, results_full)
    gl_launches = phase("goldilocks", phase_goldilocks, clock_hz, results)
    halo2_launches = phase("halo2", phase_halo2)
    surface_launches = phase("surfaces", phase_surfaces)
    math_launches = phase("math", phase_math)
    phase("cc", phase_cc)
    parallel_launches = phase("parallel", phase_parallel)
    bls_path = f"groth16_bls12_381_2^{BLS_LOG_N}"
    log(f"[phases] seconds {json.dumps(phase_s)}, since the build started "
        f"{time.perf_counter() - t0:.1f} s")

    def registers(name, W, spare):
        return {k: regs.get(k) for k in (d.format(W=W, spare=int(spare))
                                         for d in DEVICE_KERNELS[name])}

    # the kernel checks' extra numbers at W = 8 (K1 also at W = 1), by name
    extra8 = {"suffix_sweep": results["suffix_sweep_phases"],
              "reduce_sweep": results["reduce_sweep_segments"],
              "mont_mul": {"call_us": results["mont_mul_call_us"]},
              "mont_mul_w1": {"call_us": results["mont_mul_w1_call_us"],
                              "broadcast": results["mont_mul_w1_broadcast"]},
              "mont_mul_w2": {"call_us": results["mont_mul_w2_call_us"],
                              "broadcast": results["mont_mul_w2_broadcast"],
                              "edges": results["mont_mul_w2_edges"],
                              "lde": results["goldilocks_lde"]},
              "horner": {"k3_k2_loop_ms": results["horner_loop_ms"],
                         "chain": results["horner_chain"],
                         "shapes_2^18": [results["horner_2^18"]]},
              "add_xyzz": {"ms_by_width": results["add_xyzz_by_width"]},
              "bucket_add": {**results["bucket_add_info"],
                             "shapes_2^18": results["bucket_add_2^18"]}}

    def lane_numbers(res):
        """The lane scan's and fold's loops of K2 launches, from lane_check."""
        return {name: {"k2_path_ms": res[f"{name}_k2_path_ms"],
                       "k2_loop_ms": res[f"{name}_before_ms"],
                       "schedule_adds": res[f"{name}_schedule_adds"]}
                for name in ("lane_suffix_scan", "lane_fold")}
    paths = {f"msm_2^{LOG_N}": msm_launches, f"kzg_2^{KZG_LOG_N}": kzg_launches,
             f"groth16_2^{GROTH16_LOG_N}": groth16_launches,
             f"circom_2^{CIRCOM_LOG_N}": circom_launches,
             f"stark_2^{STARK_LOG_N}": stark_launches,
             f"goldilocks_2^{GL_LDE[0]}": gl_launches,
             f"multiopen_2^{KZG_LOG_N}": multiopen_launches, **halo2_launches,
             **surface_launches, **math_launches, **parallel_launches}
    # an entry for every kernel at W = 8 on a spare bit (K1 at W = 1 and 2 too),
    # with every main path's launches, then one named <name>_w12 for each
    # W = 12 instantiation, checked and timed at the BLS12-381 path's shapes,
    # and one named <name>_w8_full for each full-width W = 8 instantiation,
    # at the secp256k1 path's, each with its paths' launches there
    kernels = []
    Form = cuda_mont.Form
    for form, suffix, res, extra in ((Form(8, True), "", results, extra8),
                                     (Form(12, False), "_w12", results12, bls_extra),
                                     (Form(8, False), "_w8_full", results_full, secp_extra)):
        extra = {**lane_numbers(res), **extra}
        for name, (_, source, replaces) in KERNELS.items():
            if name not in res:
                continue  # K1 at one and two words is checked once, beside the spare-bit kernels
            w = {"mont_mul_w1": 1, "mont_mul_w2": 2}.get(name, form.W)
            tag = {1: "w1_full", 2: "w2_full"}.get(w, form.tag)
            by_path = {p: n[name] for p, n in paths.items()} if suffix == "" else {}
            by_path[bls_path] = bls_by_form[tag][name]
            by_path.update({p: n[tag][name] for p, n in secp_paths.items()})
            r = res[name]
            entry = {"name": name + suffix, "route": "cuda",
                     "source": source, "replaces": replaces,
                     "launches": sum(by_path.values()), "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": None,
                     "fmul_per_s": r["fmul_per_s"], "launches_by_path": by_path,
                     "shape": r["shape"], "plain_shape": r["plain_shape"], "w": w,
                     "form": tag[tag.index("_") + 1:],
                     "registers": registers(name, w, tag == "w8_spare")}
            if name in ALSO_REPLACES:
                entry["also_replaces"] = ALSO_REPLACES[name]
            entry.update(extra.get(name, {}))
            kernels.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
