"""Python side of the port's C ABI: byte-level marshalling into the port.

Port of ``tachyon_tpu/c/bridge.py``, called from the embedded interpreter of
``libtachyon_tpu_c.so`` (``c/c_api.cc``) and from ``cli.py prove-halo2``.
Analog of the conversion role of the reference's C API shims (reference:
tachyon/c/math/elliptic_curves/msm/msm_input_provider.h,
c/zk/plonk/halo2/bn254_prover.cc): normalise the caller's flat byte layout
into device tensors, run, convert back.

Conventions (see api.h): field elements are 32-byte little-endian standard
form; affine points are x || y with x = y = 0 for infinity.  The bytes out
are the JAX bridge's.  Where the JAX bridge converts element by element in
Python, the port reads a buffer with ``numpy.frombuffer`` as 32-bit words
(the port's word layout, transposed) and writes words back with
``tobytes``; Montgomery encoding and decoding run on the device (K1).

``init(platform)`` selects the device: "cuda", "gpu", "" or None the card
(cuda:0; raises when CUDA is absent), "cpu" the plain PyTorch path (the
tests); an entry called before ``init`` runs on the card.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

_device: torch.device | None = None


def init(platform: str | None = None) -> torch.device:
    """Select the device of every later call; returns it."""
    global _device
    name = (platform or "").strip().lower()
    if name in ("", "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"platform {platform!r} asks for the card, but CUDA is not "
                               "available on this host")
        dev = torch.device("cuda", 0)
    elif name == "cpu":
        dev = torch.device("cpu")
    else:
        raise ValueError(f"unknown platform {platform!r}: expected 'cuda', 'gpu' or 'cpu'")
    _device = dev
    return dev


def device() -> torch.device:
    return _device if _device is not None else init(None)


def _check_len(what: str, data: bytes, want: int) -> None:
    if len(data) != want:
        raise ValueError(f"{what}: {len(data)} bytes, expected {want}")


def _words(data: bytes, n: int, per: int = 1) -> torch.Tensor:
    """n records of ``per`` 32-byte LE values -> (8, per, n) int32 words."""
    w = np.frombuffer(data, dtype="<u4").reshape(n, per, 8).transpose(2, 1, 0)
    return torch.from_numpy(np.array(w, order="C").view(np.int32))


def _bytes(words: torch.Tensor) -> bytes:
    """(8, n) standard-form words -> n 32-byte LE values."""
    return words.cpu().numpy().view("<u4").T.tobytes()


def _ints(data: bytes, n: int) -> list[int]:
    from tachyon_tpu_torch.fields import limbs

    return limbs.words_to_ints(_words(data, n)[:, 0].numpy().view(np.uint32))


def msm_g1(bases: bytes, scalars: bytes, n: int) -> bytes:
    """sum_i scalars_i bases_i on BN254 G1 through the port's MSM on the
    device (the naive ladder up to 128 points, the sweep path above)."""
    from tachyon_tpu_torch.io.replay import dump_msm
    from tachyon_tpu_torch.math import curves
    from tachyon_tpu_torch.math.ec import AffinePoint
    from tachyon_tpu_torch.math.msm import msm
    from tachyon_tpu_torch.ops import mont

    _check_len("msm_g1 bases", bases, 64 * n)
    _check_len("msm_g1 scalars", scalars, 32 * n)
    dev = device()
    g1 = curves.bn254_g1(dev)
    xy = _words(bases, n, 2).to(dev)
    inf = (xy == 0).all(dim=0).all(dim=0)
    xy = mont.to_mont(g1.F.spec, xy)
    pts = AffinePoint(xy[:, 0].contiguous(), xy[:, 1].contiguous(), inf)
    sc = _words(scalars, n)[:, 0].contiguous().to(dev)
    dump_msm("bn254_g1", pts, sc)
    acc = g1.to_affine(msm(g1, pts, sc))
    if bool(acc.inf):
        return b"\x00" * 64
    return _bytes(mont.mont_reduce(g1.F.spec, torch.stack([acc.x, acc.y], dim=1)))


def fft(data: bytes, n: int, inverse: int) -> bytes:
    from tachyon_tpu_torch.math import curves
    from tachyon_tpu_torch.math.ntt import Radix2Domain
    from tachyon_tpu_torch.ops import mont

    _check_len("fft input", data, 32 * n)
    Fr = curves.bn254_fr(device())
    dom = Radix2Domain(Fr, n)
    vals = mont.to_mont(Fr.spec, _words(data, n)[:, 0].contiguous().to(Fr.device))
    out = dom.ifft(vals) if inverse else dom.fft(vals)
    return _bytes(mont.mont_reduce(Fr.spec, out))


def poseidon2_hash(inputs: bytes, n: int) -> bytes:
    """Width-3 sponge, rate 2, capacity 1: absorb pairs additively, then
    squeeze state[1] (the JAX bridge's kroma/halo2-style duplex on the
    host-exact permutation)."""
    from tachyon_tpu_torch.crypto.poseidon2 import bn254_w3

    _check_len("poseidon2_hash input", inputs, 32 * n)
    h = bn254_w3(device())
    p = h.F.p
    vals = _ints(inputs, n)
    st = [0, 0, 0]
    for off in range(0, n, 2):
        for i, v in enumerate(vals[off:off + 2]):
            st[i + 1] = (st[i + 1] + v) % p
        st = h.permute_host(st)
    return (st[1] % p).to_bytes(32, "little")


def groth16_prove(zkey_path: str, wtns_path: str, no_zk: int,
                  verify: int) -> tuple[str, str]:
    """snarkjs proof.json and public.json strings of a circom proof."""
    from tachyon_tpu_torch.cli import proof_json
    from tachyon_tpu_torch.io.zkey import parse_wtns, parse_zkey
    from tachyon_tpu_torch.zk.groth16.prover import CircomGroth16Prover, public_inputs

    dev = device()
    zkey = parse_zkey(zkey_path, dev)
    _, wtns = parse_wtns(wtns_path)
    prover = CircomGroth16Prover(zkey, dev)
    proof = prover.prove(wtns, deterministic=bool(no_zk))
    pub = public_inputs(zkey, wtns)
    if verify and not prover.verify(proof, pub):
        raise RuntimeError("proof verification failed")
    return json.dumps(proof_json(proof)), json.dumps([str(v) for v in pub])


def _build_expr(e, sels):
    from tachyon_tpu_torch.zk.plonk import expressions as ex

    tag = e[0]
    if tag == "const":
        return ex.Constant(int(e[1]))
    if tag in ("fixed", "advice", "instance"):
        return {"fixed": ex.Fixed, "advice": ex.Advice,
                "instance": ex.Instance}[tag](int(e[1]), int(e[2]))
    if tag == "challenge":
        return ex.Challenge(int(e[1]), int(e[2]))
    if tag == "selector":
        return sels[int(e[1])]
    if tag == "neg":
        return ex.Negated(_build_expr(e[1], sels))
    if tag == "sum":
        return ex.Sum(_build_expr(e[1], sels), _build_expr(e[2], sels))
    if tag == "prod":
        return ex.Product(_build_expr(e[1], sels), _build_expr(e[2], sels))
    if tag == "scaled":
        return ex.Scaled(_build_expr(e[1], sels), int(e[2]))
    raise ValueError(f"unknown expression tag {tag!r}")


class JsonCircuit:
    """A halo2 circuit described by the JSON schema of ``api.h``
    (``tachyon_tpu_halo2_bn254_prove``); the JAX bridge's circuit builder."""

    def __init__(self, spec: dict):
        self.spec = spec

    def floor_planner(self, cs, n):
        from tachyon_tpu_torch.zk.plonk.layout import SimpleFloorPlanner

        return SimpleFloorPlanner(cs, n)

    def configure(self, cs):
        from tachyon_tpu_torch.zk.plonk.constraint_system import ColumnRef

        spec = self.spec
        cols = {
            "advice": [cs.advice_column() for _ in range(spec.get("num_advice", 0))],
            "fixed": [cs.fixed_column() for _ in range(spec.get("num_fixed", 0))],
            "instance": [cs.instance_column() for _ in range(spec.get("num_instance", 0))],
        }
        sels = [cs.create_simple_selector() if kind == "simple"
                else cs.create_complex_selector() for kind in spec.get("selectors", [])]
        for kind, idx in spec.get("equality", []):
            cs.enable_equality(ColumnRef(kind, idx))
        for kind, idx in spec.get("constants", []):
            cs.enable_constant(ColumnRef(kind, idx))
        for gi, polys in enumerate(spec.get("gates", [])):
            cs.create_gate(f"gate{gi}", [_build_expr(p, sels) for p in polys])
        for lk in spec.get("lookups", []):
            cs.lookup(lk.get("name", "lookup"),
                      [(_build_expr(i, sels), _build_expr(t, sels))
                       for i, t in zip(lk["inputs"], lk["tables"])])
        for sh in spec.get("shuffles", []):
            cs.shuffle(sh.get("name", "shuffle"),
                       [(_build_expr(i, sels), _build_expr(t, sels))
                        for i, t in zip(sh["inputs"], sh["shuffles"])])
        cs.collect_queries()
        return {"cols": cols, "sels": sels}

    def synthesize(self, config, layouter):
        from tachyon_tpu_torch.zk.plonk import halo2
        from tachyon_tpu_torch.zk.plonk.constraint_system import ColumnRef

        asg = self.spec.get("assignments", {})
        a = layouter.assignment
        for j, col in enumerate(asg.get("advice", [])):
            for r, v in enumerate(col):
                a.advice[j][r] = int(v) % halo2.FR
        for j, col in enumerate(asg.get("fixed", [])):
            for r, v in enumerate(col):
                a.fixed[j][r] = int(v) % halo2.FR
        for j, col in enumerate(asg.get("selectors", [])):
            for r, v in enumerate(col):
                if v:
                    a.selectors[j][r] = True
        for (ka, ia, ra), (kb, ib, rb) in asg.get("copies", []):
            layouter.cs.copy((ColumnRef(ka, ia), ra), (ColumnRef(kb, ib), rb))

    def instance_columns(self):
        return self.spec.get("instances", [])


def halo2_prove(circuit_json: str) -> str:
    """JSON-described circuit -> halo2 bit-compatible proof (hex), proved on
    the device and verified before it is returned (reference:
    c/zk/plonk/halo2/bn254_prover.cc create-proof entry)."""
    from tachyon_tpu_torch.io.replay import dump_halo2
    from tachyon_tpu_torch.zk.plonk import halo2
    from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

    dump_halo2(circuit_json)
    spec = json.loads(circuit_json)
    circ = JsonCircuit(spec)
    dev = device()
    pk = halo2.keygen(circ, k=int(spec["k"]), lookup_type=spec.get("lookup_type", "halo2"),
                      pcs=spec.get("pcs", "shplonk"), device=dev)
    proof = halo2.Halo2Prover(pk, legacy_serialization=False,
                              backend=TorchBackend(pk, dev)).create_proof(
        [circ], [circ.instance_columns()])
    ver = halo2.Halo2Verifier(pk, legacy_serialization=False)
    if not ver.verify(proof.proof, [circ.instance_columns()]):
        raise RuntimeError("halo2 self-verification failed")
    return proof.proof.hex()


def _sp1_matrices(F, matrices_blob: bytes) -> list[torch.Tensor]:
    """The u32-LE matrix stream (count, then per matrix rows, cols and the
    row-major values) -> (1, rows, cols) Montgomery tensors on F's device:
    one ``frombuffer`` view and one K1 encode per matrix."""
    if len(matrices_blob) % 4:
        raise ValueError(f"matrix stream of {len(matrices_blob)} bytes is not u32 aligned")
    vals = np.frombuffer(matrices_blob, dtype="<u4")
    if not len(vals):
        raise ValueError("empty matrix stream")
    num, off, mats = int(vals[0]), 1, []
    for _ in range(num):
        if off + 2 > len(vals):
            raise ValueError("matrix stream truncated in a header")
        rows, cols = int(vals[off]), int(vals[off + 1])
        off += 2
        if off + rows * cols > len(vals):
            raise ValueError(f"matrix stream truncated: a {rows} x {cols} matrix")
        m = vals[off:off + rows * cols].reshape(rows, cols) % np.uint32(F.p)
        off += rows * cols
        mats.append(F.encode_canonical(torch.from_numpy(m.astype(np.int32))))
    if off != len(vals):
        raise ValueError(f"matrix stream has {len(vals) - off} trailing words")
    return mats


def _sp1_pcs(log_blowup: int, num_queries: int, pow_bits: int):
    from tachyon_tpu_torch.crypto import poseidon2
    from tachyon_tpu_torch.crypto.fri import FRIConfig, TwoAdicFRIPCS
    from tachyon_tpu_torch.fields import extensions

    h = poseidon2.baby_bear_p3_w16(device())
    return TwoAdicFRIPCS(h.F, extensions.baby_bear4(h.F.device), h,
                         FRIConfig(log_blowup=log_blowup, num_queries=num_queries,
                                   proof_of_work_bits=pow_bits))


def _root_ints(F, data) -> list[int]:
    return [int(v) for v in F.decode(data.root()).reshape(-1)]


def sp1_baby_bear_fri_commit(log_blowup: int, matrices_blob: bytes) -> bytes:
    """Commit-only entry for the SP1 PCS swap: coset-LDE batch + Poseidon2
    field-merkle-tree MMCS; returns the 8-u32-LE root (reference:
    c/zk/air/sp1/baby_bear_poseidon2_two_adic_fri.cc commit path)."""
    pcs = _sp1_pcs(log_blowup, 1, 0)  # queries and grinding unused for a commit
    data = pcs.commit(_sp1_matrices(pcs.F, matrices_blob))
    return struct.pack("<8I", *_root_ints(pcs.F, data))


def sp1_baby_bear_fri_prove_verify(log_blowup: int, num_queries: int, pow_bits: int,
                                   matrices_blob: bytes) -> bytes:
    """BabyBear Poseidon2 TwoAdicFRI commit -> open -> verify round trip
    (reference: c/zk/air/sp1/baby_bear_poseidon2_two_adic_fri.cc); returns
    the root as 8 u32 LE; raises when the proof does not verify."""
    from tachyon_tpu_torch.crypto.challenger import DuplexChallenger

    pcs = _sp1_pcs(log_blowup, num_queries, pow_bits)
    F = pcs.F
    mats = _sp1_matrices(F, matrices_blob)
    data = pcs.commit(mats)
    root = _root_ints(F, data)

    def challenger():
        # SP1 convention: duplex rate 8 over the width-16 permutation
        # (reference: c/zk/air/sp1/baby_bear_poseidon2_constants.h)
        ch = DuplexChallenger(pcs.h, rate=8)
        for v in root:
            ch.observe(v)
        return ch

    p_ch = challenger()
    zeta = p_ch.sample_ext(pcs.ext.D)
    points = [[[zeta]] * len(mats)]
    opened_values, proof = pcs.create_opening_proof([data], points, p_ch)
    v_ch = challenger()
    if v_ch.sample_ext(pcs.ext.D) != zeta:
        raise RuntimeError("FRI challenger replay diverged")
    dims = [[(m.shape[1], m.shape[2]) for m in mats]]
    if not pcs.verify_opening_proof([data.root()], dims, points, opened_values, proof, v_ch):
        raise RuntimeError("FRI verification failed")
    return struct.pack("<8I", *root)
