"""The port's MSM path against the JAX package on CPU (BN254 G1).

Sweeps, digits and blind points are compared word for word with the JAX
package; whole MSMs are compared as affine points with its exact host
reference ``msm_host_reference``.  The MSMs use c = 10 and short scalars
(few windows) to keep the file fast on a CPU: every window runs the same
code, and the full-width 2^22 MSM runs in ``chip_smoke.py`` on the card.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import msm as jmsm
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu.ops import pallas_msm
from tachyon_tpu.fields.spec import int_to_limbs
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import msm as tmsm
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec, cuda_mont, cuda_msm

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
P = jcurves.bn254_g1().F.p
G = (1, 2)


def pool_points(rng, k=32):
    return [host_ec.scalar_mul(G, int(s), 0, P) for s in rng.integers(1, 1 << 16, k)]


def port_inputs(pts, scalars):
    """Point ints (None = infinity) and scalar ints -> port tensors."""
    F = curves.bn254_g1("cpu").F
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    inf = torch.tensor([p is None for p in pts])
    sl = np.stack([int_to_limbs(int(s), 16) for s in scalars], axis=-1)
    return AffinePoint(F.encode(xs), F.encode(ys), inf), limbs.from_jax_limbs(sl)


def port_msm_affine(pts, scalars, **kw):
    curve = curves.bn254_g1("cpu")
    points, sw = port_inputs(pts, scalars)
    aff = curve.to_affine(tmsm.msm(curve, points, sw, **kw))
    if bool(aff.inf):
        return None
    return (int(curve.F.decode(aff.x)), int(curve.F.decode(aff.y)))


def jax_blinds():
    return jmsm._blind_points(jcurves.bn254_g1())


def test_blind_points_match_jax():
    got = tmsm._blind_points(curves.bn254_g1("cpu"))
    for (jp, jn), (tp, tn) in zip(jax_blinds(), got):
        for jt, tt in zip(tuple(jp) + tuple(jn), tuple(tp) + tuple(tn)):
            np.testing.assert_array_equal(limbs.to_jax_limbs(tt), np.asarray(jt))


@pytest.mark.parametrize("c", [10, 13, 17])
def test_digit_decompose_vs_jax(c):
    rng = np.random.default_rng(31)
    sl = np.stack([int_to_limbs(int.from_bytes(rng.bytes(40), "little") % (1 << 254), 16)
                   for _ in range(20)], axis=-1)
    want = np.asarray(jmsm.digit_decompose(jnp.asarray(sl), 254, c))
    got = tmsm.digit_decompose(limbs.from_jax_limbs(sl), 254, c)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def rows_to_port(t):
    """(R, L, C) JAX limbs -> (R, W, C) port words."""
    return limbs.from_jax_limbs(t.transpose(1, 0, 2)).permute(1, 0, 2).contiguous()


def rows_to_jax(t):
    """(R, W, C) port words -> (R, L, C) JAX limbs."""
    return limbs.to_jax_limbs(t.permute(1, 0, 2)).transpose(1, 0, 2)


def sweep_inputs():
    """R = 4 rows x C = 8 lanes of affine points (some at infinity) and
    XYZZ rows, with the JAX package's blind points broadcast over lanes."""
    R, C = 4, 8
    rng = np.random.default_rng(32)
    pool = pool_points(rng, R * C)
    F = jcurves.bn254_g1().F
    x = F.encode(np.array([p[0] for p in pool], dtype=object)).reshape(16, R, C)
    y = F.encode(np.array([p[1] for p in pool], dtype=object)).reshape(16, R, C)
    x, y = np.ascontiguousarray(x.transpose(1, 0, 2)), np.ascontiguousarray(y.transpose(1, 0, 2))
    inf = (rng.random((R, 1, C)) < 0.25).astype(np.uint32)
    (d1, _), (d2, _) = jax_blinds()
    dc = [tuple(np.broadcast_to(np.asarray(t)[:, None], (16, C)).copy() for t in d)
          for d in (d1, d2)]
    return x, y, inf, dc


def test_suffix_sweep_vs_jax():
    x, y, inf, (dc, _) = sweep_inputs()
    want = pallas_msm.suffix_sweep_jnp(jcurves.bn254_g1(), jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(inf), tuple(jnp.asarray(t) for t in dc))
    f = curves.bn254_g1("cpu").F.spec
    got = cuda_msm.suffix_sweep(f, rows_to_port(x), rows_to_port(y),
                                torch.from_numpy(inf.astype(np.int32)),
                                tuple(limbs.from_jax_limbs(t) for t in dc))
    for jt, tt in zip(want, got):
        assert tuple(tt.shape) == (4, 8, 8)
        np.testing.assert_array_equal(rows_to_jax(tt), np.asarray(jt))


def test_reduce_sweep_vs_jax():
    x, y, inf, (d1, d2) = sweep_inputs()
    f = curves.bn254_g1("cpu").F.spec

    # XYZZ rows with varied zz: suffix sums of the affine rows, some zeroed
    suf = cuda_msm.suffix_sweep(f, rows_to_port(x), rows_to_port(y),
                                torch.from_numpy(inf.astype(np.int32)),
                                tuple(limbs.from_jax_limbs(t) for t in d1))
    rows = tuple(torch.where(torch.from_numpy(inf.astype(bool)), 0, t) for t in suf)
    want = pallas_msm.reduce_sweep_jnp(jcurves.bn254_g1(),
                                       tuple(jnp.asarray(rows_to_jax(t)) for t in rows),
                                       tuple(jnp.asarray(t) for t in d2))
    got = cuda_msm.reduce_sweep(f, rows, tuple(limbs.from_jax_limbs(t) for t in d2))
    for jt, tt in zip(want, got):
        np.testing.assert_array_equal(limbs.to_jax_limbs(tt), np.asarray(jt))


def test_msm_n64_vs_reference():
    """n = 64 takes the naive path (scalar_mul + tree reduce), as in the
    JAX package."""
    rng = np.random.default_rng(33)
    pts = pool_points(rng, 64)
    scalars = [int(s) for s in rng.integers(0, 1 << 10, 64)]
    want = jmsm.msm_host_reference(jcurves.bn254_g1(), pts, scalars)
    assert port_msm_affine(pts, scalars, total_bits=10) == want


@pytest.mark.parametrize("n", [300, 600])
def test_msm_sweep_path_vs_reference(n):
    """c = 10 sweep path; n = 600 gives R = 2 rows per lane; a small point
    pool puts duplicate points into the buckets."""
    rng = np.random.default_rng(34 + n)
    pool = pool_points(rng)
    pts = [pool[i % 32] for i in range(n)]
    scalars = [int(s) for s in rng.integers(0, 1 << 20, n)]
    want = jmsm.msm_host_reference(jcurves.bn254_g1(), pts, scalars)
    assert port_msm_affine(pts, scalars, c=10, total_bits=20) == want


def test_msm_with_infinity_points():
    rng = np.random.default_rng(35)
    pool = pool_points(rng)
    pts = [None if i % 3 == 0 else pool[i % 32] for i in range(300)]
    scalars = [int(s) for s in rng.integers(0, 1 << 20, 300)]
    want = jmsm.msm_host_reference(jcurves.bn254_g1(), pts, scalars)
    assert port_msm_affine(pts, scalars, c=10, total_bits=20) == want


def test_msm_all_same_scalar():
    """Adversarial bucket skew: one bucket per window holds every point."""
    rng = np.random.default_rng(36)
    pts = pool_points(rng, 300)
    s = 0xBEEF1
    want = jmsm.msm_host_reference(jcurves.bn254_g1(), pts, [s] * 300)
    assert port_msm_affine(pts, [s] * 300, c=10, total_bits=20) == want


def test_cpu_tensors_launch_no_kernel():
    wrappers = (cuda_mont.mul, cuda_ec.add_xyzz, cuda_ec.dbl_xyzz,
                cuda_msm.suffix_sweep, cuda_msm.reduce_sweep,
                cuda_ec.lane_suffix_scan, cuda_ec.lane_fold, cuda_ec.horner)
    for w in wrappers:
        w.launches = 0
    rng = np.random.default_rng(37)
    pts = pool_points(rng, 8)
    scalars = [int(s) for s in rng.integers(1, 1 << 10, 8)]
    got = port_msm_affine(pts, scalars, c=10, total_bits=10)
    assert got == host_ec.msm(pts, scalars, 0, P)
    assert [w.launches for w in wrappers] == [0] * len(wrappers)


SCRIPTS = ["chip_smoke", "scripts.circom_key", "scripts.fri_pinned",
           "scripts.make_torch_stark_fixture", "scripts.make_torch_halo2_fixture"]


def test_port_imports_without_jax():
    """Every port module, chip_smoke and the scripts it imports (the circom
    key writer, the pinned FRI transcript, the STARK fixture's AIR, the
    halo2 fixture's cases) import with jax and the JAX package
    (tachyon_tpu) made unimportable."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "tachyon_tpu_torch").rglob("*.py"))
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['tachyon_tpu'] = None\n"
        f"import importlib\nfor m in {mods + SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k.split('.')[0] in ('jax', 'tachyon_tpu') for k in sys.modules"
        " if sys.modules[k] is not None)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
    assert len(mods) >= 78
    # the GLV and fixed-base MSMs, whose JAX counterparts import jax.numpy
    assert {"tachyon_tpu_torch.math.glv", "tachyon_tpu_torch.math.fixed_msm"} <= set(mods)
    # the Goldilocks slice's modules: SimpleFRI, the MLE and the sumcheck
    assert {"tachyon_tpu_torch.crypto.simple_fri", "tachyon_tpu_torch.math.mle",
            "tachyon_tpu_torch.crypto.sumcheck"} <= set(mods)
    # the halo2 slice's fourteen modules
    assert {f"tachyon_tpu_torch.{m}" for m in (
        "base.log", "crypto.rng", "crypto.transcript", "crypto.poseidon", "crypto.multiopen",
        "zk.plonk.expressions", "zk.plonk.constraint_system", "zk.plonk.selector",
        "zk.plonk.layout", "zk.plonk.lookup", "zk.plonk.stringifier", "zk.plonk.halo2",
        "zk.plonk.halo2_device", "zk.plonk.circuits")} <= set(mods)
    # the last slice: sparse polynomials, the circle and binary tower, the
    # binary Merkle tree and the multi-GPU paths
    assert {f"tachyon_tpu_torch.{m}" for m in (
        "math.sparse", "math.circle", "math.binary_field", "crypto.binary_merkle",
        "parallel.mesh", "parallel.msm_sharded", "parallel.ntt_dist")} <= set(mods)


def test_msm_naive_dispatch(monkeypatch):
    """n <= 128 goes to _msm_naive and n = 129 to the sweep path, at the JAX
    package's threshold."""
    assert tmsm.MSM_NAIVE_THRESHOLD == jmsm.MSM_NAIVE_THRESHOLD == 128
    calls = []
    monkeypatch.setattr(tmsm, "_msm_naive", lambda c, p, s: calls.append(s.shape[1]) or "naive")
    rng = np.random.default_rng(38)
    pool = pool_points(rng, 8)
    scalars = [int(s) for s in rng.integers(0, 1 << 10, 129)]
    pts = [pool[i % 8] for i in range(129)]
    curve = curves.bn254_g1("cpu")
    points, sw = port_inputs(pts[:128], scalars[:128])
    assert tmsm.msm(curve, points, sw) == "naive" and calls == [128]
    assert port_msm_affine(pts, scalars, c=10, total_bits=10) == host_ec.msm(pts, scalars, 0, P)
    assert calls == [128]


def test_tree_reduce_vs_jax():
    """The naive path's tree reduce over 3 lanes (padded to 4 with
    infinity), word for word against the JAX package's."""
    rng = np.random.default_rng(39)
    pts = pool_points(rng, 3)
    F = jcurves.bn254_g1().F
    lanes = [[p[0] for p in pts], [p[1] for p in pts], [1] * 3, [1] * 3]
    j = tuple(F.encode(np.array(v, dtype=object)) for v in lanes)
    want = jmsm._tree_reduce(jcurves.bn254_g1(), JPointXYZZ(*(jnp.asarray(t) for t in j)), 3)
    got = tmsm._tree_reduce(curves.bn254_g1("cpu"),
                            PointXYZZ(*(limbs.from_jax_limbs(t) for t in j)), 3)
    for jt, tt in zip(want, got):
        np.testing.assert_array_equal(limbs.to_jax_limbs(tt), np.asarray(jt))


def test_msm_window_glue_helpers():
    """Lane shifts bring in infinity; the layout follows the JAX package."""
    curve = curves.bn254_g1("cpu")
    g = curve.to_xyzz(curve.generator((4,)))
    sh = tmsm._shift_left(g, 3)
    assert bool((sh.zz[:, 1:] == 0).all()) and torch.equal(sh.x[:, 0], g.x[:, 3])
    assert tmsm._layout_and_blinds(curve, 300)[:2] == jmsm._layout_and_blinds(
        jcurves.bn254_g1(), 300)[:2]
    assert tmsm._layout_and_blinds(curve, 1 << 22)[:2] == (4096, 1024)
    assert tmsm.optimal_window_bits(254, 1 << 22) == jmsm.optimal_window_bits(254, 1 << 22)
    total = tmsm._fold_reduce_lanes(curve, g)
    want = host_ec.scalar_mul(G, 4, 0, P)
    aff = curve.to_affine(PointXYZZ(*(t[:, None] for t in total)))
    assert (int(curve.F.decode(aff.x)[0]), int(curve.F.decode(aff.y)[0])) == want
