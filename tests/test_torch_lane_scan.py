"""The MSM window's lane scan, on CPU (BN254 G1).

On the card it is one launch (``cuda_ec.lane_suffix_scan``) with the
order of adds of the JAX package's loop over K2, so its plain twin must
equal the JAX package's ``_suffix_scan_lanes`` word for word.  The lanes
hold infinity, a pair the scan doubles and a pair it cancels; the lane
fold's test (``test_torch_lane_fold.py``) takes the same lanes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import msm as jmsm
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math import msm as tmsm
from tachyon_tpu_torch.math.ec import PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec

torch.set_num_threads(1)


def lanes(C, curve: str = "bn254_g1"):
    """C XYZZ points of the JAX package's ``curve`` (a G1) as JAX limbs
    (L, C) x 4, lifted (zz != 1).  Lanes 1 and C - 2 are infinity; u[3] =
    u[4] (the scan's first step adds them: a double); u[6] = -u[5]
    (cancels to infinity)."""
    jc = getattr(jcurves, curve)()
    P, G = jc.F.p, (jc.gen_x, jc.gen_y)
    rng = np.random.default_rng(60 + C)
    pts = [host_ec.scalar_mul(G, int(k), 0, P) for k in rng.integers(1, 1 << 30, C)]
    pts[4] = pts[3]
    pts[6] = (pts[5][0], P - pts[5][1])
    lam = [int(v) for v in rng.integers(2, 1 << 62, C)]
    rows = [(x * l * l % P, y * l * l * l % P, l * l % P, l * l * l % P)
            for (x, y), l in zip(pts, lam)]
    rows[1] = rows[C - 2] = (0, 0, 0, 0)
    F = jc.F
    return tuple(F.encode(np.array([r[k] for r in rows], dtype=object)) for k in range(4))


def to_port(j):
    return tuple(limbs.from_jax_limbs(np.asarray(t)) for t in j)


@pytest.mark.parametrize("C", [8, 16])
def test_lane_scan_equals_jax(C):
    j = lanes(C)
    with jax.disable_jit():  # op by op: a fraction of the loop's XLA:CPU compile
        want = jmsm._suffix_scan_lanes(jcurves.bn254_g1(), JPointXYZZ(*(jnp.asarray(t) for t in j)))
    f = curves.bn254_g1("cpu").F.spec
    got = cuda_ec.lane_suffix_scan(f, to_port(j))
    for w, g in zip(to_port(want), got):
        assert torch.equal(w, g)
    # through the MSM module's name too
    got2 = tmsm._suffix_scan_lanes(curves.bn254_g1("cpu"), PointXYZZ(*to_port(j)))
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
