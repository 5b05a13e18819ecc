"""The window-sharded MSM (``parallel/msm_sharded.py``) over BN254 G2, the
generic path: a curve without point kernels sums its windows with
``_window_sum_generic`` and folds them with c doublings and an add a
window, as the JAX functions do for any curve.  One gloo rank in this
process (a ``file://`` store under the test's temporary directory; the
group is destroyed after the module), a "win" mesh, 4 points k_i G2 and
c = 8; the point must be the host-exact one (``host_ec.g2_mul``)."""
import pytest
import torch
import torch.distributed as dist

from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, host_ec
from tachyon_tpu_torch.math.ec import AffinePoint
from tachyon_tpu_torch.parallel import mesh, msm_sharded
from tachyon_tpu_torch.zk.groth16 import r1cs

torch.set_num_threads(1)

KS = (3, 5, 7, 11)
SCALARS = (1, 0x1234567890ABCDEF, 2 ** 250 + 12345, 987654321987654321987654321)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_windows_sharded_g2_is_the_host_point(group):
    g2 = curves.bn254_g2("cpu")
    assert not g2._kernel_ok
    G2 = (tuple(g2.gen_x), tuple(g2.gen_y))
    pts = r1cs._dev_points(g2, [host_ec.g2_mul(G2, k) for k in KS])
    got = msm_sharded.msm_sharded_windows(g2, mesh.data_mesh(axis="win", device="cpu"), pts,
                                          limbs.from_ints(list(SCALARS), g2.SF.W), 8)
    aff = g2.to_affine(got)
    host = r1cs.host_points(g2, AffinePoint(aff.x[..., None], aff.y[..., None], aff.inf[None]))
    assert host[0] == host_ec.g2_mul(G2, sum(k * s for k, s in zip(KS, SCALARS)) % g2.SF.p)
