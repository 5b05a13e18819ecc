"""The MSM window's lane fold, on CPU (BN254 G1).

On the card it is one launch (``cuda_ec.lane_fold``) with the order of
adds of the JAX package's loop over K2, so its plain twin must equal the
JAX package's ``_fold_reduce_lanes`` word for word, on the lanes of
``test_torch_lane_scan.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_lane_scan import lanes, to_port
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import msm as jmsm
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.math import msm as tmsm
from tachyon_tpu_torch.math.ec import PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec

torch.set_num_threads(1)


@pytest.mark.parametrize("C", [8, 16])
def test_lane_fold_equals_jax(C):
    j = lanes(C)
    with jax.disable_jit():  # op by op: a fraction of the loop's XLA:CPU compile
        want = jmsm._fold_reduce_lanes(jcurves.bn254_g1(), JPointXYZZ(*(jnp.asarray(t) for t in j)))
    f = curves.bn254_g1("cpu").F.spec
    got = cuda_ec.lane_fold(f, to_port(j))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(limbs.to_jax_limbs(g), np.asarray(w))
    got2 = tmsm._fold_reduce_lanes(curves.bn254_g1("cpu"), PointXYZZ(*to_port(j)))
    assert all(torch.equal(a, b) for a, b in zip(got, got2))
