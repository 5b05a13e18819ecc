"""Horner's step of the MSM, on CPU (BN254 G1, and BLS12-381 G1 for the
kernel's W = 12 instantiation).

On the card it is one launch (``cuda_ec.horner``) with the order of
operations of the JAX package's Horner loop (``tachyon_tpu/math/msm.py``:
c doublings, then ``add_xyzz(acc, win)``, MSB window first, from
infinity), so its plain twin must equal a loop of the JAX package's
``SWCurve._dbl_xyzz_jnp`` / ``_add_xyzz_jnp`` word for word.  The windows
(``chip_smoke.horner_windows``, from a numpy seed) make the adds double
(P = Q) and cancel (P = -Q), and hold an infinite window.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math.ec import PointXYZZ as JPointXYZZ
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves
from tachyon_tpu_torch.math.ec import PointXYZZ
from tachyon_tpu_torch.ops import cuda_ec

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_steps(curve: str):
    """The JAX package's double and add on ``curve``, each compiled once (op
    by op they take as long or longer on this CPU)."""
    jc = getattr(jcurves, curve)()
    return jc, jax.jit(jc._dbl_xyzz_jnp), jax.jit(jc._add_xyzz_jnp)


def jax_horner(wins, c: int, curve: str = "bn254_g1"):
    """The JAX package's Horner loop on JAX limbs."""
    jc, dbl, add = jax_steps(curve)
    j = [np.asarray(limbs.to_jax_limbs(t)) for t in wins]
    acc = jc.infinity_xyzz(())
    for k in range(j[0].shape[1] - 1, -1, -1):
        for _ in range(c):
            acc = dbl(acc)
        acc = add(acc, JPointXYZZ(*(jnp.asarray(t[:, k]) for t in j)))
    return acc


@pytest.mark.parametrize("name,nwin,c,seed", [("bn254_g1", 5, 3, 1), ("bn254_g1", 6, 2, 2),
                                               ("bls12_381_g1", 4, 1, 141)])
def test_horner_equals_jax(name, nwin, c, seed):
    curve = getattr(curves, name)("cpu")
    wins, want_aff, _ = chip_smoke.horner_windows(curve, nwin, c, seed)
    got = cuda_ec.horner_plain(curve.F.spec, wins, c)
    for w, g in zip(jax_horner(wins, c, name), got):
        np.testing.assert_array_equal(limbs.to_jax_limbs(g), np.asarray(w))
    aff = curve.to_affine(PointXYZZ(*(t[:, None] for t in got)))
    assert chip_smoke.sampled_points(curve, aff, [0]) == [want_aff]


def test_horner_cpu_launches_no_kernel():
    """The wrapper takes the plain twin on CPU tensors and counts no launch;
    its windows hit each case of the add (the multiplies count them)."""
    curve = curves.bn254_g1("cpu")
    wins, _, muls = chip_smoke.horner_windows(curve, 5, 3, 3)
    # 4 finite accumulators doubled 3 times, a doubling add, a cancelling
    # add, and the adds of the top window and the last onto infinity skipped
    assert muls == 9 * 3 * 3 + 13 + 4
    assert bool((wins[2][:, 2] == 0).all())  # the infinite window
    cuda_ec.horner.launches = cuda_ec.dbl_xyzz.launches = cuda_ec.add_xyzz.launches = 0
    got = cuda_ec.horner(curve.F.spec, wins, 3)
    want = cuda_ec.horner_plain(curve.F.spec, wins, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (cuda_ec.horner.launches, cuda_ec.dbl_xyzz.launches, cuda_ec.add_xyzz.launches) == (0, 0, 0)
