"""K5's and K6's plain twins on secp256k1 (the full-width form of the
kernels on the card) against the JAX package on CPU.

The sequential twins ``suffix_sweep_plain`` / ``reduce_sweep_plain`` (the
CPU path of ``suffix_sweep`` / ``reduce_sweep``) must give the words of
the JAX package's ``suffix_sweep_jnp`` / ``reduce_sweep_jnp``; the
segmented twins, whose words the card's kernels give, the same points.
The inputs are ``test_torch_sweeps.py``'s and ``test_torch_reduce.py``'s
cases on secp256k1, from numpy seeds.  Every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import torch

import chip_smoke
from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.ops import pallas_msm
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.ops import cuda_msm

from test_torch_reduce import case as reduce_case
from test_torch_sweeps import flags, rows_to_port, sweep_case

torch.set_num_threads(1)


def test_suffix_sweep_vs_jax():
    """K5's sequential twin equals the JAX words; its segmented twin (S = 3
    segments: one all at infinity, the top one at infinity, equal segment
    sums, a ragged top) the same points, with the top segment's words."""
    R, S = 13, 3
    x, y, inf0, d = sweep_case(R, "secp256k1")
    inf = flags(inf0, R, S)
    want = pallas_msm.suffix_sweep_jnp(jcurves.secp256k1(), jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(inf), tuple(jnp.asarray(t) for t in d))
    want = tuple(rows_to_port(np.asarray(t)) for t in want)
    f = presets.SECP256K1_FQ
    tx, ty = rows_to_port(x), rows_to_port(y)
    tinf = torch.from_numpy(inf.astype(np.int32))
    td = tuple(limbs.from_jax_limbs(t) for t in d)
    for w, s in zip(want, cuda_msm.suffix_sweep(f, tx, ty, tinf, td)):
        assert torch.equal(w, s)
    got = cuda_msm.suffix_sweep_segmented_plain(f, tx, ty, tinf, td, S)
    assert bool(chip_smoke.same_points(f, tuple(t.permute(1, 0, 2) for t in got),
                                       tuple(t.permute(1, 0, 2) for t in want)).all())
    top = (S - 1) * -(-R // S)
    for g, w in zip(got, want):
        assert torch.equal(g[top:], w[top:])


def test_reduce_sweep_vs_jax():
    """K6's sequential twin equals the JAX words; its segmented twin (a
    segment at infinity, two equal segment sums; the tree combine and the
    chain) the same point."""
    R, S = 12, 3
    rows, d = reduce_case(R, S, "secp256k1")
    want = pallas_msm.reduce_sweep_jnp(jcurves.secp256k1(), tuple(jnp.asarray(t) for t in rows),
                                       tuple(jnp.asarray(t) for t in d))
    want = tuple(limbs.from_jax_limbs(np.asarray(t)) for t in want)
    f = presets.SECP256K1_FQ
    trows = tuple(rows_to_port(t) for t in rows)
    td = tuple(limbs.from_jax_limbs(t) for t in d)
    for w, s in zip(want, cuda_msm.reduce_sweep(f, trows, td)):
        assert torch.equal(w, s)
    for F in (2, 1):
        got = cuda_msm.reduce_sweep_segmented_plain(f, trows, td, S, F)
        assert bool(chip_smoke.same_points(f, got, want).all())
