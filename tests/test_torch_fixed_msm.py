"""FixedBaseMSM (``tachyon_tpu_torch/math/fixed_msm.py``) against the JAX
package on CPU, on secp256k1's generator at c = 8 (32 windows of 256).

The table, the JAX package's (L, windows, 2^c) limbs repacked, must equal
the port's (W, windows, 2^c) words word for word, with the same infinity
flags.  ``run`` on 16 scalars and a zero one must give the JAX ``run``'s
XYZZ words, recorded in ``tests/fixtures/torch_glv_jax.json`` by
``scripts/make_torch_glv_fixture.py`` (the JAX tree of adds compiles for
about a minute on a CPU; the slow test in ``test_torch_glv.py`` re-records
it), and the host's scalar multiples.  Every comparison is exact.
"""
import json

import numpy as np
import torch

from tachyon_tpu.math import curves as jcurves
from tachyon_tpu.math import fixed_msm as jfixed
from tachyon_tpu_torch.fields import limbs
from tachyon_tpu_torch.math import curves, fixed_msm, host_ec

from test_torch_glv import maker

torch.set_num_threads(1)


def fixed(c=8):
    tc = curves.secp256k1("cpu")
    G = (int(tc.gen_x), int(tc.gen_y))
    return tc, G, fixed_msm.FixedBaseMSM(tc, G, c=c)


def test_table_vs_jax():
    tc, G, fb = fixed()
    jf = jfixed.FixedBaseMSM(jcurves.secp256k1(), G, c=8)
    assert fb.nwin == jf.W == 32
    assert tuple(fb.table.x.shape) == (8, 32, 256)
    for t, j in zip(fb.table[:2], jf.table[:2]):
        assert torch.equal(t, limbs.from_jax_limbs(np.asarray(j)))
    assert torch.equal(fb.table.inf, torch.from_numpy(np.array(jf.table.inf)))
    assert bool(fb.table.inf[:, 0].all()) and not bool(fb.table.inf[:, 1:].any())


def test_run_vs_jax_and_host():
    f = json.loads(maker().FIXTURE.read_text())["fixed"]
    tc, G, fb = fixed(f["c"])
    ks = [int(s, 16) for s in f["scalars"]]
    out = fb.run(limbs.from_ints(ks, 8))
    for t, words in zip(out, f["xyzz"]):
        assert limbs.words_to_ints(t.numpy().view(np.uint32)) == [int(v, 16) for v in words]
    aff = tc.to_affine(out)
    got = [None if bool(aff.inf[i]) else (int(tc.F.decode(aff.x[:, i])),
                                            int(tc.F.decode(aff.y[:, i]))) for i in range(len(ks))]
    assert got == [host_ec.scalar_mul(G, k, 0, tc.F.p) for k in ks]
    assert ks[-1] == 0 and got[-1] is None
