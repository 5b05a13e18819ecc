"""Fixed-base MSM: precomputed window tables for many scalars on one base.

Port of ``tachyon_tpu/math/fixed_msm.py`` (the reference's
tachyon/math/elliptic_curves/msm/fixed_base_msm.h, used by trusted-setup
paths, and the shape of a batch of ECDSA or Schnorr nonce commitments
k_i G).  The table T[w][d] = [d 2^(c w)] G is built once with exact host
arithmetic; evaluation is a gather of the table at the scalars' digits and
a log-depth tree of complete adds (K2 on the card) over the window axis,
with no doubling.
"""
from __future__ import annotations

import numpy as np
import torch

from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.math.ec import AffinePoint, PointXYZZ, SWCurve
from tachyon_tpu_torch.math.msm import _tree_reduce, digit_decompose


class FixedBaseMSM:
    def __init__(self, curve: SWCurve, base: tuple, c: int = 8):
        """base: affine (x, y) host ints.  ``table`` holds (W, nwin, 2^c)
        words, window w's row d at [d 2^(c w)] base (infinity at d = 0),
        the JAX package's (L, nwin, 2^c) limbs repacked."""
        self.curve = curve
        self.c = c
        self.nwin = -(-curve.SF.spec.bits // c)
        B = 1 << c
        p = curve.F.p
        xs = np.zeros((self.nwin, B), dtype=object)
        ys = np.zeros((self.nwin, B), dtype=object)
        inf = np.zeros((self.nwin, B), dtype=bool)
        step = base
        for w in range(self.nwin):
            acc = None
            for d in range(B):
                if acc is None:
                    inf[w, d] = True
                else:
                    xs[w, d], ys[w, d] = acc
                acc = host_ec.affine_add(acc, step, 0, p)
            for _ in range(c):  # step <- 2^c step
                step = host_ec.affine_add(step, step, 0, p)
                if step is None:
                    break
            if step is None:
                step = base  # the order is exhausted; the windows above are unused
        F = curve.F
        self.table = AffinePoint(F.encode(xs), F.encode(ys),
                                 torch.from_numpy(inf).to(F.device))

    def run(self, scalars: torch.Tensor) -> PointXYZZ:
        """scalars: (Ws, n) plain int32 words -> the n points [s_i] base as
        XYZZ coords (W, n)."""
        curve = self.curve
        digits = digit_decompose(scalars, curve.SF.spec.bits, self.c).long()  # (nwin, n)
        widx = torch.arange(self.nwin, device=digits.device)[:, None]
        pts = AffinePoint(self.table.x[:, widx, digits], self.table.y[:, widx, digits],
                          self.table.inf[widx, digits])
        xyzz = curve.to_xyzz(pts)  # coords (W, nwin, n)
        # the window axis last, then the tree of adds over it
        return _tree_reduce(curve, PointXYZZ(*(t.permute(0, 2, 1) for t in xyzz)), self.nwin)
