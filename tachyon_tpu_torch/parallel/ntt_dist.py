"""Distributed NTT over a device mesh (the four-step / transpose algorithm).

Port of ``tachyon_tpu/parallel/ntt_dist.py``: n = n1 n2 with the transpose
between ranks as one ``all_to_all_single``:

  1. length-n2 FFTs over j2 on each rank's block of the j1 columns,
  2. the twiddles w^(j1 k2) (from this rank's block of the w^j1 table),
  3. the all-to-all transpose,
  4. length-n1 FFTs over j1.

Field arithmetic is exact, so the result equals the single-device
``Radix2Domain`` FFT word for word.  Global arrays go in and come out (the
JAX functions take and give global arrays; here every rank holds the
whole result after an all_gather).  ``DistributedCosetLDE`` and
``fft_batch_dist`` shard the batch (column) axis instead: no collective but
the final gather.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.math.ntt import Radix2Domain, coset_lde_batch
from tachyon_tpu_torch.parallel.mesh import axis_size, gather_blocks, local_block


class DistributedNTT:
    def __init__(self, F: PrimeField, n: int, mesh: DeviceMesh, axis: str = "dp"):
        self.F = F
        self.n = n
        self.mesh = mesh
        self.axis = axis
        D = axis_size(mesh, axis)
        self.D = D
        # n = n1 n2, both powers of two divisible by D; j1 is sharded
        log_n = n.bit_length() - 1
        log_d = D.bit_length() - 1
        if D & (D - 1) or n < D * D:
            raise ValueError(f"need a power-of-two mesh axis and n >= D^2 (n {n}, D {D})")
        log_n1 = max(log_d, log_n // 2)
        self.n1 = 1 << log_n1
        self.n2 = n >> log_n1
        self.dom1 = Radix2Domain(F, self.n1)
        self.dom2 = Radix2Domain(F, self.n2)
        self.omega = F.spec.root_of_unity(n)

    def _wpow(self, inverse: bool) -> torch.Tensor:
        """(W, n1) table of w^j1 (or w^-j1)."""
        F = self.F
        w = pow(self.omega, self.n - 1, F.p) if inverse else self.omega
        return F.powers(w, self.n1)

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """x: (W, n) natural-order global array -> the same, transformed."""
        F, n1, n2, D, ax = self.F, self.n1, self.n2, self.D, self.axis
        W = x.shape[0]
        xl = local_block(x.reshape(W, n2, n1), self.mesh, ax)  # (W, n2, n1/D): [j2, j1]
        wl = local_block(self._wpow(inverse), self.mesh, ax)  # (W, n1/D)
        y = self.dom2._transform(xl, inverse)  # over j2 -> k2
        # twiddle t[k2, j1] = (w^j1)^k2, built by log-doubling over k2
        n1l = wl.shape[-1]
        tab = F.ones((1, n1l))
        cur = wl[:, None, :]
        while tab.shape[1] < n2:
            tab = torch.cat([tab, F.mul(tab, cur)], dim=1)
            cur = F.square(cur)
        y = F.mul(y, tab[:, :n2])
        # transpose across ranks: (W, n2, n1/D) -> (W, n2/D, n1); block d of
        # the k2 axis goes to rank d, rank s's j1 block arrives at position s
        send = y.reshape(W, D, n2 // D, n1l).permute(1, 0, 2, 3).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.mesh.get_group(ax))
        y = recv.permute(1, 2, 0, 3).reshape(W, n2 // D, n1)  # [k2 local, j1]
        y = self.dom1._transform(y.transpose(1, 2).contiguous(), inverse)  # (W, n1, n2/D)
        # out[k1, k2] is X[k2 + n2 k1]: gather the k2 blocks, then flatten
        # (1/n = 1/n1 1/n2 is applied by the two inverse sub-transforms)
        return gather_blocks(y, self.mesh, ax, dim=2).reshape(W, self.n)

    def fft(self, coeffs: torch.Tensor) -> torch.Tensor:
        return self._transform(coeffs, inverse=False)

    def ifft(self, evals: torch.Tensor) -> torch.Tensor:
        return self._transform(evals, inverse=True)


class DistributedCosetLDE:
    """Multi-GPU CosetLDEBatch (reference: radix2_evaluation_domain.h:100-145):
    the batch (column) axis sharded over the mesh axis, each rank running
    ``coset_lde_batch`` on its columns; the same words as one device."""

    def __init__(self, F: PrimeField, n: int, log_blowup: int, shift_int: int,
                 mesh: DeviceMesh, axis: str = "dp"):
        self.F = F
        self.n = n
        self.log_blowup = log_blowup
        self.shift_int = shift_int
        self.mesh = mesh
        self.axis = axis
        self.dom = Radix2Domain(F, n)

    def __call__(self, evals: torch.Tensor) -> torch.Tensor:
        """evals: (W, n, batch) on H -> (W, n << log_blowup, batch) on
        shift H'."""
        local = local_block(evals, self.mesh, self.axis, dim=2)
        out = coset_lde_batch(self.dom, local, self.log_blowup, self.shift_int)
        return gather_blocks(out, self.mesh, self.axis, dim=2)


def fft_batch_dist(F: PrimeField, mesh: DeviceMesh, evals: torch.Tensor,
                   inverse: bool = False, axis: str = "dp") -> torch.Tensor:
    """Distributed FFTBatch (reference: radix2_evaluation_domain.h:100):
    (W, n, batch) with the batch sharded; each rank transforms its columns
    along axis 1 over the full length."""
    dom = Radix2Domain(F, evals.shape[1])
    local = local_block(evals, mesh, axis, dim=2)
    return gather_blocks(dom._transform(local, inverse), mesh, axis, dim=2)
