"""SimpleFRI: the textbook single-polynomial FRI low-degree test.

Port of ``tachyon_tpu/crypto/simple_fri.py`` (reference: tachyon/crypto/
commitments/fri/simple_fri.h): commit folds the evaluations layer by layer
to a constant, each layer a one-column Merkle tree (``crypto/merkle.py``)
whose root the challenger observes before it samples the layer's beta; a
query opens the sibling pair (j, j + m/2) of every layer.  The production
PCS is ``TwoAdicFRIPCS`` (``crypto/fri.py``).

Fed the same evaluations and challenger, the roots, the final value, the
query indices and every opening equal the JAX package's.  What the port
does differently, with the same words: a fold's 1/(2 x_i) beta table is
inv2 beta w^-i, built on the device from ``F.powers`` of w^-1 (the JAX
``_fold`` takes a host ``pow`` for each point of each layer); each layer's
openings for every query are one ``merkle.open_batch``, and ``verify``
checks a layer's openings of all queries in one ``merkle.verify_batch``
before the fold arithmetic on host ints.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from tachyon_tpu_torch.crypto import merkle
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.math.ntt import Radix2Domain


class SimpleFRIProof(NamedTuple):
    layer_roots: list  # a (W, DIGEST) Merkle root per layer
    final_value: int  # the constant the last layer folds to
    query_paths: list  # per query: (index, [(opening at j, opening at j + m/2) per layer])


def _one(mp: merkle.MerkleProof, q: int) -> merkle.MerkleProof:
    """Opening q of a batch (rows (W, Q, cols), siblings (W, DIGEST, Q))."""
    return merkle.MerkleProof(tuple(r[:, q] for r in mp.opened_rows),
                              tuple(s[:, :, q] for s in mp.siblings))


def _stack(ops: list) -> merkle.MerkleProof:
    """Single openings -> one batch, in order."""
    return merkle.MerkleProof(
        tuple(torch.stack(rows, 1) for rows in zip(*(o.opened_rows for o in ops))),
        tuple(torch.stack(sibs, 2) for sibs in zip(*(o.siblings for o in ops))))


class SimpleFRI:
    """Commit to and verify a low-degree claim for one polynomial's
    evaluations over a two-adic domain, folding by sampled betas."""

    def __init__(self, F: PrimeField, hasher, num_queries: int = 16):
        self.F = F
        self.h = hasher  # the Poseidon2 of the Merkle trees
        self.num_queries = num_queries

    def _fold(self, evals: torch.Tensor, beta: int, dom: Radix2Domain) -> torch.Tensor:
        """f'(x^2) = (f(x) + f(-x)) / 2 + beta (f(x) - f(-x)) / (2x) over the
        first half's points x_i = w^i (f(-x_i) is row i + m/2)."""
        F, p = self.F, self.F.p
        half = evals.shape[1] // 2
        lo, hi = evals[:, :half], evals[:, half:]
        inv2 = pow(2, p - 2, p)
        odd_w = F.mul(F.powers(dom.omega_inv_int, half), F.full((), inv2 * beta % p)[:, None])
        even = F.mul(F.add(lo, hi), F.full((), inv2)[:, None])
        return F.add(even, F.mul(F.sub(lo, hi), odd_w))

    def _observe_root(self, challenger, root) -> None:
        challenger.observe_many(int(v) for v in self.h.F.decode(root))

    def commit(self, evals: torch.Tensor, challenger) -> SimpleFRIProof:
        """evals: (W, n) evaluations over the radix-2 domain of size n."""
        F = self.F
        n = evals.shape[1]
        layers, roots = [], []
        cur = evals
        while cur.shape[1] > 1:
            tree = merkle.build(self.h, [cur[:, :, None]])
            layers.append((cur.shape[1], tree))
            roots.append(tree.root())
            self._observe_root(challenger, tree.root())
            beta = challenger.sample()
            cur = self._fold(cur, beta, Radix2Domain(F, cur.shape[1]))
        final_value = int(F.decode(cur[:, 0]))
        challenger.observe(final_value)

        idxs = [challenger.sample() % n for _ in range(self.num_queries)]
        paths = [[] for _ in idxs]
        Q, cur_idx = len(idxs), idxs
        for m, tree in layers:
            js = [i % (m // 2) for i in cur_idx]
            at = torch.tensor(js + [j + m // 2 for j in js], device=evals.device)
            mp = merkle.open_batch(tree, at)
            for q in range(Q):
                paths[q].append((_one(mp, q), _one(mp, Q + q)))
            cur_idx = js
        return SimpleFRIProof(roots, final_value, list(zip(idxs, paths)))

    def verify(self, n: int, proof: SimpleFRIProof, challenger) -> bool:
        F, p = self.F, self.F.p
        if n < 2 or n & (n - 1) or 1 << len(proof.layer_roots) != n:
            return False
        betas = []
        for root in proof.layer_roots:
            self._observe_root(challenger, root)
            betas.append(challenger.sample())
        challenger.observe(proof.final_value)
        idxs = [challenger.sample() % n for _ in proof.query_paths]
        if [idx for idx, _ in proof.query_paths] != idxs or \
                any(len(path) != len(betas) for _, path in proof.query_paths):
            return False
        Q, m, cur, carried = len(idxs), n, idxs, None
        inv2 = pow(2, p - 2, p)
        for li, root in enumerate(proof.layer_roots):
            half = m // 2
            js = [i % half for i in cur]
            pairs = [path[li] for _, path in proof.query_paths]
            batch = _stack([lo for lo, _ in pairs] + [hi for _, hi in pairs])
            at = torch.tensor(js + [j + half for j in js], device=root.device)
            if not bool(merkle.verify_batch(self.h, root, [(m, 1)], at, batch).all()):
                return False
            vals = [int(v) for v in F.decode(batch.opened_rows[0][:, :, 0])]
            left, right = vals[:Q], vals[Q:]
            here = [left[q] if cur[q] < half else right[q] for q in range(Q)]
            if carried is not None and here != carried:
                return False
            w_inv = Radix2Domain(F, m).omega_inv_int
            carried = [((left[q] + right[q]) * inv2
                        + betas[li] * (left[q] - right[q]) * inv2 * pow(w_inv, js[q], p)) % p
                       for q in range(Q)]
            m, cur = half, js
        return all(c == proof.final_value % p for c in carried)
