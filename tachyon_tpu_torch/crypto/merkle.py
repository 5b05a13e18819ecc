"""FieldMerkleTree MMCS (the Plonky3-compatible mixed matrix commitment).

Port of ``tachyon_tpu/crypto/merkle.py`` (reference:
tachyon/crypto/commitments/merkle_tree/field_merkle_tree/
field_merkle_tree.h Build/CreateFirstDigestLayer/CompressAndInject,
field_merkle_tree_mmcs.h).  Every digest layer is one batched Poseidon2
call over all its rows.

Semantics (bit-compatible with Plonky3):
  * layer 0: digest_i = H(concat of row i of all tallest matrices);
  * next layers: d_i = C(prev_2i, prev_2i+1), and where matrices of that
    height are injected, d_i = C(C(prev_2i, prev_2i+1), H(row_i));
  * H = the rate-8 padding-free sponge, squeeze 8; C = truncated permutation.

Heights must be powers of two.  Digest layers are (W, DIGEST, n).  The port
opens and verifies a batch of leaf indices at once (``open_batch``,
``verify_batch``: one gather a layer, one permutation a level for all of
them); ``open_at`` and ``verify`` are their one-index cases.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from tachyon_tpu_torch.crypto.poseidon2 import Poseidon2

DIGEST = 8
RATE = 8


class FieldMerkleTree(NamedTuple):
    leaves: tuple  # matrices (W, rows, cols), caller order
    digest_layers: tuple  # (W, DIGEST, n) per level, n halving

    def root(self) -> torch.Tensor:
        return self.digest_layers[-1][:, :, 0]


def _hash_rows(h: Poseidon2, mats: Sequence[torch.Tensor]) -> torch.Tensor:
    """Hash the row-wise concat of same-height matrices -> (W, DIGEST, rows)."""
    cat = torch.cat([m.movedim(1, -1) for m in mats], dim=1)  # (W, cols, rows)
    return h.hash_no_pad(cat, DIGEST, rate=RATE)


def _by_height(heights: Sequence[int]) -> list[int]:
    """Matrix indices, tallest first, caller order within a height."""
    for r in heights:
        if r & (r - 1):
            raise ValueError(f"height {r} is not a power of two")
    return sorted(range(len(heights)), key=lambda i: -heights[i])


def build(h: Poseidon2, matrices: Sequence[torch.Tensor]) -> FieldMerkleTree:
    """matrices: (W, rows, cols) in caller order (kept for opening)."""
    if not matrices:
        raise ValueError("at least one matrix")
    order = _by_height([m.shape[1] for m in matrices])
    sorted_mats = [matrices[i] for i in order]
    tallest = sorted_mats[0].shape[1]
    rest = [m for m in sorted_mats if m.shape[1] != tallest]

    layers = [_hash_rows(h, [m for m in sorted_mats if m.shape[1] == tallest])]
    while layers[-1].shape[-1] > 1:
        prev = layers[-1]
        n_next = prev.shape[-1] // 2
        d = h.compress(prev[:, :, 0::2], prev[:, :, 1::2])
        inject = [m for m in rest if m.shape[1] == n_next]
        if inject:
            rest = [m for m in rest if m.shape[1] != n_next]
            d = h.compress(d, _hash_rows(h, inject))
        layers.append(d)
    if rest:
        raise ValueError("matrix heights must divide down the tree")
    return FieldMerkleTree(tuple(matrices), tuple(layers))


class MerkleProof(NamedTuple):
    opened_rows: tuple  # per matrix (caller order): (W, cols), or (W, Q, cols) for a batch
    siblings: tuple  # per level: (W, DIGEST), or (W, DIGEST, Q) for a batch


def open_batch(tree: FieldMerkleTree, indices: torch.Tensor) -> MerkleProof:
    """Open all matrices at Q leaf indices (int64, in tallest-height units)
    at once: each matrix's rows and each layer's siblings in one gather.

    Reference: field_merkle_tree_mmcs.h CreateOpeningProof."""
    max_h = max(m.shape[1] for m in tree.leaves)
    opened = []
    for m in tree.leaves:
        shift = (max_h // m.shape[1]).bit_length() - 1
        opened.append(m.index_select(1, indices >> shift))  # (W, Q, cols)
    sibs = [layer.index_select(2, (indices >> k) ^ 1)  # (W, DIGEST, Q)
            for k, layer in enumerate(tree.digest_layers[:-1])]
    return MerkleProof(tuple(opened), tuple(sibs))


def open_at(tree: FieldMerkleTree, index: int) -> MerkleProof:
    """Open all matrices at one leaf index (in tallest-height units)."""
    dev = tree.digest_layers[0].device
    mp = open_batch(tree, torch.tensor([index], dtype=torch.int64, device=dev))
    return MerkleProof(tuple(r[:, 0] for r in mp.opened_rows),
                       tuple(s[:, :, 0] for s in mp.siblings))


def verify_batch(
    h: Poseidon2,
    root: torch.Tensor,  # (W, DIGEST)
    dims: Sequence[tuple[int, int]],  # (rows, cols) per matrix, caller order
    indices: torch.Tensor,  # (Q,) int64
    proof: MerkleProof,  # rows (W, Q, cols), siblings (W, DIGEST, Q)
) -> torch.Tensor:
    """Recompute Q roots from opened rows and siblings, a level at a time
    for all of them; (Q,) bool, True where the root matches."""
    heights = [r for r, _ in dims]
    by_height: dict[int, list[torch.Tensor]] = {}
    for i in _by_height(heights):
        by_height.setdefault(heights[i], []).append(proof.opened_rows[i])
    level_h = max(heights)
    cur = _hash_rows(h, by_height.pop(level_h))  # (W, DIGEST, Q)
    idx = indices
    for sib in proof.siblings:
        right = (idx & 1).bool()  # cur is the right child
        cur = h.compress(torch.where(right, sib, cur), torch.where(right, cur, sib))
        idx = idx >> 1
        level_h //= 2
        if level_h in by_height:
            cur = h.compress(cur, _hash_rows(h, by_height.pop(level_h)))
    if by_height:
        return torch.zeros(indices.shape, dtype=torch.bool, device=indices.device)
    return (cur == root[:, :, None]).flatten(0, 1).all(dim=0)


def verify(h: Poseidon2, root: torch.Tensor, dims: Sequence[tuple[int, int]], index: int,
           proof: MerkleProof) -> bool:
    """One opening (rows (W, cols), siblings (W, DIGEST)) against the root."""
    dev = root.device
    batch = MerkleProof(tuple(r[:, None] for r in proof.opened_rows),
                        tuple(s[:, :, None] for s in proof.siblings))
    return bool(verify_batch(h, root, dims, torch.tensor([index], device=dev), batch)[0])
