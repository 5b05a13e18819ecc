"""A binary Merkle tree over field-element digests.

Port of ``tachyon_tpu/crypto/binary_merkle.py`` (reference: tachyon/crypto/
commitments/merkle_tree/binary_merkle_tree/binary_merkle_tree.h: a 2-ary
hash tree and inclusion proofs).  Generic over a 2-to-1 compressor such as
``Poseidon2.compress``; each layer is one batched compress.  A digest is
(W, DIGEST) words, a layer (W, DIGEST, n).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class BinaryMerkleTree(NamedTuple):
    layers: tuple  # each (W, DIGEST, n), leaves first

    def root(self):
        return self.layers[-1][:, :, 0]


def build(compress: Callable, leaf_digests: torch.Tensor) -> BinaryMerkleTree:
    """leaf_digests: (W, DIGEST, n) with n a power of two."""
    n = leaf_digests.shape[-1]
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} leaves is not a power of two")
    layers = [leaf_digests]
    cur = leaf_digests
    while cur.shape[-1] > 1:
        cur = compress(cur[:, :, 0::2], cur[:, :, 1::2])
        layers.append(cur)
    return BinaryMerkleTree(tuple(layers))


class BinaryMerkleProof(NamedTuple):
    siblings: tuple  # (W, DIGEST) per level


def open_at(tree: BinaryMerkleTree, index: int) -> BinaryMerkleProof:
    sibs = []
    idx = index
    for layer in tree.layers[:-1]:
        sibs.append(layer[:, :, idx ^ 1])
        idx >>= 1
    return BinaryMerkleProof(tuple(sibs))


def verify(compress: Callable, root, index: int, leaf_digest,
           proof: BinaryMerkleProof) -> bool:
    cur = leaf_digest[:, :, None]
    idx = index
    for sib in proof.siblings:
        sib = sib[:, :, None]
        cur = compress(sib, cur) if idx & 1 else compress(cur, sib)
        idx >>= 1
    return bool(torch.equal(cur[:, :, 0], root))
