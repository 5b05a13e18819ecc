"""TwoAdicFRI polynomial commitment scheme, bit-compatible with the
reference, Plonky3 and SP1.

Port of ``tachyon_tpu/crypto/fri.py`` (reference:
tachyon/crypto/commitments/fri/two_adic_fri.h Commit/CreateOpeningProof/
VerifyOpeningProof, fri/prove.h, fri/verify.h, fri/fri_config.h
FoldMatrix/FoldRow).  Fed the same matrices and challenger state, the
transcript, the commitments, every proof field and the final value equal
the JAX package's; the conventions are the ones its docstring lists:

  * commit: each matrix's coset LDE onto g H (g the multiplicative
    generator), rows in bit-reversed order, all matrices of a round in one
    mixed-height FieldMerkleTree;
  * open: alpha from the challenger; per (point, height) inverse
    denominators over the bit-reversed coset; reduced openings keyed by
    log-height with per-height alpha offsets; the commit phase pairs
    adjacent bit-reversed entries, observes each root, samples beta and
    folds with (1/2 + b/2 w^-rev(r)) lo + (1/2 - b/2 w^-rev(r)) hi; the
    final constant is observed; proof-of-work grind; each query index is
    SampleBits(log_global_max) and its fold layers keep the sibling only;
  * verify: replays the betas, checks the proof of work, recomputes the
    reduced openings from the opened rows, rebuilds each fold layer's leaf
    from its running value and the sibling, checks the Merkle openings,
    folds (FoldRow) and compares with the final value.

The PCS leaves the observation of input commitments and opened values to
its callers, as the reference's uni-STARK schedule does.

What the port does differently, with the same words: sums over columns,
rows and alpha powers are modular sums, so any order gives the canonical
value; the port takes them as one int64 sum a slice (``ext_dot``, chunked so
that no (D, H, C) product is ever held) where the JAX package takes a tree
of adds over a (D, L, H, C) product.  The inverse denominators are
elementwise inverses (``ExtField.inv``), not a Montgomery-trick scan.  The
query phase gathers every query's rows and siblings of a tree in one
``merkle.open_batch``, and the verifier walks all queries at once, a
permutation a tree level, where the JAX verifier loops over queries.
Transcript and index logic stays on exact host ints.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import torch

from tachyon_tpu_torch.crypto import merkle
from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.crypto.poseidon2 import Poseidon2
from tachyon_tpu_torch.math.extfield import ExtField
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.math.ntt import Radix2Domain, _bitrev_perm

CHUNK_ELEMS = 1 << 26  # base elements of one product slice in ext_dot


@dataclasses.dataclass
class FRIConfig:
    """reference: fri/fri_config.h:20-26."""

    log_blowup: int = 1
    num_queries: int = 10
    proof_of_work_bits: int = 8

    @property
    def blowup(self) -> int:
        return 1 << self.log_blowup


def _rev_bits(x: int, bits: int) -> int:
    return int(f"{x:0{bits}b}"[::-1], 2) if bits else 0


def _bitrev(log_n: int, device) -> torch.Tensor:
    return torch.from_numpy(_bitrev_perm(log_n)).to(device)


def ext_powers(ext: ExtField, z: torch.Tensor, n: int) -> torch.Tensor:
    """(D, W, n) table [1, z, z^2, ...] by log-doubling on the device."""
    tab = ext.ones((1,))
    cur = z[..., None] if z.ndim == ext.coeff_ndim else z
    while tab.shape[-1] < n:
        tab = torch.cat([tab, ext.mul(tab, cur)], dim=-1)
        cur = ext.square(cur)
    return tab[..., :n]


def ext_dot(ext: ExtField, w: torch.Tensor, m: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_k w_k m_k for extension weights w (D, W, K) and a base tensor m
    (W, ...) whose axis ``dim`` has length K -> (D, W, m's other axes).

    Each slice of at most CHUNK_ELEMS elements is multiplied by one
    coefficient of the weights at a time (K1, the weights read in place)
    and summed (one int64 sum), and the slices' sums are added, so memory
    stays at a slice's size."""
    F = ext.base
    K = m.shape[dim]
    step = max(1, CHUNK_ELEMS // max(1, m.numel() // max(K, 1)))
    shape = [1] * m.ndim
    shape[0] = m.shape[0]
    acc = None
    for k0 in range(0, K, step):
        kk = min(step, K - k0)
        mk = m.narrow(dim, k0, kk).contiguous()
        shape[dim] = kk
        part = torch.stack([F.sum(F.mul(mk, w[d, ..., k0:k0 + kk].reshape(shape)), dim)
                            for d in range(ext.D)])
        acc = part if acc is None else ext.add(acc, part)
    return acc


class CommitData(NamedTuple):
    """Prover data of one commit (reference: MMCS ProverData and the
    coefficient forms the opening needs)."""

    tree: merkle.FieldMerkleTree
    ldes: tuple  # (W, H, C) bit-reversed-row LDE evaluations per matrix
    coeffs: tuple  # (W, n, C) coefficient form per matrix
    heights: tuple  # LDE heights H per matrix
    log_max: int  # log2 of the tallest LDE of this commit

    def root(self) -> torch.Tensor:
        return self.tree.root()


class BatchOpening(NamedTuple):
    """reference: fri_proof.h BatchOpening."""

    opened_values: tuple  # per matrix: (W, C) base row (bit-reversed index)
    opening_proof: tuple  # Merkle path digests (W, DIGEST)


class CommitPhaseProofStep(NamedTuple):
    """reference: fri_proof.h CommitPhaseProofStep: the sibling only; the
    verifier rebuilds its own value from the fold chain."""

    sibling_value: torch.Tensor  # (D, W)
    opening_proof: tuple  # Merkle path digests


class QueryProof(NamedTuple):
    input_proof: tuple  # per round: BatchOpening
    commit_phase_openings: tuple  # per fold layer: CommitPhaseProofStep


class FRIProof(NamedTuple):
    """reference: fri_proof.h FRIProof."""

    commit_phase_commits: tuple  # (W, DIGEST) roots per fold layer
    query_proofs: tuple  # num_queries QueryProofs
    final_eval: torch.Tensor  # (D, W)
    pow_witness: int


class TwoAdicFRIPCS:
    def __init__(self, F: PrimeField, ext: ExtField, hasher: Poseidon2, config: FRIConfig):
        self.F = F
        self.ext = ext
        self.h = hasher
        self.cfg = config
        self._dom_cache: dict[int, Radix2Domain] = {}

    def _domain(self, n: int) -> Radix2Domain:
        if n not in self._dom_cache:
            self._dom_cache[n] = Radix2Domain(self.F, n)
        return self._dom_cache[n]

    def _ext_const(self, coeffs) -> torch.Tensor:
        """D host ints -> an extension constant (D, W)."""
        return self.ext.encode([int(c) for c in coeffs])

    def _base_ext(self, xs) -> torch.Tensor:
        """Host ints -> base values embedded in the extension, (D, W, len)."""
        return self.ext.embed(self.F.encode([int(x) for x in xs]))

    def _observe_root(self, challenger, root) -> None:
        challenger.observe_many(int(v) for v in self.F.decode(root))

    def _observe_ext(self, challenger, value) -> None:
        challenger.observe_many(int(c) for c in self.ext.decode(value))

    # ------------------------------------------------------------------ commit
    def commit(self, matrices: Sequence[torch.Tensor],
               shifts: Sequence[int] | None = None) -> CommitData:
        """matrices[i]: (W, n_i, C_i) evaluations over shifts[i] H_{n_i}
        (shift 1: the subgroup itself).  Commits their bit-reversed LDEs
        over g H_{n << log_blowup} in one mixed-height Merkle tree.

        Reference: two_adic_fri.h Commit (CosetLDEBatch(mat, log_blowup,
        g * offset_inv, reverse_at_last=false), then MMCS CommitOwned)."""
        F, blow = self.F, self.cfg.log_blowup
        g = F.spec.generator
        shifts = shifts or [1] * len(matrices)
        ldes, coeffs = [], []
        for m, s in zip(matrices, shifts):
            n = m.shape[1]
            dom = self._domain(n)
            cf = dom.coset_ifft(m, s) if s != 1 else dom.ifft(m)
            coeffs.append(cf)
            H = n << blow
            padded = torch.cat([cf, torch.zeros((cf.shape[0], H - n) + cf.shape[2:],
                                                dtype=cf.dtype, device=cf.device)], dim=1)
            lde = self._domain(H).coset_fft(padded, g)
            del padded
            ldes.append(lde.index_select(1, _bitrev(H.bit_length() - 1, lde.device)))
            del lde
        tree = merkle.build(self.h, ldes)
        max_h = max(l.shape[1] for l in ldes)
        return CommitData(tree, tuple(ldes), tuple(coeffs), tuple(l.shape[1] for l in ldes),
                          max_h.bit_length() - 1)

    def get_evaluations_on_domain(self, data: CommitData, idx: int, size: int) -> torch.Tensor:
        """Evaluations of committed matrix ``idx`` on g H_size, natural order:
        the first ``size`` bit-reversed LDE rows, re-bit-reversed (reference:
        vendors/sp1/src/baby_bear_poseidon2.rs:718; SP1's read of the trace
        on the quotient domain)."""
        lde = data.ldes[idx]
        if size & (size - 1) or not 1 <= size <= lde.shape[1]:
            raise ValueError(f"size {size}: a power of two up to the LDE's {lde.shape[1]} rows")
        return lde[:, :size].index_select(1, _bitrev(size.bit_length() - 1, lde.device))

    # -------------------------------------------------------------------- open
    def _eval_at_ext(self, coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Base coefficients (W, n, C) at an extension point z (D, W) ->
        (D, W, C): the unique interpolant's values, as the reference's
        barycentric InterpolateCoset (two_adic_fri.h:340) gives them."""
        return ext_dot(self.ext, ext_powers(self.ext, z, coeffs.shape[1]), coeffs, 1)

    def _coset_x_bitrev(self, log_h: int) -> torch.Tensor:
        """(W, 2^log_h) table x_i = g w^rev(i) over the LDE coset."""
        F = self.F
        dom = self._domain(1 << log_h)
        wp = dom.shift_powers(dom.omega_int, 1 << log_h)  # w^j, natural order
        xs = F.mul(wp, F.encode(F.spec.generator)[:, None])
        return xs.index_select(1, _bitrev(log_h, xs.device))

    def create_opening_proof(
        self,
        data_by_round: Sequence[CommitData],
        points_by_round: Sequence[Sequence[Sequence[list[int]]]],
        challenger: DuplexChallenger,
    ) -> tuple[tuple, FRIProof]:
        """points_by_round[r][m]: the extension points (D ints each) to open
        round r's matrix m at.  The caller has observed the commitments;
        alpha is the PCS's first sample (two_adic_fri.h CreateOpeningProof).

        Returns (opened_values, proof); opened_values[r][m][pt] is (D, W, C)."""
        F, ext, cfg = self.F, self.ext, self.cfg
        D = ext.D
        alpha = self._ext_const(challenger.sample_ext(D))
        log_global_max = max(d.log_max for d in data_by_round)

        # 1/(x - z) per point over its tallest subgroup, bit-reversed
        # (two_adic_fri.h ComputeInverseDenominators); the bit-reversed table
        # of H_k is a prefix of H_m's (k < m), so [:H] serves smaller heights
        max_log: dict[tuple, int] = {}
        z_enc: dict[tuple, torch.Tensor] = {}
        for data, pts in zip(data_by_round, points_by_round):
            for m_idx, H in enumerate(data.heights):
                for z_int in pts[m_idx]:
                    key = tuple(int(c) for c in z_int)
                    z_enc.setdefault(key, self._ext_const(key))
                    max_log[key] = max(max_log.get(key, 0), H.bit_length() - 1)
        inv_denoms = {}
        for key, log_h in max_log.items():
            xs = ext.embed(self._coset_x_bitrev(log_h))
            inv_denoms[key] = ext.inv(ext.sub(xs, z_enc[key][..., None]))  # (D, W, H)

        # reduced openings per log-height, with per-height alpha offsets
        # (two_adic_fri.h:126-186: reduced_openings[32], num_reduced[32])
        ro: dict[int, torch.Tensor] = {}
        num_reduced: dict[int, int] = {}
        opened_values = []
        for data, pts in zip(data_by_round, points_by_round):
            round_values = []
            for m_idx, (lde, cf) in enumerate(zip(data.ldes, data.coeffs)):
                H, C = lde.shape[1], lde.shape[2]
                log_h = H.bit_length() - 1
                apows = ext_powers(ext, alpha, C)  # (D, W, C)
                red_rows = ext_dot(ext, apows, lde, 2)  # sum_c alpha^c LDE[:, c]: (D, W, H)
                mat_values = []
                for z_int in pts[m_idx]:
                    key = tuple(int(c) for c in z_int)
                    ys = self._eval_at_ext(cf, z_enc[key])  # (D, W, C)
                    mat_values.append(ys)
                    red_ys = ext.sum(ext.mul(apows, ys))  # (D, W)
                    off = num_reduced.get(log_h, 0)
                    num_reduced[log_h] = off + C
                    term = ext.mul(ext.sub(red_rows, red_ys[..., None]),
                                   inv_denoms[key][..., :H])
                    term = ext.mul(term, ext.pow_const(alpha, off)[..., None])
                    ro[log_h] = ext.add(ro[log_h], term) if log_h in ro else term
                del red_rows
                round_values.append(tuple(mat_values))
            opened_values.append(tuple(round_values))
        del inv_denoms

        # commit phase (fri/prove.h CommitPhase)
        cur = ro.pop(log_global_max)
        fold_trees, commits = [], []
        log_h = log_global_max
        p = F.p
        inv2_ext = ext.embed(F.encode(pow(2, p - 2, p)))  # (D, W)
        while (1 << log_h) > cfg.blowup:
            half = 1 << (log_h - 1)
            lo, hi = cur[..., 0::2], cur[..., 1::2]  # adjacent bit-reversed entries
            leaves = torch.cat([lo.movedim(0, -1), hi.movedim(0, -1)], dim=-1)  # (W, half, 2D)
            tree = merkle.build(self.h, [leaves])
            fold_trees.append(tree)
            commits.append(tree.root())
            self._observe_root(challenger, tree.root())
            beta = self._ext_const(challenger.sample_ext(D))
            # FoldMatrix: pw[r] = beta/2 w^-rev(r), w a root of order 2^log_h
            dom = self._domain(1 << log_h)
            winv = dom.shift_powers(dom.omega_inv_int, half).index_select(
                1, _bitrev(log_h - 1, cur.device))  # (W, half)
            pw = ext.mul_base(ext.mul(beta, inv2_ext)[..., None], winv)  # (D, W, half)
            cur = ext.add(ext.mul(ext.add(inv2_ext[..., None], pw), lo),
                          ext.mul(ext.sub(inv2_ext[..., None], pw), hi))
            log_h -= 1
            if log_h in ro:
                cur = ext.add(cur, ro.pop(log_h))
        if ro:
            raise ValueError("reduced openings left below the blowup height")
        final_eval = cur[..., 0].contiguous()  # every entry equal (degree 0)
        self._observe_ext(challenger, final_eval)

        pow_witness = challenger.grind(cfg.proof_of_work_bits)

        # query phase (fri/prove.h Prove, AnswerQuery): every query's rows and
        # siblings of a tree in one gather
        idx = torch.tensor([challenger.sample_bits(log_global_max)
                            for _ in range(cfg.num_queries)], dtype=torch.int64,
                           device=cur.device)
        inputs = [merkle.open_batch(d.tree, idx >> (log_global_max - d.log_max))
                  for d in data_by_round]
        steps = []
        for i, tree in enumerate(fold_trees):
            index_i = idx >> i
            mp = merkle.open_batch(tree, index_i >> 1)
            row = mp.opened_rows[0]  # (W, Q, 2D)
            right = ((index_i ^ 1) & 1).bool()[:, None]  # the sibling is the odd entry
            sibling = torch.where(right, row[..., D:], row[..., :D]).movedim(-1, 0)  # (D, W, Q)
            steps.append((sibling, mp.siblings))
        query_proofs = tuple(
            QueryProof(
                tuple(BatchOpening(tuple(r[:, q] for r in mp.opened_rows),
                                   tuple(s[:, :, q] for s in mp.siblings)) for mp in inputs),
                tuple(CommitPhaseProofStep(sib[:, :, q], tuple(s[:, :, q] for s in path))
                      for sib, path in steps))
            for q in range(cfg.num_queries))
        return tuple(opened_values), FRIProof(tuple(commits), query_proofs, final_eval,
                                              pow_witness)

    # ------------------------------------------------------------------ verify
    def verify_opening_proof(
        self,
        commits_by_round: Sequence[torch.Tensor],  # MMCS roots (W, DIGEST)
        dims_by_round: Sequence[Sequence[tuple[int, int]]],  # (n, C) per matrix
        points_by_round: Sequence[Sequence[Sequence[list[int]]]],
        opened_values: Sequence,  # [r][m][pt]: (D, W, C) claimed values
        proof: FRIProof,
        challenger: DuplexChallenger,
    ) -> bool:
        """reference: two_adic_fri.h VerifyOpeningProof and fri/verify.h.
        The caller has observed the input commitments.  All queries are
        checked together: each Merkle level is one permutation over the
        queries, each fold step one set of extension ops."""
        F, ext, cfg, h = self.F, self.ext, self.cfg, self.h
        D, p, g = ext.D, F.p, F.spec.generator
        blow = cfg.log_blowup
        dev = F.device

        alpha = self._ext_const(challenger.sample_ext(D))
        log_global_max = len(proof.commit_phase_commits) + blow
        betas = []
        for root in proof.commit_phase_commits:
            self._observe_root(challenger, root)
            betas.append(self._ext_const(challenger.sample_ext(D)))
        self._observe_ext(challenger, proof.final_eval)
        qps = proof.query_proofs
        if len(qps) != cfg.num_queries:
            return False
        if not challenger.check_witness(cfg.proof_of_work_bits, proof.pow_witness):
            return False
        index = [challenger.sample_bits(log_global_max) for _ in qps]
        idx = torch.tensor(index, dtype=torch.int64, device=dev)
        Q = len(index)

        def stacked(items):
            """Per-query tensors -> one, the query axis last; None where
            the queries' shapes differ."""
            items = list(items)
            if any(t.shape != items[0].shape for t in items):
                return None
            return torch.stack(items, dim=-1)

        # reduced openings from the opened input rows (two_adic_fri.h verifier)
        ro_val: dict[int, torch.Tensor] = {}
        ro_pow: dict[int, torch.Tensor] = {}
        for r_idx, (root, dims, pts) in enumerate(
                zip(commits_by_round, dims_by_round, points_by_round)):
            lde_dims = [(n << blow, C) for n, C in dims]
            log_batch = max(H for H, _ in lde_dims).bit_length() - 1
            batches = [qp.input_proof[r_idx] for qp in qps]
            if any(len(b.opened_values) != len(dims) or len(b.opening_proof) != log_batch
                   for b in batches):
                return False
            rows = [stacked(b.opened_values[m] for b in batches) for m in range(len(dims))]
            path = [stacked(b.opening_proof[lv] for b in batches)
                    for lv in range(log_batch)]
            if any(t is None for t in rows + path):
                return False
            rows = [r.movedim(-1, 1) for r in rows]  # (W, Q, C)
            if any(r.shape[-1] != C for r, (_, C) in zip(rows, lde_dims)):
                return False
            mp = merkle.MerkleProof(tuple(rows), tuple(path))
            if not bool(merkle.verify_batch(h, root, lde_dims,
                                            idx >> (log_global_max - log_batch), mp).all()):
                return False
            for m_idx, (H, C) in enumerate(lde_dims):
                log_h = H.bit_length() - 1
                w = self._domain(H).omega_int
                x = self._base_ext(g * pow(w, _rev_bits(i >> (log_global_max - log_h), log_h), p)
                                   % p for i in index)  # (D, W, Q)
                row = ext.embed(rows[m_idx])  # (D, W, Q, C)
                if log_h not in ro_val:
                    ro_val[log_h] = ext.zeros((Q,))
                    ro_pow[log_h] = ext.ones(())
                for pt_idx, z_int in enumerate(pts[m_idx]):
                    z = self._ext_const(z_int)
                    ys = opened_values[r_idx][m_idx][pt_idx]  # (D, W, C)
                    if ys.shape[-1] != C:
                        return False
                    denom_inv = ext.inv(ext.sub(x, z[..., None]))  # (D, W, Q)
                    # quotient_c = (row_c - ys_c) / (x - z), weighted by the
                    # running per-height power stream alpha^(off + c)
                    apows = ext.mul(ext_powers(ext, alpha, C), ro_pow[log_h][..., None])
                    terms = ext.mul(ext.sub(row, ys[:, :, None]), apows[:, :, None])
                    contrib = ext.mul(ext.sum(terms), denom_inv)
                    ro_val[log_h] = ext.add(ro_val[log_h], contrib)
                    ro_pow[log_h] = ext.mul(ro_pow[log_h], ext.pow_const(alpha, C))

        # fold walk (fri/verify.h VerifyQuery), all queries at once
        if any(len(qp.commit_phase_openings) != len(betas) for qp in qps):
            return False
        inv2 = pow(2, p - 2, p)
        folded = ext.zeros((Q,))
        for step_idx in range(len(betas)):
            log_folded = log_global_max - step_idx - 1
            if log_folded + 1 in ro_val:
                folded = ext.add(folded, ro_val.pop(log_folded + 1))
            steps = [qp.commit_phase_openings[step_idx] for qp in qps]
            if any(len(s.opening_proof) != log_folded for s in steps):
                return False
            sibling = stacked(s.sibling_value for s in steps)  # (D, W, Q)
            path = [stacked(s.opening_proof[lv] for s in steps) for lv in range(log_folded)]
            if sibling is None or sibling.shape != folded.shape or any(t is None for t in path):
                return False
            right = ((idx ^ 1) & 1).bool()  # the sibling is the odd entry
            e0 = torch.where(right, folded, sibling)
            e1 = torch.where(right, sibling, folded)
            row = torch.cat([e0.movedim(0, -1), e1.movedim(0, -1)], dim=-1)  # (W, Q, 2D)
            idx = idx >> 1
            index = [i >> 1 for i in index]
            mp = merkle.MerkleProof((row,), tuple(path))
            if not bool(merkle.verify_batch(h, proof.commit_phase_commits[step_idx],
                                            [(1 << log_folded, 2 * D)], idx, mp).all()):
                return False
            # FoldRow: x = w^rev(pair) over 2^(log_folded + 1), xs = [x, -x]:
            # e0 + (beta - x)(e1 - e0) / (-2x)
            w = self._domain(1 << (log_folded + 1)).omega_int
            xs = [pow(w, _rev_bits(i, log_folded), p) for i in index]
            x = self._base_ext(xs)
            neg_inv_2x = self._base_ext((-inv2 * pow(v, p - 2, p)) % p for v in xs)
            folded = ext.add(e0, ext.mul(ext.mul(ext.sub(betas[step_idx][..., None], x),
                                                 ext.sub(e1, e0)), neg_inv_2x))
        if max(index) >= cfg.blowup or ro_val:
            return False
        return bool(ext.eq(folded, proof.final_eval[..., None]).all())
