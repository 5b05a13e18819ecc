"""PLONK prover and verifier (halo2 architecture, KZG + SHPlonk/GWC).

Port of ``tachyon_tpu/zk/plonk/prover.py``, the standalone device PLONK
prover over ``crypto/multiopen.py`` (reference: tachyon/zk/plonk/halo2/
prover.h CreateProof, keys/proving_key.h, permutation/permutation_prover.h
+ grand_product_argument.h, vanishing/circuit_polynomial_builder.h,
verifier.h).  The proofs are the JAX package's, byte for byte, given the
same blinding draws.

Features (the JAX package's): the permutation argument in halo2's chunks,
halo2 and log-derivative lookups, shuffles, ZK blinding rows
(cs.blinding_factors > 0), SHPlonk/GWC dispatch.  The JAX package's
documented deviations from upstream halo2 hold here too: no vanishing
random polynomial, selector compression as an opt-in keygen pass
(zk/plonk/selector.py), instance values absorbed as scalars.

The column algebra runs on the params' device over (W, n) Montgomery word
tensors: the NTTs (``math/ntt.py``), the gate and identity evaluation over
the extended coset (K1 for every product on the card, the port's add and
sub), the commitments through the sweep-path MSM (``crypto/kzg.py``: K2 in
the bucket and lane kernels, K3 in Horner, K5, K6).  The grand products and
the log-derivative grand sum, ``jax.lax.associative_scan`` in the JAX
package, are log-depth Hillis-Steele scans over whole columns
(``mont.scan``), as are the batch inverses' prefix and suffix products
(``mont.batch_inverse``).  K1's outputs are canonical, so every
association order gives the same words.  The transcript and challenges are exact host logic.

The blinding values come from ``rng.randbelow(p)`` (``rng`` defaults to
``secrets``, a CSPRNG as halo2's OS RNG), in the JAX prover's order, so a
seeded generator reproduces its proofs.
"""
from __future__ import annotations

import dataclasses
import secrets
from typing import NamedTuple

import numpy as np
import torch

from tachyon_tpu_torch.crypto import kzg as kzg_mod
from tachyon_tpu_torch.crypto.multiopen import GWC, ProverOpening, SHPlonk, VerifierOpening
from tachyon_tpu_torch.crypto.transcript import ProofDecodeError, TranscriptReader, TranscriptWriter
from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.math import curves, poly as poly_mod
from tachyon_tpu_torch.math.ntt import Radix2Domain
from tachyon_tpu_torch.ops import mont
from tachyon_tpu_torch.zk.plonk import expressions as ex
from tachyon_tpu_torch.zk.plonk import lookup
from tachyon_tpu_torch.zk.plonk.constraint_system import ConstraintSystem, build_permutation_mapping

PCS = {"shplonk": SHPlonk, "gwc": GWC}


class ProvingKey(NamedTuple):
    cs: ConstraintSystem
    n: int
    fixed_evals: list  # (W, n) Montgomery words per fixed column
    fixed_coeffs: list
    sigma_evals: list  # per permutation column
    sigma_coeffs: list
    fixed_commitments: list  # int points (the VK part)
    sigma_commitments: list
    deltas: list  # delta^j ints


def _delta(Fr) -> int:
    # halo2 DELTA = generator^(2^two_adicity): generates the coset group
    return pow(Fr.spec.generator, 1 << Fr.spec.two_adicity, Fr.p)


def _params_device(params: kzg_mod.KZGParams) -> torch.device:
    return params.g1_powers.x.device


def _commit_coeffs(params, Fr, coeffs):
    return kzg_mod.to_int_point(kzg_mod.commit(params, mont.mont_reduce(Fr.spec, coeffs)))


def keygen(params: kzg_mod.KZGParams, cs: ConstraintSystem, n: int,
           fixed_values: list) -> ProvingKey:
    """fixed_values: per fixed column, n ints.  Runs on the params' device.

    The sigma columns are delta^c' w^r' for each position's successor
    (c', r') in its copy cycle: the JAX package takes a host ``pow`` per
    entry; here they are one gather of a device table of w^i times the
    column's delta power."""
    Fr = curves.bn254_fr(_params_device(params))
    dom = Radix2Domain(Fr, n)
    p = Fr.p
    delta = _delta(Fr)
    num_perm = len(cs.permutation_columns)
    deltas = [pow(delta, j, p) for j in range(num_perm)]

    sigma_evals, sigma_coeffs, sigma_cms = [], [], []
    if num_perm:
        mapping = torch.from_numpy(build_permutation_mapping(cs, n)).to(Fr.device)
        omega_pows = dom.shift_powers(dom.omega_int, n)  # (W, n): w^i
        delta_cols = Fr.encode(deltas)  # (W, num_perm)
        for j in range(num_perm):
            e = Fr.mul(omega_pows[:, mapping[j] % n], delta_cols[:, mapping[j] // n])
            c = dom.ifft(e)
            sigma_evals.append(e)
            sigma_coeffs.append(c)
            sigma_cms.append(_commit_coeffs(params, Fr, c))
    fixed_evals, fixed_coeffs, fixed_cms = [], [], []
    for vals in fixed_values:
        e = Fr.encode(np.asarray(vals, dtype=object))
        c = dom.ifft(e)
        fixed_evals.append(e)
        fixed_coeffs.append(c)
        fixed_cms.append(_commit_coeffs(params, Fr, c))
    return ProvingKey(cs, n, fixed_evals, fixed_coeffs, sigma_evals, sigma_coeffs,
                      fixed_cms, sigma_cms, deltas)


def _from_jax(obj):
    """A JAX-package constraint-system object (expressions, gates, lookups,
    the system itself) -> the port's class of the same name, field by field."""
    from tachyon_tpu_torch.zk.plonk import constraint_system as csm

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(ex, type(obj).__name__, None) or getattr(csm, type(obj).__name__)
        return cls(**{f.name: _from_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return getattr(csm, type(obj).__name__)(*(_from_jax(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_jax(v) for v in obj)
    if isinstance(obj, dict):
        return {_from_jax(k): _from_jax(v) for k, v in obj.items()}
    return obj


def pk_from_jax(pk, device=torch.device("cuda")) -> ProvingKey:
    """The JAX package's ``ProvingKey`` (its (L, n) 16-bit limb columns as
    numpy or JAX arrays, its int points) -> the port's, on ``device``."""
    cols = lambda arrs: [limbs.from_jax_limbs(np.asarray(a), device) for a in arrs]  # noqa: E731
    return ProvingKey(
        _from_jax(pk.cs), int(pk.n), cols(pk.fixed_evals), cols(pk.fixed_coeffs),
        cols(pk.sigma_evals), cols(pk.sigma_coeffs),
        [None if c is None else tuple(map(int, c)) for c in pk.fixed_commitments],
        [None if c is None else tuple(map(int, c)) for c in pk.sigma_commitments],
        [int(d) for d in pk.deltas])


def vk_transcript_repr(pk: ProvingKey) -> int:
    """Transcript representative of the verifying key: blake2b of the
    pinned VK Rust-Debug string, halo2-bit-compatible
    (reference: keys/verifying_key.h:102-124 SetTranscriptRepresentative;
    string format zk/plonk/halo2/pinned_verifying_key.h)."""
    from tachyon_tpu_torch.zk.plonk import stringifier

    k = pk.n.bit_length() - 1
    max_deg = pk.cs.required_degree()
    ext_factor = 1 << max(1, (max_deg - 1).bit_length())
    extended_k = k + (ext_factor.bit_length() - 1)
    vk_str = stringifier.pinned_vk_str(
        pk.cs, k, extended_k, presets.BN254_FR.root_of_unity(pk.n),
        pk.fixed_commitments, pk.sigma_commitments,
        base_modulus=presets.BN254_FQ.p, scalar_modulus=presets.BN254_FR.p,
    )
    return stringifier.transcript_repr_from_str(vk_str, presets.BN254_FR.p)


def _prefix_product(Fr, ratios: torch.Tensor) -> torch.Tensor:
    """z with z[0] = 1, z[i] = prod_{k<i} ratios[k] (exclusive scan)."""
    inc = mont.scan(Fr.mul, ratios)
    return torch.cat([Fr.ones((1,)), inc[:, :-1]], dim=1)


class PlonkProver:
    def __init__(self, params: kzg_mod.KZGParams, pk: ProvingKey, pcs: str = "shplonk",
                 rng=secrets):
        """pcs: "shplonk" | "gwc" (reference: zk/plonk/halo2/pcs_type.h
        kGWC/kSHPlonk dispatch, c/zk/plonk/halo2/bn254_prover.cc:359).
        rng: any object with ``randbelow(p)``, the source of the blinding
        values (``secrets`` unless the caller passes a seeded one)."""
        self.params = params
        self.pk = pk
        self.pcs_cls = PCS[pcs]
        self.rng = rng
        self.Fr = curves.bn254_fr(_params_device(params))
        self.dom = Radix2Domain(self.Fr, pk.n)

    def _commit_evals(self, evals):
        return kzg_mod.to_int_point(
            kzg_mod.commit_lagrange(self.params, mont.mont_reduce(self.Fr.spec, evals)))

    def _commit_coeffs(self, coeffs):
        return _commit_coeffs(self.params, self.Fr, coeffs)

    def prove(self, advice_values: list, instance_values: list) -> bytes:
        """advice/instance values: per column, n ints.

        With cs.blinding_factors > 0 the last t+1 rows of every advice
        column are overwritten with fresh randomness and all transition
        identities are masked to the active region (halo2 blinding:
        reference zk/base/blinder.h + the l_last/l_active_row machinery in
        keys/proving_key.h): proofs become zero-knowledge.
        """
        Fr, pk, dom = self.Fr, self.pk, self.dom
        cs, n, p = pk.cs, pk.n, Fr.p
        omega = dom.omega_int
        w = TranscriptWriter(presets.BN254_FR, presets.BN254_FQ)
        dev = Fr.device

        t_blind = cs.blinding_factors
        u = cs.usable_rows(n)

        def rand_ints(k):
            # ZK blinding must be full-width uniform from a CSPRNG
            return [self.rng.randbelow(p) for _ in range(k)]

        w.common_scalar(vk_transcript_repr(pk))
        for col in instance_values:
            for v in col:
                w.common_scalar(int(v))

        if t_blind:
            advice_values = [list(v)[:u] + rand_ints(n - u) for v in advice_values]
        advice_evals = [Fr.encode(np.asarray(v, dtype=object)) for v in advice_values]
        advice_coeffs = [dom.ifft(e) for e in advice_evals]
        for e in advice_evals:
            w.write_point(self._commit_evals(e))

        instance_evals = [Fr.encode(np.asarray(v, dtype=object)) for v in instance_values]
        instance_coeffs = [dom.ifft(e) for e in instance_evals]

        # --- lookups: theta-compress + host prep (reference:
        # zk/lookup/halo2/prover_impl.h BatchCompressPairs/BatchPermutePairs,
        # log_derivative_halo2/prover_impl.h ComputeMPolys) -----------------
        theta = None
        lookup_cols = []  # per lookup: dict of committed column evals/coeffs
        if cs.lookups or cs.shuffles:
            theta = w.squeeze_challenge()
        base_ev = ex.Evaluator(Fr, pk.fixed_evals, advice_evals, instance_evals, rot_scale=1)
        for lk in cs.lookups:
            a_comp = lookup.compress(Fr, base_ev, lk.input_exprs, theta)
            s_comp = lookup.compress(Fr, base_ev, lk.table_exprs, theta)
            entry = {"a": a_comp, "s": s_comp}
            if cs.lookup_type == "halo2":
                # pairs built over the usable region; blinded tail rows of
                # A'/S' are random (halo2 permute_expression_pair + blinder)
                ap_ints, sp_ints = lookup.permute_pair(Fr.decode(a_comp)[:u],
                                                       Fr.decode(s_comp)[:u])
                if t_blind:
                    ap_ints = list(ap_ints) + rand_ints(n - u)
                    sp_ints = list(sp_ints) + rand_ints(n - u)
                ap = Fr.encode(np.asarray(ap_ints, dtype=object))
                sp = Fr.encode(np.asarray(sp_ints, dtype=object))
                entry.update(ap=ap, sp=sp, ap_coeffs=dom.ifft(ap), sp_coeffs=dom.ifft(sp))
                for e in (ap, sp):
                    w.write_point(self._commit_evals(e))
            else:
                m_ints = list(lookup.multiplicities(Fr.decode(a_comp)[:u],
                                                    Fr.decode(s_comp)[:u]))
                m = Fr.encode(np.asarray(m_ints + [0] * (n - u), dtype=object))
                entry.update(m=m, m_coeffs=dom.ifft(m))
                w.write_point(self._commit_evals(m))
            lookup_cols.append(entry)

        beta = w.squeeze_challenge()
        gamma = w.squeeze_challenge()

        # --- permutation grand product ---------------------------------------
        def col_evals(col):
            if col.kind == "fixed":
                return pk.fixed_evals[col.index]
            if col.kind == "advice":
                return advice_evals[col.index]
            return instance_evals[col.index]

        omega_pows = dom.shift_powers(omega, n)  # (W, n): w^i
        beta_c = Fr.full((), beta)[:, None]
        gamma_c = Fr.full((), gamma)[:, None]
        idx_row = torch.arange(n, device=dev)
        active_mask = idx_row < u  # (n,)

        def mask_ratios(r):
            """force ratio 1 on the last+blind rows so the prefix product
            closes at row u (active-region telescoping)."""
            return Fr.select(active_mask, r, Fr.ones((n,))) if t_blind else r

        def blind_z(z):
            """randomize z on the blind rows (> u); row u keeps the
            closing value the verifier's l_last constraint checks."""
            if not t_blind:
                return z
            rz = Fr.encode(np.asarray(rand_ints(n), dtype=object))
            return Fr.select(idx_row > u, rz, z)

        # chunked grand products (halo2 permutation/prover.rs: chunk_len =
        # degree - 2 columns per Z poly; each chunk's Z starts from the
        # previous chunk's closing value at row u, stitched by the
        # l_0 * (z_c - z_{c-1}(w^last X)) constraint)
        chunks = cs.permutation_chunks()
        perm_z = []  # per chunk: dict(evals, coeffs)
        last_z = 1
        j = 0
        for chunk in chunks:
            num = Fr.ones((n,))
            den = Fr.ones((n,))
            for col in chunk:
                v = col_evals(col)
                dj = Fr.full((), pk.deltas[j])[:, None]
                num = Fr.mul(num, Fr.add(Fr.add(v, Fr.mul(beta_c, Fr.mul(dj, omega_pows))),
                                         gamma_c))
                den = Fr.mul(den, Fr.add(Fr.add(v, Fr.mul(beta_c, pk.sigma_evals[j])), gamma_c))
                j += 1
            z = _prefix_product(Fr, mask_ratios(Fr.mul(num, Fr.batch_inverse(den))))
            if last_z != 1:
                z = Fr.mul(z, Fr.full((), last_z)[:, None])
            if len(chunks) > 1:
                # closing value at row u feeds the next chunk's start
                last_z = int(Fr.decode(z[:, u]))
            z = blind_z(z)
            perm_z.append({"evals": z, "coeffs": dom.ifft(z)})
        for entry in perm_z:
            w.write_point(self._commit_evals(entry["evals"]))

        # --- lookup grand products / grand sums -----------------------------
        for entry in lookup_cols:
            if cs.lookup_type == "halo2":
                # z[i+1]/z[i] = (A+beta)(S+gamma) / ((A'+beta)(S'+gamma))
                t_num = Fr.mul(Fr.add(entry["a"], beta_c), Fr.add(entry["s"], gamma_c))
                t_den = Fr.mul(Fr.add(entry["ap"], beta_c), Fr.add(entry["sp"], gamma_c))
                r = mask_ratios(Fr.mul(t_num, Fr.batch_inverse(t_den)))
                zl = blind_z(_prefix_product(Fr, r))
            else:
                # phi[i+1]-phi[i] = 1/(A+beta) - m/(S+beta); phi[0] = 0
                inv_a = Fr.batch_inverse(Fr.add(entry["a"], beta_c))
                inv_s = Fr.batch_inverse(Fr.add(entry["s"], beta_c))
                term = Fr.sub(inv_a, Fr.mul(entry["m"], inv_s))
                if t_blind:
                    term = Fr.select(active_mask, term, Fr.zeros((n,)))
                inc = mont.scan(Fr.add, term)
                zl = blind_z(torch.cat([Fr.zeros((1,)), inc[:, :-1]], dim=1))
            entry["z"] = zl
            entry["z_coeffs"] = dom.ifft(zl)
            w.write_point(self._commit_evals(zl))

        # --- shuffle grand products (reference: zk/shuffle/prover.h) --------
        shuffle_cols = []
        for sh in cs.shuffles:
            a_comp = lookup.compress(Fr, base_ev, sh.input_exprs, theta)
            s_comp = lookup.compress(Fr, base_ev, sh.shuffle_exprs, theta)
            r = mask_ratios(Fr.mul(Fr.add(a_comp, gamma_c),
                                   Fr.batch_inverse(Fr.add(s_comp, gamma_c))))
            zs = blind_z(_prefix_product(Fr, r))
            shuffle_cols.append({"a": a_comp, "s": s_comp, "z": zs, "z_coeffs": dom.ifft(zs)})
            w.write_point(self._commit_evals(zs))

        y = w.squeeze_challenge()

        # --- vanishing / h(X) over extended coset ------------------------------
        max_deg = cs.required_degree()
        ext_factor = 1 << max(1, (max_deg - 1).bit_length())
        big_n = n * ext_factor
        big = Radix2Domain(Fr, big_n)
        shift = Fr.spec.generator

        def to_ext(coeffs):
            return big.coset_fft(torch.nn.functional.pad(coeffs, (0, big_n - coeffs.shape[1])),
                                 shift)

        fixed_ext = [to_ext(c) for c in pk.fixed_coeffs]
        advice_ext = [to_ext(c) for c in advice_coeffs]
        instance_ext = [to_ext(c) for c in instance_coeffs]
        sigma_ext = [to_ext(c) for c in pk.sigma_coeffs]
        perm_z_ext = [to_ext(entry["coeffs"]) for entry in perm_z]

        yc = Fr.full((), y)[:, None]
        acc = None

        def fold(ident):
            nonlocal acc
            acc = ident if acc is None else Fr.add(Fr.mul(acc, yc), ident)

        ev = ex.Evaluator(Fr, fixed_ext, advice_ext, instance_ext, rot_scale=ext_factor)
        for g in cs.gates:
            for poly in g.polys:
                fold(ev.eval(poly))

        # permutation identities on the extended coset: x_i = shift * w^i
        # (chunked, halo2 ordering: z_0 init, last-chunk boolean close,
        # chunk stitches, then per-chunk transitions)
        xs = Fr.mul(big.shift_powers(big.omega_int, big_n), Fr.full((), shift)[:, None])
        col_ext = {"fixed": fixed_ext, "advice": advice_ext, "instance": instance_ext}

        # row-selector polynomials over the extended coset
        def ind_ext(vec_01):
            return to_ext(dom.ifft(Fr.encode(np.asarray(vec_01, dtype=object))))

        l0_ext = ind_ext([1] + [0] * (n - 1))
        if t_blind:
            llast_ext = ind_ext([0] * u + [1] + [0] * (n - u - 1))
            lactive_ext = ind_ext([1] * u + [0] * (n - u))

        one_b = Fr.ones((big_n,))
        if chunks:
            fold(Fr.mul(l0_ext, Fr.sub(perm_z_ext[0], one_b)))
            if t_blind:
                zl = perm_z_ext[-1]
                fold(Fr.mul(llast_ext, Fr.sub(Fr.square(zl), zl)))
            # stitches: l_0 * (z_c - z_{c-1}(w^{-(t+1)} X))
            for c in range(1, len(chunks)):
                z_prev_last = torch.roll(perm_z_ext[c - 1], (t_blind + 1) * ext_factor, dims=1)
                fold(Fr.mul(l0_ext, Fr.sub(perm_z_ext[c], z_prev_last)))
            j = 0
            for c, chunk in enumerate(chunks):
                numb = Fr.ones((big_n,))
                denb = Fr.ones((big_n,))
                for col in chunk:
                    v = col_ext[col.kind][col.index]
                    dj = Fr.full((), pk.deltas[j])[:, None]
                    numb = Fr.mul(numb, Fr.add(Fr.add(v, Fr.mul(beta_c, Fr.mul(dj, xs))), gamma_c))
                    denb = Fr.mul(denb, Fr.add(Fr.add(v, Fr.mul(beta_c, sigma_ext[j])), gamma_c))
                    j += 1
                z_c = perm_z_ext[c]
                z_next = torch.roll(z_c, -ext_factor, dims=1)
                trans = Fr.sub(Fr.mul(z_next, denb), Fr.mul(z_c, numb))
                fold(Fr.mul(trans, lactive_ext) if t_blind else trans)

        # lookup identities over the extended coset
        def act(v):
            return Fr.mul(v, lactive_ext) if t_blind else v

        for lk, entry in zip(cs.lookups, lookup_cols):
            z_lk = to_ext(entry["z_coeffs"])
            z_lk_next = torch.roll(z_lk, -ext_factor, dims=1)
            a_big = lookup.compress(Fr, ev, lk.input_exprs, theta)
            s_big = lookup.compress(Fr, ev, lk.table_exprs, theta)
            if cs.lookup_type == "halo2":
                ap_big = to_ext(entry["ap_coeffs"])
                sp_big = to_ext(entry["sp_coeffs"])
                ap_prev = torch.roll(ap_big, ext_factor, dims=1)
                fold(Fr.mul(l0_ext, Fr.sub(z_lk, one_b)))
                fold(act(Fr.sub(
                    Fr.mul(z_lk_next, Fr.mul(Fr.add(ap_big, beta_c), Fr.add(sp_big, gamma_c))),
                    Fr.mul(z_lk, Fr.mul(Fr.add(a_big, beta_c), Fr.add(s_big, gamma_c))))))
                if t_blind:
                    fold(Fr.mul(llast_ext, Fr.sub(Fr.square(z_lk), z_lk)))
                diff = Fr.sub(ap_big, sp_big)
                fold(Fr.mul(l0_ext, diff))
                fold(act(Fr.mul(diff, Fr.sub(ap_big, ap_prev))))
            else:
                m_big = to_ext(entry["m_coeffs"])
                fold(Fr.mul(l0_ext, z_lk))
                # (phi(wx)-phi(x))(A+b)(S+b) - ((S+b) - m(A+b))
                ab = Fr.add(a_big, beta_c)
                sb = Fr.add(s_big, beta_c)
                fold(act(Fr.sub(Fr.mul(Fr.sub(z_lk_next, z_lk), Fr.mul(ab, sb)),
                                Fr.sub(sb, Fr.mul(m_big, ab)))))
                if t_blind:
                    # grand sum must close to zero at the last row
                    fold(Fr.mul(llast_ext, z_lk))

        for sh, entry in zip(cs.shuffles, shuffle_cols):
            a_big = lookup.compress(Fr, ev, sh.input_exprs, theta)
            s_big = lookup.compress(Fr, ev, sh.shuffle_exprs, theta)
            z_sh = to_ext(entry["z_coeffs"])
            z_sh_next = torch.roll(z_sh, -ext_factor, dims=1)
            fold(Fr.mul(l0_ext, Fr.sub(z_sh, one_b)))
            fold(act(Fr.sub(Fr.mul(z_sh_next, Fr.add(s_big, gamma_c)),
                            Fr.mul(z_sh, Fr.add(a_big, gamma_c)))))
            if t_blind:
                fold(Fr.mul(llast_ext, Fr.sub(Fr.square(z_sh), z_sh)))

        if acc is None:
            raise ValueError("the constraint system has no gate, permutation, lookup or "
                             "shuffle (log-derivative lookups need cs.chunk_lookups())")
        # divide by Z_H(coset x) = shift^n * w^(n i) - 1, periodic in i
        sn = pow(shift, n, p)
        wn = pow(big.omega_int, n, p)
        zh_inv = Fr.encode([pow((sn * pow(wn, i, p) - 1) % p, p - 2, p) for i in range(ext_factor)])
        h_coeffs = big.coset_ifft(Fr.mul(acc, zh_inv.repeat(1, n)), shift)
        # split h into ext_factor chunks of n coefficients, commit each
        h_chunks = [h_coeffs[:, i * n:(i + 1) * n] for i in range(ext_factor)]
        for chunk in h_chunks:
            w.write_point(self._commit_coeffs(chunk))

        x = w.squeeze_challenge()
        wx = x * omega % p

        # --- evaluations ---------------------------------------------------------
        openings = []

        def open_at(coeffs, pts):
            for pt in pts:
                w.write_scalar(int(Fr.decode(poly_mod.eval_at_fast(Fr, coeffs, pt))))
            openings.append(ProverOpening(coeffs, tuple(pts)))

        for c in (*advice_coeffs, *pk.fixed_coeffs, *pk.sigma_coeffs):
            open_at(c, (x,))
        # permutation z evals: per chunk z(x), z(wx), plus z(x_last) for
        # every chunk but the final one (stitch openings; halo2
        # permutation/prover.rs evaluate order)
        x_last = x * pow(omega, (-(t_blind + 1)) % n, p) % p if chunks else 0
        for c, entry in enumerate(perm_z):
            open_at(entry["coeffs"], (x, wx, x_last) if c + 1 < len(perm_z) else (x, wx))
        # lookup openings: halo2 -> a'(x), a'(w^-1 x), s'(x), z(x), z(wx);
        # log-derivative -> m(x), phi(x), phi(wx); shuffle -> z(x), z(wx)
        winv_x = x * pow(omega, p - 2, p) % p
        for entry in lookup_cols:
            if cs.lookup_type == "halo2":
                open_at(entry["ap_coeffs"], (x, winv_x))
                open_at(entry["sp_coeffs"], (x,))
            else:
                open_at(entry["m_coeffs"], (x,))
            open_at(entry["z_coeffs"], (x, wx))
        for entry in shuffle_cols:
            open_at(entry["z_coeffs"], (x, wx))
        # h combined poly: open each chunk at x
        for chunk in h_chunks:
            open_at(chunk, (x,))

        self.pcs_cls(self.params).create_opening_proof(openings, w)
        return bytes(w.proof)


class PlonkVerifier:
    def __init__(self, params: kzg_mod.KZGParams, pk: ProvingKey, pcs: str = "shplonk"):
        self.params = params
        self.pk = pk  # uses only the VK parts (commitments + cs)
        self.pcs_cls = PCS[pcs]
        self.Fr = curves.bn254_fr(_params_device(params))
        self.dom = Radix2Domain(self.Fr, pk.n)

    def verify(self, proof: bytes, instance_values: list) -> bool:
        try:
            return self._verify(proof, instance_values)
        except ProofDecodeError:
            # malformed proof bytes are a rejection, not a crash
            return False

    def _verify(self, proof: bytes, instance_values: list) -> bool:
        Fr, pk = self.Fr, self.pk
        cs, n, p = pk.cs, pk.n, Fr.p
        omega = self.dom.omega_int
        r = TranscriptReader(proof, presets.BN254_FR, presets.BN254_FQ)
        r.common_scalar(vk_transcript_repr(pk))
        for col in instance_values:
            for v in col:
                r.common_scalar(int(v))
        advice_cms = [r.read_point() for _ in range(cs.num_advice)]
        theta = None
        if cs.lookups or cs.shuffles:
            theta = r.squeeze_challenge()
        halo2_lookup = cs.lookup_type == "halo2"
        lookup_cms = [tuple(r.read_point() for _ in range(2 if halo2_lookup else 1))
                      for _ in cs.lookups]
        beta = r.squeeze_challenge()
        gamma = r.squeeze_challenge()
        chunks = cs.permutation_chunks()
        perm_z_cms = [r.read_point() for _ in chunks]
        lookup_z_cms = [r.read_point() for _ in cs.lookups]
        shuffle_z_cms = [r.read_point() for _ in cs.shuffles]
        y = r.squeeze_challenge()
        max_deg = cs.required_degree()
        ext_factor = 1 << max(1, (max_deg - 1).bit_length())
        h_cms = [r.read_point() for _ in range(ext_factor)]
        x = r.squeeze_challenge()
        wx = x * omega % p
        winv_x = x * pow(omega, p - 2, p) % p

        t_blind = cs.blinding_factors
        u = cs.usable_rows(n)
        x_last = x * pow(omega, (-(t_blind + 1)) % n, p) % p

        advice_evals = [r.read_scalar() for _ in range(cs.num_advice)]
        fixed_evals = [r.read_scalar() for _ in range(cs.num_fixed)]
        sigma_evals = [r.read_scalar() for _ in range(len(cs.permutation_columns))]
        perm_z_evals = []
        for c in range(len(chunks)):
            e = {"z_x": r.read_scalar(), "z_wx": r.read_scalar()}
            if c + 1 < len(chunks):
                e["z_lastx"] = r.read_scalar()
            perm_z_evals.append(e)
        lookup_evals = []
        for _lk in cs.lookups:
            if halo2_lookup:
                lookup_evals.append({
                    "ap_x": r.read_scalar(), "ap_winvx": r.read_scalar(),
                    "sp_x": r.read_scalar(), "z_x": r.read_scalar(), "z_wx": r.read_scalar(),
                })
            else:
                lookup_evals.append({"m_x": r.read_scalar(), "z_x": r.read_scalar(),
                                     "z_wx": r.read_scalar()})
        shuffle_evals = [{"z_x": r.read_scalar(), "z_wx": r.read_scalar()} for _ in cs.shuffles]

        # instance evals at x computed from the public values
        inst_evals = [
            int(Fr.decode(poly_mod.eval_at_fast(
                Fr, self.dom.ifft(Fr.encode(np.asarray(col, dtype=object))), x)))
            for col in instance_values]
        h_evals = [r.read_scalar() for _ in range(ext_factor)]

        # --- recompute N(x) and check h(x) (x^n - 1) == N(x) ------------------
        scal = _ScalarEvaluator(p, fixed_evals, advice_evals, inst_evals)
        acc = None

        def fold(ident):
            nonlocal acc
            acc = ident % p if acc is None else (acc * y + ident) % p

        for g in cs.gates:
            for poly in g.polys:
                fold(scal.eval(poly))
        # permutation identities at x (chunked; mirrors the prover order)
        xn = pow(x, n, p)
        l0 = (xn - 1) * pow(n * (x - 1) % p, p - 2, p) % p

        def lag(i):
            wi = pow(omega, i, p)
            return wi * (xn - 1) % p * pow(n * (x - wi) % p, p - 2, p) % p

        if t_blind:
            l_last = lag(u)
            l_blind = sum(lag(i) for i in range(u + 1, n)) % p
            l_active = (1 - l_last - l_blind) % p
        else:
            l_last, l_active = 0, 1

        col_eval = {"fixed": fixed_evals, "advice": advice_evals, "instance": inst_evals}
        if chunks:
            fold(l0 * (perm_z_evals[0]["z_x"] - 1) % p)
            if t_blind:
                zl = perm_z_evals[-1]["z_x"]
                fold(l_last * (zl * zl - zl) % p)
            for c in range(1, len(chunks)):
                fold(l0 * (perm_z_evals[c]["z_x"] - perm_z_evals[c - 1]["z_lastx"]) % p)
            j = 0
            for c, chunk in enumerate(chunks):
                numx, denx = 1, 1
                for col in chunk:
                    v = col_eval[col.kind][col.index]
                    numx = numx * ((v + beta * pk.deltas[j] % p * x + gamma) % p) % p
                    denx = denx * ((v + beta * sigma_evals[j] + gamma) % p) % p
                    j += 1
                ev = perm_z_evals[c]
                fold((ev["z_wx"] * denx - ev["z_x"] * numx) % p * l_active % p)

        # lookup / shuffle identities at x
        for lk, ev in zip(cs.lookups, lookup_evals):
            a_x = lookup.compress_scalar(p, scal, lk.input_exprs, theta)
            s_x = lookup.compress_scalar(p, scal, lk.table_exprs, theta)
            if halo2_lookup:
                fold(l0 * (ev["z_x"] - 1) % p)
                fold((ev["z_wx"] * ((ev["ap_x"] + beta) % p) % p * ((ev["sp_x"] + gamma) % p)
                      - ev["z_x"] * ((a_x + beta) % p) % p * ((s_x + gamma) % p))
                     % p * l_active % p)
                if t_blind:
                    fold(l_last * (ev["z_x"] * ev["z_x"] - ev["z_x"]) % p)
                diff = (ev["ap_x"] - ev["sp_x"]) % p
                fold(l0 * diff % p)
                fold(diff * ((ev["ap_x"] - ev["ap_winvx"]) % p) % p * l_active % p)
            else:
                fold(l0 * ev["z_x"] % p)
                ab = (a_x + beta) % p
                sb = (s_x + beta) % p
                fold(((ev["z_wx"] - ev["z_x"]) % p * ab % p * sb - (sb - ev["m_x"] * ab) % p)
                     % p * l_active % p)
                if t_blind:
                    fold(l_last * ev["z_x"] % p)
        for sh, ev in zip(cs.shuffles, shuffle_evals):
            a_x = lookup.compress_scalar(p, scal, sh.input_exprs, theta)
            s_x = lookup.compress_scalar(p, scal, sh.shuffle_exprs, theta)
            fold(l0 * (ev["z_x"] - 1) % p)
            fold((ev["z_wx"] * ((s_x + gamma) % p) - ev["z_x"] * ((a_x + gamma) % p))
                 % p * l_active % p)
            if t_blind:
                fold(l_last * (ev["z_x"] * ev["z_x"] - ev["z_x"]) % p)

        h_at_x = 0
        for i in reversed(range(ext_factor)):
            h_at_x = (h_at_x * xn + h_evals[i]) % p
        if h_at_x * ((xn - 1) % p) % p != (acc or 0) % p:
            return False

        # --- multiopen verification -------------------------------------------
        openings = []
        for cm, v in zip(advice_cms, advice_evals):
            openings.append(VerifierOpening(cm, (x,), (v,)))
        for cm, v in zip(pk.fixed_commitments, fixed_evals):
            openings.append(VerifierOpening(cm, (x,), (v,)))
        for cm, v in zip(pk.sigma_commitments, sigma_evals):
            openings.append(VerifierOpening(cm, (x,), (v,)))
        for c, cm in enumerate(perm_z_cms):
            ev = perm_z_evals[c]
            if c + 1 < len(perm_z_cms):
                openings.append(VerifierOpening(cm, (x, wx, x_last),
                                                (ev["z_x"], ev["z_wx"], ev["z_lastx"])))
            else:
                openings.append(VerifierOpening(cm, (x, wx), (ev["z_x"], ev["z_wx"])))
        for li, ev in enumerate(lookup_evals):
            if halo2_lookup:
                ap_cm, sp_cm = lookup_cms[li]
                openings.append(VerifierOpening(ap_cm, (x, winv_x), (ev["ap_x"], ev["ap_winvx"])))
                openings.append(VerifierOpening(sp_cm, (x,), (ev["sp_x"],)))
            else:
                openings.append(VerifierOpening(lookup_cms[li][0], (x,), (ev["m_x"],)))
            openings.append(VerifierOpening(lookup_z_cms[li], (x, wx), (ev["z_x"], ev["z_wx"])))
        for cm, ev in zip(shuffle_z_cms, shuffle_evals):
            openings.append(VerifierOpening(cm, (x, wx), (ev["z_x"], ev["z_wx"])))
        for cm, v in zip(h_cms, h_evals):
            openings.append(VerifierOpening(cm, (x,), (v,)))
        return self.pcs_cls(self.params).verify_opening_proof(openings, r)


class _ScalarEvaluator:
    """host-int expression evaluation at a single point."""

    def __init__(self, p, fixed, advice, instance, challenges=None):
        self.p = p
        self.fixed = fixed
        self.advice = advice
        self.instance = instance
        self.challenges = challenges or {}

    def eval(self, e):
        p = self.p
        if isinstance(e, ex.Constant):
            return e.value % p
        if isinstance(e, (ex.Fixed, ex.Advice, ex.Instance)):
            if e.rotation != 0:
                raise ValueError("rotations at x need extra openings")
            table = {ex.Fixed: self.fixed, ex.Advice: self.advice,
                     ex.Instance: self.instance}[type(e)]
            return table[e.column]
        if isinstance(e, ex.Challenge):
            return self.challenges[e.index]
        if isinstance(e, ex.Negated):
            return (-self.eval(e.expr)) % p
        if isinstance(e, ex.Sum):
            return (self.eval(e.left) + self.eval(e.right)) % p
        if isinstance(e, ex.Product):
            return self.eval(e.left) * self.eval(e.right) % p
        if isinstance(e, ex.Scaled):
            return self.eval(e.expr) * (e.scale % p) % p
        raise TypeError(e)
