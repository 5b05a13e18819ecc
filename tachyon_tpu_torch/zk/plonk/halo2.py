"""Halo2 bit-compatible proving pipeline over BN254 (Scroll vendor flavor).

Port of ``tachyon_tpu/zk/plonk/halo2.py``: keygen, ``Halo2Prover``,
SHPlonk and GWC openings, ``Halo2Verifier`` and the proving key's JSON form,
with the JAX package's host logic as written (Python ints) and its device
work on ``TorchBackend`` (``zk/plonk/halo2_device.py``: the MSMs, NTTs and
the quotient build on the card).  Four changes from the JAX module:

* ``HostKZG`` builds its bases on first use, and commits with one exact
  host MSM (``math/host_ec.py``: the same points).  Only the GWC
  verifier's instance commitments read them; the JAX ``keygen`` builds
  all n bases even on its device path, which at n = 2^16 is about 100
  minutes of host scalar multiples.
* There is no host path: ``keygen`` always runs its IFFTs and commitments
  through ``halo2_device`` (the JAX ``device=True`` path) on ``device``,
  the card unless the caller passes another, and ``Halo2Prover`` proves
  on ``TorchBackend(pk)`` unless given a backend.  The JAX
  ``HostBackend`` and its exact-int quotient build are not ported.
* ``keygen`` keeps its KZG setup in the key (``srs``) for
  ``TorchBackend``, where the JAX package builds the setup again in its
  backend.
* ``load_proving_key`` recomputes the key's polynomials by the IFFT on
  ``device``, where the JAX package runs a host IFFT.
* The verifier takes ``pairing_bn254`` and the G2 multiple from the port
  (``math/pairing_bn254.py``, ``math/host_ec.g2_mul``); a host G1 scalar
  multiple is the exact Jacobian one of ``host_ec``.

Analog of the reference's halo2 layer
(reference: tachyon/zk/plonk/halo2/prover.h CreateProof,
zk/plonk/keys/{key.h,verifying_key.h,proving_key.h},
zk/plonk/permutation/cycle_store.cc, math/elliptic_curves/bn/bn254/halo2/
bn254.cc OverrideSubgroupGenerator, zk/plonk/halo2/random_field_generator.h,
zk/plonk/vanishing/vanishing_utils.h GetZeta).
"""
from __future__ import annotations

import dataclasses

import torch

from tachyon_tpu_torch.base.log import vlog
from tachyon_tpu_torch.crypto import rng as rng_mod
from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.zk.plonk import expressions as ex
from tachyon_tpu_torch.zk.plonk.constraint_system import (
    ColumnRef,
    ConstraintSystem,
)
from tachyon_tpu_torch.zk.plonk import stringifier

# BN254 moduli
FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
FQ = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47

# halo2curves bn256 Fr: GENERATOR = 7, S = 28
# (reference: math/elliptic_curves/bn/bn254/halo2/bn254.cc:7-30)
HALO2_GENERATOR = 7
TWO_ADICITY = 28

# XORShift seed used by every reference golden test
# (reference: zk/plonk/halo2/constants.h:33 kXORShiftSeed)
XOR_SHIFT_SEED = bytes([
    0x59, 0x62, 0xBE, 0x5D, 0x76, 0x3D, 0x31, 0x8D,
    0x17, 0xDB, 0x37, 0x32, 0x54, 0x06, 0xBC, 0xE5,
])


def halo2_omega(k: int) -> int:
    """2^k-th root of unity from the halo2curves generator."""
    return pow(HALO2_GENERATOR, (FR - 1) >> k, FR)


def halo2_zeta(vendor: str = "scroll") -> int:
    """coset shift for the extended (quotient) domain: zeta = g^((p-1)/3)
    for Scroll, zeta^2 for PSE (reference: vanishing_utils.h:26-61)."""
    z = pow(HALO2_GENERATOR, (FR - 1) // 3, FR)
    return z if vendor == "scroll" else z * z % FR


class RandomFieldGenerator:
    """halo2curves F::random over the Scroll XORShift rng: 64 LE bytes
    (8x next_u64) reduced mod r (reference:
    zk/plonk/halo2/random_field_generator.h:20-28 +
    prime_field_conversion.h FromUint512 == value mod p)."""

    def __init__(self, seed: bytes = XOR_SHIFT_SEED):
        self.rng = rng_mod.XORShiftRNG(seed)

    def generate(self) -> int:
        v = 0
        for i in range(8):
            v |= self.rng.next_u64() << (64 * i)
        return v % FR


# --- host-exact field/poly helpers ----------------------------------------


def host_fft(coeffs: list, omega: int, p: int = FR) -> list:
    """evals[i] = P(omega^i), iterative radix-2 DIT on python ints."""
    n = len(coeffs)
    assert n & (n - 1) == 0
    a = list(coeffs)
    # bit-reverse permute
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(omega, n // length, p)
        for start in range(0, n, length):
            w = 1
            half = length // 2
            for i in range(start, start + half):
                u, v = a[i], a[i + half] * w % p
                a[i] = (u + v) % p
                a[i + half] = (u - v) % p
                w = w * wlen % p
        length <<= 1
    return a


def host_ifft(evals: list, omega: int, p: int = FR) -> list:
    n = len(evals)
    n_inv = pow(n, p - 2, p)
    out = host_fft(evals, pow(omega, p - 2, p), p)
    return [v * n_inv % p for v in out]


def host_eval(coeffs: list, x: int, p: int = FR) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % p
    return acc


# --- host-exact BN254 G1 --------------------------------------------------


def g1_add(a, b, p: int = FQ):
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, p - 2, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return (x3, (lam * (x1 - x3) - y1) % p)


def g1_mul(a, k: int, p: int = FQ):
    """[k mod r] a, exact (the Jacobian chain of ``host_ec.msm``; the JAX
    package's affine double-and-add gives the same point)."""
    return host_ec.msm([a], [k % FR], 0, p)


class HostKZG:
    """powers-of-tau SRS + commitments, exact ints
    (reference: crypto/commitments/kzg/kzg.h UnsafeSetup/Commit; the
    device path is crypto/kzg.py).  The bases [tau^i]G are built on first
    use, the same points the JAX package builds in its constructor."""

    def __init__(self, n: int, tau: int):
        self.n = n
        self.tau = tau
        self._bases = None

    @property
    def bases(self) -> list:
        if self._bases is None:
            g, t, self._bases = (1, 2), 1, []
            for _ in range(self.n):
                self._bases.append(g1_mul(g, t))
                t = t * self.tau % FR
        return self._bases

    def commit(self, coeffs: list):
        """sum c_i [tau^i]G (None = infinity), one exact host MSM."""
        return host_ec.msm(self.bases[:len(coeffs)], [int(c) % FR for c in coeffs],
                           0, FQ)

    def commit_lagrange(self, evals: list, omega: int):
        return self.commit(host_ifft(list(evals), omega))


# --- cycle store (exact halo2 semantics) ----------------------------------


class CycleStore:
    """Cyclic-linked-list copy-constraint store (reference:
    zk/plonk/permutation/cycle_store.cc MergeCycle — mapping = next label in
    cycle, aux = cycle base, sizes at base; merge joins the smaller cycle
    into the larger and swaps the two next-pointers)."""

    def __init__(self, num_cols: int, n: int):
        self.n = n
        self.mapping = [[(c, r) for r in range(n)] for c in range(num_cols)]
        self.aux = [[(c, r) for r in range(n)] for c in range(num_cols)]
        self.sizes = [[1] * n for _ in range(num_cols)]

    def _get(self, table, label):
        return table[label[0]][label[1]]

    def _set(self, table, label, value):
        table[label[0]][label[1]] = value

    def merge(self, a, b) -> bool:
        base_l = self._get(self.aux, a)
        base_r = self._get(self.aux, b)
        if base_l == base_r:
            return False
        if self._get(self.sizes, base_l) < self._get(self.sizes, base_r):
            base_l, base_r = base_r, base_l
        self._set(
            self.sizes, base_l,
            self._get(self.sizes, base_l) + self._get(self.sizes, base_r))
        l = base_r
        while True:
            self._set(self.aux, l, base_l)
            l = self._get(self.mapping, l)
            if l == base_r:
                break
        ma, mb = self._get(self.mapping, a), self._get(self.mapping, b)
        self._set(self.mapping, a, mb)
        self._set(self.mapping, b, ma)
        return True


# --- keygen ----------------------------------------------------------------


@dataclasses.dataclass
class Halo2ProvingKey:
    cs: ConstraintSystem
    k: int
    n: int
    extended_k: int
    omega: int
    kzg: HostKZG
    # assembly snapshots (golden-testable)
    assembly_fixed: list  # pre-compression fixed column values
    selectors: list  # raw activations
    cycle_store: CycleStore
    usable_rows: int
    # keygen products
    fixed_columns: list  # post-compression fixed values (list of list[int])
    fixed_polys: list  # coefficient form
    permutations: list  # sigma columns, evaluation form
    permutation_polys: list
    l_first: list  # coefficient form
    l_last: list
    l_active_row: list
    fixed_commitments: list  # (x, y) int points
    permutation_commitments: list
    deltas: list
    pinned_vk: str = ""
    transcript_repr: int = 0
    vendor: str = "scroll"
    pcs: str = "shplonk"  # "shplonk" (BDFG20) or "gwc" (GWC19)
    # keygen's KZG setup on its device, which TorchBackend reuses
    srs: object = dataclasses.field(default=None, repr=False, compare=False)


def keygen(circuit, k: int, tau: int = 2,
           vendor: str = "scroll",
           lookup_type: str = "halo2",
           pcs: str = "shplonk",
           device=torch.device("cuda")) -> Halo2ProvingKey:
    """Full halo2 keygen (reference: zk/plonk/keys/key.h PreLoad,
    verifying_key.h DoLoad, proving_key.h DoLoad).

    circuit must provide: configure(cs) -> config;
    floor_planner(cs, n) -> planner; synthesize via planner.
    The keygen IFFTs and the fixed/permutation commitments run through
    the port's NTT and MSM on ``device`` (the card unless the caller
    passes another; the reference runs keygen commits through the same
    kzg.h:218-240 path as proving).
    """
    from tachyon_tpu_torch.crypto import kzg as kzg_device
    from tachyon_tpu_torch.zk.plonk.halo2_device import device_committer, device_ifft_fn

    n = 1 << k
    cs = ConstraintSystem()
    cs.lookup_type = lookup_type
    config = circuit.configure(cs)
    if lookup_type == "log_derivative":
        cs.chunk_lookups()  # reference: keys/key.h:71-73
    cs.blinding_factors = cs.compute_blinding_factors()
    usable = n - (cs.blinding_factors + 1)

    planner = circuit.floor_planner(cs, n)
    assignment = planner.synthesize(circuit, config)
    assembly_fixed = [list(col) for col in assignment.fixed]
    selectors = [list(col) for col in assignment.selectors]

    # cycle store over permutation columns, copies applied in order
    perm_cols = list(cs.permutation_columns)
    col_index = {col: i for i, col in enumerate(perm_cols)}
    store = CycleStore(len(perm_cols), n)
    for (ca, ra), (cb, rb) in cs.copies:
        assert ca in col_index and cb in col_index, "copy without equality"
        store.merge((col_index[ca], ra), (col_index[cb], rb))

    # selector compression extends the fixed columns
    combination_assignments = cs.compress_selectors(selectors)
    fixed_columns = [list(map(int, col)) for col in assembly_fixed]
    fixed_columns += [list(map(int, col)) for col in combination_assignments]
    cs.collect_queries()

    omega = halo2_omega(k)
    extended_k = cs.compute_extended_k(k)
    kzg = HostKZG(n, tau)

    # sigma columns: delta^c * omega^r at each mapping label
    # (reference: permutation_assembly.h GeneratePermutations)
    delta = pow(HALO2_GENERATOR, 1 << TWO_ADICITY, FR)
    deltas = [pow(delta, j, FR) for j in range(len(perm_cols))]
    omega_pows = [pow(omega, r, FR) for r in range(n)]
    permutations = []
    for c in range(len(perm_cols)):
        col = []
        for r in range(n):
            mc, mr = store.mapping[c][r]
            col.append(deltas[mc] * omega_pows[mr] % FR)
        permutations.append(col)

    ifft_fn = device_ifft_fn(n, omega, device)
    fixed_polys = [ifft_fn(col) for col in fixed_columns]
    permutation_polys = [ifft_fn(col) for col in permutations]

    # row-selector polys (reference: proving_key.h DoLoad l_first/l_last/
    # l_active_row)
    l_first_e = [0] * n
    l_first_e[0] = 1
    l_last_e = [0] * n
    l_last_e[usable] = 1
    l_active_e = [1 if i < usable else 0 for i in range(n)]
    l_first = ifft_fn(l_first_e)
    l_last = ifft_fn(l_last_e)
    l_active_row = ifft_fn(l_active_e)

    srs = kzg_device.unsafe_setup(n, tau, device)
    commit = device_committer(srs)
    fixed_commitments = [commit(po) for po in fixed_polys]
    permutation_commitments = [commit(po) for po in permutation_polys]

    def pt(cm):
        return cm if cm is not None else None

    pinned = stringifier.pinned_vk_str(
        cs, k, extended_k, omega,
        [pt(c) for c in fixed_commitments],
        [pt(c) for c in permutation_commitments],
        base_modulus=FQ, scalar_modulus=FR,
    )
    repr_int = stringifier.transcript_repr_from_str(pinned, FR)

    return Halo2ProvingKey(
        cs=cs, k=k, n=n, extended_k=extended_k, omega=omega, kzg=kzg,
        assembly_fixed=assembly_fixed, selectors=selectors,
        cycle_store=store, usable_rows=usable,
        fixed_columns=fixed_columns, fixed_polys=fixed_polys,
        permutations=permutations, permutation_polys=permutation_polys,
        l_first=l_first, l_last=l_last, l_active_row=l_active_row,
        fixed_commitments=fixed_commitments,
        permutation_commitments=permutation_commitments,
        deltas=deltas, pinned_vk=pinned, transcript_repr=repr_int,
        vendor=vendor, pcs=pcs, srs=srs,
    )


# --- prover ----------------------------------------------------------------


def _batch_inverse(vals: list) -> list:
    """Montgomery-trick batch inverse: ONE modexp for the whole list
    (reference: math/base/field.h BatchInverse).  The grand-product /
    log-derivative loops call this instead of a per-row Fermat pow — the
    difference between O(n) 254-bit modexps and O(n) mults at k>=14."""
    m = len(vals)
    pref = [1] * (m + 1)
    for i, v in enumerate(vals):
        pref[i + 1] = pref[i] * v % FR
    acc = pow(pref[m], FR - 2, FR)
    out = [0] * m
    for i in range(m - 1, -1, -1):
        out[i] = acc * pref[i] % FR
        acc = acc * vals[i] % FR
    return out


@dataclasses.dataclass
class Halo2Proof:
    proof: bytes
    # per-phase intermediates, golden-testable
    advice_commitments: list
    theta: int
    beta: int
    gamma: int
    permutation_product_commitments: list
    vanishing_random_commitment: tuple
    y: int
    h_commitments: list
    x: int
    advice_evals: list
    fixed_evals: list
    vanishing_random_eval: int
    common_permutation_evals: list
    permutation_product_evals: list
    permutation_product_next_evals: list
    permutation_product_last_evals: list
    h_eval: int
    lookup_permuted_commitments: list = dataclasses.field(default_factory=list)
    lookup_product_commitments: list = dataclasses.field(default_factory=list)
    lookup_evals: list = dataclasses.field(default_factory=list)
    lookup_m_commitments: list = dataclasses.field(default_factory=list)
    shuffle_product_commitments: list = dataclasses.field(default_factory=list)
    shuffle_evals: list = dataclasses.field(default_factory=list)
    challenges: dict = dataclasses.field(default_factory=dict)


class Halo2Prover:
    """Scroll-vendor halo2 prover: host-exact control flow and transcript,
    the commitments, FFTs and quotient build on ``backend``
    (``TorchBackend(pk)``, on the card, unless the caller passes one)
    (reference: zk/plonk/halo2/prover.h:67-327 CreateProof)."""

    def __init__(self, pk: Halo2ProvingKey,
                 rng: RandomFieldGenerator | None = None,
                 legacy_serialization: bool = True,
                 backend=None):
        """legacy_serialization: point flag at bit 7 (y-odd) vs the new
        form (bit 7 = infinity, bit 6 = y-odd); the reference defaults to
        legacy and the C API / Rust vendors use the new form
        (proof_serializer.h s_use_legacy_serialization,
        c/zk/plonk/halo2/prover_impl_base.h:31)."""
        self.pk = pk
        self.rng = rng or RandomFieldGenerator()
        self.legacy_serialization = legacy_serialization
        if backend is None:
            from tachyon_tpu_torch.zk.plonk.halo2_device import TorchBackend

            backend = TorchBackend(pk)
        self.be = backend

    def create_proof(self, circuits: list, instance_columns_vec: list
                     ) -> Halo2Proof:
        from tachyon_tpu_torch.crypto.transcript import (
            TranscriptWriter,
            FieldSpecShim,
        )

        pk, rng = self.pk, self.rng
        cs, n, k = pk.cs, pk.n, pk.k
        omega, kzg = pk.omega, pk.kzg
        t_blind = cs.blinding_factors
        usable = pk.usable_rows
        log_derivative = cs.lookup_type == "log_derivative"

        w = TranscriptWriter(FieldSpecShim(FR), FieldSpecShim(FQ),
                             legacy=self.legacy_serialization)
        w.common_scalar(pk.transcript_repr)

        num_circuits = len(circuits)
        # instance polys (reference: argument_data.h:164-201): SHPlonk
        # (kQueryInstance=false) absorbs raw values; GWC
        # (kQueryInstance=true, gwc_extension.h:44) absorbs commitments
        query_instance = pk.pcs == "gwc"
        instance_polys_vec = []
        instance_evals_vec = []
        for insts in instance_columns_vec:
            polys, evals = [], []
            for col in insts:
                padded = [v % FR for v in col] + [0] * (n - len(col))
                if query_instance:
                    w.common_point(self.be.commit_lagrange(padded))
                else:
                    for v in col:
                        w.common_scalar(v % FR)
                evals.append(padded)
                polys.append(self.be.ifft(padded))
            instance_polys_vec.append(polys)
            instance_evals_vec.append(evals)

        # advice synthesis per phase per circuit (reference:
        # synthesizer.h:40-97 — last row pinned to one, one blind draw per
        # column after commit; phase challenges squeezed after each phase's
        # commitments, synthesizer.h:153-165)
        import copy as _copy

        phases = cs.phases()
        challenges = {}
        advice_evals_vec = [[None] * cs.num_advice for _ in circuits]
        advice_cms_vec = [[None] * cs.num_advice for _ in circuits]
        for phase in phases:
            for ci, circuit in enumerate(circuits):
                cs_w = _copy.deepcopy(cs)
                planner = circuit.floor_planner(cs_w, n)
                # configure on a throwaway system for the config handle
                cs_throw = ConstraintSystem()
                cs_throw.lookup_type = cs.lookup_type
                config = circuit.configure(cs_throw)
                planner.challenges = dict(challenges)
                # witness synthesis reads provided instance values
                # (reference: witness_collection.h instances_)
                for j, col in enumerate(instance_columns_vec[ci]):
                    for r, v in enumerate(col):
                        planner.assignment.instance[j][r] = int(v) % FR
                assignment = planner.synthesize(circuit, config)
                for j, col in enumerate(assignment.advice):
                    if cs.advice_column_phases[j] != phase:
                        continue
                    vals = [int(v) % FR for v in col]
                    vals[n - 1] = 1
                    cm = self.be.commit_lagrange(vals)
                    w.write_point(cm)
                    rng.generate()  # the (KZG-unused) Blind scalar draw
                    advice_evals_vec[ci][j] = vals
                    advice_cms_vec[ci][j] = cm
            for i, ph in enumerate(cs.challenge_phases):
                if ph == phase:
                    challenges[i] = w.squeeze_challenge()

        theta = w.squeeze_challenge()
        vlog(2, "Halo2 prover theta: %s", hex(theta))

        chunks = cs.permutation_chunks()
        col_tables = []
        for ci in range(num_circuits):
            col_tables.append({
                "fixed": pk.fixed_columns,
                "advice": advice_evals_vec[ci],
                "instance": instance_evals_vec[ci],
            })

        # lookup compress + permute + commit permuted pairs
        # (reference: prover.h:156-166, lookup/halo2/prover_impl.h:26-125,
        # permute_expression_pair.h:30-140): whole-column expression
        # evaluation on the backend, one compressor per column table
        _compressors = {}

        def compress(exprs, table):
            comp = _compressors.get(id(table))
            if comp is None:
                comp = self.be.make_compressor(table, challenges)
                _compressors[id(table)] = comp
            return comp(exprs, theta)

        lookup_compressed_vec = []  # [circuit][lookup] -> (A_comp, S_comp)
        # log-derivative: [circuit][lookup] -> ([A_comp per set], S_comp)
        lookup_permuted_vec = (
            [[] for _ in range(num_circuits)] if log_derivative else []
        )  # [circuit][lookup] -> (A', S')
        lookup_m_vec = []  # log-derivative: [circuit][lookup] -> m evals
        if log_derivative:
            # compress + m polys (lookup/log_derivative_halo2/
            # prover_impl.h:55-156; one Blind-scalar draw per m poly)
            for ci in range(num_circuits):
                comp, ms = [], []
                for lk in cs.lookups:
                    a_comps = [compress(inputs, col_tables[ci])
                               for inputs in lk.inputs_list]
                    s_comp = compress(lk.table_exprs, col_tables[ci])
                    comp.append((a_comps, s_comp))
                    # stable-sort table rows by value, then the reference's
                    # midpoint binary search decides WHICH duplicate row's
                    # multiplicity is bumped (container_util.h:169-184 — a
                    # classic binary search, not lower_bound; the probe path
                    # picks the tie)
                    sorted_rows = sorted(range(usable),
                                         key=lambda r: s_comp[r])

                    def bsearch(v):
                        left, right = 0, usable
                        while left < right:
                            mid = left + (right - left) // 2
                            mv = s_comp[sorted_rows[mid]]
                            if mv < v:
                                left = mid + 1
                            elif v < mv:
                                right = mid
                            else:
                                return sorted_rows[mid]
                        return None

                    m = [0] * n
                    for a_comp in a_comps:
                        for r in range(usable):
                            row = bsearch(a_comp[r])
                            if row is not None:
                                m[row] += 1
                    rng.generate()  # m poly Blind scalar
                    ms.append(m)
                lookup_compressed_vec.append(comp)
                lookup_m_vec.append(ms)
            lookup_permuted_cms_vec = [[] for _ in range(num_circuits)]
            lookup_m_cms_vec = []
            for ci in range(num_circuits):
                cms = []
                for m in lookup_m_vec[ci]:
                    cm = self.be.commit_lagrange(m)
                    w.write_point(cm)
                    cms.append(cm)
                lookup_m_cms_vec.append(cms)
        for ci in range(num_circuits if not log_derivative else 0):
            comp, perm = [], []
            for lk in cs.lookups:
                a_comp = compress(lk.input_exprs, col_tables[ci])
                s_comp = compress(lk.table_exprs, col_tables[ci])
                comp.append((a_comp, s_comp))
                # permute: sort inputs, align table
                a_p = list(a_comp)
                a_p[:usable] = sorted(a_p[:usable])
                leftover = {}
                for r in range(usable):
                    leftover[s_comp[r]] = leftover.get(s_comp[r], 0) + 1
                s_p = [0] * n
                repeated = []
                for r in range(usable):
                    v = a_p[r]
                    if r == 0 or v != a_p[r - 1]:
                        s_p[r] = v
                        assert leftover.get(v, 0) > 0, \
                            "lookup input not in table"
                        leftover[v] -= 1
                    else:
                        repeated.append(r)
                for v in sorted(kk for kk, cnt in leftover.items() if cnt):
                    for _ in range(leftover[v]):
                        s_p[repeated.pop()] = v
                assert not repeated
                # blind both with the last row included (t + 1 rows)
                for i in range(n - t_blind - 1, n):
                    a_p[i] = rng.generate()
                for i in range(n - t_blind - 1, n):
                    s_p[i] = rng.generate()
                rng.generate()  # input Blind scalar
                rng.generate()  # table Blind scalar
                perm.append((a_p, s_p))
            lookup_compressed_vec.append(comp)
            lookup_permuted_vec.append(perm)
        if not log_derivative:
            lookup_permuted_cms_vec = []
            for ci in range(num_circuits):
                cms = []
                for a_p, s_p in lookup_permuted_vec[ci]:
                    cma = self.be.commit_lagrange(a_p)
                    w.write_point(cma)
                    cms_pair = [cma]
                    cmb = self.be.commit_lagrange(s_p)
                    w.write_point(cmb)
                    cms_pair.append(cmb)
                    cms.append(tuple(cms_pair))
                lookup_permuted_cms_vec.append(cms)

        beta = w.squeeze_challenge()
        gamma = w.squeeze_challenge()
        vlog(2, "Halo2 prover beta: %s gamma: %s", hex(beta), hex(gamma))

        perm_z_vec = []  # [circuit][chunk] -> evals list
        for ci in range(num_circuits):
            table = col_tables[ci]
            last_z = 1
            zs = []
            j = 0
            omega_pows = getattr(pk, "_omega_pows_cache", None)
            if omega_pows is None:
                omega_pows = [1] * n
                for r in range(1, n):
                    omega_pows[r] = omega_pows[r - 1] * omega % FR
                pk._omega_pows_cache = omega_pows
            for chunk in chunks:
                nums, dens = [], []
                for r in range(n):
                    num_v, den_v = 1, 1
                    for cidx, col in enumerate(chunk):
                        v = table[col.kind][col.index][r]
                        dj = pk.deltas[j + cidx]
                        num_v = num_v * (
                            (v + beta * dj % FR * omega_pows[r] + gamma)
                            % FR) % FR
                        den_v = den_v * (
                            (v + beta * pk.permutations[j + cidx][r] + gamma)
                            % FR) % FR
                    nums.append(num_v)
                    dens.append(den_v)
                inv_dens = _batch_inverse(dens)
                ratios = [nv * iv % FR for nv, iv in zip(nums, inv_dens)]
                j += len(chunk)
                z = [0] * n
                z[0] = last_z
                for i in range(usable):
                    z[i + 1] = z[i] * ratios[i] % FR
                last_z = z[usable]
                # blind rows [n - t, n) (blinder.h:36-44)
                for i in range(n - t_blind, n):
                    z[i] = rng.generate()
                rng.generate()  # Blind scalar for the z poly
                zs.append(z)
            perm_z_vec.append(zs)

        # lookup grand products/sums (reference: prover.h:199-205,
        # lookup/halo2/prover_impl.h:129-160 + grand_product_argument.h:40-61;
        # log-derivative: log_derivative_halo2/prover_impl.h:203-300)
        lookup_z_vec = []
        for ci in range(num_circuits):
            zs = []
            for li in range(len(cs.lookups)):
                if log_derivative:
                    a_comps, s_comp = lookup_compressed_vec[ci][li]
                    m = lookup_m_vec[ci][li]
                    # phi(w^0)=0; phi(w^{i+1}) = phi(w^i) + L(w^i) where
                    # L = sum_j 1/(f_j + beta) - m/(t + beta)
                    # phi(w^{i+1}) = phi(w^i) + L(w^i) for i < usable-1;
                    # phi(w^usable) stays 0 (the sum telescopes to zero)
                    a_invs = [_batch_inverse(
                        [(a_comp[i] + beta) % FR for i in range(usable - 1)])
                        for a_comp in a_comps]
                    s_inv = _batch_inverse(
                        [(s_comp[i] + beta) % FR for i in range(usable - 1)])
                    z = [0] * n
                    for i in range(usable - 1):
                        l_val = sum(ai[i] for ai in a_invs)
                        l_val -= m[i] * s_inv[i]
                        z[i + 1] = (z[i] + l_val) % FR
                    for i in range(n - t_blind, n):
                        z[i] = rng.generate()
                    rng.generate()  # Blind scalar
                    zs.append(z)
                    continue
                a_comp, s_comp = lookup_compressed_vec[ci][li]
                a_p, s_p = lookup_permuted_vec[ci][li]
                nums = [(a_comp[r] + beta) * (s_comp[r] + gamma) % FR
                        for r in range(n)]
                dens = [(a_p[r] + beta) * (s_p[r] + gamma) % FR
                        for r in range(n)]
                ratios = [nv * iv % FR
                          for nv, iv in zip(nums, _batch_inverse(dens))]
                z = [0] * n
                z[0] = 1
                for i in range(usable):
                    z[i + 1] = z[i] * ratios[i] % FR
                for i in range(n - t_blind, n):
                    z[i] = rng.generate()
                rng.generate()  # Blind scalar
                zs.append(z)
            lookup_z_vec.append(zs)

        # shuffle grand products (reference: prover.h:208-211 +
        # shuffle/prover_impl.h:73-135: compress with theta AFTER beta/gamma,
        # z ratios (A+gamma)/(S+gamma), blind t rows, one Blind-scalar draw)
        shuffle_z_vec = []
        for ci in range(num_circuits):
            zs = []
            for sh in cs.shuffles:
                a_comp = compress(sh.input_exprs, col_tables[ci])
                s_comp = compress(sh.shuffle_exprs, col_tables[ci])
                s_inv = _batch_inverse(
                    [(s_comp[i] + gamma) % FR for i in range(usable)])
                z = [0] * n
                z[0] = 1
                for i in range(usable):
                    ratio = (a_comp[i] + gamma) * s_inv[i] % FR
                    z[i + 1] = z[i] * ratio % FR
                for i in range(n - t_blind, n):
                    z[i] = rng.generate()
                rng.generate()  # Blind scalar
                zs.append(z)
            shuffle_z_vec.append(zs)

        # vanishing random poly = 1 (vanishing_prover_impl.h:23-38)
        random_poly = [1]

        # commit grand products then the random poly
        perm_z_cms_vec = []
        for ci in range(num_circuits):
            cms = []
            for z in perm_z_vec[ci]:
                cm = self.be.commit_lagrange(z)
                w.write_point(cm)
                cms.append(cm)
            perm_z_cms_vec.append(cms)
        lookup_z_cms_vec = []
        for ci in range(num_circuits):
            cms = []
            for z in lookup_z_vec[ci]:
                cm = self.be.commit_lagrange(z)
                w.write_point(cm)
                cms.append(cm)
            lookup_z_cms_vec.append(cms)
        shuffle_z_cms_vec = []
        for ci in range(num_circuits):
            cms = []
            for z in shuffle_z_vec[ci]:
                cm = self.be.commit_lagrange(z)
                w.write_point(cm)
                cms.append(cm)
            shuffle_z_cms_vec.append(cms)
        random_cm = self.be.commit(random_poly)
        w.write_point(random_cm)

        y = w.squeeze_challenge()
        vlog(2, "Halo2 prover y: %s", hex(y))

        # to coefficient form
        advice_polys_vec = [
            [self.be.ifft(c) for c in cols] for cols in advice_evals_vec
        ]
        perm_zp_vec = [
            [self.be.ifft(z) for z in zs] for zs in perm_z_vec
        ]
        lookup_zp_vec = [
            [self.be.ifft(z) for z in zs] for zs in lookup_z_vec
        ]
        lookup_permuted_polys_vec = [
            [(self.be.ifft(a_p), self.be.ifft(s_p))
             for a_p, s_p in pairs]
            for pairs in lookup_permuted_vec
        ]
        lookup_mp_vec = [
            [self.be.ifft(m) for m in ms] for ms in lookup_m_vec
        ] if log_derivative else [[] for _ in range(num_circuits)]
        shuffle_zp_vec = [
            [self.be.ifft(z) for z in zs] for zs in shuffle_z_vec
        ]

        sigma_polys = pk.permutation_polys
        # --- h(X): delegated to the backend (TorchBackend: the vectorized
        # evaluator over the extended coset, the reference GraphEvaluator's
        # analog) --------------------------------------------------------------
        h_coeffs = self.be.build_h_coeffs(
            challenges=challenges, theta=theta, beta=beta, gamma=gamma,
            y=y, t_blind=t_blind, chunks=chunks,
            log_derivative=log_derivative,
            advice_polys_vec=advice_polys_vec,
            instance_polys_vec=instance_polys_vec,
            perm_zp_vec=perm_zp_vec, lookup_zp_vec=lookup_zp_vec,
            lookup_permuted_polys_vec=lookup_permuted_polys_vec,
            lookup_mp_vec=lookup_mp_vec, shuffle_zp_vec=shuffle_zp_vec,
        )

        # split into quotient_poly_degree pieces of n
        # (vanishing_prover_impl.h CreateFinalHPoly/CommitFinalHPoly)
        qdeg = cs.required_degree() - 1
        h_pieces = [
            h_coeffs[i * n:(i + 1) * n] for i in range(qdeg)
        ]
        h_cms = []
        for piece in h_pieces:
            cm = self.be.commit(piece)
            w.write_point(cm)
            h_cms.append(cm)

        x = w.squeeze_challenge()
        vlog(2, "Halo2 prover x: %s", hex(x))
        x_next = x * omega % FR
        x_last = x * pow(omega, (-(t_blind + 1)) % n, FR) % FR
        x_n = pow(x, n, FR)

        # --- evals (reference: prover.h:330-353 Evaluate + proof_reader.h
        # order: advice per circuit, fixed, random, common sigma, z's) ----
        def ev(po, pt):
            return host_eval(po, pt)

        instance_evals_out = []
        if query_instance:
            # instance evals first (vanishing_prover_impl.h:160-166)
            for ci in range(num_circuits):
                evs = []
                for (cidx, rot) in cs.instance_queries:
                    pt = x * pow(omega, rot % n, FR) % FR
                    vv = ev(instance_polys_vec[ci][cidx], pt)
                    w.write_scalar(vv)
                    evs.append(vv)
                instance_evals_out.append(evs)
        advice_evals_out = []
        for ci in range(num_circuits):
            evs = []
            for (cidx, rot) in cs.advice_queries:
                pt = x * pow(omega, rot % n, FR) % FR
                vv = ev(advice_polys_vec[ci][cidx], pt)
                w.write_scalar(vv)
                evs.append(vv)
            advice_evals_out.append(evs)
        fixed_evals_out = []
        for (cidx, rot) in cs.fixed_queries:
            pt = x * pow(omega, rot % n, FR) % FR
            vv = ev(pk.fixed_polys[cidx], pt)
            w.write_scalar(vv)
            fixed_evals_out.append(vv)
        random_eval = host_eval(random_poly, x)
        w.write_scalar(random_eval)
        common_perm_evals = []
        for po in sigma_polys:
            vv = ev(po, x)
            w.write_scalar(vv)
            common_perm_evals.append(vv)
        pp_evals, pp_next_evals, pp_last_evals = [], [], []
        for ci in range(num_circuits):
            es, ns, ls = [], [], []
            zps = perm_zp_vec[ci]
            for ji, zp in enumerate(zps):
                vv = ev(zp, x)
                w.write_scalar(vv)
                es.append(vv)
                vv = ev(zp, x_next)
                w.write_scalar(vv)
                ns.append(vv)
                if ji != len(zps) - 1:
                    vv = ev(zp, x_last)
                    w.write_scalar(vv)
                    ls.append(vv)
            pp_evals.append(es)
            pp_next_evals.append(ns)
            pp_last_evals.append(ls)
        # lookup evals: z(x), z(wx), a'(x), a'(w^-1 x), s'(x) per lookup
        # (lookup/halo2/prover_impl.h:203-232)
        x_prev = x * pow(omega, n - 1, FR) % FR
        lookup_evals_out = []
        for ci in range(num_circuits):
            evs = []
            for li in range(len(cs.lookups)):
                zp = lookup_zp_vec[ci][li]
                e = {}
                e["z_x"] = ev(zp, x)
                w.write_scalar(e["z_x"])
                e["z_wx"] = ev(zp, x_next)
                w.write_scalar(e["z_wx"])
                if log_derivative:
                    # phi(x), phi(wx), m(x)
                    # (log_derivative_halo2/prover_impl.h:359-383)
                    e["m_x"] = ev(lookup_mp_vec[ci][li], x)
                    w.write_scalar(e["m_x"])
                    evs.append(e)
                    continue
                pa, ps = lookup_permuted_polys_vec[ci][li]
                e["a_x"] = ev(pa, x)
                w.write_scalar(e["a_x"])
                e["a_prev"] = ev(pa, x_prev)
                w.write_scalar(e["a_prev"])
                e["s_x"] = ev(ps, x)
                w.write_scalar(e["s_x"])
                evs.append(e)
            lookup_evals_out.append(evs)
        # shuffle evals: z(x), z(wx) (shuffle/prover_impl.h:139-161)
        shuffle_evals_out = []
        for ci in range(num_circuits):
            evs = []
            for zp in shuffle_zp_vec[ci]:
                e = {"z_x": ev(zp, x), "z_wx": ev(zp, x_next)}
                w.write_scalar(e["z_x"])
                w.write_scalar(e["z_wx"])
                evs.append(e)
            shuffle_evals_out.append(evs)

        # combined h poly for the opening: sum_i x^(n*i) * h_piece_i
        combined_h = [0] * n
        for i in range(len(h_pieces) - 1, -1, -1):
            for jj in range(n):
                combined_h[jj] = (combined_h[jj] * x_n
                                  + h_pieces[i][jj]) % FR
        h_eval = host_eval(combined_h, x)

        # --- openings (reference: prover.h:355-407 Open order) ------------
        openings = []  # (poly_id, coeffs, point, eval)
        pid = 0

        def add(poly_key, coeffs, pt):
            openings.append((poly_key, coeffs, pt, host_eval(coeffs, pt)))

        for ci in range(num_circuits):
            if query_instance:
                # instance openings precede advice
                # (vanishing_prover_impl.h:218-233)
                for (cidx, rot) in cs.instance_queries:
                    pt = x * pow(omega, rot % n, FR) % FR
                    add(("instance", ci, cidx),
                        instance_polys_vec[ci][cidx], pt)
            for (cidx, rot) in cs.advice_queries:
                pt = x * pow(omega, rot % n, FR) % FR
                add(("advice", ci, cidx), advice_polys_vec[ci][cidx], pt)
            zps = perm_zp_vec[ci]
            for ji, zp in enumerate(zps):
                add(("perm_z", ci, ji), zp, x)
                add(("perm_z", ci, ji), zp, x_next)
            for ji in range(len(zps) - 2, -1, -1):
                add(("perm_z", ci, ji), zps[ji], x_last)
            # lookup openings: halo2 z@x, a'@x, s'@x, a'@x_prev, z@x_next
            # (lookup/halo2/prover_impl.h:236-268); log-derivative phi@x,
            # phi@x_next, m@x (log_derivative_halo2/prover_impl.h:386-410)
            for li in range(len(cs.lookups)):
                zp = lookup_zp_vec[ci][li]
                if log_derivative:
                    add(("lookup_z", ci, li), zp, x)
                    add(("lookup_z", ci, li), zp, x_next)
                    add(("lookup_m", ci, li), lookup_mp_vec[ci][li], x)
                    continue
                pa, ps = lookup_permuted_polys_vec[ci][li]
                add(("lookup_z", ci, li), zp, x)
                add(("lookup_a", ci, li), pa, x)
                add(("lookup_s", ci, li), ps, x)
                add(("lookup_a", ci, li), pa, x_prev)
                add(("lookup_z", ci, li), zp, x_next)
            # shuffle openings: z@x, z@x_next
            # (shuffle/prover_impl.h:163-187)
            for si, zp in enumerate(shuffle_zp_vec[ci]):
                add(("shuffle_z", ci, si), zp, x)
                add(("shuffle_z", ci, si), zp, x_next)
        for (cidx, rot) in cs.fixed_queries:
            pt = x * pow(omega, rot % n, FR) % FR
            add(("fixed", cidx), pk.fixed_polys[cidx], pt)
        for ji, po in enumerate(sigma_polys):
            add(("sigma", ji), po, x)
        add(("h",), combined_h, x)
        add(("random",), random_poly, x)

        # the opening-proof commitments (h/q for SHPlonk, the per-point W_i
        # for GWC) run through the SAME backend as every other commit, so a
        # TorchBackend keeps them on the device MSM
        # (reference: kzg.h:218-240, shplonk.h:85)
        if pk.pcs == "gwc":
            gwc_open(self.be, openings, w)
        else:
            shplonk_open(self.be, openings, w)

        return Halo2Proof(
            proof=bytes(w.proof),
            advice_commitments=advice_cms_vec,
            theta=theta, beta=beta, gamma=gamma,
            permutation_product_commitments=perm_z_cms_vec,
            vanishing_random_commitment=random_cm,
            y=y, h_commitments=h_cms, x=x,
            advice_evals=advice_evals_out,
            fixed_evals=fixed_evals_out,
            vanishing_random_eval=random_eval,
            common_permutation_evals=common_perm_evals,
            permutation_product_evals=pp_evals,
            permutation_product_next_evals=pp_next_evals,
            permutation_product_last_evals=pp_last_evals,
            h_eval=h_eval,
            lookup_permuted_commitments=lookup_permuted_cms_vec,
            lookup_product_commitments=lookup_z_cms_vec,
            lookup_evals=lookup_evals_out,
            lookup_m_commitments=(lookup_m_cms_vec if log_derivative
                                  else []),
            shuffle_product_commitments=shuffle_z_cms_vec,
            shuffle_evals=shuffle_evals_out,
            challenges=challenges,
        )


# --- SHPlonk (host-exact; reference: crypto/commitments/kzg/shplonk.h:85-230
# + polynomial_openings.h grouping) ----------------------------------------


def _poly_sub(a, b):
    m = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) - (b[i] if i < len(b) else 0)) % FR
            for i in range(m)]


def _poly_scale(a, s):
    return [v * s % FR for v in a]


def _poly_add(a, b):
    m = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % FR
            for i in range(m)]


def _poly_mul_linear(a, c):
    """a(X) * (X - c)"""
    out = [0] * (len(a) + 1)
    for i, v in enumerate(a):
        out[i + 1] = (out[i + 1] + v) % FR
        out[i] = (out[i] - v * c) % FR
    return out


def _poly_div_linear(a, c):
    """a(X) / (X - c) by synthetic division; asserts zero remainder."""
    out = [0] * (len(a) - 1)
    carry = 0
    for i in range(len(a) - 1, 0, -1):
        carry = (a[i] + carry * c) % FR
        out[i - 1] = carry
    assert (a[0] + carry * c) % FR == 0, "division has remainder"
    return out


def _lagrange_interpolate(points, values):
    """exact Lagrange interpolation -> coeffs (low-to-high)."""
    coeffs = [0] * len(points)
    for i, (xi, yi) in enumerate(zip(points, values)):
        basis = [1]
        denom = 1
        for jj, xj in enumerate(points):
            if jj == i:
                continue
            basis = _poly_mul_linear(basis, xj)
            denom = denom * (xi - xj) % FR
        scale = yi * pow(denom, FR - 2, FR) % FR
        coeffs = _poly_add(coeffs, _poly_scale(basis, scale))
    return coeffs


def shplonk_open(be, openings: list, w) -> None:
    """openings: list of (poly_key, coeffs, point, eval); groups by
    (oracle, point-set), then BDFG20: h = sum_groups v^i * sum_polys y^j *
    (P - R)/Z_set; commit h; u; L = linear comb - Z_T(u) h; q = L/(X-u)
    (reference: shplonk.h:85-230)."""
    # group by poly oracle (key) preserving first-seen order
    oracle_order = []
    oracle_map = {}
    super_points = set()
    for key, coeffs, pt, vv in openings:
        super_points.add(pt)
        if key not in oracle_map:
            oracle_map[key] = {"coeffs": coeffs, "points": {}, }
            oracle_order.append(key)
        oracle_map[key]["points"][pt] = vv
    # group oracles by identical (sorted) point sets, first-seen order
    set_order = []
    set_map = {}
    for key in oracle_order:
        pts = tuple(sorted(oracle_map[key]["points"]))
        if pts not in set_map:
            set_map[pts] = []
            set_order.append(pts)
        set_map[pts].append(key)

    y = w.squeeze_challenge()

    h_polys = []
    ldes = []  # per group: list of R polys (same order as group oracles)
    for pts in set_order:
        group = set_map[pts]
        rs = []
        for key in group:
            info = oracle_map[key]
            rs.append(_lagrange_interpolate(
                list(pts), [info["points"][pt] for pt in pts]))
        ldes.append(rs)
        # sum_i y^i * (P_i - R_i), group order = first-seen order
        # (shplonk.h LinearCombinationInPlace<forward=false>)
        acc = [0]
        for i, key in enumerate(group):
            num = _poly_sub(oracle_map[key]["coeffs"], rs[i])
            acc = _poly_add(acc, _poly_scale(num, pow(y, i, FR)))
        for pt in pts:
            acc = _poly_div_linear(acc, pt)
        h_polys.append(acc)

    v = w.squeeze_challenge()
    h_poly = [0]
    for i, hp in enumerate(h_polys):
        h_poly = _poly_add(h_poly, _poly_scale(hp, pow(v, i, FR)))
    h_cm = be.commit(h_poly)
    w.write_point(h_cm)
    u = w.squeeze_challenge()

    sorted_super = sorted(super_points)
    l_poly = [0]
    first_z_diff = 1
    for gi, pts in enumerate(set_order):
        group = set_map[pts]
        diffs = [pt for pt in sorted_super if pt not in pts]
        z_diff = 1
        for d in diffs:
            z_diff = z_diff * (u - d) % FR
        if gi == 0:
            first_z_diff = z_diff
        acc = [0]
        for i, key in enumerate(group):
            r_u = host_eval(ldes[gi][i], u)
            poly = list(oracle_map[key]["coeffs"])
            if poly:
                poly[0] = (poly[0] - r_u) % FR
            else:
                poly = [(-r_u) % FR]
            acc = _poly_add(acc, _poly_scale(poly, pow(y, i, FR)))
        l_poly = _poly_add(l_poly, _poly_scale(acc, pow(v, gi, FR)
                                               * z_diff % FR))
    zt_eval = 1
    for pt in sorted_super:
        zt_eval = zt_eval * (u - pt) % FR
    l_poly = _poly_sub(l_poly, _poly_scale(h_poly, zt_eval))
    assert host_eval(l_poly, u) == 0
    q_poly = _poly_div_linear(l_poly, u)
    q_poly = _poly_scale(q_poly, pow(first_z_diff, FR - 2, FR))
    q_cm = be.commit(q_poly)
    w.write_point(q_cm)


def gwc_open(be, openings: list, w) -> None:
    """GWC19 multi-open: v challenge, group by single point (first-seen
    order), W_i = sum_j v^j (P_j - P_j(x_i)) / (X - x_i), commit each
    (reference: crypto/commitments/kzg/gwc.h:83-124)."""
    v = w.squeeze_challenge()
    point_order = []
    groups = {}
    for key, coeffs, pt, vv in openings:
        if pt not in groups:
            groups[pt] = []
            point_order.append(pt)
        groups[pt].append((coeffs, vv))
    cms = []
    for pt in point_order:
        acc = [0]
        for j, (coeffs, vv) in enumerate(groups[pt]):
            num = list(coeffs)
            if num:
                num[0] = (num[0] - vv) % FR
            else:
                num = [(-vv) % FR]
            acc = _poly_add(acc, _poly_scale(num, pow(v, j, FR)))
        acc = _poly_div_linear(acc, pt)
        cms.append(be.commit(acc))
    for cm in cms:
        w.write_point(cm)


# --- verifier ----------------------------------------------------------------

# standard BN254 G2 generator (x, y) over Fq2 as ((c0, c1), (c0, c1))
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


class Halo2Verifier:
    """Host-exact halo2 verifier: accepts proofs from this module's prover
    AND the reference's pinned golden proofs (reference:
    zk/plonk/halo2/verifier.h, crypto/commitments/kzg/shplonk.h
    DoVerifyOpeningProof, kzg/gwc.h DoVerifyOpeningProof)."""

    def __init__(self, pk: Halo2ProvingKey, legacy_serialization: bool = True):
        self.pk = pk
        self.legacy = legacy_serialization
        # [tau]_2 for the pairing check, exact host G2 arithmetic
        from tachyon_tpu_torch.math import pairing_bn254 as pairing

        self.pairing = pairing
        self.tau_g2 = host_ec.g2_mul(G2_GEN, pk.kzg.tau)

    def verify(self, proof: bytes, instance_columns_vec: list) -> bool:
        try:
            return self._verify(proof, instance_columns_vec)
        except Exception:
            return False

    def _verify(self, proof: bytes, instance_columns_vec: list) -> bool:
        from tachyon_tpu_torch.crypto.transcript import (
            TranscriptReader,
            FieldSpecShim,
        )

        pk = self.pk
        cs, n, omega, kzg = pk.cs, pk.n, pk.omega, pk.kzg
        t_blind = cs.blinding_factors
        usable = pk.usable_rows
        log_derivative = cs.lookup_type == "log_derivative"
        query_instance = pk.pcs == "gwc"
        num_circuits = len(instance_columns_vec)

        r = TranscriptReader(proof, FieldSpecShim(FR), FieldSpecShim(FQ),
                             b_coeff=3, legacy=self.legacy)
        r.common_scalar(pk.transcript_repr)
        instance_polys_vec = []
        for insts in instance_columns_vec:
            polys = []
            for col in insts:
                padded = [v % FR for v in col] + [0] * (n - len(col))
                if query_instance:
                    r.common_point(kzg.commit_lagrange(padded, omega))
                else:
                    for v in col:
                        r.common_scalar(v % FR)
                polys.append(host_ifft(padded, omega))
            instance_polys_vec.append(polys)

        phases = cs.phases()
        challenges = {}
        advice_cms_vec = [[None] * cs.num_advice for _ in range(num_circuits)]
        for phase in phases:
            for ci in range(num_circuits):
                for j in range(cs.num_advice):
                    if cs.advice_column_phases[j] == phase:
                        advice_cms_vec[ci][j] = r.read_point()
            for i, ph in enumerate(cs.challenge_phases):
                if ph == phase:
                    challenges[i] = r.squeeze_challenge()
        theta = r.squeeze_challenge()

        lookup_permuted_cms_vec, lookup_m_cms_vec = [], []
        for ci in range(num_circuits):
            if log_derivative:
                lookup_m_cms_vec.append(
                    [r.read_point() for _ in cs.lookups])
            else:
                lookup_permuted_cms_vec.append(
                    [(r.read_point(), r.read_point()) for _ in cs.lookups])
        beta = r.squeeze_challenge()
        gamma = r.squeeze_challenge()
        chunks = cs.permutation_chunks()
        perm_z_cms_vec = [
            [r.read_point() for _ in chunks] for _ in range(num_circuits)
        ]
        lookup_z_cms_vec = [
            [r.read_point() for _ in cs.lookups] for _ in range(num_circuits)
        ]
        shuffle_z_cms_vec = [
            [r.read_point() for _ in cs.shuffles] for _ in range(num_circuits)
        ]
        random_cm = r.read_point()
        y = r.squeeze_challenge()
        qdeg = cs.required_degree() - 1
        h_cms = [r.read_point() for _ in range(qdeg)]
        x = r.squeeze_challenge()
        x_next = x * omega % FR
        x_prev = x * pow(omega, n - 1, FR) % FR
        x_last = x * pow(omega, (-(t_blind + 1)) % n, FR) % FR
        x_n = pow(x, n, FR)

        instance_evals_vec = []
        if query_instance:
            for ci in range(num_circuits):
                instance_evals_vec.append(
                    [r.read_scalar() for _ in cs.instance_queries])
        else:
            for ci in range(num_circuits):
                instance_evals_vec.append([
                    host_eval(instance_polys_vec[ci][cq], 
                              x * pow(omega, rot % n, FR) % FR)
                    for cq, rot in cs.instance_queries
                ])
        advice_evals_vec = [
            [r.read_scalar() for _ in cs.advice_queries]
            for _ in range(num_circuits)
        ]
        fixed_evals = [r.read_scalar() for _ in cs.fixed_queries]
        random_eval = r.read_scalar()
        sigma_evals = [r.read_scalar() for _ in pk.permutation_polys]
        perm_evals_vec = []
        for ci in range(num_circuits):
            es = []
            for j in range(len(chunks)):
                e = {"z_x": r.read_scalar(), "z_wx": r.read_scalar()}
                if j != len(chunks) - 1:
                    e["z_lastx"] = r.read_scalar()
                es.append(e)
            perm_evals_vec.append(es)
        lookup_evals_vec = []
        for ci in range(num_circuits):
            es = []
            for _ in cs.lookups:
                e = {"z_x": r.read_scalar(), "z_wx": r.read_scalar()}
                if log_derivative:
                    e["m_x"] = r.read_scalar()
                else:
                    e["a_x"] = r.read_scalar()
                    e["a_prev"] = r.read_scalar()
                    e["s_x"] = r.read_scalar()
                es.append(e)
            lookup_evals_vec.append(es)
        shuffle_evals_vec = [
            [{"z_x": r.read_scalar(), "z_wx": r.read_scalar()}
             for _ in cs.shuffles]
            for _ in range(num_circuits)
        ]

        # --- expected h eval: identities at x, y-chained in prover order --
        l0 = (x_n - 1) * pow(n * (x - 1) % FR, FR - 2, FR) % FR

        def lag(i):
            wi = pow(omega, i, FR)
            return wi * (x_n - 1) % FR * pow(
                n * (x - wi) % FR, FR - 2, FR) % FR

        l_last = lag(usable)
        l_blind = sum(lag(i) for i in range(usable + 1, n)) % FR
        l_active = (1 - l_last - l_blind) % FR

        def eval_expr_at_x(e, ci):
            if isinstance(e, ex.Constant):
                return e.value % FR
            if isinstance(e, ex.Challenge):
                return challenges[e.index]
            if isinstance(e, ex.Fixed):
                qi = cs.fixed_queries.index((e.column, e.rotation))
                return fixed_evals[qi]
            if isinstance(e, ex.Advice):
                qi = cs.advice_queries.index((e.column, e.rotation))
                return advice_evals_vec[ci][qi]
            if isinstance(e, ex.Instance):
                qi = cs.instance_queries.index((e.column, e.rotation))
                return instance_evals_vec[ci][qi]
            if isinstance(e, ex.Negated):
                return (-eval_expr_at_x(e.expr, ci)) % FR
            if isinstance(e, ex.Scaled):
                return eval_expr_at_x(e.expr, ci) * e.scale % FR
            if isinstance(e, ex.Sum):
                return (eval_expr_at_x(e.left, ci)
                        + eval_expr_at_x(e.right, ci)) % FR
            if isinstance(e, ex.Product):
                return eval_expr_at_x(e.left, ci) \
                    * eval_expr_at_x(e.right, ci) % FR
            raise TypeError(e)

        delta = pow(HALO2_GENERATOR, 1 << TWO_ADICITY, FR)
        acc = None

        def chain(v):
            nonlocal acc
            acc = v % FR if acc is None else (acc * y + v) % FR

        col_eval_tbl = {"fixed": lambda ci, c: fixed_evals[
            cs.fixed_queries.index((c, 0))]}

        for ci in range(num_circuits):
            for g in cs.gates:
                for poly in g.polys:
                    chain(eval_expr_at_x(poly, ci))
            if chunks:
                pz = perm_evals_vec[ci]
                chain(l0 * (1 - pz[0]["z_x"]))
                zl = pz[-1]["z_x"]
                chain(l_last * (zl * zl - zl))
                for c in range(1, len(chunks)):
                    chain(l0 * (pz[c]["z_x"] - pz[c - 1]["z_lastx"]))
                jcol = 0
                cur_delta = beta * x % FR
                for c, chunk in enumerate(chunks):
                    left, right = pz[c]["z_wx"], pz[c]["z_x"]
                    for col in chunk:
                        if col.kind == "fixed":
                            cv = fixed_evals[
                                cs.fixed_queries.index((col.index, 0))]
                        elif col.kind == "advice":
                            cv = advice_evals_vec[ci][
                                cs.advice_queries.index((col.index, 0))]
                        else:
                            cv = instance_evals_vec[ci][
                                cs.instance_queries.index((col.index, 0))]
                        left = left * ((cv + beta * sigma_evals[jcol]
                                        + gamma) % FR) % FR
                        right = right * ((cv + cur_delta + gamma) % FR) % FR
                        cur_delta = cur_delta * delta % FR
                        jcol += 1
                    chain((left - right) * l_active)
            for li, lk in enumerate(cs.lookups):
                e = lookup_evals_vec[ci][li]
                if log_derivative:
                    phis = []
                    for inputs in lk.inputs_list:
                        a_comp = 0
                        for e2 in inputs:
                            a_comp = (a_comp * theta
                                      + eval_expr_at_x(e2, ci)) % FR
                        phis.append((a_comp + beta) % FR)
                    s_comp = 0
                    for e2 in lk.table_exprs:
                        s_comp = (s_comp * theta
                                  + eval_expr_at_x(e2, ci)) % FR
                    tau = (s_comp + beta) % FR
                    prod = 1
                    for p_v in phis:
                        prod = prod * p_v % FR
                    lhs = tau * prod % FR * ((e["z_wx"] - e["z_x"]) % FR) % FR
                    excl = 0
                    for i2 in range(len(phis)):
                        t2 = 1
                        for j2, p_v in enumerate(phis):
                            if j2 != i2:
                                t2 = t2 * p_v % FR
                        excl = (excl + t2) % FR
                    rhs = (tau * excl - prod * e["m_x"]) % FR
                    chain(l0 * e["z_x"])
                    chain(l_last * e["z_x"])
                    chain((lhs - rhs) * l_active)
                else:
                    a_comp = 0
                    for e2 in lk.input_exprs:
                        a_comp = (a_comp * theta
                                  + eval_expr_at_x(e2, ci)) % FR
                    s_comp = 0
                    for e2 in lk.table_exprs:
                        s_comp = (s_comp * theta
                                  + eval_expr_at_x(e2, ci)) % FR
                    a_minus_s = (e["a_x"] - e["s_x"]) % FR
                    chain(l0 * (1 - e["z_x"]))
                    chain(l_last * (e["z_x"] * e["z_x"] - e["z_x"]))
                    chain(l_active * (
                        e["z_wx"] * ((e["a_x"] + beta) % FR) % FR
                        * ((e["s_x"] + gamma) % FR)
                        - e["z_x"] * ((a_comp + beta) % FR) % FR
                        * ((s_comp + gamma) % FR)))
                    chain(l0 * a_minus_s)
                    chain(l_active * a_minus_s
                          * ((e["a_x"] - e["a_prev"]) % FR))
            for si, sh in enumerate(cs.shuffles):
                e = shuffle_evals_vec[ci][si]
                a_comp = 0
                for e2 in sh.input_exprs:
                    a_comp = (a_comp * theta + eval_expr_at_x(e2, ci)) % FR
                s_comp = 0
                for e2 in sh.shuffle_exprs:
                    s_comp = (s_comp * theta + eval_expr_at_x(e2, ci)) % FR
                chain(l0 * (1 - e["z_x"]))
                chain(l_last * (e["z_x"] * e["z_x"] - e["z_x"]))
                chain(l_active * (
                    e["z_wx"] * ((s_comp + gamma) % FR)
                    - e["z_x"] * ((a_comp + gamma) % FR)))
        h_eval = (acc or 0) * pow((x_n - 1) % FR, FR - 2, FR) % FR

        # combined h commitment: sum x^(n i) h_i
        combined_h_cm = None
        for cm in reversed(h_cms):
            if combined_h_cm is not None:
                combined_h_cm = g1_add(
                    g1_mul(combined_h_cm, x_n),
                    cm) if cm is not None else g1_mul(combined_h_cm, x_n)
            else:
                combined_h_cm = cm

        # --- verifier openings, same order as the prover; keyed by the
        # LOGICAL polynomial (grouping is by oracle identity, base/ref.h
        # SHALLOW pointer equality — value-equal commitments stay distinct)
        openings = []  # (key, commitment, point, eval)

        def add(key, cm, pt, vv):
            openings.append((key, cm, pt, vv % FR))

        for ci in range(num_circuits):
            if query_instance:
                for qi, (cq, rot) in enumerate(cs.instance_queries):
                    pt = x * pow(omega, rot % n, FR) % FR
                    add(("instance", ci, cq),
                        kzg.commit(instance_polys_vec[ci][cq]), pt,
                        instance_evals_vec[ci][qi])
            for qi, (cq, rot) in enumerate(cs.advice_queries):
                pt = x * pow(omega, rot % n, FR) % FR
                add(("advice", ci, cq), advice_cms_vec[ci][cq], pt,
                    advice_evals_vec[ci][qi])
            pz = perm_evals_vec[ci]
            for j in range(len(chunks)):
                add(("perm_z", ci, j), perm_z_cms_vec[ci][j], x,
                    pz[j]["z_x"])
                add(("perm_z", ci, j), perm_z_cms_vec[ci][j], x_next,
                    pz[j]["z_wx"])
            for j in range(len(chunks) - 2, -1, -1):
                add(("perm_z", ci, j), perm_z_cms_vec[ci][j], x_last,
                    pz[j]["z_lastx"])
            for li in range(len(cs.lookups)):
                e = lookup_evals_vec[ci][li]
                if log_derivative:
                    add(("lookup_z", ci, li), lookup_z_cms_vec[ci][li], x,
                        e["z_x"])
                    add(("lookup_z", ci, li), lookup_z_cms_vec[ci][li],
                        x_next, e["z_wx"])
                    add(("lookup_m", ci, li), lookup_m_cms_vec[ci][li], x,
                        e["m_x"])
                else:
                    a_cm, s_cm = lookup_permuted_cms_vec[ci][li]
                    add(("lookup_z", ci, li), lookup_z_cms_vec[ci][li], x,
                        e["z_x"])
                    add(("lookup_a", ci, li), a_cm, x, e["a_x"])
                    add(("lookup_s", ci, li), s_cm, x, e["s_x"])
                    add(("lookup_a", ci, li), a_cm, x_prev, e["a_prev"])
                    add(("lookup_z", ci, li), lookup_z_cms_vec[ci][li],
                        x_next, e["z_wx"])
            for si in range(len(cs.shuffles)):
                e = shuffle_evals_vec[ci][si]
                add(("shuffle_z", ci, si), shuffle_z_cms_vec[ci][si], x,
                    e["z_x"])
                add(("shuffle_z", ci, si), shuffle_z_cms_vec[ci][si],
                    x_next, e["z_wx"])
        for qi, (cq, rot) in enumerate(cs.fixed_queries):
            pt = x * pow(omega, rot % n, FR) % FR
            add(("fixed", cq), pk.fixed_commitments[cq], pt, fixed_evals[qi])
        for j, cm in enumerate(pk.permutation_commitments):
            add(("sigma", j), cm, x, sigma_evals[j])
        add(("h",), combined_h_cm, x, h_eval)
        add(("random",), random_cm, x, random_eval)

        if pk.pcs == "gwc":
            return self._gwc_verify(openings, r)
        return self._shplonk_verify(openings, r)

    # --- PCS verifiers (pairing checks) ------------------------------------
    def _pairing_ok(self, q_cm, p_cm) -> bool:
        """e(Q, tau_2) * e(P, -G2) == 1"""
        pairing = self.pairing
        neg_g2 = (G2_GEN[0],
                  tuple((-c) % pairing.P for c in G2_GEN[1]))
        pairs = []
        if q_cm is not None:
            pairs.append((q_cm, self.tau_g2))
        if p_cm is not None:
            pairs.append((p_cm, neg_g2))
        return pairing.pairing_product_is_one(pairs)

    def _shplonk_verify(self, openings, r) -> bool:
        """reference: shplonk.h:244-350 DoVerifyOpeningProof."""
        y = r.squeeze_challenge()
        v = r.squeeze_challenge()
        h_cm = r.read_point()
        u = r.squeeze_challenge()
        q_cm = r.read_point()

        oracle_order, oracle_map = [], {}
        super_points = set()
        for key, cm, pt, vv in openings:
            super_points.add(pt)
            if key not in oracle_map:
                oracle_map[key] = {"cm": cm, "points": {}}
                oracle_order.append(key)
            oracle_map[key]["points"][pt] = vv
        set_order, set_map = [], {}
        for key in oracle_order:
            pts = tuple(sorted(oracle_map[key]["points"]))
            if pts not in set_map:
                set_map[pts] = []
                set_order.append(pts)
            set_map[pts].append(key)
        sorted_super = sorted(super_points)

        first_z, first_z_diff_inv = 0, 0
        normalized_l = []
        for gi, pts in enumerate(set_order):
            group = set_map[pts]
            diffs = [pt for pt in sorted_super if pt not in pts]
            z_diff = 1
            for d in diffs:
                z_diff = z_diff * (u - d) % FR
            if gi == 0:
                first_z = 1
                for pt in pts:
                    first_z = first_z * (u - pt) % FR
                first_z_diff_inv = pow(z_diff, FR - 2, FR)
                z_diff = 1
            else:
                z_diff = z_diff * first_z_diff_inv % FR
            l_cm = None
            for key in reversed(group):
                info = oracle_map[key]
                r_poly = _lagrange_interpolate(
                    list(pts), [info["points"][pt] for pt in pts])
                r_u = host_eval(r_poly, u)
                term = g1_add(info["cm"],
                              g1_mul((1, 2), (-r_u) % FR))
                l_cm = term if l_cm is None else g1_add(
                    g1_mul(l_cm, y), term)
            normalized_l.append(g1_mul(l_cm, z_diff)
                                if l_cm is not None else None)
        p_cm = None
        for l_cm in reversed(normalized_l):
            p_cm = g1_mul(p_cm, v) if p_cm is not None else None
            p_cm = g1_add(p_cm, l_cm)
        p_cm = g1_add(p_cm, g1_mul(h_cm, (-first_z) % FR))
        p_cm = g1_add(p_cm, g1_mul(q_cm, u))
        return self._pairing_ok(q_cm, p_cm)

    def _gwc_verify(self, openings, r) -> bool:
        """reference: gwc.h:126-210 DoVerifyOpeningProof: fold per-point
        W's with u: e(sum u^i W_i, tau_2) == e(sum u^i (z_i W_i + F_i), -G2)
        with F_i = sum v^j (C_ij - y_ij G)."""
        v = r.squeeze_challenge()
        point_order, groups = [], {}
        for _key, cm, pt, vv in openings:
            if pt not in groups:
                groups[pt] = []
                point_order.append(pt)
            groups[pt].append((cm, vv))
        w_cms = [r.read_point() for _ in point_order]
        u = r.squeeze_challenge()
        lhs, rhs = None, None
        for i in range(len(point_order) - 1, -1, -1):
            pt = point_order[i]
            f_cm, acc_eval = None, 0
            for j in range(len(groups[pt]) - 1, -1, -1):
                cm, vv = groups[pt][j]
                f_cm = g1_mul(f_cm, v) if f_cm is not None else None
                f_cm = g1_add(f_cm, cm)
                acc_eval = (acc_eval * v + vv) % FR
            term = g1_add(g1_add(g1_mul(w_cms[i], pt),
                                 f_cm),
                          g1_mul((1, 2), (-acc_eval) % FR))
            lhs = g1_mul(lhs, u) if lhs is not None else None
            lhs = g1_add(lhs, w_cms[i])
            rhs = g1_mul(rhs, u) if rhs is not None else None
            rhs = g1_add(rhs, term)
        return self._pairing_ok(lhs, rhs)


# --- key serialization (reference: base/buffer/copyable.h — every key is
# buffer-serializable; JSON here, ints are exact) ---------------------------


def _expr_to_json(e):
    if isinstance(e, ex.Constant):
        return ["const", e.value]
    if isinstance(e, ex.Fixed):
        return ["fixed", e.column, e.rotation]
    if isinstance(e, ex.Advice):
        return ["advice", e.column, e.rotation]
    if isinstance(e, ex.Instance):
        return ["instance", e.column, e.rotation]
    if isinstance(e, ex.Challenge):
        return ["challenge", e.index, e.phase]
    if isinstance(e, ex.Selector):
        return ["selector", e.index, e.is_simple]
    if isinstance(e, ex.Negated):
        return ["neg", _expr_to_json(e.expr)]
    if isinstance(e, ex.Sum):
        return ["sum", _expr_to_json(e.left), _expr_to_json(e.right)]
    if isinstance(e, ex.Product):
        return ["prod", _expr_to_json(e.left), _expr_to_json(e.right)]
    if isinstance(e, ex.Scaled):
        return ["scaled", _expr_to_json(e.expr), e.scale]
    raise TypeError(e)


def _expr_from_json(j):
    tag = j[0]
    if tag == "const":
        return ex.Constant(j[1])
    if tag == "fixed":
        return ex.Fixed(j[1], j[2])
    if tag == "advice":
        return ex.Advice(j[1], j[2])
    if tag == "instance":
        return ex.Instance(j[1], j[2])
    if tag == "challenge":
        return ex.Challenge(j[1], j[2])
    if tag == "selector":
        return ex.Selector(j[1], j[2])
    if tag == "neg":
        return ex.Negated(_expr_from_json(j[1]))
    if tag == "sum":
        return ex.Sum(_expr_from_json(j[1]), _expr_from_json(j[2]))
    if tag == "prod":
        return ex.Product(_expr_from_json(j[1]), _expr_from_json(j[2]))
    if tag == "scaled":
        return ex.Scaled(_expr_from_json(j[1]), j[2])
    raise ValueError(tag)


def save_proving_key(pk: Halo2ProvingKey, path: str) -> None:
    """JSON-serialize everything needed to prove and verify (the SRS is
    regenerated from tau; commitments/polys are exact ints)."""
    import json

    from tachyon_tpu_torch.zk.plonk.constraint_system import (
        LookupArgument,
        ShuffleArgument,
        Gate,
    )

    cs = pk.cs
    doc = {
        "k": pk.k, "extended_k": pk.extended_k, "omega": pk.omega,
        "tau": pk.kzg.tau, "vendor": pk.vendor, "pcs": pk.pcs,
        "usable_rows": pk.usable_rows,
        "cs": {
            "num_fixed": cs.num_fixed, "num_advice": cs.num_advice,
            "num_instance": cs.num_instance,
            "num_selectors": cs.num_selectors,
            "lookup_type": cs.lookup_type,
            "blinding_factors": cs.blinding_factors,
            "minimum_degree": cs.minimum_degree,
            "advice_column_phases": cs.advice_column_phases,
            "challenge_phases": cs.challenge_phases,
            "constants": [list(c) for c in cs.constants],
            "selectors": cs.selectors,
            "selector_map": [list(c) if c else None
                             for c in cs.selector_map],
            "permutation_columns": [list(c) for c in
                                    cs.permutation_columns],
            "advice_queries": cs.advice_queries,
            "fixed_queries": cs.fixed_queries,
            "instance_queries": cs.instance_queries,
            "gates": [[_expr_to_json(p) for p in g.polys]
                      for g in cs.gates],
            "lookups": [{
                "name": lk.name,
                "inputs_list": [[_expr_to_json(e) for e in inputs]
                                for inputs in lk.inputs_list],
                "tables": [_expr_to_json(e) for e in lk.table_exprs],
            } for lk in cs.lookups],
            "shuffles": [{
                "name": sh.name,
                "inputs": [_expr_to_json(e) for e in sh.input_exprs],
                "shuffles": [_expr_to_json(e) for e in sh.shuffle_exprs],
            } for sh in cs.shuffles],
        },
        "fixed_columns": pk.fixed_columns,
        "permutations": pk.permutations,
        "l_first": pk.l_first, "l_last": pk.l_last,
        "l_active_row": pk.l_active_row,
        "fixed_commitments": [list(c) if c else None
                              for c in pk.fixed_commitments],
        "permutation_commitments": [list(c) if c else None
                                    for c in pk.permutation_commitments],
        "deltas": pk.deltas,
        "pinned_vk": pk.pinned_vk,
        "transcript_repr": pk.transcript_repr,
    }
    with open(path, "w") as f:
        json.dump(doc, f)


def load_proving_key(path: str, device=torch.device("cuda")) -> Halo2ProvingKey:
    """A key from ``save_proving_key``'s JSON (the JAX package's too); the
    fixed and permutation polynomials are recomputed by the IFFT on
    ``device``, the card unless the caller passes another."""
    import json

    from tachyon_tpu_torch.zk.plonk.constraint_system import (
        LookupArgument,
        ShuffleArgument,
        Gate,
    )

    with open(path) as f:
        doc = json.load(f)
    c = doc["cs"]
    cs = ConstraintSystem()
    cs.num_fixed = c["num_fixed"]
    cs.num_advice = c["num_advice"]
    cs.num_instance = c["num_instance"]
    cs.num_selectors = c["num_selectors"]
    cs.lookup_type = c["lookup_type"]
    cs.blinding_factors = c["blinding_factors"]
    cs.minimum_degree = c["minimum_degree"]
    cs.advice_column_phases = c["advice_column_phases"]
    cs.challenge_phases = c["challenge_phases"]
    cs.constants = [ColumnRef(*x) for x in c["constants"]]
    cs.selectors = c["selectors"]
    cs.selector_map = [ColumnRef(*x) if x else None
                       for x in c["selector_map"]]
    cs.permutation_columns = [ColumnRef(*x) for x in
                              c["permutation_columns"]]
    cs.advice_queries = [tuple(q) for q in c["advice_queries"]]
    cs.fixed_queries = [tuple(q) for q in c["fixed_queries"]]
    cs.instance_queries = [tuple(q) for q in c["instance_queries"]]
    cs.gates = [Gate(f"gate{i}", [_expr_from_json(p) for p in polys])
                for i, polys in enumerate(c["gates"])]
    cs.lookups = [
        LookupArgument(
            lk["name"],
            [_expr_from_json(e) for e in lk["inputs_list"][0]],
            [_expr_from_json(e) for e in lk["tables"]],
            inputs_list=[[_expr_from_json(e) for e in inputs]
                         for inputs in lk["inputs_list"]],
        )
        for lk in c["lookups"]
    ]
    cs.shuffles = [
        ShuffleArgument(sh["name"],
                        [_expr_from_json(e) for e in sh["inputs"]],
                        [_expr_from_json(e) for e in sh["shuffles"]])
        for sh in c["shuffles"]
    ]
    n = 1 << doc["k"]
    from tachyon_tpu_torch.zk.plonk.halo2_device import device_ifft_fn

    ifft_fn = device_ifft_fn(n, doc["omega"], device)
    return Halo2ProvingKey(
        cs=cs, k=doc["k"], n=n, extended_k=doc["extended_k"],
        omega=doc["omega"], kzg=HostKZG(n, doc["tau"]),
        assembly_fixed=[], selectors=[], cycle_store=None,
        usable_rows=doc["usable_rows"],
        fixed_columns=doc["fixed_columns"],
        fixed_polys=[ifft_fn(col) for col in doc["fixed_columns"]],
        permutations=doc["permutations"],
        permutation_polys=[ifft_fn(col) for col in doc["permutations"]],
        l_first=doc["l_first"], l_last=doc["l_last"],
        l_active_row=doc["l_active_row"],
        fixed_commitments=[tuple(x) if x else None
                           for x in doc["fixed_commitments"]],
        permutation_commitments=[tuple(x) if x else None
                                 for x in doc["permutation_commitments"]],
        deltas=doc["deltas"], pinned_vk=doc["pinned_vk"],
        transcript_repr=doc["transcript_repr"],
        vendor=doc["vendor"], pcs=doc["pcs"],
    )
