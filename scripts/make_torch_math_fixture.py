#!/usr/bin/env python3
"""Record the JAX package's sparse polynomials, M31 circle group and binary
Merkle tree as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_math_fixture.py \
        [--out tests/fixtures/torch_math_jax.json] [--only sparse|circle|merkle]

Each group runs ``tachyon_tpu``'s module on inputs drawn from a fixed numpy
seed (the functions below, which the tests call too) and stores what it
returns: words as the JAX uint32 16-bit limb arrays (hex, with shapes),
sparse terms as ints.  The JAX ops run under ``jax.jit`` where they can; on
a CPU a circle ``scalar_mul`` still compiles for about 25 s a scalar and a
BabyBear Poseidon2 compress for 10-25 s a tree level, so the tests read
this file (``tests/test_torch_sparse.py``, ``test_torch_circle.py``,
``test_torch_binary_merkle.py``); each file's slow test recomputes its
group with ``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from scripts.make_torch_fq12_fixture import hexed, unhexed  # noqa: E402,F401

FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_math_jax.json"
GROUPS = ("sparse", "circle", "merkle")
BABY_BEAR_P = (1 << 31) - (1 << 27) + 1
GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1
M31_P = (1 << 31) - 1

SPARSE_SEED = 81
SPARSE_POINTS = 4
LC_VARS = 5
CIRCLE_SEED = 82
CIRCLE_BATCH = 8
CIRCLE_KS = (0, 1, 1 << 30, (1 << 31) - 1, 1868121971)  # edges and a 31-bit value
MERKLE_SEED = 83
MERKLE_LEAVES = 16
MERKLE_DIGEST = 8
MERKLE_OPEN = 5


def sparse_inputs() -> dict:
    """Host ints for every sparse case: a univariate of 12 terms (degrees
    0, 1, 2^40 + 3 and random ones; a coefficient p - 1), its evaluation
    points, two univariates with shared degrees (one cancelling) for +, -
    and *, a multivariate, and a LinearCombination's tables, terms and
    point over Goldilocks."""
    rng = np.random.default_rng(SPARSE_SEED)
    p = BABY_BEAR_P
    degs = sorted({0, 1, (1 << 40) + 3, *(int(d) for d in rng.integers(2, 1 << 20, 9))})
    uni = {d: int(rng.integers(1, p)) for d in degs}
    uni[degs[3]] = p - 1
    points = [int(v) for v in rng.integers(0, p, SPARSE_POINTS)]
    ta = {0: 3, 2: 7, 9: 11, 40: int(rng.integers(1, p))}
    tb = {2: p - 7, 5: 1, 9: 4, 33: int(rng.integers(1, p))}
    multi = [(3, {}), (5, {0: 2, 2: 1}), (7, {1: 3}), (int(rng.integers(1, p)), {0: 1, 1: 1, 2: 9})]
    multi_point = [int(v) for v in rng.integers(1, p, 3)]
    q = GOLDILOCKS_P
    n = 1 << LC_VARS
    tables = [[int.from_bytes(rng.bytes(12), "little") % q for _ in range(n)] for _ in range(3)]
    lc_terms = [(2, [0, 1]), (9, [1]), (q - 5, [0, 1, 2]), (11, [])]
    lc_point = [int.from_bytes(rng.bytes(12), "little") % q for _ in range(LC_VARS)]
    return {"uni": uni, "points": points, "ta": ta, "tb": tb, "multi": multi,
            "multi_point": multi_point, "tables": tables, "lc_terms": lc_terms,
            "lc_point": lc_point}


def circle_inputs() -> list:
    """CIRCLE_BATCH points of the M31 circle as host ints: the generator,
    the identity, the order-8 subgroup's generator, and multiples of the
    generator by random 31-bit scalars."""
    rng = np.random.default_rng(CIRCLE_SEED)
    p = M31_P
    g = (2, 1268011823)

    def add(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)

    def mul(k):
        acc, cur = (1, 0), g
        while k:
            if k & 1:
                acc = add(acc, cur)
            cur = add(cur, cur)
            k >>= 1
        return acc

    sub8 = g
    for _ in range(31 - 3):
        sub8 = add(sub8, sub8)
    pts = [g, (1, 0), sub8]
    pts += [mul(int(k)) for k in rng.integers(1, 1 << 31, CIRCLE_BATCH - len(pts))]
    return pts


def merkle_leaves() -> np.ndarray:
    """MERKLE_LEAVES digests of MERKLE_DIGEST BabyBear values: (DIGEST, n)."""
    rng = np.random.default_rng(MERKLE_SEED)
    return rng.integers(0, BABY_BEAR_P, size=(MERKLE_DIGEST, MERKLE_LEAVES)).astype(object)


def _ints(a) -> list:
    return [int(v) for v in np.asarray(a, dtype=object).ravel()]


def record_sparse() -> dict:
    import jax

    from tachyon_tpu.fields import presets
    from tachyon_tpu.math.field import PrimeField
    from tachyon_tpu.math.sparse import LinearCombination, SparseMultivariate, SparseUnivariate

    F = PrimeField(presets.BABY_BEAR)
    x = sparse_inputs()

    def enc1(v):
        return F.encode(np.array([v % F.p], dtype=object))[:, 0]

    uni = SparseUnivariate.from_dict(F, x["uni"])
    ev = jax.jit(uni.evaluate)
    a = SparseUnivariate.from_dict(F, x["ta"])
    b = SparseUnivariate.from_dict(F, x["tb"])
    out = {"uni_coeffs": hexed(uni.coeffs),
           "uni_eval": [hexed(ev(enc1(z))) for z in x["points"]],
           "dense": hexed(SparseUnivariate.from_dict(F, x["ta"]).to_dense(48))}
    for name, r in (("add", a + b), ("sub", a - b), ("mul", a * b)):
        out[name] = {"degrees": r.degrees, "coeffs": hexed(r.coeffs),
                     "dict": {str(d): c for d, c in r.to_dict().items()}}
    m = SparseMultivariate.from_terms(F, x["multi"])
    out["multi_eval"] = hexed(jax.jit(m.evaluate)([enc1(v) for v in x["multi_point"]]))
    G = PrimeField(presets.GOLDILOCKS)
    lc = LinearCombination(G, LC_VARS)
    for t in x["tables"]:
        lc.add_mle(G.encode(np.array(t, dtype=object)))
    for c, idx in x["lc_terms"]:
        lc.add_term(c, idx)
    pt = [G.encode(np.array([v], dtype=object))[:, 0] for v in x["lc_point"]]
    out["lc_combine"] = hexed(jax.jit(lc.combine)())
    out["lc_evaluate"] = hexed(jax.jit(lc.evaluate)(pt))
    return out


def record_circle() -> dict:
    import jax

    from tachyon_tpu.math.circle import m31_circle

    C = m31_circle()
    pts = circle_inputs()
    a = C.encode(pts)
    b = C.encode(pts[::-1])

    def words(pt):
        return {"x": hexed(pt.x), "y": hexed(pt.y)}

    out = {"add": words(jax.jit(C.add)(a, b)), "double": words(jax.jit(C.double)(a)),
           "neg": words(C.neg(a)), "antipode": words(C.antipode(a)),
           "on_circle": _ints(np.asarray(C.is_on_circle(a)).astype(int)),
           "subgroup_22": list(C.subgroup_generator(22)),
           "scalar_mul": {}}
    for k in CIRCLE_KS:
        # k = 0 gives the identity from the batch's host shape: not traceable
        run = (lambda q, k=k: C.scalar_mul(q, k)) if k == 0 else \
            jax.jit(lambda q, k=k: C.scalar_mul(q, k))
        out["scalar_mul"][str(k)] = words(run(a))
        print(f"circle scalar_mul {k}", flush=True)
    return out


def record_merkle() -> dict:
    from tachyon_tpu.crypto import binary_merkle, poseidon2

    h = poseidon2.baby_bear_p3_w16()
    F = h.F
    leaves = F.encode(merkle_leaves())  # (L, DIGEST, n)
    tree = binary_merkle.build(h.compress, leaves)
    proof = binary_merkle.open_at(tree, MERKLE_OPEN)
    root = tree.root()
    ok = binary_merkle.verify(h.compress, root, MERKLE_OPEN, leaves[:, :, MERKLE_OPEN], proof)
    bad = leaves[:, :, MERKLE_OPEN].at[:, 0].set(F.encode(np.array([12345], dtype=object))[:, 0])
    refused = not binary_merkle.verify(h.compress, root, MERKLE_OPEN, bad, proof)
    return {"layers": [hexed(layer) for layer in tree.layers],
            "siblings": [hexed(s) for s in proof.siblings], "verify": ok,
            "tampered_refused": refused}


def record(only=GROUPS) -> dict:
    fns = {"sparse": record_sparse, "circle": record_circle, "merkle": record_merkle}
    out = {}
    for name in only:
        out[name] = fns[name]()
        print(f"recorded {name}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(FIXTURE))
    ap.add_argument("--only", choices=GROUPS)
    args = ap.parse_args()
    out = Path(args.out)
    data = json.loads(out.read_text()) if args.only and out.exists() else {}
    data.update(record((args.only,) if args.only else GROUPS))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
