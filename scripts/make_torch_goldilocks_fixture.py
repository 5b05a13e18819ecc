#!/usr/bin/env python3
"""Record the JAX package's Goldilocks NTTs, mixed-radix domains and
sumcheck proofs as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_goldilocks_fixture.py \
        [--only ntt|mixed|sumcheck] [--out tests/fixtures/torch_goldilocks_jax.json]

Runs ``tachyon_tpu`` on inputs drawn from fixed numpy seeds (the functions
below, which the tests import) and writes canonical ints:

* ``ntt``: Goldilocks ``Radix2Domain`` fft, ifft, coset_fft and coset_ifft
  at shift 7 on (n, 3) matrices, n = 8 and 16, and ``coset_lde_batch`` of
  an (8, 3) matrix at log_blowup 1, 2 and 3;
* ``mixed``: ``MixedRadixDomain`` fft and ifft over bn254_fr and
  Goldilocks at n = 12, 18 and 24 (18 has no Goldilocks subgroup: recorded
  as refused) and ``DomainCache``'s domain types;
* ``sumcheck``: ``sumcheck.prove`` on three tables of 2^4 entries over
  BabyBear and over Goldilocks with a SHA-256 sampler, and the MLE's
  ``fix_first_variable`` and ``evaluate``.

The JAX package runs op by op here, and each new shape compiles: a few
minutes on a CPU, which is why the tests read the file.  Their slow tests
recompute a part with ``record(part)`` and require equality.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

FIXTURE = (Path(__file__).resolve().parent.parent / "tests" / "fixtures"
           / "torch_goldilocks_jax.json")
PARTS = ("ntt", "mixed", "sumcheck")
GOLDILOCKS_P = (1 << 64) - (1 << 32) + 1
SHIFT = 7  # Goldilocks' multiplicative generator, the coset shift
NTT_SIZES = (8, 16)
LDE_N, LDE_COLS, LDE_BLOWUPS = 8, 3, (1, 2, 3)
MIXED = (("bn254_fr", (12, 18, 24)), ("goldilocks", (12, 18, 24)))
SUMCHECK_FIELDS = ("baby_bear", "goldilocks")
SUMCHECK_K, SUMCHECK_D = 4, 3


def rand_ints(p: int, n: int, seed: int) -> list[int]:
    """n canonical ints from a seed, the first three 0, 1 and p - 1."""
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    xs[:3] = [0, 1, p - 1][:n]
    return xs


def ntt_input(n: int) -> list[int]:
    """An (n, 3) Goldilocks matrix, row-major."""
    return rand_ints(GOLDILOCKS_P, 3 * n, 135 + n)


def lde_input(log_blowup: int) -> list[int]:
    """An (LDE_N, LDE_COLS) Goldilocks matrix, row-major."""
    return rand_ints(GOLDILOCKS_P, LDE_N * LDE_COLS, 140 + log_blowup)


def mixed_input(p: int, n: int) -> list[int]:
    return rand_ints(p, n, 150 + n)


def sumcheck_tables(p: int) -> list[list[int]]:
    return [rand_ints(p, 1 << SUMCHECK_K, 160 + i) for i in range(SUMCHECK_D)]


def sha_sampler(p: int):
    """The toy Fiat-Shamir of tests/test_sumcheck_mle.py: SHA-256 of the
    round's evaluations, mod p."""
    def sample(evals):
        h = hashlib.sha256(repr([int(v) for v in evals]).encode()).digest()
        return int.from_bytes(h, "little") % p
    return sample


def record(part: str) -> dict:
    """The JAX package's outputs for one part (imports JAX)."""
    import jax.numpy as jnp

    from tachyon_tpu.crypto import sumcheck
    from tachyon_tpu.fields import presets
    from tachyon_tpu.math import mle, ntt
    from tachyon_tpu.math.field import PrimeField

    def ints(F, a):
        return [int(v) for v in np.asarray(F.decode(a)).reshape(-1)]

    if part == "ntt":
        F = PrimeField(presets.GOLDILOCKS)
        out = {}
        for n in NTT_SIZES:
            x = F.encode(np.array(ntt_input(n), dtype=object).reshape(n, 3))
            d = ntt.Radix2Domain(F, n)
            out[str(n)] = {"fft": ints(F, d.fft(x)), "ifft": ints(F, d.ifft(x)),
                           "coset_fft": ints(F, d.coset_fft(x, SHIFT)),
                           "coset_ifft": ints(F, d.coset_ifft(x, SHIFT)),
                           "twiddles": ints(F, d.twiddles(False))}
        for lb in LDE_BLOWUPS:
            x = F.encode(np.array(lde_input(lb), dtype=object).reshape(LDE_N, LDE_COLS))
            out[f"lde_{lb}"] = ints(F, ntt.coset_lde_batch(ntt.Radix2Domain(F, LDE_N), x, lb,
                                                           SHIFT))
        return out
    if part == "mixed":
        out = {}
        for name, sizes in MIXED:
            F = PrimeField(getattr(presets, name.upper()))
            cache = ntt.DomainCache(F)
            for n in sizes:
                try:
                    d = ntt.MixedRadixDomain(F, n)
                except AssertionError:
                    out[f"{name}_{n}"] = "refused"
                    continue
                x = F.encode(np.array(mixed_input(F.p, n), dtype=object))
                out[f"{name}_{n}"] = {"omega": d.omega_int, "fft": ints(F, d.fft(x)),
                                      "ifft": ints(F, d.ifft(x)),
                                      "cache": type(cache.get(n)).__name__}
            out[f"{name}_cache_16"] = type(cache.get(16)).__name__
        return out
    if part == "sumcheck":
        out = {}
        for name in SUMCHECK_FIELDS:
            F = PrimeField(getattr(presets, name.upper()))
            tabs = [F.encode(np.array(t, dtype=object)) for t in sumcheck_tables(F.p)]
            proof, chals = sumcheck.prove(F, tabs, sha_sampler(F.p))
            pts = [F.full((), c) for c in chals]
            out[name] = {"round_evals": [list(map(int, r)) for r in proof.round_evals],
                         "claimed_sum": int(proof.claimed_sum), "challenges": chals,
                         "final_evals": [int(F.decode(mle.evaluate(F, t, pts))) for t in tabs],
                         "fix_first": ints(F, mle.fix_first_variable(
                             F, tabs[0], jnp.asarray(F.full((), chals[0]))))}
        return out
    raise ValueError(part)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=FIXTURE)
    ap.add_argument("--only", choices=PARTS)
    args = ap.parse_args()
    data = json.loads(args.out.read_text()) if args.only and args.out.exists() else {}
    for part in ([args.only] if args.only else PARTS):
        data[part] = record(part)
        print(f"recorded {part}", flush=True)
    args.out.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
