#!/usr/bin/env python3
"""Record the JAX package's BN254 Fq6 and Fq12 arithmetic as a test fixture.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_fq12_fixture.py \
        [--out tests/fixtures/torch_fq12_jax.json]

For each of ``tachyon_tpu.math.curves.bn254_fq6()`` and ``bn254_fq12()``:
``mul``, ``square``, ``inv`` and ``pow_const`` by p (the Frobenius map) and
by a short exponent, each under ``jax.jit``, on N elements drawn from a
fixed numpy seed (``tower_inputs``: lane 0 zero, lane 1 an embedded Fq
element, lane 2 every coefficient p - 1, the rest random).  The outputs are
stored as the JAX uint32 16-bit limb arrays (little-endian bytes, hex) with
their shapes.  Eagerly one JAX Fq12 multiply takes about 100 s on a CPU
(every op of its limb program compiles on its own); jitted, the XLA:CPU
compiles take about 50 minutes in all (about 10 of them for Fq6).

``tests/test_torch_fq12.py`` holds ``tachyon_tpu_torch``'s
``curves.bn254_fq6/fq12("cpu")`` against the file word for word; its slow
test recomputes it with ``record()`` and requires equality.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 6
SEED = 71
SHORT_EXP = 0b1011011001  # a zero run, a one run, both ends set
P = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47  # BN254 Fq
FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "torch_fq12_jax.json"
SHAPES = {"fq6": (3, 2), "fq12": (2, 3, 2)}  # an element's coefficient axes over Fq


def tower_inputs(name: str, seed: int, n: int = N) -> tuple:
    """Two elements (a, b) as nested lists of n-int arrays over Fq, as
    ``ExtField.encode`` takes them: lane 0 zero, lane 1 an embedded Fq
    element (every coefficient but the first zero), lane 2 every
    coefficient p - 1, the rest random below p."""
    rng = np.random.default_rng(seed)
    shape = SHAPES[name]
    count = int(np.prod(shape))

    def element():
        flat = [[int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]
                for _ in range(count)]
        for j, coeff in enumerate(flat):
            coeff[0] = 0
            if j:
                coeff[1] = 0
            coeff[2] = P - 1
        arr = np.empty((count, n), dtype=object)
        arr[:] = flat
        return nest(arr.reshape(shape + (n,)))

    return element(), element()


def nest(arr: np.ndarray):
    """An object array (*coeff_axes, n) -> nested lists of (n,) arrays."""
    return arr if arr.ndim == 1 else [nest(a) for a in arr]


def hexed(a) -> dict:
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return {"shape": list(a.shape), "hex": a.astype("<u4").tobytes().hex()}


def unhexed(d: dict) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(d["hex"]), dtype="<u4").reshape(d["shape"])


def record() -> dict:
    """The JAX package's outputs on the inputs above (imports JAX)."""
    import jax

    from tachyon_tpu.math import curves

    out = {"n": N, "seed": SEED, "short_exp": SHORT_EXP}
    for i, (name, F) in enumerate((("fq6", curves.bn254_fq6()), ("fq12", curves.bn254_fq12()))):
        a, b = (F.encode(x) for x in tower_inputs(name, SEED + i))
        out[name] = {
            "mul": hexed(jax.jit(F.mul)(a, b)),
            "square": hexed(jax.jit(F.square)(a)),
            "inv": hexed(jax.jit(F.inv)(a)),
            "pow_p": hexed(jax.jit(lambda x: F.pow_const(x, P))(a)),
            "pow_short": hexed(jax.jit(lambda x: F.pow_const(x, SHORT_EXP))(b)),
        }
        print(f"recorded {name}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(FIXTURE))
    out = Path(ap.parse_args().out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record(), indent=1) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
