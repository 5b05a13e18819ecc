"""Native R1CS circuits for the Groth16 tests, fixture and smoke run.

Each function takes the R1CS class to fill (the port's by default; the JAX
package's has the same ``new_private``/``constrain`` surface) and the
scalar field's modulus ``r`` (BN254's by default; ``pairing_bls12_381.R``
for the bls12_381 family), and returns the circuit with a satisfying
witness mod r split into (public, private).
"""
from __future__ import annotations

from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.zk.groth16.r1cs import R1CS


def mul_circuit(r1cs_cls=R1CS, x: int = 3, y: int = 7, r: int = pairing.R):
    """x * y = z with z public, and the linear (x + y) * 1 = s that uses
    ONE: w = (1, z, x, y, s)."""
    r1cs = r1cs_cls(num_public=1)
    vx, vy = r1cs.new_private(), r1cs.new_private()
    r1cs.constrain({vx: 1}, {vy: 1}, {1: 1})
    vs = r1cs.new_private()
    r1cs.constrain({vx: 1, vy: 1}, {0: 1}, {vs: 1})
    return r1cs, [x * y % r], [x % r, y % r, (x + y) % r]


def square_chain(m: int, x0: int, r1cs_cls=R1CS, r: int = pairing.R):
    """m >= 4 constraints over the scalar field of modulus r: the chain
    x_{i+1} = x_i * x_i from x_0 for m - 2 squarings, whose last product is
    the public output z, and two linear constraints that use ONE,
    (x_0 + x_1) * 1 = s_0 and (z + 2 x_0) * 1 = s_1.  Variables: ONE, z,
    x_0 .. x_{m-3}, s_0, s_1 (m + 2 in all, m of them private)."""
    if m < 4:
        raise ValueError(f"a chain of {m} constraints is too short (at least 4)")
    r1cs = r1cs_cls(num_public=1)
    xs = [r1cs.new_private() for _ in range(m - 2)] + [1]  # x_{m-2} is z
    s0, s1 = r1cs.new_private(), r1cs.new_private()
    for i in range(m - 2):
        r1cs.constrain({xs[i]: 1}, {xs[i]: 1}, {xs[i + 1]: 1})
    r1cs.constrain({xs[0]: 1, xs[1]: 1}, {0: 1}, {s0: 1})
    r1cs.constrain({1: 1, xs[0]: 2}, {0: 1}, {s1: 1})
    vals = [x0 % r]
    for _ in range(m - 2):
        vals.append(vals[-1] * vals[-1] % r)
    z = vals[-1]
    return r1cs, [z], vals[:-1] + [(vals[0] + vals[1]) % r, (z + 2 * vals[0]) % r]


def bits_chain(m: int, x0: int, r1cs_cls=R1CS, r: int = pairing.R):
    """m >= 257 constraints with the long linear combinations of a circom
    bit decomposition: the bits b_i of x_0 (b_i * b_i = b_i, one constraint
    each, as many as r has bits), their sum (sum_i 2^i b_i) * 1 = x_0 (an A
    row of 254 terms), t = (b_0 + b_1 + b_2) * (b_3 + .. + b_7) (rows of 3
    and 5 terms), then square_chain's x_{i+1} = x_i * x_i for the other
    constraints, whose last product is the public output z.  Variables:
    ONE, z, b_0 .. b_253, t, x_0 .. x_{m-257} (m + 1 in all), at BN254's
    254-bit r (255 bits and one more constraint at BLS12-381's)."""
    nbits = r.bit_length()
    k = m - nbits - 2  # squarings
    if k < 1:
        raise ValueError(f"a bit chain of {m} constraints is too short (at least {nbits + 3})")
    r1cs = r1cs_cls(num_public=1)
    bs = [r1cs.new_private() for _ in range(nbits)]
    vt = r1cs.new_private()
    xs = [r1cs.new_private() for _ in range(k)] + [1]  # x_k is z
    for b in bs:
        r1cs.constrain({b: 1}, {b: 1}, {b: 1})
    r1cs.constrain({b: 1 << i for i, b in enumerate(bs)}, {0: 1}, {xs[0]: 1})
    r1cs.constrain({b: 1 for b in bs[:3]}, {b: 1 for b in bs[3:8]}, {vt: 1})
    for i in range(k):
        r1cs.constrain({xs[i]: 1}, {xs[i]: 1}, {xs[i + 1]: 1})
    bits = [(x0 % r) >> i & 1 for i in range(nbits)]
    vals = [x0 % r]
    for _ in range(k):
        vals.append(vals[-1] * vals[-1] % r)
    return r1cs, [vals[-1]], bits + [sum(bits[:3]) * sum(bits[3:8])] + vals[:-1]
