"""Goldilocks in the port (W = 2) against the JAX package on CPU.

Inputs are made with numpy from fixed seeds and go through both packages:
K1's plain twin at W = 2 (``cuda_mont.mul_plain``, the CPU path of
``mul``) against the JAX ``mont.mul`` (its jnp limb program on a CPU) on
random and edge operands and a broadcast operand; the wrapper's in-place
broadcast read, replayed on the CPU by its index rule; ``goldilocks2``
against the JAX ``extensions.goldilocks2()``; ``PrimeField.random`` and
``root_of_unity``; Poseidon2 ``goldilocks_w8``; and the radix-2 domain and
``coset_lde_batch`` against ``tests/fixtures/torch_goldilocks_jax.json``,
recorded from the JAX package by ``scripts/make_torch_goldilocks_fixture.py``
(its NTTs run op by op and compile each new shape, about half a minute a
case; the slow test recomputes them).  Every comparison is word for word: both packages
return canonical Montgomery residues with the same R = 2^64, so the
tolerance is zero.  The kernel itself runs only on the card
(``chip_smoke.py`` phase 11 holds it against the same twin there).
"""
import importlib.util
import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tachyon_tpu.crypto import poseidon2 as jposeidon2
from tachyon_tpu.fields import extensions as jextensions
from tachyon_tpu.fields import presets as jpresets
from tachyon_tpu.math.field import PrimeField as JPrimeField
from tachyon_tpu.ops import mont as jmont
from tachyon_tpu_torch.crypto import poseidon2
from tachyon_tpu_torch.fields import extensions, limbs, presets
from tachyon_tpu_torch.math import ntt
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.ops import cuda_mont, mont

torch.set_num_threads(1)
CPU = torch.device("cpu")
GL = presets.GOLDILOCKS
P = GL.p
# 0, 1, mont(1), 2^32 - 1, 2^32, 2^63 - 1, 2^63, 2^63 + 2^32, p - 2^32, p - 2, p - 1:
# values above 2^63 are negative as int64, and (p - 1)^2 and (p - 2)(p - 1) make
# t + m p carry into bit 128 of the 64-bit Montgomery round
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "make_torch_goldilocks_fixture.py"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_goldilocks_jax.json"
EDGES = [0, 1, GL.R_mod_p, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
         (1 << 63) + (1 << 32), P - (1 << 32), P - 2, P - 1]


def fixture_script():
    """scripts/make_torch_goldilocks_fixture.py: the seeded inputs the
    fixture was recorded on, and ``record``."""
    spec = importlib.util.spec_from_file_location("make_torch_goldilocks_fixture", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rand_ints(rng, n):
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def both(xs, shape=None):
    """Python ints -> (JAX Montgomery limbs, port Montgomery words)."""
    j = jpresets.GOLDILOCKS.encode(np.array(xs, dtype=object))
    t = limbs.from_jax_limbs(j)
    if shape is not None:
        j, t = j.reshape((4,) + shape), t.reshape((2,) + shape)
    return jnp.asarray(j), t


def assert_same(jax_out, torch_out, axis=0):
    np.testing.assert_array_equal(limbs.to_jax_limbs(torch_out, axis), np.asarray(jax_out))


def test_k1_twin_vs_jax_random_and_edges():
    """Every pair of the edge operands (as Montgomery words), then random
    pairs: the twin equals the JAX mul and the host product."""
    rng = np.random.default_rng(130)
    xs = [x for x in EDGES for _ in EDGES] + rand_ints(rng, 200)
    ys = [y for _ in EDGES for y in EDGES] + rand_ints(rng, 200)
    (ja, ta), (jb, tb) = both(xs), both(ys)
    got = cuda_mont.mul_plain(GL, ta, tb)
    assert_same(jmont.mul(jpresets.GOLDILOCKS, ja, jb), got)
    assert torch.equal(mont.mul(GL, ta, tb), got)  # mul on CPU tensors is the twin
    assert [int(v) for v in limbs.decode(GL, got)] == [x * y % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("b_shape", [(8, 1), (1, 4), (8, 4)])
def test_k1_twin_broadcast_vs_jax(b_shape):
    """An operand broadcast as the NTT's twiddles (one per row) or a
    column weight is (one per column): the twin equals the JAX mul on the
    same broadcast."""
    rng = np.random.default_rng(131)
    ja, ta = both(rand_ints(rng, 32), (8, 4))
    jb, tb = both(rand_ints(rng, int(np.prod(b_shape))), b_shape)
    assert_same(jmont.mul(jpresets.GOLDILOCKS, ja, jb), cuda_mont.mul_plain(GL, ta, tb))


@pytest.mark.parametrize("a_shape, b_shape", [
    ((2, 16, 4, 8), (2, 1, 4, 1)),   # a stage's twiddles over (groups, m/2, columns)
    ((2, 8, 16), (2, 8, 1)),         # a constant per Poseidon2 lane
    ((2, 8, 16), (2, 1, 16)),        # a weight per column
    ((2, 8, 16), (2, 8, 16)),        # no broadcast
    ((2, 8, 16), (2, 1, 1)),         # one constant
    ((2, 1, 16), (2, 8, 16)),        # a broadcasts: the operands swap
])
def test_broadcast_read_in_place(a_shape, b_shape):
    """The W = 2 wrapper's operands: b is kept at its own size when its axes
    are one run of the output's, and the kernel's read of b at
    (k / inner) % period, word i at i * period, replayed on the CPU gives
    the twin's product of the expanded operands."""
    rng = np.random.default_rng(132)
    a = limbs.from_ints(rand_ints(rng, int(np.prod(a_shape[1:]))), 2).reshape(a_shape)
    b = limbs.from_ints(rand_ints(rng, int(np.prod(b_shape[1:]))), 2).reshape(b_shape)
    sa, sb, (inner, period) = cuda_mont._narrow_operands(a, b)
    n = sa[0].numel()
    assert sa.is_contiguous() and sb.is_contiguous() and sb.numel() == 2 * period
    k = torch.arange(n)
    gathered = sb.reshape(2, period)[:, (k // inner) % period]
    got = cuda_mont.mul_plain(GL, sa.reshape(2, n), gathered).reshape(sa.shape)
    assert torch.equal(got, cuda_mont.mul_plain(GL, a, b))
    if a.shape != b.shape and b.shape != sa.shape:
        assert period < n  # read in place, not expanded


def test_kernel_form_and_point_kernels_refuse_w2():
    """K1 takes W = 2 under its own tag; no point or sweep kernel does."""
    assert 2 in cuda_mont.SUPPORTED_W and 2 not in cuda_mont.POINT_W
    assert cuda_mont.kernel_form(GL) == cuda_mont.Form(2, False)
    assert cuda_mont.check_cuda(GL, any_width=True).tag == "w2_full"
    with pytest.raises(ValueError, match="point kernels take W in"):
        cuda_mont.check_cuda(GL)
    t = limbs.from_ints([1, 2], 2)
    with pytest.raises(ValueError, match="one CUDA device"):
        cuda_mont.mul2(GL, t, t)  # a CPU tensor never reaches the launcher
    assert cuda_mont.mul2.launches == 0


def test_goldilocks2_vs_jax():
    """goldilocks2 (x^2 - 7): add, sub, mul, square, inv (0 -> 0) and the
    sum over a batch axis equal the JAX extension's."""
    jext, ext = jextensions.goldilocks2(), extensions.goldilocks2(CPU)
    rng = np.random.default_rng(133)
    n = 12
    cs = [rand_ints(rng, n), rand_ints(rng, n)]
    ds = [rand_ints(rng, n), rand_ints(rng, n)]
    cs[0][0] = cs[1][0] = 0
    cs[1][1] = 0
    cs[0][-1] = cs[1][-1] = P - 1
    ja, jb = jext.encode([np.array(c, dtype=object) for c in cs]), \
        jext.encode([np.array(d, dtype=object) for d in ds])
    ta, tb = ext.encode(cs), ext.encode(ds)
    assert_same(ja, ta, axis=1)
    for op in ("add", "sub", "mul"):
        assert_same(getattr(jext, op)(ja, jb), getattr(ext, op)(ta, tb), axis=1)
    assert_same(jext.square(ja), ext.square(ta), axis=1)
    inv = ext.inv(ta)
    assert_same(jext.inv(ja), inv, axis=1)
    one = ext.ones((n,))
    assert torch.equal(ext.mul(ta, inv)[:, :, 1:], one[:, :, 1:])
    assert torch.equal(inv[:, :, 0], ta[:, :, 0])  # inv(0) = 0
    got = [int(v) for v in np.concatenate([ext.decode(ext.sum(ta, -1))[i].reshape(-1)
                                           for i in range(2)])]
    assert got == [sum(c) % P for c in cs]


def test_random_and_root_of_unity_vs_jax():
    """random draws what the JAX package draws from the same generator;
    root_of_unity gives the same words and a primitive root."""
    jF, F = JPrimeField(jpresets.GOLDILOCKS), PrimeField(GL, CPU)
    for shape in ((), (5,), (2, 3)):
        assert_same(jF.random(shape, np.random.default_rng(134)),
                    F.random(shape, np.random.default_rng(134)))
    for order in (1, 2, 8, 1 << 20, 1 << 32):
        w = F.root_of_unity(order)
        assert_same(jF.root_of_unity(order), w)
        wi = int(F.decode(w))
        assert pow(wi, order, P) == 1 and (order == 1 or pow(wi, order // 2, P) != 1)
    assert F.two_adicity == jF.two_adicity == 32


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())["ntt"]


def ints(F, t):
    return [int(v) for v in F.decode(t).reshape(-1)]


@pytest.mark.parametrize("n", [8, 16])
def test_radix2_vs_jax(n, fx):
    """fft, ifft, coset_fft and coset_ifft over Goldilocks on an (n, 3)
    matrix equal the JAX package's (recorded in the fixture)."""
    F = PrimeField(GL, CPU)
    x = F.encode(np.array(fixture_script().ntt_input(n), dtype=object).reshape(n, 3))
    want = fx[str(n)]
    d = ntt.Radix2Domain(F, n)
    assert ints(F, d.twiddles(False)) == want["twiddles"]
    ev = d.fft(x)
    assert ints(F, ev) == want["fft"]
    assert ints(F, d.ifft(x)) == want["ifft"]
    assert torch.equal(d.ifft(ev), x)
    assert ints(F, d.coset_fft(x, 7)) == want["coset_fft"]
    assert ints(F, d.coset_ifft(x, 7)) == want["coset_ifft"]


@pytest.mark.parametrize("log_blowup", [1, 2, 3])
def test_coset_lde_batch_vs_jax(log_blowup, fx, monkeypatch):
    """coset_lde_batch of an (8, 3) matrix at shift 7 equals the JAX
    package's, and so does the same LDE run one column a chunk, and one
    column alone with no batch axis; every value is the column's
    interpolant at 7 w^i."""
    mod = fixture_script()
    F = PrimeField(GL, CPU)
    vals = np.array(mod.lde_input(log_blowup), dtype=object).reshape(mod.LDE_N, mod.LDE_COLS)
    dom = ntt.Radix2Domain(F, mod.LDE_N)
    got = ntt.coset_lde_batch(dom, F.encode(vals), log_blowup, 7)
    assert got.shape == (2, 8 << log_blowup, 3)
    assert ints(F, got) == fx[f"lde_{log_blowup}"]
    monkeypatch.setattr(ntt, "LDE_CHUNK_ELEMS", 8 << log_blowup)
    assert torch.equal(ntt.coset_lde_batch(dom, F.encode(vals), log_blowup, 7), got)
    assert torch.equal(ntt.coset_lde_batch(dom, F.encode(vals[:, 1]), log_blowup, 7),
                       got[:, :, 1])
    coeffs = [int(v) for v in F.decode(dom.ifft(F.encode(vals[:, 2])))]
    w = GL.root_of_unity(8 << log_blowup)
    assert [int(v) for v in F.decode(got[:, :, 2])] == [
        sum(c * pow(7 * pow(w, i, P), j, P) for j, c in enumerate(coeffs)) % P
        for i in range(8 << log_blowup)]


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed NTT part (minutes)."""
    assert fixture_script().record("ntt") == fx


def test_poseidon2_goldilocks_w8_vs_jax():
    """permute on 4 states equals the JAX permute and permute_host."""
    jh, h = jposeidon2.goldilocks_w8(), poseidon2.goldilocks_w8(CPU)
    assert h.ark_full_host == jh.ark_full_host and h.int_diag_host == jh.int_diag_host
    rng = np.random.default_rng(136)
    states = [rand_ints(rng, 8) for _ in range(4)]
    states[0] = [P - 1] * 8
    vals = np.array(states, dtype=object).T  # (8, 4)
    want = np.asarray(jh.permute(jnp.asarray(jh.F.encode(vals))))
    got = h.permute(h.F.encode(vals))
    np.testing.assert_array_equal(limbs.to_jax_limbs(got), want)
    assert [[int(v) for v in col] for col in h.F.decode(got).T] == \
        [h.permute_host(s) for s in states]


def test_goldilocks_entry_points_default_to_the_card(monkeypatch):
    """goldilocks_w8 and goldilocks2 default to CUDA; with no CUDA device a
    call left at its default raises instead of taking the CPU."""
    fns = (poseidon2.goldilocks_w8, extensions.goldilocks2)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == torch.device("cuda"), fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in fns + (lambda: PrimeField(GL),):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
