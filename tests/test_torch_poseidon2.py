"""The port's one-word field, baby_bear4 and Poseidon2 against the JAX package on CPU.

Inputs are made with numpy from fixed seeds.  The one-word ops (W = 1:
BabyBear, KoalaBear, Mersenne-31) are held against the JAX ``mont`` ops,
the quartic extension's products and inverses against the JAX package's
exact ``HostExt`` (and KoalaBear's), and ``permute`` on an 8-state batch against JAX
``permute`` and ``permute_host`` for three presets (one JAX permute, about
ten seconds of XLA compile, a preset); ``hash_no_pad`` and ``compress``
against sponges and truncations of ``permute_host``.  Every comparison is
word for word: both packages return canonical Montgomery residues with the
same R, so the tolerance is zero.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tachyon_tpu.crypto import poseidon2 as jposeidon2
from tachyon_tpu.fields import presets as jpresets
from tachyon_tpu.math.extfield import HostExt as JHostExt
from tachyon_tpu.fields import extensions as jextensions
from tachyon_tpu.ops import mont as jmont
from tachyon_tpu_torch.crypto import poseidon2
from tachyon_tpu_torch.fields import extensions, limbs, presets
from tachyon_tpu_torch.math.extfield import HostExt
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.ops import cuda_mont

torch.set_num_threads(1)
CPU = torch.device("cpu")
ONE_WORD = [presets.BABY_BEAR, presets.KOALA_BEAR, presets.MERSENNE31]


def rand_ints(p, n, rng):
    xs = [int(v) for v in rng.integers(0, p, n)]
    xs[:3] = [0, 1, p - 1]
    return xs


@pytest.mark.parametrize("f", ONE_WORD, ids=lambda f: f.name)
def test_one_word_ops_vs_jax(f):
    """add, sub, neg, double, mul and the axis sum at W = 1 (the int32
    forms and the int64 sum) equal the JAX ops; the device encode equals
    the host one."""
    rng = np.random.default_rng(3)
    jf = getattr(jpresets, f.name.upper())
    xs, ys = rand_ints(f.p, 40, rng), rand_ints(f.p, 40, rng)[::-1]
    ja, jb = (jnp.asarray(jf.encode(np.array(v, dtype=object))) for v in (xs, ys))
    F = PrimeField(f, CPU)
    a, b = F.encode(xs), F.encode(ys)
    assert F.W == 1 and torch.equal(F.encode_canonical(torch.tensor(xs)), a)
    assert F.to_canonical(a).tolist() == xs

    def same(j, t):
        np.testing.assert_array_equal(limbs.to_jax_limbs(t), np.asarray(j))

    same(jmont.add(jf, ja, jb), F.add(a, b))
    same(jmont.sub(jf, ja, jb), F.sub(a, b))
    same(jmont.neg(jf, ja), F.neg(a))
    same(jmont.add(jf, ja, ja), F.double(a))
    same(jmont._mul_jnp(jf, ja, jb), F.mul(a, b))
    assert int(F.decode(F.sum(a, -1))) == sum(xs) % f.p
    # the same shape the broadcasting multiply sees: a constant per lane
    lane = F.encode(ys[:4]).reshape(1, 4, 1)
    got = F.mul(a.reshape(1, 4, 10), lane)
    want = cuda_mont.mul_plain(f, a.reshape(1, 4, 10), lane.expand(1, 4, 10))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["baby_bear4", "koala_bear4"])
def test_quartic_vs_host(name):
    """The quartic extensions' products, the quadratic-subfield inverse
    (0 -> 0) and the port's HostExt equal the JAX package's HostExt."""
    rng = np.random.default_rng(4)
    ext = getattr(extensions, name)(CPU)
    jhx, hx = JHostExt(getattr(jextensions, name)()), HostExt(ext)
    p = ext.p
    xs = [[int(v) for v in rng.integers(0, p, 4)] for _ in range(12)]
    xs[0] = [0, 0, 0, 0]
    xs[1] = [5, 0, 0, 0]
    xs[2] = [0, 0, p - 1, 0]
    ys = xs[::-1]
    a = ext.encode([[x[d] for x in xs] for d in range(4)])
    b = ext.encode([[y[d] for y in ys] for d in range(4)])

    def host(t):
        return [[int(v) for v in col] for col in np.stack(ext.decode(t), -1)]

    assert host(ext.mul(a, b)) == [jhx.mul(x, y) for x, y in zip(xs, ys)]
    assert host(ext.inv(a)) == [jhx.inv(x) if any(x) else [0] * 4 for x in xs]
    assert [hx.mul(x, y) for x, y in zip(xs, ys)] == [jhx.mul(x, y) for x, y in zip(xs, ys)]
    assert hx.inv(xs[5]) == jhx.inv(xs[5]) and hx.pow(xs[6], 77) == jhx.pow(xs[6], 77)


PRESETS = ["baby_bear_p3_w16", "baby_bear_w16_horizen_ext", "bn254_w3"]


def host_sponge(h, cols: list, rate: int, out_len: int) -> list:
    st = [0] * h.t
    for off in range(0, len(cols), rate):
        chunk = cols[off:off + rate]
        st[:len(chunk)] = chunk
        st = h.permute_host(st)
    return st[:out_len]


@pytest.mark.parametrize("name", PRESETS)
def test_permute_hash_compress(name):
    """permute on 8 states equals JAX permute and permute_host; the
    sponge and the 2-to-1 compression equal their permute_host forms."""
    jh, h = getattr(jposeidon2, name)(), getattr(poseidon2, name)(CPU)
    F, p, t = h.F, h.F.p, h.t
    assert h.ark_full_host == jh.ark_full_host and h.int_diag_host == jh.int_diag_host
    rng = np.random.default_rng(9)
    states = [[int.from_bytes(rng.bytes(40), "little") % p for _ in range(t)] for _ in range(8)]
    states[0] = list(range(t))
    states[1] = [0] * t
    vals = np.array(states, dtype=object).T  # (t, 8)
    want = np.asarray(jh.permute(jnp.asarray(jh.F.encode(vals))))
    st = F.encode(vals)
    got = h.permute(st)
    np.testing.assert_array_equal(limbs.to_jax_limbs(got), want)
    assert torch.equal(st, F.encode(vals))  # the input is not written
    outs = [[int(v) for v in col] for col in F.decode(got).T]
    assert outs == [h.permute_host(s) for s in states]

    rate = 8 if t == 16 else t - 1
    out_len = 8 if t == 16 else 1
    cols = np.array([[int(v) for v in rng.integers(0, 1 << 30, 3)] for _ in range(19)],
                     dtype=object)  # 19 inputs of a batch of 3
    digest = h.hash_no_pad(F.encode(cols), out_len, rate=rate)  # (W, out_len, 3)
    assert [[int(v) for v in col] for col in F.decode(digest).T] == [
        host_sponge(h, [int(v) % p for v in cols[:, j]], rate, out_len) for j in range(3)]
    k = t // 2
    left, right = F.encode(vals[:k]), F.encode(vals[k:2 * k])
    got_c = [[int(v) for v in col] for col in F.decode(h.compress(left, right)).T]
    pad = [0] * (t - 2 * k)
    assert got_c == [h.permute_host(s[:2 * k] + pad)[:k] for s in states]


@pytest.mark.parametrize("name, width, want", [
    ("goldilocks_w8", 8, [14266028122062624699, 5353147180106052723, 15203350112844181434,
                          17630919042639565165, 16601551015858213987, 10184091939013874068,
                          16774100645754596496, 12047415603622314780]),
    ("baby_bear_w16_horizen_ext", 16, [
        1699737005, 296394369, 268410240, 828329642, 1491697358, 1128780676, 287184043,
        1806152977, 1380147856, 345666717, 491196631, 1875224538, 697740550, 1854502887,
        1201727753, 1802410886]),
])
def test_reference_goldens(name, width, want):
    """The reference's unit-test vectors (poseidon2_unittest.cc, as
    tests/test_poseidon2.py pins them) on 0, 1, ..., t - 1 (Goldilocks at
    W = 2; tests/test_torch_goldilocks.py holds it against the JAX permute)."""
    h = getattr(poseidon2, name)(CPU)
    st = h.F.encode(np.arange(width, dtype=object))[:, :, None]
    assert [int(v) for v in h.F.decode(h.permute(st)[:, :, 0])] == want
    assert h.permute_host(list(range(width))) == want


def test_stark_entry_points_default_to_the_card(monkeypatch):
    """The Poseidon2 presets and the quartic extensions default to CUDA;
    with no CUDA device a call left at its default raises."""
    import inspect

    fns = (poseidon2.baby_bear_p3_w16, poseidon2.baby_bear_w16_horizen_ext,
           poseidon2.bn254_w3, extensions.baby_bear4, extensions.koala_bear4)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == torch.device("cuda"), fn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in fns:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
