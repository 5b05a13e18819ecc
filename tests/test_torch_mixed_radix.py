"""The port's MixedRadixDomain and DomainCache against the JAX package on CPU.

bn254_fr (3^2 divides p - 1) and Goldilocks (3 divides p - 1) at n = 12, 18
and 24: fft and ifft of seeded inputs equal the JAX ``MixedRadixDomain``'s,
recorded in ``tests/fixtures/torch_goldilocks_jax.json`` by
``scripts/make_torch_goldilocks_fixture.py`` (the JAX domain runs op by op
and compiles each new shape: about a minute a case at bn254_fr's 16 limbs;
the slow test recomputes the part).  The comparison is word for word
(canonical ints), and each fft is also held against the host DFT sum.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math.field import PrimeField
from tachyon_tpu_torch.math.ntt import DomainCache, MixedRadixDomain, Radix2Domain

torch.set_num_threads(1)
SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "make_torch_goldilocks_fixture.py"
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_goldilocks_jax.json"


def fixture_script():
    spec = importlib.util.spec_from_file_location("make_torch_goldilocks_fixture", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return json.loads(FIXTURE.read_text())["mixed"]


@pytest.mark.parametrize("name", ["bn254_fr", "goldilocks"])
@pytest.mark.parametrize("n", [12, 18, 24])
def test_mixed_radix_vs_jax(name, n, fx):
    F = PrimeField(getattr(presets, name.upper()), "cpu")
    p = F.p
    want = fx[f"{name}_{n}"]
    if want == "refused":  # no subgroup of order n: both packages refuse
        assert (p - 1) % n
        with pytest.raises(ValueError, match="no subgroup"):
            MixedRadixDomain(F, n)
        return
    xs = fixture_script().mixed_input(p, n)
    d = MixedRadixDomain(F, n)
    assert d.omega_int == want["omega"] and d.n1 * d.n2 == n and d.n2 & (d.n2 - 1) == 0
    x = F.encode(xs)
    ev = d.fft(x)
    got = [int(v) for v in F.decode(ev)]
    assert got == want["fft"]
    assert [int(v) for v in F.decode(d.ifft(x))] == want["ifft"]
    assert torch.equal(d.ifft(ev), x)
    w = d.omega_int
    assert got == [sum(c * pow(w, j * k, p) for j, c in enumerate(xs)) % p for k in range(n)]


@pytest.mark.parametrize("name", ["bn254_fr", "goldilocks"])
def test_mixed_radix_batch_axes(name):
    """Trailing batch axes ride along: each column of a (12, 2, 3) batch
    transforms as it does alone."""
    F = PrimeField(getattr(presets, name.upper()), "cpu")
    d = MixedRadixDomain(F, 12)
    x = F.random((12, 2, 3), np.random.default_rng(170))
    ev = d.fft(x)
    assert torch.equal(ev[:, :, 1, 2], d.fft(x[:, :, 1, 2].contiguous()))
    assert torch.equal(d.ifft(ev), x)


@pytest.mark.parametrize("name", ["bn254_fr", "goldilocks"])
def test_domain_cache_vs_jax(name, fx):
    """DomainCache gives the JAX package's domain type for each size, the
    same object on a second call, and refuses a size with a factor 5."""
    F = PrimeField(getattr(presets, name.upper()), "cpu")
    cache = DomainCache(F)
    assert type(cache.get(16)).__name__ == fx[f"{name}_cache_16"] == "Radix2Domain"
    assert isinstance(cache.get(16), Radix2Domain) and cache.get(16) is cache.get(16)
    for n in (12, 24):
        assert type(cache.get(n)).__name__ == fx[f"{name}_{n}"]["cache"] == "MixedRadixDomain"
    with pytest.raises(ValueError, match="not 2\\^a"):
        cache.get(10)


@pytest.mark.slow
def test_fixture_recomputed_from_jax(fx):
    """The JAX package, run again, gives the committed mixed-radix part (minutes)."""
    assert fixture_script().record("mixed") == fx
