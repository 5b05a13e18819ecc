"""The port's ``msm_sharded_2d`` on a 2 x 2 ("dp", "win") mesh of 4 gloo
ranks, and ``DistributedNTT``, ``DistributedCosetLDE`` and
``fft_batch_dist`` on a 4-way mesh, against the JAX package's results on
its 8-way CPU mesh (``tests/fixtures/torch_parallel_jax.json``; see
``test_torch_parallel.py``, whose rank program this group runs)."""
import pytest
import torch

from test_torch_parallel import affine, fixture, host_msm, jax_point, jax_words, same, spawn_group

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list:
    return spawn_group(tmp_path_factory, WORLD)


def test_results_are_replicated(ranks):
    assert all(same(r, ranks[0]) for r in ranks[1:])


def test_msm_sharded_2d_point_vs_jax(ranks):
    assert affine(ranks[0]["msm_sharded_2d"]) == jax_point("msm_sharded_2d") == host_msm()


@pytest.mark.parametrize("field", ("baby_bear", "bn254_fr"))
def test_distributed_ntt_words_vs_jax(ranks, field):
    r = ranks[0]
    want = fixture()[f"ntt_{field}"]
    assert torch.equal(r[f"ntt_{field}"]["fft"], jax_words(want["fft"]))
    assert torch.equal(r[f"ntt_{field}"]["ifft"], jax_words(want["ifft"]))
    assert torch.equal(r[f"ntt_{field}"]["roundtrip"], r[f"input_{field}"])


def test_coset_lde_and_fft_batch_words_vs_jax(ranks):
    r = ranks[0]
    for name in ("coset_lde", "fft_batch", "ifft_batch"):
        assert torch.equal(r[name], jax_words(fixture()[name])), name
