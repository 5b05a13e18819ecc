"""The port's multi-GPU paths (``tachyon_tpu_torch/parallel``) in gloo
groups on the CPU against the JAX package on its 8-way CPU mesh.

``tests/fixtures/torch_parallel_jax.json`` holds ``tachyon_tpu.parallel``'s
results on ``scripts/make_torch_parallel_fixture.py``'s inputs, recorded on
the virtual 8-device mesh of ``tests/conftest.py`` (the window-sharded JAX
MSMs compile for minutes).  Here a group of 2 ranks is spawned once for
the module, with a ``file://`` store under a temporary directory (no TCP
port to clash between test workers): ``msm_sharded`` on a "dp" mesh,
``msm_sharded_windows`` on a "win" mesh, ``DistributedNTT``,
``DistributedCosetLDE`` and ``fft_batch_dist``.  ``test_torch_parallel_2d.py``
spawns 4 ranks for ``msm_sharded_2d`` on a 2 x 2 ("dp", "win") mesh and the
NTTs on a 4-way mesh (one group a file: a rank's plain-twin MSMs take 5-10 s
of CPU).  Every rank's results must be the same (they are replicated), the
MSMs' affine points the JAX points, the NTTs' words the JAX words.
"""
import importlib.util
import json
import multiprocessing
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from tachyon_tpu_torch.fields import limbs, presets
from tachyon_tpu_torch.math import host_ec

ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_parallel_jax.json"
RANK_TIMEOUT_S = 240


@lru_cache(maxsize=None)
def maker():
    path = ROOT / "scripts" / "make_torch_parallel_fixture.py"
    spec = importlib.util.spec_from_file_location("make_torch_parallel_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@lru_cache(maxsize=None)
def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def rank_main(rank: int, world: int, store: str, out: str) -> None:
    """One rank of a gloo group: the parallel paths on the CPU, results saved
    to ``out/<world>_<rank>.pt`` (words as int32 tensors; the MSMs' XYZZ
    points, made affine on the host by ``affine``)."""
    import torch.distributed as dist

    from tachyon_tpu_torch.math import curves
    from tachyon_tpu_torch.math.ec import AffinePoint
    from tachyon_tpu_torch.math.field import PrimeField
    from tachyon_tpu_torch.parallel import mesh, msm_sharded, ntt_dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    m = maker()
    res = {}
    try:
        curve = curves.bn254_g1("cpu")
        F = curve.F
        pts, scalars = m.msm_inputs()
        points = AffinePoint(F.encode(np.array([p[0] for p in pts], dtype=object)),
                             F.encode(np.array([p[1] for p in pts], dtype=object)),
                             torch.zeros(len(pts), dtype=torch.bool))
        sc = limbs.from_ints(scalars, curve.SF.W)

        dp = mesh.data_mesh(device="cpu")
        if world == 2:
            res["msm_sharded"] = tuple(msm_sharded.msm_sharded(curve, dp, points, sc,
                                                               c=m.C_POINTS))
            win = mesh.data_mesh(axis="win", device="cpu")
            res["msm_sharded_windows"] = tuple(msm_sharded.msm_sharded_windows(
                curve, win, points, sc, c=m.C_WINDOWS))
        else:
            grid = mesh.grid_mesh((2, 2), ("dp", "win"), device="cpu")
            res["msm_sharded_2d"] = tuple(msm_sharded.msm_sharded_2d(curve, grid, points, sc,
                                                                     c=m.C_WINDOWS))
        x = m.ntt_inputs()
        for name, spec in (("baby_bear", presets.BABY_BEAR), ("bn254_fr", presets.BN254_FR)):
            Fn = PrimeField(spec, "cpu")
            a = Fn.encode(np.array(x[name], dtype=object))
            d = ntt_dist.DistributedNTT(Fn, m.NTT_N[name], dp)
            y = d.fft(a)
            res[f"ntt_{name}"] = {"fft": y, "ifft": d.ifft(a), "roundtrip": d.ifft(y)}
            res[f"input_{name}"] = a
        B = PrimeField(presets.BABY_BEAR, "cpu")
        rows, _, log_blowup, shift = m.LDE
        mat = B.encode(np.array(x["matrix"], dtype=object))
        res["coset_lde"] = ntt_dist.DistributedCosetLDE(B, rows, log_blowup, shift, dp)(mat)
        res["fft_batch"] = ntt_dist.fft_batch_dist(B, dp, mat)
        res["ifft_batch"] = ntt_dist.fft_batch_dist(B, dp, mat, inverse=True)
    finally:
        dist.destroy_process_group()
    torch.save(res, f"{out}/{world}_{rank}.pt")


def spawn_group(tmp_path_factory, world: int) -> list:
    """``world`` ranks of rank_main in a gloo group; their results, by rank."""
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path_factory.mktemp("ranks")
    store = tmp_path_factory.mktemp("store") / "store"
    procs = [ctx.Process(target=rank_main, args=(r, world, str(store), str(out)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [torch.load(out / f"{world}_{r}.pt") for r in range(world)]


WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory) -> list:
    return spawn_group(tmp_path_factory, WORLD)


def affine(xyzz) -> list:
    """An XYZZ point's Montgomery words -> affine ints (x = X / ZZ, y = Y / ZZZ)."""
    f = presets.BN254_FQ
    x, y, zz, zzz = (limbs.decode(f, t) for t in xyzz)
    return [int(x) * pow(int(zz), -1, f.p) % f.p, int(y) * pow(int(zzz), -1, f.p) % f.p]


def jax_point(name: str) -> list:
    return [int(v, 16) for v in fixture()[name]]


def jax_words(d: dict) -> torch.Tensor:
    return limbs.from_jax_limbs(maker().unhexed(d))


def host_msm() -> list:
    pts, scalars = maker().msm_inputs()
    return list(host_ec.msm(pts, scalars, 0, maker().BN254_P))


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_results_are_replicated(ranks):
    assert all(same(r, ranks[0]) for r in ranks[1:])


@pytest.mark.parametrize("name", ("msm_sharded", "msm_sharded_windows"))
def test_msm_points_vs_jax(ranks, name):
    assert affine(ranks[0][name]) == jax_point(name) == host_msm()


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


def test_mesh_needs_a_process_group():
    from tachyon_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="not initialized"):
        mesh.data_mesh(device="cpu")


@pytest.mark.slow
def test_fixture_recomputed_from_jax():
    """The JAX package, run again, gives the committed fixture (minutes)."""
    assert maker().record() == fixture()
