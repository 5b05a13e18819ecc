"""The pinned TwoAdicFRI transcript of ``tests/test_fri_pinned.py``, computed by
the port: its shapes, seed and config through ``tachyon_tpu_torch``.

``artifacts(device)`` returns the fields of
``tests/fixtures/fri_babybear_pinned.json`` (written from the JAX package):
both rounds' roots, the commit phase's roots, the final value, the
proof-of-work witness, every opened value and the first query's fold
siblings.  ``tests/test_torch_fri.py`` runs it on the CPU and
``chip_smoke.py`` on the card; both require equality with the file.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from tachyon_tpu_torch.crypto import poseidon2
from tachyon_tpu_torch.crypto.challenger import DuplexChallenger
from tachyon_tpu_torch.crypto.fri import FRIConfig, TwoAdicFRIPCS
from tachyon_tpu_torch.fields import extensions, presets
from tachyon_tpu_torch.math.field import PrimeField

FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / \
    "fri_babybear_pinned.json"
SEED = 20260819
SHAPES = [[(32, 3), (16, 2)], [(8, 4)]]  # (rows, columns) per matrix, per round
CONFIG = FRIConfig(log_blowup=1, num_queries=3, proof_of_work_bits=2)


def setup(device):
    """The PCS, the committed rounds and the opening's points, as the
    JAX test makes them (a rate-8 challenger has observed the roots)."""
    F = PrimeField(presets.BABY_BEAR, device)
    h = poseidon2.baby_bear_p3_w16(device)
    pcs = TwoAdicFRIPCS(F, extensions.baby_bear4(device), h, CONFIG)
    rng = np.random.default_rng(SEED)
    datas = []
    for round_shapes in SHAPES:
        mats = [F.encode(np.array([[int(rng.integers(0, F.p)) for _ in range(c)]
                                   for _ in range(n)], dtype=object))
                for n, c in round_shapes]
        datas.append(pcs.commit(mats))
    ch = DuplexChallenger(h, rate=8)
    for d in datas:
        ch.observe_many(int(v) for v in F.decode(d.root()))
    zeta = ch.sample_ext(4)
    points = [[[zeta] for _ in d.ldes] for d in datas]
    return pcs, datas, points, ch


def artifacts(device) -> dict:
    pcs, datas, points, ch = setup(device)
    F = pcs.F
    opened, proof = pcs.create_opening_proof(datas, points, ch)

    def ints(a):  # base (W, ...) flat; extension (D, W, ...) coefficient by coefficient
        if a.ndim >= 2 and a.shape[0] == pcs.ext.D and a.shape[1] == F.W:
            return [int(v) for d in range(a.shape[0])
                    for v in np.atleast_1d(F.decode(a[d])).reshape(-1)]
        return [int(v) for v in np.atleast_1d(F.decode(a)).reshape(-1)]

    def nested(o):
        return [nested(v) for v in o] if isinstance(o, (list, tuple)) else ints(o)

    return {
        "roots": [ints(d.root()) for d in datas],
        "commit_phase_commits": [ints(c) for c in proof.commit_phase_commits],
        "final_eval": ints(proof.final_eval),
        "pow_witness": int(proof.pow_witness),
        "opened": nested(opened),
        "first_query_siblings": [ints(s.sibling_value)
                                 for s in proof.query_proofs[0].commit_phase_openings],
    }

