"""The port's PLONK verifier refuses what it should, on ``tests/test_plonk.py``'s
circuit at n = 16 (the fixture case ``mul_shplonk``; see
``test_torch_plonk.py``): a flipped byte, the instance + 1, a truncated
proof, a GWC verifier on a SHPlonk proof, a bad witness and a broken copy;
on CPU."""
import torch

from test_torch_halo2 import int_field_ops  # noqa: F401 (autouse fixture)
from test_torch_plonk import R, check_case
from tachyon_tpu_torch.zk.plonk import prover as plonk

torch.set_num_threads(1)


def test_refusals():
    """A flipped byte, the instance + 1, a bad witness, a broken copy and
    the other multiopen scheme are refused."""
    case, params, pk, proof = check_case("mul_shplonk")
    ver = plonk.PlonkVerifier(params, pk)
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    assert ver.verify(bytes(bad), case["instance"]) is False
    wrong = [[(case["instance"][0][0] + 1) % R] + case["instance"][0][1:]]
    assert ver.verify(proof, wrong) is False
    assert plonk.PlonkVerifier(params, pk, pcs="gwc").verify(proof, case["instance"]) is False
    assert ver.verify(proof[:-7], case["instance"]) is False

    advice = [list(c) for c in case["advice"]]
    advice[2][1] += 1  # a * b != c on row 1
    assert ver.verify(plonk.PlonkProver(params, pk).prove(advice, case["instance"]),
                      case["instance"]) is False

    advice = [list(c) for c in case["advice"]]
    advice[0][1], advice[2][1] = 7, 7 * advice[1][1]  # the gate holds, c[0] != a[1]
    assert ver.verify(plonk.PlonkProver(params, pk).prove(advice, case["instance"]),
                      case["instance"]) is False
