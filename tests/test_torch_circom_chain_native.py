"""The circom form of the 130-constraint chain against the port's native
Groth16 prover, on CPU: the native ``r1cs.Groth16.prove`` on the same setup
(the committed key's points, which the writer took from the native
``setup`` on the chain with its public-input constraints, and the native H
query [tau^i Z(tau) / delta] G from the same secrets), at the same r and s,
gives the circom prover's host-exact tuple (``test_torch_circom_chain.py``
holds the circom prover's device paths to that tuple): the same
polynomials give the same A, B and C.  The writer's chain bytes are held
by the slow test of ``test_torch_circom.py``, its toy bytes by
``test_torch_zkey.py``."""
import torch

from tachyon_tpu_torch.math import host_ec
from tachyon_tpu_torch.math import pairing_bn254 as pairing
from tachyon_tpu_torch.zk.groth16 import r1cs

from test_torch_circom_chain import chain_case, host_sums, reference_proof

import circom_key  # noqa: E402  (scripts/, on the path through test_torch_circom)
import make_torch_circom_fixture as maker  # noqa: E402

torch.set_num_threads(1)


def native_params(pr, circuit, secrets) -> r1cs.Groth16Params:
    """The native params of the setup behind the committed chain key."""
    full = circom_key.circom_r1cs(circuit)
    n, rp = pr.zkey.domain_size, pairing.R
    tau, delta = secrets[0], secrets[4]
    t = (pow(tau, n, rp) - 1) * pow(delta, -1, rp) % rp
    h_query = []
    for _ in range(n - 1):
        h_query.append(host_ec.scalar_mul((1, 2), t, 0, pairing.P))
        t = t * tau % rp

    def g1(pts):
        return r1cs.host_points(pr.g1, pts)

    return r1cs.Groth16Params(
        family="bn254", r1cs=full, n=n, alpha1=pr._alpha1, beta1=pr._beta1,
        beta2=pr._beta2, delta1=pr._delta1, delta2=pr._delta2,
        a_query=g1(pr.pts_a1), b1_query=g1(pr.pts_b1),
        b2_query=r1cs.host_points(pr.g2, pr.pts_b2), l_query=g1(pr.pts_c1),
        h_query=h_query, gamma2=pr._gamma2, ic=pr._ic)


def test_chain_native_prover_equals_circom():
    (circuit, public, private), secrets, r, s = maker.inputs("chain")
    pr, _, wi, cpublic, h, cr, cs = chain_case()
    assert (cpublic, cr, cs) == (public, r, s) and wi == [1] + public + private
    pp = native_params(pr, circuit, secrets)
    assert pp.n == 256 and len(pp.r1cs.constraints) == maker.CHAIN_M + 2

    circom = reference_proof(pr, host_sums(pr, wi, h), r, s)
    native = r1cs.Groth16(pp, device="cpu").prove(public, private, r=r, s=s)
    assert tuple(native) == circom
