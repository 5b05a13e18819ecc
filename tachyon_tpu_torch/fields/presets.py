"""Concrete field specs — parameters mirror the reference's generator flags.

The port's own copy of ``tachyon_tpu/fields/presets.py``.

Reference parameter sources (values only; our constants are re-derived from
the modulus by FieldSpec):
  * BN254:     tachyon/math/elliptic_curves/bn/bn254/BUILD.bazel:21-60
  * BLS12-381: tachyon/math/elliptic_curves/bls12/bls12_381/BUILD.bazel
  * secp256k1: tachyon/math/elliptic_curves/secp/secp256k1/BUILD.bazel
  * Pasta:     tachyon/math/elliptic_curves/pasta/{pallas,vesta}/BUILD.bazel
  * BabyBear/KoalaBear/Mersenne31/Goldilocks:
               tachyon/math/finite_fields/{baby_bear,koala_bear,
               mersenne31,goldilocks}/BUILD.bazel
"""
from tachyon_tpu_torch.fields.spec import FieldSpec

# --- BN254 (alt_bn128) ------------------------------------------------------
BN254_FQ = FieldSpec(
    name="bn254_fq",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
)
BN254_FR = FieldSpec(
    name="bn254_fr",
    p=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    small_subgroup_base=3,
    small_subgroup_adicity=2,
)

# --- BLS12-381 ---------------------------------------------------------------
BLS12_381_FQ = FieldSpec(
    name="bls12_381_fq",
    p=4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
    generator=2,
)
BLS12_381_FR = FieldSpec(
    name="bls12_381_fr",
    p=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    generator=7,
    small_subgroup_base=3,
    small_subgroup_adicity=1,
)

# --- secp256k1 ---------------------------------------------------------------
SECP256K1_FQ = FieldSpec(
    name="secp256k1_fq",
    p=115792089237316195423570985008687907853269984665640564039457584007908834671663,
    generator=3,
)
SECP256K1_FR = FieldSpec(
    name="secp256k1_fr",
    p=115792089237316195423570985008687907852837564279074904382605163141518161494337,
    generator=7,
    small_subgroup_base=3,
    small_subgroup_adicity=1,
)

# --- Pasta (Pallas / Vesta) --------------------------------------------------
PALLAS_FP = FieldSpec(  # = VESTA_FR
    name="pasta_fp",
    p=28948022309329048855892746252171976963363056481941560715954676764349967630337,
    generator=5,
)
VESTA_FP = FieldSpec(  # = PALLAS_FR
    name="pasta_fq",
    p=28948022309329048855892746252171976963363056481941647379679742748393362948097,
    generator=5,
)

# --- 31/64-bit STARK fields --------------------------------------------------
BABY_BEAR = FieldSpec(name="baby_bear", p=(1 << 31) - (1 << 27) + 1, generator=31)
KOALA_BEAR = FieldSpec(name="koala_bear", p=(1 << 31) - (1 << 24) + 1, generator=3)
MERSENNE31 = FieldSpec(name="mersenne31", p=(1 << 31) - 1, generator=7)
GOLDILOCKS = FieldSpec(
    name="goldilocks",
    p=(1 << 64) - (1 << 32) + 1,
    generator=7,
    small_subgroup_base=3,
    small_subgroup_adicity=1,
)

ALL_FIELDS = [
    BN254_FQ,
    BN254_FR,
    BLS12_381_FQ,
    BLS12_381_FR,
    SECP256K1_FQ,
    SECP256K1_FR,
    PALLAS_FP,
    VESTA_FP,
    BABY_BEAR,
    KOALA_BEAR,
    MERSENNE31,
    GOLDILOCKS,
]
