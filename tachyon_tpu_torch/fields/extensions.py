"""Small-field extensions, the FRI challenge fields (port of
``tachyon_tpu/fields/extensions.py``), on one device: the card unless the
caller passes another.

Reference parameter sources:
  * BabyBear4 (x^4 - 11):  math/finite_fields/baby_bear/internal/BUILD.bazel:17
  * KoalaBear4 (x^4 - 3):  math/finite_fields/koala_bear/internal/BUILD.bazel:17
  * Goldilocks2 (x^2 - 7): math/finite_fields/goldilocks/internal/BUILD.bazel:36

Goldilocks2's base multiplies are K1 at W = 2 on the card; its adds and
sums keep to the word-ripple paths of ``ops/mont.py`` (a Goldilocks value
above 2^63 has no int64 form).
"""
import functools

import torch

from tachyon_tpu_torch.fields import presets
from tachyon_tpu_torch.math.extfield import ExtField
from tachyon_tpu_torch.math.field import PrimeField


@functools.lru_cache(maxsize=None)
def baby_bear4(device=torch.device("cuda")) -> ExtField:
    return ExtField(PrimeField(presets.BABY_BEAR, device), 4, 11, name="baby_bear4")


@functools.lru_cache(maxsize=None)
def koala_bear4(device=torch.device("cuda")) -> ExtField:
    return ExtField(PrimeField(presets.KOALA_BEAR, device), 4, 3, name="koala_bear4")



@functools.lru_cache(maxsize=None)
def goldilocks2(device=torch.device("cuda")) -> ExtField:
    return ExtField(PrimeField(presets.GOLDILOCKS, device), 2, 7, name="goldilocks2")
