"""tachyon_tpu_torch: the PyTorch + CUDA port of tachyon_tpu.

The JAX package ``tachyon_tpu`` stays the reference.  This package runs the
same algorithms on PyTorch tensors, with every TPU (Pallas) kernel on the
ported paths rewritten as a hand-written CUDA kernel for Hopper (sm_90a).

It imports ``torch`` and never ``jax``, and nothing of ``tachyon_tpu``: it
keeps its own copies of the jax-free modules it needs (``fields/spec.py``,
``fields/presets.py``, ``math/pairing_bn254.py``,
``math/pairing_bls12_381.py``).  Its entry points put
their tensors on the card unless the caller passes another device.
"""
