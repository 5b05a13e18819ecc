"""tachyon_tpu_torch: the PyTorch + CUDA port of tachyon_tpu.

The JAX package ``tachyon_tpu`` stays the reference.  This package runs the
same algorithms on PyTorch tensors, with every TPU (Pallas) kernel on the
ported path rewritten as a hand-written CUDA kernel for Hopper (sm_90a).

It imports ``torch`` and never ``jax``; of ``tachyon_tpu`` it uses only the
jax-free ``tachyon_tpu.fields.spec`` and ``tachyon_tpu.fields.presets``.
"""
