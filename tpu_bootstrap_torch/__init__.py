"""PyTorch / CUDA port of the slice workload (``tpu_bootstrap.workload``)
for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its module
names under ``tpu_bootstrap_torch.workload`` so each piece has an obvious
counterpart. It imports ``torch`` and never ``jax`` or anything of
``tpu_bootstrap``. Importing it loads nothing heavy: each module is
imported on its own.
"""
