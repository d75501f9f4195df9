"""The port's workload modules: model, quantization, the two CUDA
kernels (int8 matmul, paged int8 decode attention), paged decode and
the block-paged serving engine.

Import the modules directly (``from tpu_bootstrap_torch.workload import
serving``); this package file imports nothing, so importing it does not
pull in torch or build a kernel.
"""
