"""The port's workload modules: model, quantization, decoding
(``generate`` on contiguous caches, paged decode, greedy speculative
decoding), the serving engines (block-paged and replay-slot), training,
and the CUDA kernels behind them (``kernels.py``, sources in ``csrc/``).

Import the modules directly (``from tpu_bootstrap_torch.workload import
serving``); this package file imports nothing, so importing it does not
pull in torch or build a kernel.
"""
