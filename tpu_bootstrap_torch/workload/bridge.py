"""Carry a params tree from the JAX reference to the port, through numpy.

The reference's tree, after ``jax.tree.map(np.asarray, params)``, holds
numpy arrays in nested dicts and lists, and its quantized leaves are
dataclass instances whose ``q``/``s`` fields are numpy arrays. This
module duck-types those leaves by their ``q``/``s``/``shape`` attributes,
so it needs no JAX import; the port's tree has the same keys with torch
tensors and ``quant.QuantizedWeight`` leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bootstrap_torch.workload import quant


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def params_from_numpy(tree, device="cpu"):
    """Numpy params tree (reference layout) -> the port's tree on
    ``device``. int8 quantized leaves become ``QuantizedWeight``; int4
    leaves (a ``group`` field) are not ported and raise."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "s") and hasattr(tree, "shape"):
        if hasattr(tree, "group"):
            raise NotImplementedError(
                "int4 weights are not ported yet (ROADMAP queue 1 item 9: "
                "int4 and MoE)")
        return quant.QuantizedWeight(q=_tensor(tree.q, device),
                                     s=_tensor(tree.s, device),
                                     shape=tuple(tree.shape))
    return _tensor(tree, device)
