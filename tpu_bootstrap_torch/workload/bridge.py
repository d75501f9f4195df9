"""Carry a params tree from the JAX reference to the port, through numpy.

The reference's tree, after ``jax.tree.map(np.asarray, params)``, holds
numpy arrays in nested dicts and lists, and its quantized leaves are
dataclass instances whose ``q``/``s`` fields are numpy arrays. This
module duck-types those leaves by their ``q``/``s``/``shape`` attributes
(and int4 leaves by their ``group``), so it needs no JAX import; the
port's tree has the same keys with torch tensors and
``quant.QuantizedWeight`` / ``quant.Quantized4Weight`` leaves. Expert
stacks keep their leading E axis.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bootstrap_torch.workload import quant
from tpu_bootstrap_torch.workload.model import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def params_from_numpy(tree, device=None):
    """Numpy params tree (reference layout) -> the port's tree on
    ``device`` (None: the card). int8 quantized leaves become
    ``QuantizedWeight``; int4 leaves (a ``group`` field) become
    ``Quantized4Weight`` with their ``group`` and ``kdim``."""
    return _convert(tree, resolve_device(device))


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "s") and hasattr(tree, "shape"):
        q, s = _tensor(tree.q, device), _tensor(tree.s, device)
        if hasattr(tree, "group"):
            return quant.Quantized4Weight(q=q, s=s, group=int(tree.group),
                                          shape=tuple(tree.shape),
                                          kdim=int(tree.kdim))
        return quant.QuantizedWeight(q=q, s=s, shape=tuple(tree.shape))
    return _tensor(tree, device)
