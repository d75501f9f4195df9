"""The parts of ``jax.random`` the serving engines call, bit for bit, in
torch integer ops: ``PRNGKey``, ``fold_in``, ``split``, 32-bit random
bits, ``uniform``, ``gumbel`` and ``categorical``, on the default
threefry2x32 implementation with ``jax_threefry_partitionable`` on (the
default since jax 0.5): bits and split keys come from counters
``(hi, lo)`` of the flat index, not from the original paths' halves of
one iota.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words
(torch's uint32 arithmetic is incomplete, and threefry has no multiply,
so int64 holds every intermediate exactly once each add and shift is
masked to 32 bits). Everything is vectorised over the key's batch shape
and runs on the key's device, inside a CUDA graph capture too: no host
read, no data-dependent shape. This is no kernel: the reference computes
the same in XLA, outside any Pallas call.

The integer half (keys, bits, the uniform's mantissa trick) is exact on
every device. ``gumbel`` takes two logs, which torch and XLA may round
an ulp apart, so a ``categorical`` draw can differ only where the top
two values of ``logits + gumbel`` lie within a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with x64 off (jax's default): the
    seed's low 32 bits, after a high word of 0. A seed outside the int64
    range raises OverflowError, as jax does."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def as_key(k, device=None) -> torch.Tensor:
    """A key (..., 2) as this module holds it, from a tensor or from any
    array of uint32 words (``numpy.asarray(jax.random.PRNGKey(s))``)."""
    if isinstance(k, torch.Tensor):
        return k.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(k).astype(np.int64), device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple:
    """The threefry2x32 hash of counter words (x1, x2) under keys ``k``
    (..., 2), all uint32 values in int64, broadcast together: 20 rounds
    of the two rotation sets, the key schedule (parity word 0x1BD11BDA)
    injected every 4 rounds. Returns the two output words."""
    k1, k2 = k[..., 0], k[..., 1]
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: the hash of counters (0,
    uint32(data)). ``data`` an int, or a tensor broadcast against the
    key's batch shape: ``fold_in(keys (B, 2), data (B,))`` is
    ``jax.vmap(jax.random.fold_in)``."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data), dtype=torch.int64, device=k.device)
    data = data.to(torch.int64) & _M32
    a, b = threefry2x32(k, torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def _counters(shape: tuple, device) -> torch.Tensor:
    """The low words of ``iota_2x32_shape(shape)``: the flat index (the
    high words are 0 below 2**32 elements)."""
    n = 1
    for d in shape:
        n *= d
    if n >= 1 << 32:
        raise NotImplementedError("random bits of 2**32 or more elements")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)`` (one key (2,)): the foldlike split, key i
    the hash of counters (0, i). Returns (n, 2)."""
    lo = _counters((n,), k.device)
    a, b = threefry2x32(k, torch.zeros_like(lo), lo)
    return torch.stack([a, b], dim=-1)


def bits32(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)``: both output words of the hash
    of counters (0, flat index), xored. ``k`` may carry batch dims (...,
    2), which lead the result: (..., *shape), each row its key's bits of
    ``shape`` (``jax.vmap`` over keys)."""
    lo = _counters(tuple(shape), k.device)
    kb = k.reshape(*k.shape[:-1], *([1] * len(shape)), 2)
    a, b = threefry2x32(kb, torch.zeros_like(lo), lo)
    return a ^ b


def uniform(k: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in f32: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled into [minval, maxval), clamped below
    at minval. XLA fuses the scale and the shift into one multiply-add,
    rounded once: the product of two f32 values is exact in f64, so the
    f64 sum rounded to f32 gives its bits."""
    bits = bits32(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (f.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp(scaled, min=float(lo))


def gumbel(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel`` in f32, its default ("low") mode: -log(-log(u))
    with u uniform in [tiny, 1)."""
    u = uniform(k, shape, minval=_F32_TINY, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis=-1)`` with one key ``k``
    (2,) over ``logits`` (..., V): argmax of logits plus gumbel noise of
    the logits' shape, drawn in f32. Keys (B, 2) with logits (B, V) draw
    each row with its own key: ``jax.vmap(jax.random.categorical)``."""
    if k.ndim == 1:
        g = gumbel(k, tuple(logits.shape))
    else:
        g = gumbel(k, tuple(logits.shape[k.ndim - 1:]))
    return torch.argmax(g + logits.float(), dim=-1)


__all__ = ["as_key", "bits32", "categorical", "fold_in", "gumbel", "key",
           "split", "threefry2x32", "uniform"]
