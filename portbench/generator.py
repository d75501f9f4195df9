"""The one traffic generator: it reads a mix's data file
(``traffic/<name>.json``) and the cell's settings, and makes a run's
inputs from ``--seed``.

Serve mixes (``"kind": "serve"``) are an open loop: ``rate_rps`` (the
cell's) requests a second over the window, in arrival events at Poisson
gaps, each event ``arrivals.burst`` requests due at once (1: plain
Poisson arrivals; more: bursts at the same mean rate). A request's prompt
is, with ``shared_prefix``, one of ``groups`` prefixes of ``tokens``
tokens, then its own tokens; its own length and its output length follow
``prompt_tokens`` and ``output_tokens``, each a ``lognormal`` (median,
sigma) or ``uniform`` distribution clipped to [min, max].
Every seed gets the same set of sizes and gaps, the quantiles of the
distributions, in an order the seed draws, so two seeds do the same work
and differ only in its order and in the token ids. A new mix of these
shapes is a data file alone.

Train mixes (``"kind": "train"``): rows of ``seq_len + 1`` uniform token
ids, made on the device from the seed and the step's index.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# A seed may be any whole number; torch generators take 64 bits.
_SEED_MASK = (1 << 63) - 1


@dataclasses.dataclass
class Arrival:
    rid: int
    due_s: float  # seconds after the window opens
    prompt: list
    max_new: int


def _quantiles(spec: dict, n: int) -> np.ndarray:
    """n sizes at the quantiles (i + 0.5) / n of the spec's distribution,
    rounded and clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    dist = spec["dist"]
    if dist == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(x) for x in u])
        sizes = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif dist == "uniform":
        sizes = spec["min"] + u * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(sizes), spec["min"], spec["max"]).astype(np.int64)


def serve_arrivals(traffic: dict, settings: dict, seed: int, seconds: float,
                   vocab: int, rate: float | None = None) -> list:
    """The requests due in a window of ``seconds``: round(rate * seconds)
    of them in events of ``burst``, the first event due at 0 and the rest
    after gaps that sum to the window (exponential quantiles, shuffled)."""
    if traffic["kind"] != "serve":
        raise ValueError("serve_arrivals reads a serve mix")
    arr = traffic["arrivals"]
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    burst = int(arr.get("burst", 1))
    rate = float(settings["rate_rps"] if rate is None else rate)
    n = max(1, round(rate * seconds))
    events = -(-n // burst)
    rng = np.random.default_rng(seed & _SEED_MASK)
    prompts = rng.permutation(_quantiles(traffic["prompt_tokens"], n))
    outputs = rng.permutation(_quantiles(traffic["output_tokens"], n))
    gaps = -np.log1p(-(np.arange(events) + 0.5) / events)
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    starts = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    due = np.repeat(starts, burst)[:n]
    shared = traffic.get("shared_prefix")
    prefixes, group = [], np.zeros(n, dtype=np.int64)
    if shared:
        g = int(shared["groups"])
        prefixes = [rng.integers(0, vocab, int(shared["tokens"])).tolist()
                    for _ in range(g)]
        group = rng.permutation(np.arange(n) % g)
    out = []
    for i in range(n):
        own = rng.integers(0, vocab, size=int(prompts[i])).tolist()
        head = prefixes[group[i]] if shared else []
        out.append(Arrival(rid=i, due_s=float(due[i]), prompt=head + own,
                           max_new=int(outputs[i])))
    return out


def warm_arrivals(traffic: dict, settings: dict, vocab: int,
                  block_size: int, max_seq_len: int) -> list:
    """Set-up's requests: one prompt per decode table width the mix can
    reach (1, 2, 4, ... blocks up to the longest prompt plus the longest
    output), each decoding a few tokens, so every captured width and the
    prefill chunk shapes are built before the window."""
    prefix = int((traffic.get("shared_prefix") or {}).get("tokens", 0))
    longest = min(prefix + traffic["prompt_tokens"]["max"]
                  + traffic["output_tokens"]["max"], max_seq_len)
    rng = np.random.default_rng(0)
    out, nb = [], 1
    while True:
        width = min(nb * block_size, longest)
        prompt = max(2, width - 4)
        out.append(Arrival(rid=-(len(out) + 1), due_s=0.0,
                           prompt=rng.integers(0, vocab, prompt).tolist(),
                           max_new=4))
        if width >= longest:
            return out
        nb *= 2


def train_batch(torch, seed: int, step: int, rows: int, seq_len: int,
                vocab: int, device) -> "torch.Tensor":
    """Step ``step``'s token rows (rows, seq_len + 1), made on the device
    from the seed and the step index."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & _SEED_MASK) * 1_000_003 + step) & _SEED_MASK)
    return torch.randint(0, vocab, (rows, seq_len + 1), generator=gen,
                         device=device)
