"""k4_roofline.train: the least time of the traced steps' causal attention
backward over the time kernel K4 (``flash_dq`` and ``flash_dkv``) ran, in
%. Work a layer a step: 5 B H S^2 D operations (the scores again, dP, dV,
dQ and dK, the causal half); q, k, v, the output and its gradient read
and dq, dk, dv written once in bf16, the float32 log-sum-exp and row
delta read. Layer: K4. Moves train_tok_s."""

from portbench import counts
from portbench.trace import fragments, kernel_seconds


def read(ctx):
    if ctx["kind"] != "train":
        return None
    secs = sum(kernel_seconds(ctx["red"]["ops"], fragments(*f))
               for f in counts.K4)
    if secs <= 0:
        return None
    p, w = ctx["config"], ctx["work"]
    b, s, h, d = w["rows"], w["seq"], p["num_heads"], p["head_dim"]
    hk = p["num_kv_heads"]
    ops = 5.0 * b * h * s * s * d
    nbytes = 2 * b * s * d * (4 * h + 4 * hk) + 2 * 4 * b * h * s
    t = counts.least(ops, nbytes) * p["num_layers"] * w["steps"]
    return 100.0 * t / secs
