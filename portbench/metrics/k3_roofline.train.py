"""k3_roofline.train: the least time of the traced steps' causal attention
forward over the time kernel K3 (``flash_fwd``) ran, in %. Work a layer a
step: 2 B H S^2 D operations (scores and values, the causal half); q, k,
v read and the output written once in bf16, the float32 log-sum-exp
written. Layer: K3. Moves train_tok_s."""

from portbench import counts
from portbench.trace import fragments, kernel_seconds


def read(ctx):
    if ctx["kind"] != "train":
        return None
    secs = kernel_seconds(ctx["red"]["ops"], fragments(*counts.K3))
    if secs <= 0:
        return None
    p, w = ctx["config"], ctx["work"]
    b, s, h, d = w["rows"], w["seq"], p["num_heads"], p["head_dim"]
    hk = p["num_kv_heads"]
    ops = 2.0 * b * h * s * s * d
    nbytes = 2 * b * s * d * (2 * h + 2 * hk) + 4 * b * h * s
    t = counts.least(ops, nbytes) * p["num_layers"] * w["steps"]
    return 100.0 * t / secs
