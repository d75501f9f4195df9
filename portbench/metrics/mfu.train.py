"""mfu.train: 6 N FLOPs a token (N the parameters a token multiplies by,
the tied head once) plus causal attention (6 B H S^2 D a layer: forward
and backward), over the traced steps' wall time times the cards at the
H100's 989 TFLOP/s, in %. Recomputed work is not counted. Layer: the
train step. Moves train_tok_s."""

from portbench import counts
from portbench.common import PEAK_FLOPS


def read(ctx):
    if ctx["kind"] != "train" or ctx["slice_s"] <= 0:
        return None
    p, w = ctx["config"], ctx["work"]
    b, s = w["rows"], w["seq"]
    per_step = (6.0 * counts.train_param_count(p) * b * s
                + 6.0 * b * p["num_heads"] * s * s * p["head_dim"]
                * p["num_layers"])
    return 100.0 * per_step * w["steps"] / (
        ctx["slice_s"] * ctx["chips"] * PEAK_FLOPS)
