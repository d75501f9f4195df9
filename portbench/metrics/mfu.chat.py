"""mfu.chat: the model FLOPs of every token the traced slice prefilled and
decoded (matmuls, the head for decoded tokens, attention over each
token's context) over the slice's wall time (whole rounds) at the H100's
989 TFLOP/s, in %. Layer: the serve step (PagedPool round). Moves
out_tok_s."""

from portbench import counts
from portbench.common import PEAK_FLOPS


def read(ctx):
    if ctx["kind"] != "serve" or ctx["slice_s"] <= 0:
        return None
    p, work = ctx["config"], ctx["work"]
    flops = 0.0
    for step in work["decode_steps"]:
        flops += len(step) * counts.token_flops(p, True)
        flops += counts.attn_flops(p, sum(step))
    for chunks in work["prefill_rounds"]:
        for start, w in chunks:
            flops += w * counts.token_flops(p, False)
            # Positions start .. start + w - 1 attend over pos + 1 each.
            flops += counts.attn_flops(p, w * start + w * (w + 1) // 2)
    if flops <= 0:
        return None
    return 100.0 * flops / (ctx["slice_s"] * ctx["chips"] * PEAK_FLOPS)
