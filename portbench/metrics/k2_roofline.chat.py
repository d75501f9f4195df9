"""k2_roofline.chat: the least time of the traced slice's decode attention
over the time kernel K2 (``decode_attention.paged_decode_attention_int8``)
ran, in %. Work: each live row's int8 K/V and scales of its valid
positions read once, its query in and output out, 4 H D operations a
position, every layer. Layer: K2. Moves out_tok_s."""

from portbench import counts
from portbench.trace import fragments, kernel_seconds


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    secs = kernel_seconds(ctx["red"]["ops"], fragments(*counts.K2))
    if secs <= 0:
        return None
    p, work = ctx["config"], ctx["work"]
    per_pos = counts.kv_bytes_per_pos(p)
    qo = 2 * 2 * p["num_heads"] * p["head_dim"] * p["num_layers"]
    t = 0.0
    for step in work["decode_steps"]:
        if step:
            pos = sum(step)
            t += counts.least(counts.attn_flops(p, pos),
                              pos * per_pos + qo * len(step))
    return 100.0 * t / secs
