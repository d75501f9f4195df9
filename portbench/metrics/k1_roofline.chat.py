"""k1_roofline.chat: the least time of the traced slice's int8 projections
over the time kernel K1 (``quant.int8_matmul``) ran, in %. Work: each
decode step streams every K1 weight (int8 and scales) once and multiplies
its live rows; each round's prefill streams them once for all its prompt
tokens (no head). Layer: K1. Moves out_tok_s."""

from portbench import counts
from portbench.trace import fragments, kernel_seconds


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    secs = kernel_seconds(ctx["red"]["ops"], fragments(*counts.K1))
    if secs <= 0:
        return None
    p, work = ctx["config"], ctx["work"]
    dec, pre = counts.k1_shapes(p, True), counts.k1_shapes(p, False)
    t = 0.0
    for step in work["decode_steps"]:
        n = len(step)
        if n:
            t += counts.least(counts.matmul_ops(dec, n),
                              counts.int8_bytes(dec)
                              + counts.act_bytes(dec, n, True))
    for chunks in work["prefill_rounds"]:
        n = sum(w for _, w in chunks)
        if n:
            t += counts.least(counts.matmul_ops(pre, n),
                              counts.int8_bytes(pre)
                              + counts.act_bytes(pre, n, False))
    return 100.0 * t / secs
