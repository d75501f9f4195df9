"""idle_share.chat: the share of the traced slice in which no operation
ran on the device (1 - the union of kernel, copy and set intervals over
the slice), in %. Layer: device. Moves out_tok_s."""


def read(ctx):
    if ctx["kind"] != "serve" or ctx["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["red"]["busy_us"] / 1e6 / ctx["slice_s"])
