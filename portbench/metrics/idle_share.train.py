"""idle_share.train: the share of the traced steps in which no operation
ran on the device (1 - the union of kernel, copy and set intervals over
the slice), in %, averaged over the ranks. Layer: device. Moves
train_tok_s."""


def read(ctx):
    if ctx["kind"] != "train" or ctx["slice_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["red"]["busy_us"] / 1e6 / ctx["slice_s"])
