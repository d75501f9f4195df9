"""The readings a cell's check limits are set from, many seeds in one
process (set-up and kernel builds paid once a process).

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control <k>] [--faults <k>]

For each seed, the cell's run as ``portbench.run`` makes it (the window at
the cell's own load, then the check's numbers against the reference). For
the first ``--control`` seeds, the control: the reference put in the
program's place one precision below the configuration's (activations,
and in training weights too, rounded to float8 e4m3 with a scale per
row), held to the same reference. For a train cell and the first
``--faults`` seeds, the fault "half of the batch left out" read on the
reference put in the program's place. One JSON line per reading on
standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from portbench import common


def main(argv=None, device=None) -> int:
    """``device`` is for the tests: a CPU device skips the look for
    cards."""
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=0)
    args = ap.parse_args(argv)
    cell = common.Cell(common.benchmark(), args.workload)
    common.pin_environment(cell.settings)
    import torch

    from portbench import run
    from portbench.reference import model as ref

    common.pin_torch(torch)
    if device is None:
        common.require_cards(torch, cell.chips)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    on_card = device.type == "cuda"
    for k, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        out = run.run_cell(torch, cell, seed, args.seconds, False, device, t0)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        release(torch, on_card)
        checks = run.check(torch, cell, seed, out, device, every=True)
        line = {"seed": seed, "kind": "program",
                "values": {n: c["value"] for n, c in checks.items()},
                "setup_s": out["setup_s"], "peak_bytes": peak,
                "attempted": out["attempted"], "failed": out["failed"]}
        for m in cell.end_to_end:
            line[m["name"]] = out[m["name"]]
        print(json.dumps(line), flush=True)
        if k < args.control:
            print(json.dumps({"seed": seed, "kind": "control",
                              "values": control(torch, cell, seed, out,
                                                device, ref)}), flush=True)
        if cell.kind == "train" and k < args.faults:
            print(json.dumps({"seed": seed, "kind": "fault_half_batch",
                              "values": half_batch(torch, cell, seed,
                                                   device)}), flush=True)
        del out
        release(torch, on_card)
    return 0


def release(torch, on_card: bool) -> None:
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()


def control(torch, cell, seed: int, out: dict, device, ref) -> dict:
    if cell.kind == "serve":
        from portbench import serve

        c = cell.settings["check"]
        rids = serve.sample(out["book"], seed, c["sample_tokens"],
                            c["sample_requests"])
        got = serve.served_gaps(torch, cell.config["port"], seed, device,
                                out["book"], rids, out["chunks"],
                                act=ref.fp8_rows)
        return {k: got[k] for k in ("max_gap", "mean_gap", "tokens")}
    from portbench import train

    base = train.reference_numbers(torch, cell, seed, device)
    low = train.reference_numbers(torch, cell, seed, device,
                                  act=ref.fp8_rows, wround=ref.fp8_cols)
    return train.compare(low, base, cell.settings["check"]["skip_below"])


def half_batch(torch, cell, seed: int, device) -> dict:
    """The reference on the first half of each step's rows, held to the
    reference on all of them."""
    from portbench import generator, train, weights
    from portbench.reference import model as ref

    p, st = cell.config["port"], cell.settings
    rows, seq = int(st["rows"]), int(cell.traffic["seq_len"])
    base = train.reference_numbers(torch, cell, seed, device)
    params = weights.float_params(torch, p, seed, device)
    batches = [generator.train_batch(torch, seed, i, rows, seq,
                                     p["vocab_size"], device)[:rows // 2]
               for i in range(train.CHECKED)]
    half = ref.train_steps(p, params, batches, st["optimizer"])
    return train.compare(half, base, st["check"]["skip_below"])


if __name__ == "__main__":
    sys.exit(main())
