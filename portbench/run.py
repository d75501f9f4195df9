"""Run one benchmark cell once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name from ``BENCHMARK.json``. With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a profiled slice of the
window, and the slice's breakdown. Every run ends with the check that
decides ``correct``: its numbers and limits are the last lines on
standard error and the last key of the result, the last line on standard
output. Without CUDA, or with fewer cards than the cell asks for, or with
a JAX module loaded when the window has closed, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import sys  # noqa: E402

from portbench import common  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell, out: dict, chips: int) -> dict:
    """Each per-layer metric's reader over the traced slice; a reader that
    finds nothing to read leaves its metric out."""
    if "red" not in out:
        return {}
    ctx = {"kind": cell.kind, "config": cell.config["port"],
           "red": out["red"], "work": out["work"],
           "slice_s": out["red"]["wall_s"], "chips": chips}
    got = {}
    for m in cell.per_layer:
        value = common.load_reader(m["name"])(ctx)
        if value is not None:
            got[m["name"]] = {"value": value, "unit": m["unit"]}
    return got


def check(torch, cell, seed: int, out: dict, device,
          every: bool = False) -> dict:
    """The comparison with the plain reference, run once the program's
    state is freed. Returns {name: {value, limit, ok}} for each number the
    cell compares, and with ``every`` also the numbers it does not (their
    limit None)."""
    limits = cell.settings["check"]["limits"]
    if cell.kind == "serve":
        from portbench import serve

        c = cell.settings["check"]
        rids = serve.sample(out["book"], seed, c["sample_tokens"],
                            c["sample_requests"])
        got = serve.served_gaps(torch, cell.config["port"], seed, device,
                                out["book"], rids, out["chunks"])
        # No finished request to compare fails the check.
        values = {k: got[k] if rids else 1e9
                  for k in ("max_gap", "mean_gap")}
    else:
        from portbench import train

        refn = train.reference_numbers(torch, cell, seed, device)
        values = train.compare(out["checked"], refn,
                               cell.settings["check"]["skip_below"])
        values.pop("skipped_leaves")
    return {k: {"value": v, "limit": limits.get(k),
                "ok": k not in limits or v <= limits[k]}
            for k, v in values.items() if every or k in limits}


def run_cell(torch, cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, **kw) -> dict:
    if cell.kind == "serve":
        from portbench import serve

        return serve.run(torch, cell, seed, seconds, traced, device,
                         t_start, **kw)
    from portbench import train

    return train.run(torch, cell, seed, seconds, traced, device, t_start,
                     **kw)


def result(torch, cell, out: dict, traced: bool, device, chips: int) -> dict:
    """The result line's keys but ``correct`` and the checks."""
    if traced:
        metrics = per_layer(cell, out, chips)
    else:
        metrics = {m["name"]: {"value": out[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if device.type == "cuda":
        dev = common.device_info(torch, chips)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    res = {"attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": dev}
    if traced and "red" in out:
        from portbench import trace

        red = out["red"]
        dev["busy_s"] = red["busy_us"] / 1e6
        dev["window_s"] = red["wall_s"]
        res["breakdown"] = trace.breakdown(red, red["wall_s"] * 1e6)
    return res


def main(argv=None, device=None, **kw) -> int:
    """``device`` and ``kw`` are for the tests: a CPU device skips the look
    for cards and runs the program's plain CPU path."""
    args = parse(argv)
    bench = common.benchmark()
    cell = common.Cell(bench, args.workload)
    common.pin_environment(cell.settings)
    import torch

    common.pin_torch(torch)
    if device is None:
        common.require_cards(torch, cell.chips)
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    out = run_cell(torch, cell, args.seed, args.seconds, bool(args.trace),
                   device, T_START, **kw)
    loaded = common.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {loaded}; no result",
              file=sys.stderr)
        return 3
    res = result(torch, cell, out, bool(args.trace), device, cell.chips)
    out.pop("red", None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = check(torch, cell, args.seed, out, device)
    res = {"correct": all(c["ok"] for c in checks.values()), **res}
    common.emit(res, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
