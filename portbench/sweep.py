"""The knee of a serve cell: one set-up, then a window of ``--seconds`` at
each offered rate, the pool emptied before the next. The knee is the
highest rate whose completions keep up with its arrivals: above it the
backlog at the window's close grows with the rate, and the tokens
delivered a second stop growing.

    python3 -m portbench.sweep --workload <cell> --seed <n> \
        --seconds 30 --rates <r> [<r> ...]

One JSON line a rate on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = common.Cell(common.benchmark(), args.workload)
    common.pin_environment(cell.settings)
    import torch

    from portbench import generator, serve
    from tpu_bootstrap_torch.workload import serving

    common.pin_torch(torch)
    common.require_cards(torch, cell.chips)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t0 = time.perf_counter()
    cfg, pool = serve.build_pool(torch, cell, args.seed, device)
    serve.warm_up(torch, cell, cfg, pool)
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    eng = cell.settings["engine"]
    for rate in args.rates:
        pool.reset()
        sched = serving.Scheduler(pool, overcommit=eng["overcommit"])
        arrivals = generator.serve_arrivals(cell.traffic, cell.settings,
                                            args.seed, args.seconds,
                                            cfg.vocab_size, rate)
        win = serve.run_window(torch, cell, pool, sched, arrivals,
                               args.seconds, False)
        book = win["book"]
        print(json.dumps({
            "rate": rate, **serve.end_to_end(book, win["t_end"]),
            **serve.stats(book, win["t_end"]),
            "offered_tok_s": sum(a.max_new for a in arrivals) / args.seconds,
            "rounds": pool.stats["rounds"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
