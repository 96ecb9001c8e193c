#!/usr/bin/env python3
"""Find the highest arrival rate an open-loop serving cell sustains: one
process, one set-up, then the cell's window at each rate in turn.

    python3 portbench/tools/sweep.py --workload qwen3-14b.docqa \\
        --seed 7 --seconds 40 --rates 1.5 2 2.5 3

For each rate it prints the time to first token (median, 95th percentile,
largest), how long the requests still waiting at the window's end took to
drain, and the waves' mean size.  A rate is sustained while the drain stays
within about one wave's time and the later half of the requests waits
no longer than the earlier half (a backlog that grows through the window
makes the later half wait longer).
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness.env import prepare  # noqa: E402

prepare()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=40)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[],
                    help="more seeds to run at each rate after --seed")
    ap.add_argument("--detail", action="store_true",
                    help="print every request's length and time to first "
                         "token")
    args = ap.parse_args()

    import torch
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Engine, ServeConfig

    from harness import serving
    from harness.spec import load_cell, port_config
    from harness.trace import Tracer
    from harness.weights import make_params

    cell = load_cell(args.workload)
    t, s = dict(cell.traffic), cell.shape
    engine = Engine(get_model(port_config(s)),
                    make_params(s, args.seed, "cuda"),
                    ServeConfig(max_len=int(t["max_len"]),
                                slots=int(t["slots"]), device="cuda"))
    sampler = serving.Sampler(engine, Tracer(False), time.perf_counter)
    serving.warm_up(engine, sampler, t["prompt_lengths"], 1, s.vocab)
    torch.cuda.synchronize()
    for rate, seed in [(r, sd) for r in args.rates
                       for sd in [args.seed] + args.seeds]:
        t["rate_per_s"] = rate
        sampler.log = []
        t0 = time.perf_counter()
        res = serving.run_open(engine, sampler, t, seed, args.seconds,
                               s.vocab)
        inside = [(n, w, k) for at, n, w, k in sampler.log
                  if at - t0 <= args.seconds]
        v = sorted(res.ttft.values())
        order = [res.ttft[i] for i in sorted(res.ttft)]
        half = len(order) // 2
        late = sum(i / rate + res.ttft[i] > args.seconds for i in res.ttft)
        row = {"rate_per_s": rate, "seed": seed, "requests": len(v),
               "ttft_mean_first_half_s": statistics.mean(order[:half]),
               "ttft_mean_second_half_s": statistics.mean(order[half:]),
               "first_token_after_window": late,
               "ttft_p50_s": statistics.median(v),
               "ttft_p95_s": v[max(-(-95 * len(v) // 100) - 1, 0)],
               "ttft_max_s": v[-1],
               "drain_s": res.window_s - args.seconds,
               "waves": res.waves,
               "mean_wave": len(v) / res.waves,
               "prefill_s": res.stats["prefill_s"],
               "decode_s": res.stats["decode_s"],
               # ids that reached the host inside the window, over it (the
               # decode-throughput reading of an open-loop window), and the
               # prefills that took part of the window
               "ids_in_window_per_s": sum(n for n, _, _ in inside)
               / args.seconds,
               "prefills_in_window": sum(k == 0 for _, _, k in inside),
               "prefill_positions_in_window": sum(w[0] * w[1]
                                                  for _, w, k in inside
                                                  if k == 0)}
        if args.detail:
            lengths = {r.index: r.length for r in serving.open_schedule(
                t, seed, args.seconds)}
            row["requests_detail"] = [[i, lengths[i], res.ttft[i]]
                                      for i in sorted(res.ttft)]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
