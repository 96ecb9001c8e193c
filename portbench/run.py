#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 portbench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Set-up makes the weights on the device from the seed, builds the program
(the port, ``repro_torch``) and warms the cell's own shapes; the window
then runs for ``--seconds``.  With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
``torch.profiler`` session over the window.  Once the window has closed,
the peak memory is read, the program's state is freed and the plain
reference judges what the window produced (``harness.checks``); each
number compared is printed beside its limit, last on standard error and
last in the line.  No card, fewer cards than the cell asks for, or the JAX
package (or JAX) loaded in this process: no result, and a nonzero exit.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness.env import BENCH, forbidden_modules, prepare  # noqa: E402

prepare()


def _reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _p95(values) -> float:
    """Nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def _serve(cell, seed, seconds, tracer, device, fault, control):
    import torch
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Engine, ServeConfig

    from harness import serving
    from harness.spec import port_config
    from harness.weights import make_params

    t, s = cell.traffic, cell.shape
    model = get_model(port_config(s))
    if fault == "unchanged":
        model = serving.UnchangedStepModel(model)
    engine = Engine(model, make_params(s, seed, device),
                    ServeConfig(max_len=int(t["max_len"]),
                                slots=int(t["slots"]), device=device))
    sampler = serving.Sampler(engine, tracer, time.perf_counter, fault)
    closed = t["loop"] == "closed"
    serving.warm_up(engine, sampler, t["prompt_lengths"],
                    int(t["wave_size"]) if closed else 1, s.vocab)
    _sync(device)
    setup_s = time.perf_counter() - T_START
    tracer.start()
    if closed:
        res = serving.run_closed(engine, sampler, t, seed, seconds, s.vocab)
    else:
        res = serving.run_open(engine, sampler, t, seed, seconds, s.vocab)
    trace = tracer.stop(res.run_s)
    e2e = {"setup_s": setup_s}
    if closed:
        e2e["gen_tok_s"] = res.tokens / res.window_s
    else:
        e2e["ttft_p95_s"] = _p95(res.ttft.values())
    peak = _peak(device)
    del engine, sampler, model
    _free(device)

    def check():
        from harness.checks import sample_requests, serve_gaps
        picked = sample_requests(res.finished, seed,
                                 int(t["check_requests"]))
        if not picked:
            return {"logit_gap": float("inf")}
        return serve_gaps(s, seed, res.finished, picked, device, control)

    return res, trace, e2e, peak, check


def _train(cell, seed, seconds, tracer, device, fault, control):
    from harness.training import Trainer
    from harness.traffic import train_rows

    t, s = cell.traffic, cell.shape
    trainer = Trainer(s, t, seed, device, fault)
    readings = trainer.checked_steps()
    _sync(device)
    setup_s = time.perf_counter() - T_START
    tracer.start()
    res = trainer.window(seconds, tracer)
    trace = tracer.stop(res.window_s)
    e2e = {"setup_s": setup_s, "train_tok_s": res.tokens / res.window_s}
    peak = _peak(device)
    del trainer
    _free(device)

    def check():
        from harness.checks import train_numbers
        from reference.dense import train_readings
        k = int(t["checked_steps"])
        args = (s, seed, [train_rows(t, seed, i, s.vocab) for i in range(k)],
                t["optimizer"], device)
        mb = int(t["global_batch"]) // int(t["microbatches"])
        ref = train_readings(*args, microbatch=mb)
        out = train_numbers(readings, ref)
        if control:
            low = train_readings(*args, microbatch=mb, fp8=True)
            out.update({f"control_{k}": v for k, v in
                        train_numbers(low, ref).items()})
        return out

    return res, trace, e2e, peak, check


def _sync(device) -> None:
    """Wait for the device, then move every object set-up made out of the
    collector's way (``gc.freeze``, as servers do once started), so the
    window's collections scan only what the window makes."""
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()


def _peak(device) -> int:
    import torch
    if str(device).startswith("cuda"):
        return int(torch.cuda.max_memory_allocated())
    return 0


def _free(device) -> None:
    """Free the program's state: what set-up made goes back to the
    collector (``gc.unfreeze``), so cycles among it (the engine and its
    wrapped sampling) are collected too, and the device's cache is
    emptied."""
    import torch
    gc.unfreeze()
    gc.collect()
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             fault=None, control: bool = False) -> dict:
    """One run of ``cell`` -> the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
    ``checks`` last).  ``fault`` plants a fault underneath the timed path
    (serving: ``token``, ``unchanged``; training: ``unchanged``,
    ``half_batch``);
    ``control`` adds the control's readings (``control_<number>``: the
    reference in float8 put in the program's place), which no limit
    holds."""
    import torch

    from harness.checks import judge
    from harness.readers import RunView
    from harness.trace import Tracer

    tracer = Tracer(trace)
    run = {"serve": _serve, "train": _train}[cell.traffic["kind"]]
    res, dtrace, e2e, peak, check = run(cell, seed, seconds, tracer,
                                        device, fault, control)
    if trace:
        view = RunView(cell, cell.shape, dtrace, res)
        metrics = {}
        for m in cell.per_layer:
            value = _reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    t_check = time.perf_counter()
    numbers = check()
    print(f"portbench: setup_s {e2e['setup_s']:.3f} window_s "
          f"{res.window_s:.3f} check_s {time.perf_counter() - t_check:.3f} "
          f"attempted {res.attempted} waves {getattr(res, 'waves', '-')} "
          f"tokens {res.tokens}", file=sys.stderr)
    ok, table = judge({k: v for k, v in numbers.items()
                       if not k.startswith("control_")}, cell.limits)
    table.update({k: {"value": v, "limit": None}
                  for k, v in numbers.items() if k.startswith("control_")})
    kind = torch.cuda.get_device_name(0) if str(device).startswith("cuda") \
        else str(device)
    dev = {"platform": "gpu" if str(device).startswith("cuda") else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(ok and res.failed == 0 and res.attempted > 0),
           "attempted": res.attempted, "failed": res.failed,
           "metrics": metrics, "device": dev}
    if trace and dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        out["breakdown"] = {"device_ops": dtrace.top_ops(),
                            "idle_gaps": dtrace.idle_gaps()}
    out["checks"] = table
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found {found}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}: JAX or the JAX "
              f"package may not run here", file=sys.stderr)
        return 3
    for name, row in out["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
