"""Multi-device dry run on a fake process group.

The port of ``repro.launch.dryrun``.  For every (architecture x input
shape) cell and mesh:

  * build the step function the shape implies (``make_train_step``,
    ``prefill`` or ``decode_step``) with the reference's runtime knobs
    (remat, microbatching, chunked attention);
  * lay every input out as DTensors by the divisibility-aware rules: the
    parameters, optimizer state and batch by ``TRAIN_RULES`` or
    ``SERVE_RULES``, a decode step's cache by the same rules but never
    along its sequence (the step writes one position of it in place);
  * run the step under ``activation_sharding`` on ``meta`` tensors (shapes
    and dtypes, no storage) and count what it runs on this rank's shards
    with ``analysis.trace.StepTrace``: success proves the distribution
    coherent, and a failure is a bug, recorded in the cell's record;
  * write memory, cost and collectives to
    ``<out>/<mesh>/<arch>__<shape>.json`` for the roofline report
    (``analysis/report.py``).

The counterpart of the reference's ``--xla_force_host_platform_device_count``
is a ``fake`` process group of ``REPRO_DRYRUN_DEVICES`` ranks (512 unless
set) in this one process (``torch.testing._internal.distributed.fake_pg``):
the process is rank 0 of it, and its collectives return at once.  Meshes are
on the CPU device type, so no card is needed; there DTensor moves a shard
from one tensor dimension to another by an all-gather and a local chunk,
where a CUDA mesh exchanges it all-to-all (each record's ``device_type``).
The tensors are ``meta`` tensors rather than ``FakeTensorMode``'s: DTensor's
arithmetic for strided shards reads index tensors back, which a fake mode
refuses.  The model kernels' wrappers take their plain versions on
``meta``, so a prefill counts the plain attention's FLOPs.

A train step runs its microbatches one by one (the reference scans them).
Its costs are affine in their count, so a cell of more than three is run at
two and at three microbatches' sequences and its ``cost`` and
``collectives`` extrapolated, T(n) = T(3) + (n - 3) (T(3) - T(2)); its
``memory`` is the three-microbatch run's, with the whole batch among its
arguments.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch qwen3-14b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --skip-existing
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["run_cell", "cells_for", "pick_microbatches", "build_cell",
           "init_fake_group", "make_mesh", "make_production_mesh", "main"]

SKIP_LONG_FULL_ATTN = "long_500k needs sub-quadratic attention; pure " \
    "full-attention arch — skipped per assignment (see DESIGN.md §4)"


def init_fake_group(devices: int | None = None) -> int:
    """Start a ``fake`` process group of ``devices`` ranks (default
    ``REPRO_DRYRUN_DEVICES``, else 512) with this process as rank 0, if no
    group is running; returns the group's size."""
    if dist.is_initialized():
        return dist.get_world_size()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = devices or int(os.environ.get("REPRO_DRYRUN_DEVICES") or 512)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return n


def make_mesh(shape, axes):
    """A CPU ``DeviceMesh`` of ``shape`` named ``axes`` over the first
    ranks of the fake group (started here if need be)."""
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    world = init_fake_group(n)
    if n > world:
        raise ValueError(f"a mesh of shape {tuple(shape)} holds {n} devices; "
                         f"the process group has {world} "
                         f"(REPRO_DRYRUN_DEVICES)")
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production meshes: (16, 16) or (2, 16, 16)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def cells_for(arch_names, shape_names):
    """Yield runnable (arch, shape) cells, honoring the long_500k rule."""
    from ..configs import get_config, shape_for

    for a in arch_names:
        cfg = get_config(a)
        for s in shape_names:
            shape_for(s)
            if s == "long_500k" and not cfg.subquadratic:
                yield (a, s, SKIP_LONG_FULL_ATTN)
                continue
            yield (a, s, None)


def pick_microbatches(cfg, shape, mesh) -> int:
    """Gradient-accumulation factor for the train cells: target ~1 sequence
    per data shard per microbatch for wide models (bounds activation + MoE
    dispatch memory), 4 for narrow ones."""
    from ..sharding.specs import axis_sizes

    sizes = axis_sizes(mesh)
    data_shards = sizes.get("data", 1) * sizes.get("pod", 1)
    per_dev = max(shape.global_batch // data_shards, 1)
    target = 1 if (cfg.d_model >= 4096 or cfg.family == "moe") else 4
    mb = max(per_dev // target, 1)
    while shape.global_batch % mb != 0:
        mb -= 1
    return max(mb, 1)


def _layout(tree, logical, rules, mesh):
    """A tree of ``meta`` tensors as DTensors laid out by ``rules``."""
    from ..sharding import tree_shardings
    from ..sharding.context import distribute

    return distribute(tree, tree_shardings(tree, logical, rules, mesh))


def _batch_logical(batch_shapes):
    """Logical axes for each input tensor of the batch."""
    return {name: ("batch",) + ("",) * (t.dim() - 1)
            for name, t in batch_shapes.items()}


def _cache_rules(rules):
    """``rules`` with the cache's sequence never split: a decode step
    writes one position of it in place."""
    return dataclasses.replace(rules, name=rules.name + "-cache",
                               mapping={**rules.mapping, "kv_seq": ()})


def build_cell(arch: str, shape_name: str, mesh, runtime=None,
               overrides: dict | None = None, sequences: int | None = None):
    """Returns (step_fn, example_args as DTensors of meta tensors, meta).

    ``overrides`` (perf-iteration knobs, as the reference's):
      rules         — replace the Rules object (sharding layout variants)
      microbatches  — grad-accumulation factor for train cells
      runtime       — models.Runtime (remat / q_chunk / moe_impl)
      cache_dtype   — the decode cache's dtype for its bfloat16 leaves
      no_donate     — a decode step writes a copy of the cache
    ``sequences`` replaces the batch's sequence count (the microbatch
    extrapolation of ``run_cell``)."""
    overrides = overrides or {}
    from ..configs import get_config, shape_for
    from ..models import Runtime, get_model
    from ..sharding import SERVE_RULES, TRAIN_RULES
    from ..sharding.context import activation_sharding
    from ..train.optimizer import OptConfig, init_opt_state, opt_state_specs
    from ..train.train_loop import TrainConfig, make_train_step

    cfg = get_config(arch)
    shape = shape_for(shape_name)
    model = get_model(cfg)
    meta = {"arch": arch, "shape": shape_name, "kind": shape.kind}

    def _ctx(fn, rules):
        """Run the step under the activation-sharding context so the
        models' constrain() calls anchor batch/vocab/expert layouts."""
        def wrapped(*a, **k):
            with activation_sharding(mesh, rules):
                return fn(*a, **k)
        return wrapped

    bshapes = model.input_specs(shape)
    if sequences is not None:
        bshapes = {name: torch.empty((sequences,) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device="meta")
                   for name, t in bshapes.items()}

    if shape.kind == "train":
        rules = overrides.get("rules", TRAIN_RULES)
        mb = overrides.get("microbatches") or pick_microbatches(cfg, shape,
                                                                mesh)
        meta["microbatches"] = mb
        rt = overrides.get("runtime") or runtime or Runtime(q_chunk=1024,
                                                            remat="full")
        oc = OptConfig(master_f32=True)
        tc = TrainConfig(opt=oc, microbatches=mb, runtime=rt)
        step = _ctx(make_train_step(model, tc), rules)
        pshapes = model.param_shapes()
        plogical = model.param_specs()
        ostate = init_opt_state(pshapes, oc)
        ological = opt_state_specs(plogical, oc,
                                   has_master="master" in ostate)
        state_in = _layout({"params": pshapes, "opt": ostate},
                           {"params": plogical, "opt": ological}, rules, mesh)
        batch_in = _layout(bshapes, _batch_logical(bshapes), rules, mesh)
        return step, (state_in, batch_in), meta

    rules = overrides.get("rules", SERVE_RULES)
    rt = overrides.get("runtime") or runtime or Runtime(q_chunk=1024)
    params_in = _layout(model.param_shapes(), model.param_specs(), rules,
                        mesh)
    batch_in = _layout(bshapes, _batch_logical(bshapes), rules, mesh)
    if shape.kind == "prefill":
        step = _ctx(lambda p, b: model.prefill(p, b, max_len=shape.seq_len,
                                               rt=rt), rules)
        return step, (params_in, batch_in), meta

    # decode / long-context decode: one new token against a filled cache
    cache = model.cache_input_specs(shape)
    cache.pop("len")
    if overrides.get("cache_dtype"):
        dt = getattr(torch, overrides["cache_dtype"])
        cache = {name: t.to(dt) if t.dtype == torch.bfloat16 else t
                 for name, t in cache.items()}
    logical = {name: axes for name, axes in model.cache_specs().items()
               if name in cache}
    cache_in = _layout(cache, logical, _cache_rules(rules), mesh)
    cache_in["len"] = shape.seq_len - 1
    copy = bool(overrides.get("no_donate"))

    def decode(p, b, c):
        if copy:
            c = {name: t if name == "len" else t.clone()
                 for name, t in c.items()}
        return model.decode_step(p, b, c, rt=rt)

    return _ctx(decode, rules), (params_in, batch_in, cache_in), meta


def _leaves(tree) -> list:
    """The local tensors of a tree's tensors (DTensors' shards)."""
    from ..analysis.trace import _tensors

    return [getattr(t, "_local_tensor", t) for t in _tensors(tree)]


def _bytes_by_storage(leaves) -> dict:
    """{storage: bytes of the leaves on it} (views of one storage once)."""
    out = {}
    for t in leaves:
        key = t.untyped_storage()._cdata
        out[key] = max(out.get(key, 0), t.numel() * t.element_size())
    return out


def _trace(step, args) -> dict:
    """Run ``step(*args)`` under ``StepTrace``: its memory (one device,
    the reference's keys), cost and collectives."""
    from ..analysis.trace import StepTrace

    inputs = _bytes_by_storage(_leaves(args))
    t0 = time.perf_counter()
    with torch.no_grad(), StepTrace() as tr:
        out = step(*args)
    seconds = time.perf_counter() - t0
    outputs = _bytes_by_storage(_leaves(out))
    alias = sum(n for key, n in outputs.items() if key in inputs)
    new = sum(outputs.values()) - alias
    memory = {"argument_bytes": sum(inputs.values()),
              "output_bytes": sum(outputs.values()),
              "temp_bytes": max(tr.peak_live_bytes - new, 0),
              "alias_bytes": alias}
    return {"memory": memory, "flops": tr.dot_flops,
            "bytes": tr.bytes_accessed, "collectives": tr.collectives,
            "seconds": seconds}


def _extrapolate(t2: dict, t3: dict, n: int) -> dict:
    """A train step's counts at ``n`` microbatches from its runs at two and
    three: T(3) + (n - 3) (T(3) - T(2))."""
    from ..analysis.hlo import CollectiveStats

    def at(a, b):
        return b + (n - 3) * (b - a)

    c2, c3 = t2["collectives"], t3["collectives"]
    stats = CollectiveStats()
    for op in sorted(set(c2.count_by_op) | set(c3.count_by_op)):
        stats.bytes_by_op[op] = at(c2.bytes_by_op.get(op, 0),
                                   c3.bytes_by_op.get(op, 0))
        stats.count_by_op[op] = at(c2.count_by_op.get(op, 0),
                                   c3.count_by_op.get(op, 0))
    return {"memory": dict(t3["memory"]), "flops": at(t2["flops"],
                                                      t3["flops"]),
            "bytes": at(t2["bytes"], t3["bytes"]), "collectives": stats,
            "seconds": t2["seconds"] + t3["seconds"]}


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str,
             overrides: dict | None = None) -> dict:
    """Build and trace one cell; return the artifact dict (a failure is
    recorded in it, not raised)."""
    from ..analysis.trace import tensor_bytes
    from ..configs import shape_for

    t0 = time.time()
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "devices": int(mesh.size()), "device_type": mesh.device_type,
              "ok": False}
    try:
        step, args, meta = build_cell(arch, shape_name, mesh,
                                      overrides=overrides)
        record.update(meta)
        t_build = time.time()
        mb = meta.get("microbatches", 1)
        if mb > 3:
            per = shape_for(shape_name).global_batch // mb
            runs = []
            for n in (2, 3):
                s_n, a_n, _ = build_cell(
                    arch, shape_name, mesh, sequences=per * n,
                    overrides={**(overrides or {}), "microbatches": n})
                runs.append(_trace(s_n, a_n))
            traced = _extrapolate(runs[0], runs[1], mb)
            memory = traced["memory"]
            memory["argument_bytes"] = tensor_bytes(args)
            record["traced_microbatches"] = [2, 3]
        else:
            traced = _trace(step, args)
            memory = traced["memory"]
        memory["peak_estimate_bytes"] = (memory["argument_bytes"]
                                         + memory["output_bytes"]
                                         + memory["temp_bytes"]
                                         - memory["alias_bytes"])
        record["memory"] = memory
        record["cost"] = {"flops": float(traced["flops"]),
                          "bytes accessed": float(traced["bytes"])}
        record["collectives"] = traced["collectives"].to_json()
        record["timings"] = {"build_s": round(t_build - t0, 2),
                             "trace_s": round(traced["seconds"], 2)}
        record["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, don't die
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_s"] = round(time.time() - t0, 2)
    return record


def main(argv=None) -> int:
    from ..configs import ARCHS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="arch id (repeatable); default: all")
    ap.add_argument("--shape", action="append", default=None,
                    help="shape name (repeatable); default: all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="all archs x shapes x both meshes")
    args = ap.parse_args(argv)

    archs = args.arch or sorted(ARCHS)
    shapes = args.shape or list(SHAPES)
    meshes = ["single", "multi"] if (args.mesh == "both" or args.all) \
        else [args.mesh]

    failures = 0
    for mesh_name in meshes:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
        out_dir = os.path.join(args.out, mesh_name)
        os.makedirs(out_dir, exist_ok=True)
        for arch, shape, skip in cells_for(archs, shapes):
            path = os.path.join(out_dir, f"{arch}__{shape}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip-existing] {mesh_name}/{arch}/{shape}")
                continue
            if skip is not None:
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape,
                               "mesh": mesh_name, "skipped": skip,
                               "ok": True}, f, indent=1)
                print(f"[skipped] {mesh_name}/{arch}/{shape}: long_500k rule")
                continue
            print(f"[run] {mesh_name}/{arch}/{shape} ...", flush=True)
            rec = run_cell(arch, shape, mesh, mesh_name)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            status = "OK" if rec["ok"] else f"FAIL ({rec.get('error')})"
            print(f"  -> {status} in {rec['total_s']}s "
                  f"(trace {rec.get('timings', {}).get('trace_s', '-')}s)",
                  flush=True)
            failures += 0 if rec["ok"] else 1
    print(f"done; failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
