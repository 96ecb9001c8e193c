"""Serving launcher: initialise a model from a seed, serve a synthetic request
stream through the engine, report what it took.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --requests 8 --prompt-len 512 --max-new 16 --max-len 640
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-14b-smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch paligemma-3b-smoke --device cpu
    PYTHONPATH=src torchrun --nproc_per_node 4 -m repro_torch.launch.serve \
        --arch internlm2-1.8b-smoke --mesh 2x2 --device cpu

The port of ``repro.launch.serve``.  ``--mesh DxM`` is a (data, model)
``DeviceMesh`` over ``torchrun``'s ranks, as ``launch.train`` makes it;
the parameters are laid out on it by ``sharding.SERVE_RULES``, ``1x1``
included, and the engine's batches and cache live on it replicated (see
``serve.engine``).  Without ``--mesh`` the launcher serves in one process
on one device with plain tensors: DTensor's dispatch on the host makes a
one-device mesh's serve about three times slower and buys no sharding.
``--ckpt-dir`` restores the parameters of the latest checkpoint there (as
``launch.train`` writes it, from any mesh) onto the mesh, or onto the
device, in the launcher's own parameters' dtype: a bfloat16 training
checkpoint serves in float32 for a ``-smoke`` config.  ``main`` returns
its numbers as well as printing the ``[serve]`` line (rank 0).

Requests are drawn from a generator seeded with 0, in the layout the
family's prefill takes for one sequence: ``--prompt-len`` ids; for audio
(K, prompt_len) codebook ids; for vlm ``{"patches", "tokens"}`` with
N(0, 1) patches (n_patches, vision_embed_dim) rounded to the parameter
dtype, as the reference's smoke batches make them.  ``--max-len`` must
hold the patches, the prompt and the new tokens.  ``new_tokens`` counts
every sampled id, K a frame for audio, as the reference's launcher counts
``o.size``; ``frames`` counts the positions generated.
"""
import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..kernels import ops
from ..models import get_model
from ..models.common import DTYPES
from ..serve import Engine, ServeConfig
from ..sharding import SERVE_RULES, tree_shardings
from ..sharding.context import distribute
from .mesh import init_process_group, make_mesh, parse_mesh

__all__ = ["main", "requests"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def requests(cfg, n: int, prompt_len: int) -> list:
    """``n`` synthetic requests of ``prompt_len`` positions of text for
    ``cfg``'s family, drawn from a numpy generator seeded with 0."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        if cfg.family == "audio":
            out.append(rng.integers(0, cfg.vocab_size,
                                    (cfg.n_codebooks, prompt_len)
                                    ).astype(np.int32))
            continue
        tokens = rng.integers(0, cfg.vocab_size, prompt_len).astype(np.int32)
        if cfg.family != "vlm":
            out.append(tokens)
            continue
        patches = rng.standard_normal((cfg.n_patches, cfg.vision_embed_dim),
                                      dtype=np.float32)
        rounded = torch.from_numpy(patches).to(DTYPES[cfg.dtype]).float()
        out.append({"patches": rounded.numpy(), "tokens": tokens})
    return out


def main(argv=None) -> dict:
    """Serve and return ``{"arch", "device", "requests", "new_tokens",
    "frames", "wall_s", "tok_per_s", "prefill_s", "decode_s", "launches",
    "outputs", "engine", "mesh"}``; ``launches`` counts each model-kernel
    wrapper's calls during the serve; ``mesh`` is None without
    ``--mesh``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model mesh shape; D*M ranks "
                         "(default: one device, no mesh)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore params from a training checkpoint")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default=None,
                    help="parameter dtype (default: float32 for -smoke "
                         "configs, else the config's)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    default = "float32" if cfg.name.endswith("-smoke") else cfg.dtype
    cfg = cfg.replace(dtype=args.dtype or default)
    need = cfg.n_patches + args.prompt_len + args.max_new
    if args.max_len < need:
        raise ValueError(f"--max-len {args.max_len} holds less than "
                         f"{cfg.n_patches} patches + {args.prompt_len} "
                         f"prompt + {args.max_new} new positions ({need})")
    mesh = None
    if args.mesh is not None:
        d, m = parse_mesh(args.mesh)
        device_type = torch.device(args.device).type
        init_process_group(device_type, d * m)
        mesh = make_mesh((d, m), ("data", "model"), device_type)
    model = get_model(cfg)
    params = model.init(seed=0, device=args.device)
    shardings = None if mesh is None else tree_shardings(
        params, model.param_specs(), SERVE_RULES, mesh)
    if args.ckpt_dir:
        state, _ = Checkpointer(args.ckpt_dir).restore(
            {"params": params},
            shardings=None if mesh is None else {"params": shardings})
        params = state["params"]
    elif shardings is not None:
        params = distribute(params, shardings)
    eng = Engine(model, params, ServeConfig(
        max_len=args.max_len, slots=args.slots, device=args.device))
    reqs = requests(cfg, args.requests, args.prompt_len)

    before = {fn.__name__: fn.launches for fn in ops.LLM_WRAPPERS}
    _sync(eng.device)
    t0 = time.perf_counter()
    outs = eng.serve(reqs, max_new=args.max_new)
    _sync(eng.device)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches - before[fn.__name__]
                for fn in ops.LLM_WRAPPERS}
    toks = sum(o.size for o in outs)
    frames = sum(o.shape[0] for o in outs)
    if mesh is None or dist.get_rank() == 0:
        print(f"[serve] arch={cfg.name} mesh={args.mesh} "
              f"device={eng.device} dtype={cfg.dtype} "
              f"requests={len(reqs)} new_tokens={toks} frames={frames} "
              f"wall={wall:.2f}s throughput={toks / wall:.1f} tok/s "
              f"prefill={eng.stats['prefill_s']:.3f}s "
              f"decode={eng.stats['decode_s']:.3f}s launches={launches}")
    return {"arch": cfg.name, "device": str(eng.device),
            "requests": reqs, "new_tokens": toks, "frames": frames,
            "wall_s": wall,
            "tok_per_s": toks / wall, "prefill_s": eng.stats["prefill_s"],
            "decode_s": eng.stats["decode_s"], "launches": launches,
            "outputs": outs, "engine": eng, "mesh": mesh}


if __name__ == "__main__":
    main()
