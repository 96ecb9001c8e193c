"""Serving launcher: initialise a model from a seed, serve a synthetic request
stream through the engine, report what it took.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
        --requests 8 --prompt-len 512 --max-new 16 --max-len 640
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch qwen3-14b-smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch paligemma-3b-smoke --device cpu

The port of ``repro.launch.serve`` on one card: ``--mesh`` takes only
``1x1`` (``sharding/`` is not ported).  ``--ckpt-dir`` restores the
parameters of the latest checkpoint there (as ``launch.train`` writes it)
into the launcher's own seed-0 parameters, in their dtype: a bfloat16
training checkpoint serves in float32 for a ``-smoke`` config.  ``main``
returns its numbers as well as printing the ``[serve]`` line.

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

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..kernels import ops
from ..models import get_model
from ..models.common import DTYPES
from ..serve import Engine, ServeConfig

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
    "outputs", "engine"}``; ``launches`` counts each model-kernel
    wrapper's calls during the serve."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b-smoke")
    ap.add_argument("--mesh", default="1x1")
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
    if args.mesh != "1x1":
        raise NotImplementedError(f"--mesh {args.mesh}: sharding/ is not "
                                  f"ported; the port serves on one card "
                                  f"(1x1)")

    cfg = get_config(args.arch)
    default = "float32" if cfg.name.endswith("-smoke") else cfg.dtype
    cfg = cfg.replace(dtype=args.dtype or default)
    need = cfg.n_patches + args.prompt_len + args.max_new
    if args.max_len < need:
        raise ValueError(f"--max-len {args.max_len} holds less than "
                         f"{cfg.n_patches} patches + {args.prompt_len} "
                         f"prompt + {args.max_new} new positions ({need})")
    model = get_model(cfg)
    params = model.init(seed=0, device=args.device)
    if args.ckpt_dir:
        state, _ = Checkpointer(args.ckpt_dir).restore({"params": params})
        params = state["params"]
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
    print(f"[serve] arch={cfg.name} mesh={args.mesh} device={eng.device} "
          f"dtype={cfg.dtype} requests={len(reqs)} new_tokens={toks} "
          f"frames={frames} "
          f"wall={wall:.2f}s throughput={toks / wall:.1f} tok/s "
          f"prefill={eng.stats['prefill_s']:.3f}s "
          f"decode={eng.stats['decode_s']:.3f}s launches={launches}")
    return {"arch": cfg.name, "device": str(eng.device),
            "requests": reqs, "new_tokens": toks, "frames": frames,
            "wall_s": wall,
            "tok_per_s": toks / wall, "prefill_s": eng.stats["prefill_s"],
            "decode_s": eng.stats["decode_s"], "launches": launches,
            "outputs": outs, "engine": eng}


if __name__ == "__main__":
    main()
