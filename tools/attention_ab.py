"""Time two versions of the f32 CUDA-core attention kernel side by side.

Run from the root of a checkout on a machine with one NVIDIA H100:

    git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu \\
        > build/ab/flash_attention_old.cu
    python3 tools/attention_ab.py build/ab/flash_attention_old.cu

The older source and the checkout's ``csrc/flash_attention.cu`` are each
compiled alone with ``nvcc`` (the flags of ``kernels/_build.py``) into a
library of their own, and run on the card at B 4, Hq 40, Hkv 8, S 512,
d 128, causal, float32, in the order old, new, new, old.  Each is first held
to ``flash_attention_plain`` within rtol = atol = 2e-5, then timed by CUDA
events (median of ``--reps`` calls) and by ``torch.profiler``'s device time
(``chip_smoke.device_ms``, all four in one session), with
``scaled_dot_product_attention`` in float32 beside them.  The card's name
and power limit come first; the numbers also go to ``--out`` as JSON.  An
older entry point without the row-width argument is called without it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_plain  # noqa: E402

NEW = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
SHAPE = dict(b=4, hq=40, hkv=8, s=512, d=128)
TOL = 2e-5


def build(src: Path, out: Path) -> tuple[ctypes.CDLL, bool, str]:
    """``src`` compiled alone into ``out``; the library, whether its entry
    point takes the row width, and ptxas's report."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    takes_ld = re.search(r"int d,\s*int ld,", src.read_text()) is not None
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = (p,) * 4 + (i,) * (8 if takes_ld
                                                        else 7) + (p,)
    lib.flash_attention_fwd.restype = i
    return lib, takes_ld, proc.stdout + proc.stderr


def launcher(lib, takes_ld: bool, q, k, v, out):
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    dims = (b, hq, hkv, s, s, d) + ((d,) if takes_ld else ()) + (1,)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                      v.data_ptr(), out.data_ptr(), *dims,
                                      stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
        return out
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, help="the older flash_attention.cu")
    ap.add_argument("--reps", type=int, default=chip_smoke.REPS)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build/ab/attention_ab.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[ab] {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    work = ROOT / "build/ab"
    work.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("old", "new"), pool.map(
            build, (args.old, NEW),
            (work / "libfa_old.so", work / "libfa_new.so"))))
    for name, (_, takes_ld, log) in built.items():
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        print(f"[ab] {name}: row-width argument {takes_ld}; ptxas "
              + " | ".join(ptxas))

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, hq, hkv, s, d = (SHAPE[x] for x in ("b", "hq", "hkv", "s", "d"))
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda")
            for _ in range(2))
    want = flash_attention_plain(q, k, v, True)
    runs, errs = {}, {}
    for name, (lib, takes_ld, _) in built.items():
        out = torch.empty_like(q)
        runs[name] = launcher(lib, takes_ld, q, k, v, out)
        got = runs[name]()
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise RuntimeError(f"{name}: max_abs_err {errs[name]} beyond "
                               f"rtol = atol = {TOL}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    order = ("old", "new", "new", "old")
    event = [chip_smoke.event_ms(runs[name], args.reps) for name in order]
    dev = chip_smoke.device_ms(
        {f"{name}{i}": (runs[name], 1) for i, name in enumerate(order)}
        | {"sdpa": (sdpa, None)}, args.reps)
    device = [dev[f"{name}{i}"] for i, name in enumerate(order)]
    sdpa_ev = chip_smoke.event_ms(sdpa, args.reps)
    nbytes, n_ops = chip_smoke._attn_work(b, hq, hkv, s, d, 4, True)
    bound, by = chip_smoke.bound_ms(nbytes, n_ops)
    for name, ev, dv in zip(order, event, device):
        print(f"[ab] {name}: event_ms={ev:.4f} device_ms={dv:.4f} "
              f"({bound / dv:.3f} of the bound)")
    old_dev = (device[0] + device[3]) / 2
    new_dev = (device[1] + device[2]) / 2
    result = dict(card=smi, shape=SHAPE, order=order, event_ms=event,
                  device_ms=device, sdpa_event_ms=sdpa_ev,
                  sdpa_device_ms=dev["sdpa"], bound_ms=bound, bound_by=by,
                  max_abs_err=errs, speedup_device=old_dev / new_dev,
                  speedup_event=(event[0] + event[3]) / (event[1] + event[2]))
    print(f"[ab] sdpa f32: event_ms={sdpa_ev:.4f} device_ms="
          f"{dev['sdpa']:.4f}; bound_ms={bound:.6f} ({by}); new over old: "
          f"{result['speedup_device']:.3f}x device, "
          f"{result['speedup_event']:.3f}x events")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
