"""Time an older attention kernel against the checkout's, side by side.

Run from the root of a checkout on a machine with one NVIDIA H100:

    git show <rev>:src/repro_torch/kernels/csrc/flash_attention_wide.cu \\
        > build/ab/flash_attention_wide_old.cu
    python3 tools/attention_ab.py build/ab/flash_attention_wide_old.cu \\
        --entry flash_attention_wide_fwd --d 320 512 \\
        --dtype bfloat16 float32

The older source is compiled alone with ``nvcc`` (the flags of
``kernels/_build.py``) into a library of its own, and so is each source of
the checkout that ``flash_attention.kernel_for`` names for the dtypes
asked for.  For each head dim and dtype both run on the card at B 4,
Hq 40, Hkv 8, S 512, causal (``--full`` for full attention), on the same
inputs, their rows padded to ``flash_attention.row_width``, in the order
old, new, new, old.  Each is first held to ``flash_attention_plain``
(float32 rtol = atol = 2e-5; bfloat16 rtol 2**-7, atol 2**-8 max|v|), then
timed by CUDA events (median of ``--reps`` calls) and by
``torch.profiler``'s device time (``chip_smoke.device_ms``, all four and
``scaled_dot_product_attention`` in one session).  An entry point's
arguments are read by name from its declaration in the source (q, k, v,
o, b, hq, hkv, sq, sk, d, ld, causal, prefix_len (0), bf16, stream), so
an older entry point without the row width or the prefix, or with a dtype
flag, is called as it asks.
The card's name and power limit come first; the numbers also go to
``--out`` as JSON.
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
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402

SHAPE = dict(b=4, hq=40, hkv=8, s=512)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
POINTERS = ("q", "k", "v", "o", "stream")


def parameters(src: Path, entry: str) -> list[str]:
    """The parameter names of ``entry`` as its source declares it."""
    found = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src.read_text())
    if found is None:
        raise ValueError(f"{src} declares no entry point {entry}")
    return [p.split()[-1].lstrip("*") for p in found[1].split(",")]


def build(src: Path, out: Path, entry: str) -> tuple:
    """``src`` compiled alone into ``out``: the library's entry point, its
    parameter names and ptxas's report."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    names = parameters(src, entry)
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = [ctypes.c_void_p if n in POINTERS else ctypes.c_int
                   for n in names]
    fn.restype = ctypes.c_int
    return fn, names, proc.stdout + proc.stderr


def launcher(fn, names, q, k, v, out, d: int, causal: bool):
    """A call of ``fn`` on q, k, v (rows ld wide) writing ``out``."""
    b, s, hq, ld = q.shape
    values = dict(b=b, hq=hq, hkv=k.shape[2], sq=s, sk=s, d=d, ld=ld,
                  causal=int(causal), prefix_len=0,
                  bf16=int(q.dtype == torch.bfloat16))

    def run():
        ptrs = dict(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                    o=out.data_ptr(),
                    stream=torch.cuda.current_stream().cuda_stream)
        err = fn(*(ptrs[n] if n in ptrs else values[n] for n in names))
        if err:
            raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
        return out
    return run


def ab_case(built: dict, d: int, dtype: torch.dtype, causal: bool,
            reps: int) -> dict:
    """One head dim and dtype: both kernels held to the plain version, then
    timed old, new, new, old beside SDPA."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    b, hq, hkv, s = (SHAPE[x] for x in ("b", "hq", "hkv", "s"))
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    want = fa.flash_attention_plain(q, k, v, causal).float()
    ld = fa.row_width(dtype, d)
    qp, kp, vp = (F.pad(x, (0, ld - d)).contiguous() for x in (q, k, v))
    if dtype == torch.bfloat16:
        rtol, atol = 2 ** -7, 2 ** -8 * float(v.float().abs().max())
    else:
        rtol = atol = 2e-5
    runs, errs = {}, {}
    for name in ("old", "new"):
        fn, names = built[name][:2]
        out = torch.zeros_like(qp)
        runs[name] = launcher(fn, names, qp, kp, vp, out, d, causal)
        got = runs[name]()[..., :d].float()
        torch.cuda.synchronize()
        errs[name] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            raise RuntimeError(f"{name} d={d} {dtype}: max_abs_err "
                               f"{errs[name]} beyond rtol={rtol:g}, "
                               f"atol={atol:g}")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)

    order = ("old", "new", "new", "old")
    event = [chip_smoke.event_ms(runs[name], reps) for name in order]
    dev = chip_smoke.device_ms(
        {f"{name}{i}": (runs[name], 1) for i, name in enumerate(order)}
        | {"sdpa": (sdpa, None)}, reps)
    device = [dev[f"{name}{i}"] for i, name in enumerate(order)]
    nbytes, n_ops = chip_smoke._attn_work(b, hq, hkv, s, d, q.element_size(),
                                          causal)
    bound, by = chip_smoke.bound_ms(
        nbytes, n_ops, chip_smoke.BF16_OPS_PER_S if dtype == torch.bfloat16
        else chip_smoke.FP32_OPS_PER_S)
    old_dev, new_dev = (device[0] + device[3]) / 2, (device[1] + device[2]) / 2
    return dict(d=d, dtype=str(dtype).split(".")[-1],
                causal=causal, order=order, event_ms=event, device_ms=device,
                sdpa_event_ms=chip_smoke.event_ms(sdpa, reps),
                sdpa_device_ms=dev["sdpa"], bound_ms=bound, bound_by=by,
                bound_share_new=bound / new_dev, max_abs_err=errs,
                speedup_device=old_dev / new_dev,
                speedup_event=(event[0] + event[3]) / (event[1] + event[2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, help="the older attention source")
    ap.add_argument("--entry", default="flash_attention_fwd",
                    help="the older source's C entry point")
    ap.add_argument("--d", type=int, nargs="+", default=[128],
                    help="head dims")
    ap.add_argument("--dtype", nargs="+", default=["float32"],
                    choices=sorted(DTYPES))
    ap.add_argument("--full", action="store_true",
                    help="full attention instead of causal")
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
    routes = {dt: fa.kernel_for(DTYPES[dt], 0) for dt in args.dtype}
    jobs = {"old": (args.old, args.entry)} | {
        route: (ROOT / "src/repro_torch/kernels" / fa.SOURCES[route],
                fa._ENTRIES[route]) for route in set(routes.values())}
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(
            lambda item: build(item[1][0], work / f"libab_{item[0]}.so",
                               item[1][1]), jobs.items())))
    for name, (_, names, log) in done.items():
        ptxas = [line.strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
        print(f"[ab] {name} ({jobs[name][0].name} {jobs[name][1]}"
              f"({', '.join(names)})): ptxas " + " | ".join(ptxas))

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for dt in args.dtype:
        for d in args.d:
            case = ab_case({"old": done["old"], "new": done[routes[dt]]}, d,
                           DTYPES[dt], not args.full, args.reps)
            cases.append(case)
            for name, ev, dv in zip(case["order"], case["event_ms"],
                                    case["device_ms"]):
                print(f"[ab] d={d} {dt} {name}: event_ms={ev:.4f} "
                      f"device_ms={dv:.4f} ({case['bound_ms'] / dv:.3f} of "
                      f"the bound)")
            print(f"[ab] d={d} {dt} sdpa: event_ms={case['sdpa_event_ms']:.4f}"
                  f" device_ms={case['sdpa_device_ms']:.4f}; bound_ms="
                  f"{case['bound_ms']:.6f} ({case['bound_by']}); new over "
                  f"old: {case['speedup_device']:.3f}x device, "
                  f"{case['speedup_event']:.3f}x events; max_abs_err "
                  f"{case['max_abs_err']}")
    result = dict(card=smi, shape=SHAPE, old=str(args.old), entry=args.entry,
                  cases=cases)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
