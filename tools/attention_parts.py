"""Time the wide attention kernels (head dims past 256) with parts removed.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 tools/attention_parts.py --d 320 512

Each variant is the checkout's source with one part of the wide kernel's
loop cut out by a text patch (the patches assert the lines they replace,
so a changed source fails here, loudly), compiled alone with ``nvcc`` (the
flags of ``kernels/_build.py``) and timed by CUDA events (the best of two
passes, in the order of ``VARIANTS`` and back, ``--reps`` calls each) at
B 4, Hq 40, Hkv 8, S 512, causal, on the same inputs:

* bfloat16 (``flash_fwd_sm90_wide_kernel``): ``loads`` — the consumers
  only wait for each stage and give it back (the producer's TMA pipeline
  alone); ``no_pv`` — no P V product; ``one_s`` — consumer 1 skips its
  copy of S = Q K^T;
* float32 (``flash_fwd_wide_kernel``): ``no_loads`` — no K or V tile
  loaded inside the kv loop; ``no_s`` — no S = Q K^T loop; ``no_pv`` — no
  P V loop; ``no_s_pv`` — neither.

Only the unpatched kernel (``all``) computes attention; it is held to
``flash_attention_plain`` first.  The card's name and power limit come
first; the numbers also go to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402

SHAPE = dict(b=4, hq=40, hkv=8, s=512)
# dtype -> variant -> [(line as the source has it, line with the part cut)]
VARIANTS = {
    "bfloat16": {
        "all": [],
        "loads": [
            ("        for (int kk = 0; kk < D / 16; ++kk) {\n"
             "          const uint32_t q_box = (kk / 4) * kWideBM",
             "        for (int kk = 0; kk < 0; ++kk) {\n"
             "          const uint32_t q_box = (kk / 4) * kWideBM"),
            ("      for (int kk = 0; kk < kBN / 16; ++kk)\n"
             "        wgmma_pv<NB>(",
             "      for (int kk = 0; kk < 0; ++kk)\n"
             "        wgmma_pv<NB>(")],
        "no_pv": [
            ("      for (int kk = 0; kk < kBN / 16; ++kk)\n"
             "        wgmma_pv<NB>(",
             "      for (int kk = 0; kk < 0; ++kk)\n"
             "        wgmma_pv<NB>(")],
        "one_s": [
            ("        for (int kk = 0; kk < D / 16; ++kk) {\n"
             "          const uint32_t q_box = (kk / 4) * kWideBM",
             "        for (int kk = 0; kk < (B0 ? 0 : D / 16); ++kk) {\n"
             "          const uint32_t q_box = (kk / 4) * kWideBM")],
    },
    "float32": {
        "all": [],
        "no_loads": [
            ("    if (n_sl == 1 && kt + 1 < n_kt) {\n"
             "      load_wide_tile<D, T::kBN, D, true>",
             "    if (false) {\n"
             "      load_wide_tile<D, T::kBN, D, true>"),
            ("    if (kt + 1 < n_kt) {                           // are free\n"
             "      load_wide_tile<D, T::kBN, D, false>",
             "    if (false) {\n"
             "      load_wide_tile<D, T::kBN, D, false>")],
        "no_s": [
            ("      for (int n = 0; n < T::kHalf; ++n) {",
             "      for (int n = 0; n < 0; ++n) {")],
        "no_pv": [
            ("    if (half == 0)\n      wide_pv<D, T::kG0>",
             "    if (false) {} else if (false)\n      wide_pv<D, T::kG0>"),
            ("    else\n      wide_pv<D, T::kG1>",
             "    else if (false)\n      wide_pv<D, T::kG1>")],
        "no_s_pv": [
            ("      for (int n = 0; n < T::kHalf; ++n) {",
             "      for (int n = 0; n < 0; ++n) {"),
            ("    if (half == 0)\n      wide_pv<D, T::kG0>",
             "    if (false) {} else if (false)\n      wide_pv<D, T::kG0>"),
            ("    else\n      wide_pv<D, T::kG1>",
             "    else if (false)\n      wide_pv<D, T::kG1>")],
    },
}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def variant_source(text: str, patches: list) -> str:
    """``text`` with each (line, cut) of ``patches`` applied; raises if a
    line is not in it exactly once."""
    for line, cut in patches:
        if text.count(line) != 1:
            raise ValueError(f"the source no longer has, once: {line!r}")
        text = text.replace(line, cut)
    return text


def build(src: Path, out: Path, entry: str):
    """``src`` compiled alone into ``out``; its entry point ``entry``."""
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(out)), entry)
    fn.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 9 + (
        ctypes.c_void_p,)
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, nargs="+", default=[320])
    ap.add_argument("--dtype", nargs="+", default=sorted(VARIANTS),
                    choices=sorted(VARIANTS))
    ap.add_argument("--reps", type=int, default=chip_smoke.REPS)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build/ab/attention_parts.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_parts: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[parts] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    work = ROOT / "build/ab/parts"
    work.mkdir(parents=True, exist_ok=True)
    jobs = []
    for dt in args.dtype:
        route = fa.kernel_for(DTYPES[dt], 0)
        text = (ROOT / "src/repro_torch/kernels" / fa.SOURCES[route]
                ).read_text()
        for name, patches in VARIANTS[dt].items():
            src = work / f"{dt}_{name}.cu"
            src.write_text(variant_source(text, patches))
            jobs.append((dt, name, src, fa._ENTRIES[route]))
    with ThreadPoolExecutor(len(jobs)) as pool:
        fns = dict(zip(((dt, name) for dt, name, *_ in jobs), pool.map(
            lambda job: build(job[2], job[2].with_suffix(".so"), job[3]),
            jobs)))

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, hq, hkv, s = (SHAPE[x] for x in ("b", "hq", "hkv", "s"))
    cases = []
    for dt in args.dtype:
        dtype = DTYPES[dt]
        for d in args.d:
            ld = fa.row_width(dtype, d)
            if ld != d:
                raise ValueError(f"d={d}: a row the {dt} kernel pads")
            q = torch.randn((b, s, hq, d), generator=gen, device="cuda"
                            ).to(dtype)
            k, v = (torch.randn((b, s, hkv, d), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            out = torch.empty_like(q)
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn):
                def run():
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(), b, hq, hkv, s, s, d, d, 1, 0,
                             stream)
                    if err:
                        raise RuntimeError(f"CUDA error {err}")
                return run

            call(fns[(dt, "all")])()
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, True).float()
            rtol, atol = ((2 ** -7, 2 ** -8 * float(v.float().abs().max()))
                          if dtype == torch.bfloat16 else (2e-5, 2e-5))
            if not torch.allclose(out.float(), want, rtol=rtol, atol=atol):
                raise RuntimeError(f"{dt} d={d}: the unpatched kernel "
                                   f"disagrees with the plain version")
            names = list(VARIANTS[dt])
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                times[name].append(chip_smoke.event_ms(call(fns[(dt, name)]),
                                                       args.reps))
            best = {name: min(t) for name, t in times.items()}
            cases.append(dict(d=d, dtype=dt, event_ms=best))
            print(f"[parts] {dt} d={d} causal: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in best.items())
                  + " ms")
    result = dict(card=smi, shape=SHAPE, cases=cases)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
