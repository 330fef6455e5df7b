#!/usr/bin/env python3
"""Where the f32 prefill kernel's time goes, on one NVIDIA GPU.

    python3 prefill_f32_ablation.py

K1's f32 prefill instance (``prefill_tf32x3_kernel`` in
``distributed_llm_dissemination_tpu_torch/csrc/attention_prefill.cu``)
runs, per 32-key tile, a split pass (K to its TF32 hi and lo parts, V
transposed into V^T's parts), one CTA barrier, the 3xTF32 product S = Q
K^T, the online softmax, and the 3xTF32 product O += P V, one after
another.  "rest" is what remains with all three cut: the loads, the
barriers, the softmax and the launch's tail.  This script builds the source several times, each build with
some of those parts cut out by a preprocessor guard inserted around it,
and times each build at the full-width causal block (``llama3-8b-d4``:
kvh 8, g 4, s = t = 2048, hd 128), and at a 128-token prompt.  A build
without a part computes wrong numbers: only its time is read.  The
difference between a build and the whole kernel is what that part costs
in place (it overlaps nothing, since the parts run in turn).

Each build runs in its own process (each library carries its own CUDA
runtime).  Prints one JSON line per build, then the card's name and
power limit, then a JSON summary.  Needs ``nvcc`` and a card; exits 2
without one.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# The parts, each as the source text that starts it and the text that
# ends it; a build cuts a part by wrapping that span in #ifndef NO_<part>.
PARTS = {
    "SPLIT": ("    split_tf32<KV>(k_gen, k_gen + KV);\n",
              "k_gen + 4 * KV);\n"),
    "S": ("    float s[BK / 2];\n    wgmma_fence();\n",
          "    wgmma_commit_wait();\n    fence_regs(s);\n"),
    "PV": ("    fence_regs(o);\n    wgmma_fence();\n#pragma unroll\n"
           "    for (int j = 0; j < NKT; ++j) {\n      // 8 keys",
           "    wgmma_commit_wait();\n    fence_regs(o);\n"),
}
BUILDS = {"whole": (), "no_split": ("SPLIT",), "no_s": ("S",),
          "no_pv": ("PV",), "none": ("SPLIT", "S", "PV")}
SHAPES = ((1, 8, 4, 2048, 2048, 128), (1, 8, 4, 128, 128, 128))
KERNEL = "prefill_tf32x3_kernel(const __grid_constant__"


def guarded_source(text: str) -> str:
    """The source with every part wrapped in its guard.  A part with no
    S product still declares ``s`` (zeros), so the softmax runs."""
    head, kern = text.split(KERNEL, 1)
    for name, (start, end) in PARTS.items():
        i = kern.index(start)
        j = kern.index(end, i) + len(end)
        other = ("    float s[BK / 2];\n    for (int i = 0; i < BK / 2; ++i)"
                 " s[i] = 0.f;\n" if name == "S" else "")
        kern = (kern[:i] + f"#ifndef NO_{name}\n" + kern[i:j] + "#else\n"
                + other + "#endif\n" + kern[j:])
    return head + KERNEL + kern


def time_build(lib: str) -> dict:
    """In this process: load one build and time it at every shape."""
    import torch

    import chip_smoke
    from distributed_llm_dissemination_tpu_torch.ops import (
        flash_attention as fa)

    fn = getattr(ctypes.CDLL(lib), "attention_prefill_fwd")
    fn.argtypes = fa._ARGTYPES["prefill"]
    fn.restype = ctypes.c_int
    fa._fns["prefill"] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for b, kvh, g, s, t, hd in SHAPES:
        qg = torch.randn((b, kvh, g, s, hd), generator=gen, device="cuda")
        k = torch.randn((b, kvh, t, hd), generator=gen, device="cuda")
        v = torch.randn((b, kvh, t, hd), generator=gen, device="cuda")
        out[f"s{s}"] = chip_smoke.time_graph(
            lambda: fa.block_attention(qg, k, v, 0, 0), 4, 5)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("prefill_f32_ablation: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps(time_build(sys.argv[2])), flush=True)
        return 0
    import chip_smoke
    from distributed_llm_dissemination_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "attention_prefill.cu").read_text()
    work = cuda_build.BUILD_DIR / "ablation"
    work.mkdir(parents=True, exist_ok=True)
    guarded = work / "attention_prefill_guarded.cu"
    guarded.write_text(guarded_source(src))

    def build(name):
        lib = work / f"prefill_{name}.so"
        flags = [f"-DNO_{p}" for p in BUILDS[name]]
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                               *flags, "-o", str(lib), str(guarded)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}: {proc.stderr[-2000:]}")
        return lib

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(build, BUILDS)))
    build_s = time.monotonic() - t0
    ms = {}
    for name, lib in libs.items():
        proc = subprocess.run([sys.executable, __file__, "--time", str(lib)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"timing {name} failed: {proc.stderr[-2000:]}")
        ms[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"build": name, "cut": list(BUILDS[name]),
                          "ms": ms[name]}), flush=True)
    whole = ms["whole"]
    print(chip_smoke.nvidia_smi(), flush=True)
    print(json.dumps({
        "timing": chip_smoke.TIMING, "build_s": build_s, "whole_ms": whole,
        "part_ms": {p: {k: whole[k] - ms[f"no_{p.lower()}"][k] for k in whole}
                    for p in PARTS},
        "rest_ms": ms["none"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
