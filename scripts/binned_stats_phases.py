#!/usr/bin/env python3
"""Where the time of the binned-counts histogram kernel goes, on one CUDA card.

    python3 scripts/binned_stats_phases.py

For the main path's binned update (2048, 10, 100), the JAX package's binned
benchmark shape (65536, 8, 128) and an ImageNet-1k eval batch (2048, 1000,
100), it prints

1. the device time (``torch.profiler``) of the C entry under the plan that
   ``metrics_tpu_torch.ops.binned_stats._plan`` picks and under a few other
   (class tile, row blocks) plans, which is how the plan's rule was chosen;
2. per-phase times inside the kernel: a copy of ``csrc/binned_stats.cu`` with
   ``%globaltimer`` stamps at the phase boundaries (thread 0 of each block),
   built with ``nvcc`` into ``metrics_tpu_torch/_build/phases/``, as it is
   (``base``) and with the rank sort switched off (``bitonic-only``), so the
   two sorts are compared in one run. Times are microseconds since the first
   block started (median and max over blocks; the timer ticks in steps of
   about 0.26 us).

Every launch is checked against the compare form. Needs a card and nvcc.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from metrics_tpu_torch.ops import _build, binned_stats  # noqa: E402

SHAPES = {
    (2048, 10, 100): [(1, 2), (2, 1), (10, 1)],
    (65536, 8, 128): [(4, 63), (4, 126), (8, 31), (4, 250)],
    (2048, 1000, 100): [(4, 1), (4, 2), (16, 1)],
}
PHASES = ["start", "sorted", "zeroed", "bucketed", "merged", "epilogue", "end"]
ANCHORS = [("  // 0. this block's rows", 0), ("  // 2. zero this tile", 1), ("  // 3. bucket every element", 2),
           ("  // 4. merge the row blocks", 3), ("    if (!s_last) return;", 4), ("  // 5. epilogue", 5)]
STAMP = "if (threadIdx.x == 0) g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + {k}] = now();\n"
VARIANTS = {
    "base": lambda src: src,
    "bitonic-only": lambda src: src.replace("  if (t <= kThreads) {\n    if (threadIdx.x < t) {",
                                            "  if (false) {\n    if (threadIdx.x < t) {", 1),
}


def _instrumented(src: str) -> str:
    for anchor, k in ANCHORS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, STAMP.format(k=k) + anchor)
    tail = "  }\n}\n\n// ------------------------------------------------------------------ compare"
    assert src.count(tail) == 1
    src = src.replace(tail, "  }\n" + STAMP.format(k=6) + tail[4:])
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_stamp[1 << 16];\n"
                      "__device__ __forceinline__ unsigned long long now() {\n"
                      "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
                      "  return t;\n}\n", 1)
    return src + ('\nextern "C" int stamps_read(void* host, int n) '
                  "{ return (int)cudaMemcpyFromSymbol(host, g_stamp, n * 8); }\n"
                  'extern "C" int stamps_clear() { void* p = nullptr; cudaGetSymbolAddress(&p, g_stamp); '
                  "return (int)cudaMemset(p, 0, sizeof(g_stamp)); }\n")


def _build_variant(name: str) -> ctypes.CDLL:
    out = ROOT / "metrics_tpu_torch" / "_build" / "phases"
    out.mkdir(parents=True, exist_ok=True)
    src = VARIANTS[name]((ROOT / "metrics_tpu_torch" / "csrc" / "binned_stats.cu").read_text())
    (out / f"{name}.cu").write_text(_instrumented(src))
    cmd = [_build._nvcc(), *_build._NVCC_FLAGS, "-shared", str(out / f"{name}.cu"), "-o", str(out / f"{name}.so")]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    lib.binned_stats_launch.argtypes = _build.load_library().binned_stats_launch.argtypes
    lib.binned_stats_launch.restype = ctypes.c_int
    lib.stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stamps_clear.argtypes = []
    return lib


def _launcher(lib, preds, target, thr, design, tile, rows):
    n, c = preds.shape
    t = thr.numel()
    nbytes = binned_stats._scratch_bytes(design, n, c, t, tile, rows)
    scratch = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=preds.device)
    out = torch.empty((3, c, t), dtype=torch.float32, device=preds.device)
    args = (preds.data_ptr(), target.data_ptr(), binned_stats._TARGET_KINDS[target.dtype], thr.data_ptr(), n, c, t,
            binned_stats._DESIGNS[design], tile, rows, scratch.data_ptr(), nbytes, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)

    def launch():
        err = lib.binned_stats_launch(*args)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    launch()
    torch.cuda.synchronize()
    want = binned_stats._binned_stats_compare(preds, target, thr)
    if not all(torch.equal(o, w) for o, w in zip(out, want)):
        raise AssertionError(f"the {design} kernel (tile {tile}, {rows} rows per block) differs from the compare form")
    return launch


def _device_us(fn, calls: int = 50) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("binned_stats_phases: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    sm_count = binned_stats._sm_count(0)
    lib = _build.load_library()
    variants = {name: _build_variant(name) for name in VARIANTS}
    rng = np.random.RandomState(0)
    for (n, c, t), others in SHAPES.items():
        preds = torch.from_numpy(rng.rand(n, c).astype(np.float32)).to(device)
        target = torch.from_numpy((rng.rand(n, c) > 0.5).astype(np.float32)).to(device)
        thr = torch.linspace(0, 1, t, device=device)
        design, tile, rows = binned_stats._plan(n, c, t, binned_stats._SMEM_OPTIN, sm_count)
        plans = [(tile, -(-n // rows))] + [p for p in others if p != (tile, -(-n // rows))]
        for k, (tile_k, row_blocks) in enumerate(plans):
            us = _device_us(_launcher(lib, preds, target, thr, design, tile_k, -(-n // row_blocks)))
            blocks = -(-c // tile_k) * row_blocks
            print(f"N={n} C={c} T={t} tile {tile_k} x {row_blocks} row blocks ({blocks} blocks)"
                  f"{' (the plan)' if k == 0 else ''}: {us:.2f} us device time per call")
        blocks = -(-c // tile) * -(-n // rows)
        for name, vlib in variants.items():
            launch = _launcher(vlib, preds, target, thr, design, tile, rows)
            us = _device_us(launch)
            for _ in range(3):  # the stamps of the last of a few launches, warm
                if vlib.stamps_clear() != 0:
                    raise RuntimeError("clearing the stamps failed")
                launch()
                torch.cuda.synchronize()
            buf = np.zeros(blocks * 8, dtype=np.uint64)
            if vlib.stamps_read(buf.ctypes.data, blocks * 8) != 0:
                raise RuntimeError("reading the stamps failed")
            ts = buf.reshape(blocks, 8)[:, :7].astype(np.float64)
            rel = np.where(ts > 0, ts - ts[:, 0].min(), np.nan) / 1e3
            seen = ~np.isnan(rel).all(axis=0)  # "merged" only when row blocks merge
            med, top = np.nanmedian(rel[:, seen], axis=0), np.nanmax(rel[:, seen], axis=0)
            print(f"  {name:12s} {us:.2f} us device time per call; stamps, us median/max over blocks: "
                  + ", ".join(f"{p} {m:.2f}/{x:.2f}" for p, m, x in zip(np.array(PHASES)[seen], med, top)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
