"""Benchmark of metrics_tpu_torch on NVIDIA cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, the numbers the check compared beside their limits, which are
also the last lines on standard error. Exits non-zero, with no result, when
there is no CUDA card (or fewer than the cell asks for), or when ``jax``,
``jaxlib``, ``flax`` or ``metrics_tpu`` was imported.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time


def _process_age_s() -> float:
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


START_WALL = time.time() - _process_age_s()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]
# build and kernel caches at fixed places inside the checkout
_CACHE = os.path.join(HERE, ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
# and the bytecode of every module imported from here on: where the
# environment forbids writing it beside the sources (PYTHONDONTWRITEBYTECODE),
# each process would compile torch's Python anew, seconds of set-up that
# swing with the host; the first run in a checkout writes it, later runs read it
sys.pycache_prefix = os.path.join(_CACHE, "pycache")
sys.dont_write_bytecode = False

from harness.guard import forbidden_modules  # noqa: E402


def _finite(x):
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return str(x) if isinstance(x, float) and not math.isfinite(x) else x


def _power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return "card: " + "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi unavailable ({e})"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def missing_cards(cell, device_kind: str):
    """Why this machine cannot run ``cell``, or None."""
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_kind == "cuda" and have < cell.chips:
        return f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {have}"
    return None


def run_cell(cell, seeds, seconds: float, trace: bool, device_kind: str, control: bool = False,
             marks=None) -> list:
    """The results of ``seeds``, one after the other, on the first card (or
    the CPU)."""
    import torch

    from harness.cell import run_seeds

    marks = {} if marks is None else marks
    device = torch.device("cuda", 0) if device_kind == "cuda" else torch.device("cpu")
    if device_kind == "cuda":
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    marks["cuda"] = time.time()
    return run_seeds(cell, device, seeds, seconds, trace, control, marks)


def _setup_line(marks: dict, t0_wall: float) -> str:
    """Where set-up went: the seconds of each of its steps, in order."""
    at, parts = START_WALL, []
    for name, t in [*marks.items(), ("to the window", t0_wall)]:
        parts.append(f"{name} {t - at:.3f}")
        at = t
    return "set-up s: " + ", ".join(parts)


def _passes_line(pass_s: list) -> str:
    """The window's passes: a first pass much slower than the median would
    mean that something compiled or warmed up inside the window."""
    ms = sorted(pass_s)
    return (f"window: {len(pass_s)} passes, first {pass_s[0] * 1e3:.3f} ms, median {ms[len(ms) // 2] * 1e3:.3f} ms, "
            f"slowest {ms[-1] * 1e3:.3f} ms")


def main(argv=None, device_kind: str = "cuda", root: str = ROOT) -> int:
    marks = {"python": time.time()}
    args = parse(argv)
    import torch  # noqa: F401

    from harness import result
    from harness.spec import load_cell

    marks["torch"] = time.time()
    cell = load_cell(root, args.workload)
    why = missing_cards(cell, device_kind)
    if why:
        print(why, file=sys.stderr)
        return 2
    trace = bool(args.trace)
    r = run_cell(cell, [args.seed], args.seconds, trace, device_kind, marks=marks)[0]
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules were loaded: {bad}", file=sys.stderr)
        return 3
    if r["fallback"]:
        print(f"compiled path fell back: {r['fallback']}", file=sys.stderr)
    line = _finite(result.assemble(cell, r, trace, START_WALL, device_kind))
    print(_setup_line(marks, r["t0_wall"]), file=sys.stderr)
    print(_passes_line(r["pass_s"]), file=sys.stderr)
    if "window_s" in r:
        print(f"profiled: {cell.mix['trace_passes']} passes in {r['window_s'] * 1e3:.3f} ms, "
              f"device busy {r['busy_s'] * 1e3:.3f} ms", file=sys.stderr)
    if device_kind == "cuda":
        print(_power_line(), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
