"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and linked into one shared library
with a plain C interface, ``_build/libmetrics_tpu_torch_kernels.so``, which is
loaded with ``ctypes``. The build runs at first use and is keyed on a hash of
the sources and flags: an edited source rebuilds, an unchanged one is loaded
as it is. Nothing here runs at import.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libmetrics_tpu_torch_kernels.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
#: What the last build did: seconds it took (0.0 when the library was loaded
#: as built before) and the compiler's messages (``-Xptxas -v`` register and
#: shared-memory use per kernel).
last_build = {"seconds": 0.0, "log": ""}


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    candidates = [
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc was not found (looked in $CUDA_HOME/bin, on PATH and in /usr/local/cuda/bin); "
        "the CUDA kernels of metrics_tpu_torch need the CUDA toolkit to build."
    )


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(out_dir: Path) -> Path:
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *_NVCC_FLAGS, "-Xptxas=-v", "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    lib = out_dir / _LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", *[str(obj) for _src, obj, _p in procs], "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking {_LIB_NAME} failed:\n{link.stdout}")
    last_build["log"] = "\n".join(logs)
    return lib


def library_path() -> Path:
    """Build the kernels if the sources changed since the last build; return
    the library's path."""
    lib = _BUILD_DIR / _LIB_NAME
    stamp = _BUILD_DIR / (_LIB_NAME + ".sha256")
    digest = _source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text().strip() == digest:
        last_build["seconds"] = 0.0
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        built = _compile(Path(tmp))
        # replace, never overwrite in place: a process that loaded the old
        # library keeps its mapping
        os.replace(built, lib)
        tmp_stamp = Path(tmp) / "stamp"
        tmp_stamp.write_text(digest)
        os.replace(tmp_stamp, stamp)
    last_build["seconds"] = time.perf_counter() - t0
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            # a build (nvcc, seconds) must never run inside a CUDA graph
            # capture: the compiled path's eager warm-up loads it first
            raise RuntimeError("the kernel library is not loaded yet; load it before a CUDA graph capture")
        lib = ctypes.CDLL(str(library_path()))
        fn = lib.binned_stats_launch
        fn.argtypes = [
            ctypes.c_void_p,  # preds
            ctypes.c_void_p,  # target
            ctypes.c_int,  # target kind
            ctypes.c_void_p,  # thresholds
            ctypes.c_longlong,  # n
            ctypes.c_int,  # c
            ctypes.c_int,  # t
            ctypes.c_int,  # design
            ctypes.c_int,  # class tile
            ctypes.c_int,  # rows per block
            ctypes.c_void_p,  # scratch
            ctypes.c_longlong,  # scratch bytes
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        fn = lib.confusion_counts_launch
        fn.argtypes = [
            ctypes.c_void_p,  # preds
            ctypes.c_int,  # preds kind
            ctypes.c_void_p,  # target
            ctypes.c_int,  # target kind
            ctypes.c_longlong,  # n
            ctypes.c_int,  # c
            ctypes.c_longlong,  # x
            ctypes.c_longlong,  # num_classes
            ctypes.c_longlong,  # width
            ctypes.c_int,  # design
            ctypes.c_int,  # lanes
            ctypes.c_int,  # blocks
            ctypes.c_int,  # shared
            ctypes.c_void_p,  # out
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib
