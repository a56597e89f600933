"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers: seconds to build, not minutes),
loaded with ctypes.  The build happens at first use, from the sources in
the package only, into `_build/` next to this file; the library's file
name carries a hash of its sources, so an edited source rebuilds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("pairwise_l2", "l2_topk", "ivf_scan")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points per library: name -> (restype, argtypes)
_SIGNATURES = {
    "pairwise_l2": {
        "pairwise_l2": (_I, [_P, _P, _P, _I, _I, _I, _P]),
    },
    "l2_topk": {
        "l2_topk_partial": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _P]),
        "l2_topk_smem_bytes": (ctypes.c_longlong, [_I, _I, _I]),
    },
    "ivf_scan": {
        "ivf_scan_partial": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _P]),
        "ivf_scan_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=KERNELS) -> dict:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together.  Returns {name: {"cmd", "seconds",
    "log"}} for the ones compiled (the log holds ptxas' register and
    shared-memory report).  Raises RuntimeError if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = nvcc_command(name, tmp)
        procs[name] = (cmd, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (cmd, out, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"cmd": " ".join(cmd), "log": log,
                        "seconds": time.perf_counter() - t0}
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
