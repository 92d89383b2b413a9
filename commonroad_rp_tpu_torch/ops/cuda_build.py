"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled alone
into a shared library in ``build/torch_kernels/`` (gitignored), named by a
hash of the source and the flags, so an edit or a flag change rebuilds and
an unchanged source is built once per checkout.  Nothing is compiled when a
module is imported: the first launch of a kernel builds its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Dict, Optional

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
# IEEE division and square root, no fast math, and no contraction of
# multiply-add pairs into FMA (-fmad=false): every floating-point operation
# rounds as the plain PyTorch versions' separate tensor operations do, so a
# kernel and its plain version agree except where cos/sin/tan differ in the
# last bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's command line and output of the last build of each source
_build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       f"{CSRC_DIR} with the CUDA toolkit's nvcc")


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` into ``build/torch_kernels`` (once per source and
    flag set) and return the shared library's path; raises with nvcc's
    output if the build fails."""
    text = source.read_bytes()
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"libcrp_{source.stem}_{tag[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _build_logs[source.name] = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{_build_logs[source.name]}")
    os.replace(tmp, out)
    return out


def load(source: pathlib.Path,
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from ``source``, loaded once per process;
    ``bind(lib)`` declares its entry points' argtypes and restypes."""
    with _lock:
        lib = _loaded.get(source.name)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _loaded[source.name] = lib
    return lib


def build_log(source: pathlib.Path) -> Optional[str]:
    """nvcc's output of this process's build of ``source`` (None when the
    library was already built)."""
    return _build_logs.get(source.name)
