"""Build a CUDA source of ``csrc/`` into a plain-C shared library.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` at first use,
into ``build/torch_kernels/`` beside the package (``.gitignore`` lists
``/build/``).  The library name carries a hash of the source and flags,
so an edited source is never served from a stale build; the output is
written to a temporary name and renamed, so concurrent builders cannot
load a half-written file.  Loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (library path, seconds the build took or 0.0 if cached, ptxas log)
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an identical build exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, (out, 0.0, ""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-8000:]}")
    os.replace(tmp, out)
    BUILD_INFO[name] = (out, time.perf_counter() - t0, proc.stderr)
    return out


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
