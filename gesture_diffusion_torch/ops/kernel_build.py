"""Build a source of ``csrc/`` into a plain-C shared library.

A CUDA source (``<name>.cu``): ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared`` at first use, into ``build/torch_kernels/`` beside the
package.  A host C++ source (``<name>.cpp``): ``g++ -O3 -shared -fPIC``
into ``build/host/``.  (``.gitignore`` lists ``/build/``.)  The library
name carries a hash of the source and flags, so an edited source is never
served from a stale build; the output is written to a temporary name and
renamed, so concurrent builds cannot load a half-written file.  A CUDA
source that declares ``#define KERNEL_BUILD_PARTS n`` is compiled as n
objects at once, each with ``-DKERNEL_BUILD_PART=k`` (the source emits
one part of its code for each k), and linked into the one library: its
kernels' instantiations compile in parallel.  Loaded with ``ctypes``.  A
compiler that is missing or fails raises; nothing falls back to another
route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: a host C++ compiler is needed to build "
                       "the port's native BVH parser (put g++ on PATH)")


def _build(name: str, src: Path, out_dir: Path, compiler, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            ).hexdigest()[:16]
    out = out_dir / f"lib{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, (out, 0.0, ""))
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    exe = compiler()
    t0 = time.perf_counter()
    parts = re.search(r"^#define KERNEL_BUILD_PARTS (\d+)", src.read_text(),
                      re.M) if src.suffix == ".cu" else None
    if parts is None:
        log = _run([exe, *flags, "-o", str(tmp), str(src)], exe, src)
    else:
        objs = [tmp.with_name(f"{tmp.name}.{k}.o")
                for k in range(int(parts.group(1)))]
        compile_flags = [f for f in flags if f != "-shared"]
        procs = [subprocess.Popen(
            [exe, *compile_flags, "-c", f"-DKERNEL_BUILD_PART={k}", "-o",
             str(obj), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for k, obj in enumerate(objs)]
        logs = [proc.communicate()[1] for proc in procs]
        try:
            for proc, err in zip(procs, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"{Path(exe).name} failed on {src}:\n"
                                       f"{err[-8000:]}")
            link = [f for f in flags if f not in ("-Xptxas", "-v")]
            log = "".join(logs) + _run([exe, *link, "-o", str(tmp),
                                        *map(str, objs)], exe, src)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    BUILD_INFO[name] = (out, time.perf_counter() - t0, log)
    return out


def _run(cmd, exe, src) -> str:
    """Run one compiler command; its stderr, or raise with it."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(exe).name} failed on {src}:\n"
                           f"{proc.stderr[-8000:]}")
    return proc.stderr


def build_library(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an identical build exists."""
    return _build(name, CSRC / f"{name}.cu", BUILD_DIR, _nvcc, NVCC_FLAGS)


def build_host_library(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` for the host unless an identical build
    exists."""
    return _build(name, CSRC / f"{name}.cpp", HOST_BUILD_DIR, _gxx, GXX_FLAGS)


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
