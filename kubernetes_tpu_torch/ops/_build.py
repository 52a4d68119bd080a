"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` compiles to an object with its own `nvcc` process —
all started together — and the objects link once into one shared library,
`build/kernels/libkernels-<hash>.so` at the repository root, for `sm_90a`.
Each source exports a plain C launcher `launch_<name>` that `ctypes` calls
(no PyTorch headers: a source that includes them takes minutes to compile,
these take seconds). The hash covers the sources and flags, so an
unchanged checkout reuses its build. Nothing is built at import: the first
launch on a CUDA tensor builds.

The launchers' C signatures are the one statement of each kernel's
arguments. `signature(name)` reads it from the source, and `launcher(name)`
types the ctypes call from it, so the Python side keeps no argument list
of its own; `ops/kernel.py` checks every tensor against it before a launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import NamedTuple, Optional, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")
KERNELS = ("static_masks", "resource_eval", "lap_schedule", "scan_general", "dry_run_preemption",
           "scatter_rows", "patch_carry_rows", "schedule_placements", "whatif_score",
           "sharded_lap")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
COMPILE_FLAGS = (ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# A source's own extra flags: the lap's 32 instantiations, the build's
# longest compile, are optimized in parallel threads.
SOURCE_FLAGS = {"lap_schedule": ("--split-compile=0",)}
LINK_FLAGS = (ARCH, "-shared")

# C pointee type of a launcher argument -> the dtype its tensor must have.
DTYPES = {"int64_t": torch.int64, "int32_t": torch.int32, "bool": torch.bool,
          "uint8_t": torch.uint8}


class Param(NamedTuple):
    """One launcher argument: `dtype` None for an `int`, else the tensor's
    dtype; `optional` pointers (marked OPTIONAL in C) may be None, `host`
    ones (HOST) are CPU tensors that the launcher reads on the host, and
    `mapped` ones (MAPPED) may be pinned CPU tensors that the card reaches
    under unified addressing."""

    name: str
    dtype: Optional[torch.dtype]
    optional: bool = False
    host: bool = False
    mapped: bool = False


@functools.lru_cache(maxsize=None)
def signature(name: str) -> Tuple[Param, ...]:
    """The arguments of `launch_<name>` before its trailing cudaStream_t,
    read from the source that exports it (csrc/<name>.cu)."""
    with open(os.path.join(CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    m = re.search(r'extern "C" int launch_%s\((.*?)\)\s*\{' % name, src, re.S)
    if m is None:
        raise RuntimeError(f"csrc/{name}.cu has no launch_{name}")
    params = [" ".join(p.split()) for p in m.group(1).split(",")]
    if not params[-1].startswith("cudaStream_t "):
        raise RuntimeError(f"launch_{name} must end with a cudaStream_t argument")
    out = []
    for p in params[:-1]:
        words = p.replace("*", " * ").split()
        if words[:1] == ["int"] and len(words) == 2:
            out.append(Param(words[1], None))
            continue
        ctype = next((w for w in words if w in DTYPES), None)
        if ctype is None or "*" not in words:
            raise RuntimeError(f"launch_{name}: unsupported argument {p!r}")
        out.append(Param(words[-1], DTYPES[ctype], words[0] == "OPTIONAL", words[0] == "HOST",
                         words[0] == "MAPPED"))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def defines(source: str) -> dict:
    """The integer #defines of csrc/<source> (`#define NAME 256`, `#define
    NAME (48 * 1024)`), evaluated: the constants a model of a kernel takes
    from the source it models."""
    with open(os.path.join(CSRC, source)) as fh:
        src = fh.read()
    out = {}
    for name, expr in re.findall(r"^#define (\w+) \(?(\d+(?: \* \d+)*)\)?", src, re.M):
        value = 1
        for factor in expr.split(" * "):
            value *= int(factor)
        out[name] = value
    return out


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a "
                           "machine with the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode() + repr(SOURCE_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, fn), "rb") as fh:
            h.update(fn.encode() + fh.read())
    return h.hexdigest()[:16]


def _run_all(cmds, log_path: str) -> None:
    """Run the commands in parallel; raise with their output if any fails.
    The output (with ptxas' register and shared-memory report) is kept."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    with open(log_path, "a") as log:
        log.write("".join(outs))
    failed = [(c[-1], o) for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{src}:\n{o[-4000:]}"
                                                         for src, o in failed))


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tag = _digest()
        so = os.path.join(BUILD_DIR, f"libkernels-{tag}.so")
        if not os.path.exists(so):
            log = os.path.join(BUILD_DIR, f"libkernels-{tag}.log")
            objs = [os.path.join(BUILD_DIR, f"{n}-{tag}.o") for n in KERNELS]
            _run_all([[_nvcc(), *COMPILE_FLAGS, *SOURCE_FLAGS.get(n, ()), "-o", o,
                       os.path.join(CSRC, f"{n}.cu")] for n, o in zip(KERNELS, objs)], log)
            _run_all([[_nvcc(), *LINK_FLAGS, "-o", so + ".tmp", *objs]], log)
            os.replace(so + ".tmp", so)
        lib = ctypes.CDLL(so)
        for name in KERNELS:
            fn = getattr(lib, f"launch_{name}")
            # Every pointer is c_void_p: ctypes would otherwise pass a
            # Python int as a 32-bit C int and cut the address.
            fn.argtypes = [ctypes.c_int if p.dtype is None else ctypes.c_void_p
                           for p in signature(name)] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
        build_seconds = time.perf_counter() - t0
        return _lib


def launcher(name: str):
    """The C launcher `launch_<name>` (building everything on first use)."""
    return getattr(build(), f"launch_{name}")
