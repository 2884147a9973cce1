"""Build the package's CUDA sources with nvcc at first use and load them
through ctypes.

Each library is compiled from jet_pbrt_tpu_torch/csrc/ into
jet_pbrt_tpu_torch/_build/<name>-<hash>/, the hash taken over the sources,
the headers of csrc/ and the flags, so an edited source or header rebuilds
and an unchanged one is reused within a checkout. A library named in FLAGS is built with those flags
added (a variant of a source under a -D define of its own). The sources
have a plain C interface (no PyTorch headers), which keeps a build to
seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD = os.path.join(PKG_DIR, "_build")
# sm_90a: Hopper with its architecture-specific instructions; no
# --use_fast_math, so division and sqrt stay IEEE-exact
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# library name -> its flags beyond NVCC_FLAGS: shade_count is csrc/shade.cu
# with every float operation counted per thread (the kernel's bound)
FLAGS = {"shade_count": ("-DSHADE_COUNT_OPS",)}

_LOADED: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler log) of builds made by this process
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME (default
    /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str, sources: list[str]) -> tuple[str, list[str]]:
    paths = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS + list(FLAGS.get(name, ())))
                       .encode())
    # the sources and every header they may include: csrc's and those
    # beside a source
    dirs = sorted({CSRC} | {os.path.dirname(p) for p in paths})
    headers = [os.path.join(d, f) for d in dirs for f in sorted(os.listdir(d))
               if f.endswith(".cuh")]
    for p in paths + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD, f"{name}-{h.hexdigest()[:16]}")
    return os.path.join(out_dir, f"lib{name}.so"), paths


def build_libraries(specs) -> None:
    """Compile every library of specs [(name, sources), ...] that is not
    built yet, one nvcc per library, all started together; raises if any
    fails."""
    procs = []
    for name, sources in specs:
        lib_path, paths = _lib_path(name, sources)
        if os.path.exists(lib_path):
            continue
        os.makedirs(os.path.dirname(lib_path), exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        procs.append((name, lib_path, tmp, time.perf_counter(),
                      subprocess.Popen([nvcc(), *NVCC_FLAGS,
                                        *FLAGS.get(name, ()), "-o", tmp,
                                        *paths],
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib_path, tmp, t0, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{out}\n{err}")
            continue
        os.replace(tmp, lib_path)
        BUILD_LOG[name] = (time.perf_counter() - t0, out + err)
    if failed:
        raise RuntimeError("\n".join(failed))


def library_path(name: str, sources: list[str]) -> str:
    """Where lib<name>.so of these sources is (or will be) built."""
    return _lib_path(name, sources)[0]


def load_library(name: str, sources: list[str], declare) -> ctypes.CDLL:
    """Compile (if needed) and load lib<name>.so; `declare(lib)` sets the
    argtypes and restype of its functions."""
    if name in _LOADED:
        return _LOADED[name]
    build_libraries([(name, sources)])
    lib = ctypes.CDLL(_lib_path(name, sources)[0])
    declare(lib)
    _LOADED[name] = lib
    return lib
