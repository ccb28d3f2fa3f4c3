"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with
``ctypes``; no PyTorch header is compiled, so a build takes seconds.
Libraries go to ``kernels/_build/`` (git-ignored), named by a hash of the
sources, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built at import: the first call that launches a kernel
builds it, and ``build_all`` builds every kernel at once, one ``nvcc``
per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "mla_attention")
#: ``--split-compile=4`` optimises each source's kernels on 4 threads: the
#: paged and latent sources instantiate many kernels and took ~100 s each
#: on one thread, ~52 s this way (an H100 host's 8 cores), with the same
#: output bits
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=4")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes, keyed by the hash of
    that source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, Dict]:
    """Compile every kernel in ``names`` that is not built yet, in
    parallel. Returns {name: {"seconds", "cached", "log"}}; raises with
    nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, lib)          # atomic: a concurrent loader sees
        out[name] = {"seconds": time.perf_counter() - t0,  # all or nothing
                     "cached": False, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
