"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``_build/`` inside the
package, named by a hash of the source and of the shared ``csrc/*.cuh``
headers, so an edited source or header is rebuilt and a stale library is
never loaded.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import contextlib
import subprocess
import threading
from typing import Dict, Iterator, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

# Kernel launches by name.  Each wrapper adds one where it launches its
# kernel and nowhere else; a run zeroes the counts before its main path and
# reads them after to show that the path went through the kernels.
launch_counts: Dict[str, int] = {"attention_fwd": 0, "attention_bwd": 0,
                                 "image_normalize": 0}
# Calls of the ``torch.distributed`` collectives by name
# (``parallel/collectives.py``), counted as launches are.
collective_calls: Dict[str, int] = {}
# The launches recorded by the CUDA graph being captured (``capturing``):
# a captured launch runs at every replay, so it counts there.
_tally: Optional[Dict[str, int]] = None


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (or one call of collective
    ``name``): into ``launch_counts`` (``collective_calls``), or, while
    :func:`capturing` a graph on the current stream, into that graph's
    tally, which :func:`add_launches` adds at each replay.  A capture
    outside :func:`capturing` counts its launches once, here."""
    import torch
    if _tally is not None and torch.cuda.is_current_stream_capturing():
        _tally[name] = _tally.get(name, 0) + 1
    else:
        counts = launch_counts if name in launch_counts else collective_calls
        counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """The tally of the launches captured inside the block."""
    global _tally
    prev, _tally = _tally, dict.fromkeys(launch_counts, 0)
    try:
        yield _tally
    finally:
        _tally = prev


def add_launches(tally: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    for name, n in tally.items():
        counts = launch_counts if name in launch_counts else collective_calls
        counts[name] = counts.get(name, 0) + n


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    of every shared ``csrc/*.cuh`` header it may include, and of the
    flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named ``csrc/<name>.cu`` sources that have no current
    library, one ``nvcc`` process per source, all started together.
    Returns each library's ``ptxas`` report (registers, spills) or "cached".
    Raises with the compiler's output if a build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            reports[name] = "cached"
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, name + ".cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (rc={proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            lib.mpmc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.mpmc_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check_launch(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.mpmc_cuda_error_string(rc).decode()})")
