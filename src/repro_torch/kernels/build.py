"""Build, bind and count the port's CUDA kernel libraries.

Each kernel package keeps its CUDA C++ source under ``csrc/``.  At first
use ``nvcc`` compiles it for ``sm_90a`` into a shared library with a
plain C interface, and ``ctypes`` loads it.  The library is cached in
``_build/`` beside the package, named by the hash of source and flags,
so an edited source builds anew and an unchanged one loads at once.
The build runs under a lock, because a serving thread and a hot-swap's
warm-up can both make a first call; libraries of different packages
build independently, so a caller may build them all at once from
threads.  nvcc's ``-Xptxas -v`` report (registers, shared memory,
spills per kernel) is kept in ``info["log"]``.

Each library also counts its kernels' launches: a wrapper adds one
where it launches a kernel and nowhere else, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Sequence

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


class KernelLibrary:
    """One CUDA source, its built library and its kernels' launch counts.

    ``bind(lib)`` declares ``argtypes``/``restype`` of every exported
    function (and may check layouts); it runs once, after loading.
    """

    def __init__(self, source: str, kernels: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.name = os.path.splitext(os.path.basename(source))[0]
        self.build_dir = os.path.join(
            os.path.dirname(os.path.dirname(source)), "_build")
        self._bind = bind
        self._lib = None
        self._build_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self.launches: Dict[str, int] = dict.fromkeys(kernels, 0)
        # filled by the first load: library path, seconds, nvcc's report
        self.info: Dict[str, object] = {}

    def load(self) -> ctypes.CDLL:
        """Compile (once per source version) and load the library."""
        with self._build_lock:
            if self._lib is not None:
                return self._lib
            with open(self.source, "rb") as f:
                src = f.read()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                                 ).hexdigest()[:16]
            so = os.path.join(self.build_dir, f"lib{self.name}-{tag}.so")
            t0 = time.perf_counter()
            log = ""
            if not os.path.exists(so):
                os.makedirs(self.build_dir, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                proc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                    capture_output=True, text=True)
                log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                    raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                       f"{log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            self._bind(lib)
            self.info.update(path=so, seconds=time.perf_counter() - t0,
                             log=log)
            self._lib = lib
            return lib

    def count(self, kernel: str, n: int = 1) -> None:
        """Add ``n`` launches of ``kernel`` (a wrapper that launches it
        ``n`` times from one call)."""
        with self._count_lock:
            self.launches[kernel] += n

    def reset_counts(self) -> None:
        with self._count_lock:
            for k in self.launches:
                self.launches[k] = 0

    def counts(self) -> Dict[str, int]:
        with self._count_lock:
            return dict(self.launches)


def check_rc(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error (a launch the
    card refused never runs, and a later synchronise does not say so)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{rc}")


def stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on ``dev``."""
    return torch.cuda.current_stream(dev).cuda_stream
