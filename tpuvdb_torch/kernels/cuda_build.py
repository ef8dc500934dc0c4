"""Builds the port's CUDA sources with nvcc and loads them with ctypes.

Each source in `tpuvdb_torch/csrc/` has a plain C interface and compiles on
its own into `tpuvdb_torch/build/lib<name>.so` for sm_90a at first use
(`CudaLibrary.load`). A library is rebuilt when its source, or a header of
`csrc/` that the source includes, is newer than it.
`load` holds only its own library's lock, so loads of several libraries from
several threads run their nvcc builds side by side. Nothing here runs when a
module is imported: the CPU never needs nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Callable, Optional, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")


def nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


class CudaLibrary:
    """One csrc/ source built into one shared library. `bind(lib)` sets
    the ctypes argtypes/restype of every function the wrapper calls;
    `headers` names the csrc/ headers the source includes."""

    def __init__(self, source: str, library: str,
                 bind: Callable[[ctypes.CDLL], None],
                 headers: Sequence[str] = ()):
        self.source = os.path.join(CSRC_DIR, source)
        self.headers = [os.path.join(CSRC_DIR, h) for h in headers]
        self.library = os.path.join(BUILD_DIR, library)
        self.build_log = ""  # nvcc's output of the last build (-Xptxas -v)
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def command(self, out: str):
        return [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", out, self.source]

    def up_to_date(self) -> bool:
        if not os.path.exists(self.library):
            return False
        newest = max(os.path.getmtime(p) for p in [self.source] + self.headers)
        return os.path.getmtime(self.library) >= newest

    def build(self) -> str:
        """Compile unless an up-to-date library is there; raises with
        nvcc's output if the build fails."""
        if self.up_to_date():
            return self.library
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.library}.{os.getpid()}.tmp"
        proc = subprocess.run(self.command(tmp), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source}:\n{proc.stdout}")
        os.replace(tmp, self.library)
        return self.library

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                self._bind(lib)
                self._lib = lib
            return self._lib

