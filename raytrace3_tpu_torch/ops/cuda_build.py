"""Build the hand-written CUDA kernels with nvcc and launch them via ctypes.

Each source in ``csrc/`` exports a plain C entry point that launches its
kernel on the stream it is given and returns ``cudaGetLastError()``.  At
first use the source is compiled for Hopper (``sm_90a``) into a shared
library under ``_build/`` (listed in ``.gitignore``), keyed by a hash of the
source and the flags, and loaded with ``ctypes``.  Nothing is built or
imported from CUDA when this module is imported.

Flags: no ``--use_fast_math`` (the Newton slab test relies on IEEE
``1/0 = inf`` and on NaN compares), and ``-fmad=false`` so that the kernels
round every product like their plain PyTorch versions do: the deposit count
then matches exactly and the Newton roots bit for bit.  Turning
contraction back on is a later speed lever.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(source: str, csrc_dir: Path = CSRC_DIR) -> Path:
    """Compile ``<csrc_dir>/<source>`` once per content hash (the source,
    the directory's ``*.cuh`` headers and the flags); return the library.

    The ptxas report (registers, shared memory, spills) is kept beside the
    library as ``<name>.ptxas.txt``.
    """
    src = Path(csrc_dir) / source
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


#: The counted kernels by name: each ``CudaKernel`` built with a ``name``.
KERNELS: dict = {}


class CudaKernel:
    """One C entry point of one source, loaded at first launch.

    ``launches`` counts successful launches; only :meth:`launch` adds to it.
    With a ``name`` the kernel enters ``KERNELS``, which
    :func:`launch_counts` reads.  ``csrc_dir`` goes to :func:`build` (a
    comparison script loads another tree's sources this way, unnamed).
    """

    def __init__(self, source: str, symbol: str, argtypes, csrc_dir: Path = CSRC_DIR,
                 name: str | None = None):
        if name is not None:
            KERNELS[name] = self
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.csrc_dir = csrc_dir
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        if self._fn is None:
            self._lib = ctypes.CDLL(str(build(self.source, self.csrc_dir)))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]   # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a refused launch.

        The caller keeps every tensor whose pointer is in ``args`` alive
        until the call returns (the kernel runs asynchronously on the
        stream, which PyTorch's allocator orders against later reuse).
        """
        fn = self.load()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (``None`` in ``shape`` matches any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def zero_launches() -> None:
    """Set every named kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    """Every named kernel's launch count, by name (the kernels of the
    modules imported so far)."""
    return {name: k.launches for name, k in KERNELS.items()}


def launches_since(before: dict) -> dict:
    """Every named kernel's launches since ``before`` (a ``launch_counts()``;
    a kernel whose module was imported since counts from 0)."""
    return {name: n - before.get(name, 0) for name, n in launch_counts().items()}
