"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

Each source has a plain C interface: nvcc compiles it for sm_90a into a
shared library under `_build/<hash>/` (the hash covers the source and the
flags, so an edited source rebuilds and an unchanged one is only loaded),
and ctypes loads it. Nothing here includes PyTorch's headers. The build
happens at a kernel's first launch, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    homes.append("/usr/local/cuda")
    for h in homes:
        if h and (Path(h) / "bin" / "nvcc").is_file():
            return str(Path(h) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH, CUDA_HOME or "
                       "torch.utils.cpp_extension.CUDA_HOME: cannot build the kernels")


def build_library(source: Path) -> Path:
    """Compile `source` into _build/<hash>/lib<stem>.so unless that build
    exists (nvcc's output beside it in nvcc.log). Returns the library's path."""
    src = source.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = BUILD_ROOT / key
    lib = out_dir / f"lib{source.stem}.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so", delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp_path), str(source)],
                              capture_output=True, text=True, check=False)
        (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_path, lib)
    finally:
        tmp_path.unlink(missing_ok=True)
    return lib


class Library:
    """One C entry point of a kernel source, built and loaded on first use.
    argtypes: ctypes.c_void_p for every pointer and the stream."""

    def __init__(self, source: Path, symbol: str, argtypes):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self._fn = None

    def fn(self):
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(build_library(self.source))), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
