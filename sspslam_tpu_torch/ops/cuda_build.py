"""Compiling the package's CUDA sources (``csrc/*.cu``) with ``nvcc`` into
shared libraries under ``build/torch_kernels/`` beside the package, once per
source and flags, for ``ctypes`` to load.  Nothing here runs at import: a
kernel module builds its library at its first launch."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

__all__ = ["CSRC", "BUILD_DIR", "SM90A_FLAGS", "nvcc", "build"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
#: Hopper, nvcc's default arithmetic (no fast math, FMA contraction where
#: the source allows it), ptxas's register report for the smoke's log
SM90A_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    return shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(source: Path, stem: str,
          flags: Sequence[str] = SM90A_FLAGS) -> Tuple[str, str]:
    """Compile ``source`` into ``lib<stem>_<hash>.so`` unless this source is
    built with these flags already; returns (library path, nvcc's output —
    '' if it was built)."""
    src = Path(source).read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    lib_path = BUILD_DIR / f"lib{stem}_{tag[:16]}.so"
    if lib_path.exists():
        return str(lib_path), ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return str(lib_path), proc.stdout + proc.stderr
