"""Build and load the package's CUDA kernels (one shared library).

Every ``*.cu`` file of ``scp_tpu_torch/csrc`` is compiled with ``nvcc`` for
``sm_90a`` (one compiler process per source, all started together) and linked
into ONE shared library with a plain C interface, loaded with ``ctypes``. The
library is built at first use into ``build/`` at the repository root and is
keyed by a hash of every source and header, the flags and the defines, so an
edit rebuilds it and nothing else does. A failing build or load raises; no
caller carries on without the library.

The kernel wrappers (``ops/ipm_kernel.py``, ``ops/linalg_kernel.py``,
``ops/riccati_kernel.py``) call :func:`load_library` inside the call that
launches, never at import; :func:`check_operands` and :func:`launch` are
their shared operand check and launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

# Dynamic shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT_BYTES = 232_448

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# Preprocessor defines of the build; a diagnostic script may set this before
# the first use (scripts/torch_k1_sections.py builds with
# SCP_PROFILE_SECTIONS). It is part of the library's hash.
BUILD_DEFINES: tuple = ()

_lib = None


def sources() -> list[Path]:
    """The ``*.cu`` files of ``csrc/``, sorted by name."""
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS + tuple(BUILD_DEFINES)).encode())
    return BUILD_DIR / f"libscp_kernels_{h.hexdigest()[:16]}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile and link the library if this source hash has not been built.
    With ``verbose`` the compilers' ``ptxas -v`` reports are printed."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tag = f"{out.stem}.{os.getpid()}"
    base = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in BUILD_DEFINES)]
    if verbose:
        base += ["-Xptxas", "-v"]
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            base + ["-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, proc in procs:
        so, se = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{so}\n{se}")
        elif verbose:
            print(se)
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
             *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def load_library():
    """Build (if needed) and load the kernel library; cached per process.
    The wrappers set the ``argtypes`` of the functions they call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build_library()))
    return _lib


def check_operands(name: str, shapes) -> bool:
    """``shapes``: (tensor, wanted shape) pairs; the first sets dtype and
    device. Returns True when the kernel takes the call (CUDA tensors):
    float32 and contiguous, else ``TypeError`` / ``ValueError``. CPU tensors
    return False (the caller runs the plain version)."""
    first = shapes[0][0]
    for t, shape in shapes:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name}: dtype/device differ between operands")
    if min(first.shape) == 0:
        raise ValueError(f"{name}: empty operand {tuple(first.shape)}")
    if first.device.type != "cuda":
        return False
    if first.dtype != torch.float32:
        raise TypeError(
            f"the CUDA {name} kernel is float32 only, got {first.dtype}")
    for t, _ in shapes:
        if not t.is_contiguous():
            raise ValueError(f"the CUDA {name} kernel needs contiguous "
                             f"tensors")
    return True


def launch(symbol: str, argtypes: list, first: torch.Tensor, *args) -> None:
    """Call the library's launcher ``symbol`` with ``args`` and the current
    stream of ``first``'s device; a non-zero return raises."""
    fn = getattr(load_library(), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(first.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{symbol} failed with CUDA error {err} (args {args[-4:]})")
