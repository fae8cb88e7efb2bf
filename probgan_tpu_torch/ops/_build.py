"""Build and load the CUDA kernels in ``probgan_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Nothing is
built when the package is imported: the first CUDA launch of a kernel builds
it (a few seconds), and ``build()`` starts one ``nvcc`` per source, all at
once. Libraries land in ``probgan_tpu_torch/build/``, named by a hash of the
sources and flags, so an edited source is rebuilt and a stale library is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
KERNELS = ("packed_upconv", "packed_conv", "packed_conv_rgb", "packed_convpool",
           "packed_conv_wgrad", "packed_upconv_conv", "packed_upconv_conv_rgb",
           "denorm_uint8", "rank_topk", "rank_scores", "rank_topk_bf16",
           "packed_upconv_bf16", "packed_conv_bf16", "packed_conv_rgb_bf16",
           "packed_convpool_bf16", "packed_conv_wgrad_bf16", "packed_upconv_conv_bf16",
           "packed_upconv_conv_rgb_bf16")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on first use and need "
            "the CUDA toolkit"
        )
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS, ptxas_info: bool = False) -> dict[str, str]:
    """Compile every kernel in ``names`` that has no current library, one
    ``nvcc`` process per source, all started together. Returns
    {name: nvcc's stderr} for what was compiled (with ``ptxas_info`` it holds
    each kernel's registers, shared memory and spills). Raises RuntimeError
    naming each source that failed."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        logs[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.probgan_error_string.argtypes = [ctypes.c_int]
        lib.probgan_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(name: str, argtypes: list, device: torch.device, *args) -> None:
    """Call kernel ``name``'s C entry point ``probgan_<name>(*args, stream)``
    on ``device``'s current stream. Raises RuntimeError when the launch is
    refused (the entry point returns the launch's cudaError_t)."""
    lib = load(name)
    fn = getattr(lib, f"probgan_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.probgan_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err} ({msg})")
