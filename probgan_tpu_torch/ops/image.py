"""The fused denorm kernel: Python side.

The counterpart of ``probgan_tpu/ops/pallas_image.py``. ``to_uint8_fused``
is the drop-in for ``models/pro_gan.to_uint8``: tanh -> (t + 1) * 127.5 ->
round half to even -> clip to [0, 255] -> uint8, in one pass written by hand
in CUDA C++ for Hopper (``csrc/denorm_uint8.cu``). The kernel takes any
contiguous fp32 tensor of any element count, so unlike the JAX function there
is no shape gate and no fallback.

``to_uint8_fused_plain`` is its plain PyTorch twin. The wrapper takes the
twin only for CPU tensors; for a CUDA tensor it launches the kernel or
raises. The two may differ by 1 where tanh lands on a rounding boundary (the
card's ``tanhf`` and torch's differ in the last bit). ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from probgan_tpu_torch.models.pro_gan import to_uint8
from probgan_tpu_torch.ops import _build

# Launches of the kernel since the last reset_launches(); the wrapper adds
# one where it launches the kernel and nowhere else.
launches = {"to_uint8_fused": 0}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def to_uint8_fused_plain(rgb: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``to_uint8_fused``."""
    return to_uint8(rgb)


def to_uint8_fused(rgb: torch.Tensor) -> torch.Tensor:
    """fp32 pre-tanh RGB of any shape -> uint8 of the same shape."""
    if rgb.device.type == "cpu":
        return to_uint8_fused_plain(rgb)
    name = "to_uint8_fused"
    if rgb.device.type != "cuda":
        raise RuntimeError(
            f"{name}: tensors on {rgb.device.type!r} are not supported; the "
            "kernel runs on CUDA and its plain twin on the CPU"
        )
    if rgb.dtype != torch.float32 or not rgb.is_contiguous() or rgb.numel() < 1:
        raise ValueError(
            f"{name}: rgb must be a non-empty contiguous float32 tensor, got "
            f"{rgb.dtype} {tuple(rgb.shape)} contiguous={rgb.is_contiguous()}"
        )
    out = torch.empty(rgb.shape, device=rgb.device, dtype=torch.uint8)
    vec = int(rgb.data_ptr() % 16 == 0 and out.data_ptr() % 4 == 0)
    _build.launch("denorm_uint8", _ARGTYPES, rgb.device, rgb.data_ptr(),
                  out.data_ptr(), rgb.numel(), vec)
    launches[name] += 1
    return out
