"""Device selection policy.

Accepted specs: ``auto|cuda|gpu|cpu`` (``tpu`` is not a torch device).
``auto``, ``cuda`` and ``gpu`` all mean "the first CUDA card" and raise when
there is none; ``cpu`` is honoured only when the caller asks for it.
"""

from __future__ import annotations

import torch

_ACCEL_ALIASES = ("auto", "cuda", "gpu")


def resolve_device(spec: str = "auto") -> torch.device:
    """Resolve a device spec string to a concrete ``torch.device``.

    Raises:
        RuntimeError: if an accelerator was requested (``auto`` included) but
            ``torch.cuda.is_available()`` is False.
        ValueError: for an unknown spec.
    """
    spec = (spec or "auto").lower()
    if spec == "cpu":
        return torch.device("cpu")
    if spec in _ACCEL_ALIASES:
        # Deliberately unlike the JAX policy, which falls back to the CPU on
        # "auto": a port whose hot path is CUDA kernels must not quietly run
        # their plain CPU twins and report it as the card's result.
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"Device '{spec}' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain CPU path"
            )
        return torch.device("cuda", 0)
    raise ValueError(f"Unknown device spec: {spec!r}")


def device_str(device: torch.device) -> str:
    """Short human-readable device name, e.g. 'cuda:0' or 'cpu:0'."""
    return f"{device.type}:{device.index or 0}"


def device_report() -> dict:
    """Structured report of the attached devices: the CUDA cards' names and
    count (the installer doctor's view)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "backend": "cuda" if n else "cpu",
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "accelerator_count": n,
        "devices": [
            {"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i)}
            for i in range(n)
        ],
    }
