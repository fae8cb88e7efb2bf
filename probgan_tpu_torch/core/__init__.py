"""Runtime core: device selection, RNG policy, JAX-params conversion."""

from probgan_tpu_torch.core.device import device_report, device_str, resolve_device
from probgan_tpu_torch.core.rng import RngStream

__all__ = ["resolve_device", "device_str", "device_report", "RngStream"]
