"""probgan_tpu_torch — the PyTorch / CUDA port of ``probgan_tpu``.

It mirrors the JAX package's layout and names so that each module has an
obvious counterpart, and it imports ``torch``, numpy and the standard library
only: never ``jax``, ``flax`` or anything of ``probgan_tpu``.

- ``core``    — device policy (no silent CPU fallback), RNG streams over
                ``torch.Generator``, the JAX-params converter.
- ``models``  — the progressive image generator (``pro_gan``).
- ``ops``     — the fused upsample→conv (cuDNN-level) and the three
                late-stage generator kernels written in CUDA C++ for Hopper
                (``packed``; sources in ``csrc/``, built by ``_build``).
- ``engine``  — ``ImageGANEngine``: latents → uint8 images.
- ``utils``   — profiler annotations.
"""

__version__ = "0.1.0"
