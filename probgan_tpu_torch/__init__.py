"""probgan_tpu_torch — the PyTorch / CUDA port of ``probgan_tpu``.

It mirrors the JAX package's layout and names so that each module has an
obvious counterpart, and it imports ``torch``, numpy and the standard library
only: never ``jax``, ``flax``, ``msgpack`` or anything of ``probgan_tpu``.

- ``core``    — device policy (no silent CPU fallback), RNG streams over
                ``torch.Generator``, C17 checkpoint I/O (torch ``.pt`` and
                the native msgpack through ``_msgpack``), the JAX-params
                converters.
- ``models``  — the progressive image generator (``pro_gan``), the KG
                generator and discriminator MLPs (``kg_gan``) and their
                ``nn.Module`` forms (``modular``).
- ``ops``     — the kernels written in CUDA C++ for Hopper (sources in
                ``csrc/``, built by ``_build``), each with its plain twin:
                the three late-stage generator kernels (``packed``) and the
                fused rank kernels (``rank_fused``); the cuDNN-level fused
                upsample→conv (``fused_upconv``) and the rank primitives
                (``rank``).
- ``engine``  — ``ImageGANEngine`` (latents → uint8 images) and
                ``InferenceEngine`` (the five KG link-prediction tasks).
- ``cli``     — ``infer`` (the reference's argparse surface), ``repl``,
                ``install`` (the doctor).
- ``utils``   — profiler annotations and traces, a seeded demo checkpoint,
                per-path profiles and the rank kernel's ablation.
"""

__version__ = "0.1.0"
