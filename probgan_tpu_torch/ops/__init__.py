"""Compute ops: the cuDNN-level fused upsample→conv and the late-stage
generator kernels written in CUDA C++ for Hopper, each with its plain
PyTorch twin."""
