"""The port's denorm kernel wrapper (probgan_tpu_torch/ops/image.py) on the
CPU: its plain twin against the JAX package's Pallas kernel in interpret mode
(as tests/test_pallas_kernels.py runs it), on the same numpy inputs.

Tolerance: equal bytes, or +-1 only where (tanh(x) + 1) * 127.5 lies within
1e-3 of a half (the two tanh implementations differ in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import pallas_image
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import image as tim


def _assert_equal_off_boundaries(got, want, x):
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    pre = (np.tanh(x.astype(np.float64)) + 1.0) * 127.5
    off_half = np.abs(pre - np.floor(pre) - 0.5)
    assert (off_half[d != 0] < 1e-3).all(), off_half[d != 0]


@pytest.mark.parametrize("shape", [(2, 32, 64, 3), (1, 64, 64, 3), (32, 128)])
def test_to_uint8_fused_matches_pallas(shape):
    x = (np.random.RandomState(0).standard_normal(shape) * 1.5).astype(np.float32)
    assert pallas_image.supports(shape)  # the JAX side runs its kernel
    want = np.asarray(pallas_image.to_uint8_fused(jnp.asarray(x), interpret=True))
    before = dict(tim.launches)
    got = tim.to_uint8_fused(torch.from_numpy(x)).numpy()
    assert tim.launches == before  # CPU tensors take the plain twin
    _assert_equal_off_boundaries(got, want, x)


@pytest.mark.parametrize("shape", [(3, 5, 7), (1,), (1027,)])
def test_to_uint8_fused_takes_any_count(shape):
    """Counts that do not tile into the JAX kernel's (32, 128) blocks: the
    JAX function falls back to to_uint8, the port's has no such branch."""
    x = (np.random.RandomState(1).standard_normal(shape) * 2.0).astype(np.float32)
    assert not pallas_image.supports(shape)
    want = np.asarray(pallas_image.to_uint8_fused(jnp.asarray(x), interpret=True))
    got = tim.to_uint8_fused(torch.from_numpy(x)).numpy()
    _assert_equal_off_boundaries(got, want, x)
    np.testing.assert_array_equal(got, tpg.to_uint8(torch.from_numpy(x)).numpy())


def test_to_uint8_fused_saturates_and_rounds_half_to_even():
    x = torch.tensor([-50.0, -1e-9, 0.0, 50.0, float("inf"), float("-inf")])
    np.testing.assert_array_equal(tim.to_uint8_fused(x).numpy(), [0, 128, 128, 255, 255, 0])


def test_to_uint8_fused_raises_off_cpu_without_cuda():
    before = dict(tim.launches)
    with pytest.raises(RuntimeError, match="not supported"):
        tim.to_uint8_fused(torch.zeros((2, 3), device="meta"))
    assert tim.launches == before
