"""The port's engine, device policy, RNG stream and import boundary, on the
CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from probgan_tpu_torch.core.device import device_report, device_str, resolve_device
from probgan_tpu_torch.core.rng import RngStream
from probgan_tpu_torch.engine import ImageGANEngine
from probgan_tpu_torch.models.pro_gan import ProGANConfig
from probgan_tpu_torch.ops import packed

PORT = Path(__file__).resolve().parent.parent / "probgan_tpu_torch"
# A config whose packed gate engages (stages 6-7); the engine on the CPU
# takes the unpacked path (engine/image.py packed_default), on the card the
# kernels.
PACKED = ProGANConfig(resolution=512, latent_dim=16, fmap_base=512, fmap_max=64)


def test_engine_generate_cpu_shape_dtype():
    engine = ImageGANEngine(PACKED, device="cpu", seed=3)
    assert engine.final_stage == 7
    z = engine.sample_latents(2)
    assert z.shape == (2, 16) and z.device.type == "cpu"
    before = dict(packed.launches)
    img = engine.generate(z)
    assert isinstance(img, np.ndarray) and img.dtype == np.uint8
    assert img.shape == (2, 512, 512, 3)
    assert packed.launches == before  # CPU: no kernel launches
    # same seed -> same weights and latents -> same images
    twin = ImageGANEngine(PACKED, device="cpu", seed=3)
    zt = twin.sample_latents(2)
    assert torch.equal(zt, z)
    np.testing.assert_array_equal(twin.generate(zt), img)
    # numpy latents, a lower stage and a fade-in alpha
    img = engine.generate(np.zeros((1, 16), np.float32), stage=3, alpha=0.5)
    assert img.shape == (1, 32, 32, 3)


@pytest.mark.parametrize("grade", [None, "default", "fast"])
def test_engine_rejects_bf16_grades(grade, monkeypatch):
    """An engine at a bf16 grade serves on the CPU (unpacked there). With its
    packed path on, as on the card (here through the twins), it renders the
    late stages in kernel mode "default", under PROBGAN_STAGE_FUSED=1 too
    (which raised before the stage-fused kernels had the bf16 modes: now the
    same images). At "fast" it scores with D's packed stage in kernel mode
    "mid", near the "high" engine's logits."""
    engine = ImageGANEngine(PACKED, device="cpu", precision=grade, seed=3)
    z = engine.sample_latents(1)
    img = engine.generate(z, stage=6)
    assert img.dtype == np.uint8 and img.shape == (1, 256, 256, 3)
    engine.packed = True
    packed = engine.generate(z, stage=6)
    _, _, psnr = _uint8_psnr(packed, img)
    assert psnr > 30.0  # one bf16 pass in the packed stage (~3 significant digits)
    reals = img.astype(np.float32) / 127.5 - 1.0
    logits = engine.score(reals, stage=6)
    assert np.isfinite(logits).all()
    if grade == "fast":
        high = ImageGANEngine(PACKED, g_params=engine.g_params, d_params=engine.d_params,
                              device="cpu", precision="high")
        high.packed = True
        np.testing.assert_allclose(logits, high.score(reals, stage=6), rtol=1e-2, atol=1e-2)
    monkeypatch.setenv("PROBGAN_STAGE_FUSED", "1")
    np.testing.assert_array_equal(engine.generate(z, stage=6), packed)


def _uint8_psnr(a, b):
    d = a.astype(np.float64) - b.astype(np.float64)
    mse = float(np.mean(d * d))
    return np.abs(d).max(), mse, 10 * np.log10(255.0**2 / mse) if mse else float("inf")


@pytest.mark.parametrize("spec", ["auto", "cuda", "gpu"])
def test_accelerator_specs_never_land_on_cpu(spec):
    if torch.cuda.is_available():
        assert resolve_device(spec) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(spec)


def test_device_policy_cpu_and_unknown():
    assert resolve_device("cpu") == torch.device("cpu")
    assert device_str(resolve_device("cpu")) == "cpu:0"
    with pytest.raises(ValueError):
        resolve_device("tpu")
    report = device_report()
    assert report["accelerator_count"] == len(report["devices"])


def test_rng_stream_is_per_task():
    a, b = RngStream(7), RngStream(7)
    a.next_generator("other")  # another task's draws do not shift this one's
    x = torch.randn(4, generator=a.next_generator("t"))
    y = torch.randn(4, generator=b.next_generator("t"))
    assert torch.equal(x, y)
    assert not torch.equal(torch.randn(4, generator=b.next_generator("t")), y)
    assert a.counter("t") == 1 and b.counter("t") == 2


def test_import_leaves_jax_out():
    """Importing the port and every module in it loads no jax, flax, optax,
    msgpack or orbax (a subprocess: the test process itself has jax loaded by
    conftest)."""
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'orbax', 'probgan_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=PORT.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(modules) >= 40
    for name in ("engine.inference", "engine.image", "core.image_checkpoint", "ops.image",
                 "ops.packed", "ops.rank_fused", "cli.infer", "utils.demo_checkpoint",
                 "utils.profile_score", "engine.train", "ops.packed_vjp", "core.train_state",
                 "core.tree", "utils.profile_train", "cli.train", "cli.train_image",
                 "native"):
        assert f"probgan_tpu_torch.{name}" in modules


def test_kernel_sources_are_the_build_list():
    """Every CUDA source of the port is a kernel that ops/_build.py builds (or
    the clock-split probe, utils/conv_clock_split.py's), the stage-fused
    bf16 kernels among them, and the headers they include are the port's
    own: no source reaches outside csrc/."""
    from probgan_tpu_torch.ops import _build

    sources = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert sources == set(_build.KERNELS) | {"conv_clock_split"}
    assert {"packed_upconv_conv_bf16", "packed_upconv_conv_rgb_bf16"} <= set(_build.KERNELS)
    include = re.compile(r'^#include\s+"([^"]+)"', re.MULTILINE)
    for src in (PORT / "csrc").iterdir():
        for name in include.findall(src.read_text()):
            assert (PORT / "csrc" / name).is_file(), (src.name, name)


def test_sources_import_no_jax_and_no_jax_package():
    forbidden = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|msgpack|orbax|probgan_tpu(?!_torch))\b",
        re.MULTILINE
    )
    files = list(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in forbidden.finditer(f.read_text())]
    assert not hits, hits
    # the regex itself: the port's own name passes, the JAX package does not
    assert forbidden.search("from probgan_tpu.ops import x")
    assert not forbidden.search("from probgan_tpu_torch.ops import x")
    assert forbidden.search("import msgpack")
    assert forbidden.search("import optax")
    assert not forbidden.search("from probgan_tpu_torch.core import _msgpack")
