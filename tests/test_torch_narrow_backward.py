"""The training backward at 16 and 8 channels (the narrow generator N,
``ProGANConfig(fmap_base=2048, fmap_max=256)`` at 1024²: packed stages 6-8 at
32, 16 and 8 channels) on the CPU, against the JAX package.

- The four ``torch.autograd.Function``s of ``ops/packed_vjp.py`` at N's
  narrow (C, Cout) pairs: forward and (dx, dw, db) against ``jax.vjp`` of
  the JAX custom VJPs with the Pallas kernels in interpret mode, on the same
  numpy inputs, weights and cotangent, at "highest" and "mid", to the
  tolerances of tests/test_torch_packed_vjp.py. Two JAX calls (about 5 s
  each, the file's budget): ``conv_lrelu`` takes its pairs at once, with
  block-diagonal weights (zero products leave each block's sums and
  gradients as they are), as tests/test_torch_narrow.py does;
  ``upconv_lrelu_norm`` (PixelNorm over all Cout) one pair.
- What the CUDA wrappers hand the kernels for "none" at slabs of 16 and 8
  (B2 ``packed_conv`` and B5 ``packed_convpool``, fp32 and both bf16 modes;
  meta tensors, no card): the slab and tiling, the persistent blocks, the
  shared-memory bytes the kernels check (csrc/packed_conv.cu's own figures),
  the weight layouts, and the launches under ``narrow_launches``.
- One CPU ``progan_train_step`` with both packed gates at a small narrow
  config (256², one packed stage at 8 channels): every call it makes to the
  kernels' wrappers, replayed on meta tensors through the CUDA branch at
  each kernel mode, launches and raises nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.ops import packed_vjp as jvjp
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk
from probgan_tpu_torch.ops import packed_vjp as tvjp
from tests.test_torch_packed import TOL, _nchw, _nhwc, _oihw, _phase_blocked, _rand

VJP_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_packed_vjp.py's
# (Function, mode, N's (C, Cout) pairs), the pairs of one call
# block-diagonal: their input gradients are B2 "none" at slabs of 8 and 16
# (conv_lrelu's Cout -> C) and B5 "none" 8 -> 16 (the upconv's), at
# "highest" and "mid". tests/test_torch_packed_vjp.py holds all four
# Functions at (8, 8) and (8, 16) at "highest" and at (8, 16) at "mid".
CASES = [
    ("conv_lrelu", "highest", ((8, 8), (16, 16))),  # D's conv1, stages 8 and 7
    ("upconv_lrelu_norm", "mid", ((16, 8),)),       # G's upconv, stage 8
]
# output scale and phase count out / in of each Function
_SCALE = {"conv_lrelu": 1, "convpool_lrelu": 0.5, "conv_lrelu_norm": 1, "upconv_lrelu_norm": 2}


def _hwio(w_oihw: torch.Tensor) -> np.ndarray:
    return w_oihw.detach().numpy().transpose(2, 3, 1, 0)


def _torch_vjp(fn, x, w, b, cot):
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))


@pytest.mark.parametrize("name,mode,pairs", CASES)
def test_functions_at_narrow_pairs_match_jax_vjp(name, mode, pairs):
    scale = _SCALE[name]
    p, b, h, w = 2, 1, 16, 32
    p_out = int(p * scale)
    cs, cos = [c for c, _ in pairs], [co for _, co in pairs]
    wgt = np.zeros((3, 3, sum(cs), sum(cos)), np.float32)
    slices = []
    for k, (c, co) in enumerate(pairs):
        ci, oi = sum(cs[:k]), sum(cos[:k])
        wgt[:, :, ci:ci + c, oi:oi + co] = _rand((3, 3, c, co), 31 + k, 0.2)
        slices.append((slice(ci, ci + c), slice(oi, oi + co)))
    x = _rand((b, h, w, sum(cs)), 30)
    bias = _rand((sum(cos),), 32)
    cot = _rand((b, int(h * scale), int(w * scale), sum(cos)), 33)
    jax_fn = getattr(jvjp, name)
    y_j, vjp_fn = jax.vjp(lambda xp, wg, bi: jax_fn(xp, wg, bi, p, mode),
                          _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias))
    dx_j, dw_j, db_j = vjp_fn(_phase_blocked(cot, p_out))
    y_j, dx_j = np.asarray(pk.packed_rgb_to_nhwc(y_j, p_out)), np.asarray(
        pk.packed_rgb_to_nhwc(dx_j, p))
    dw_j, db_j = np.asarray(dw_j), np.asarray(db_j)
    before = dict(tpk.launches)
    for ci, oi in slices:
        y, dx, dw, db = _torch_vjp(
            lambda *a: getattr(tvjp, name)(*a, mode=mode), _nchw(x[..., ci]),
            _oihw(wgt[:, :, ci, oi]), torch.from_numpy(bias[oi]), _nchw(cot[..., oi]))
        np.testing.assert_allclose(_nhwc(y), y_j[..., oi], **TOL)
        np.testing.assert_allclose(_nhwc(dx), dx_j[..., ci], **VJP_TOL)
        np.testing.assert_allclose(_hwio(dw), dw_j[:, :, ci, oi], **VJP_TOL)
        np.testing.assert_allclose(db.numpy(), db_j[oi], **VJP_TOL)
    assert tpk.launches == before  # CPU tensors take the plain twins


# -- what the wrappers hand the kernels for "none" at 16 and 8 ----------------


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _shape_check(name, x, cin, h_mult, w_mult, **params):
    """ops/packed.py ``_check`` without its device test (meta tensors stand
    in for the card): the shape conditions the kernels rely on."""
    _, c, h, w = x.shape
    if c != cin or c % 8 or h % h_mult or w % w_mult:
        raise ValueError(f"{name}: x {tuple(x.shape)}: C {cin}, H % {h_mult}, W % {w_mult}")


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on meta tensors as on the card: an H100's 132 SMs, the
    shape checks, and the C launch recording (name, args), pointers as the
    tensors themselves; the launches are counted as the card counts them."""
    calls = []
    monkeypatch.setattr(tpk, "_check", _shape_check)
    monkeypatch.setattr(tpk, "_sms", lambda device: 132)
    monkeypatch.setattr(tpk, "_aligned16", lambda x: x)
    monkeypatch.setattr(tpk, "_ptr", lambda t: t)
    monkeypatch.setattr(tpk._build, "launch", lambda name, argtypes, device, *args:
                        calls.append((name, args)))
    tpk.reset_launches()
    yield calls
    tpk.reset_launches()


# (kernel, C, Cout, H) of N's step at batch 2: B2 "none" at slabs 8 and 16,
# B5 "none" at 16, and B5 at a slab of 8 (no step at N reaches it)
NONE_SHAPES = [("packed_conv", 8, 8, 1024), ("packed_conv", 16, 8, 1024),
               ("packed_conv", 16, 16, 512), ("packed_conv", 32, 16, 512),
               ("packed_convpool", 8, 16, 1024), ("packed_convpool", 8, 8, 1024)]


@pytest.mark.parametrize("mode", ["highest", "default", "mid"])
def test_none_wrappers_hand_the_kernels_the_narrow_slabs(recorded, mode):
    with torch.no_grad():
        for kernel, c, cout, h in NONE_SHAPES:
            getattr(tpk, kernel)(_meta(2, c, h, h), _meta(cout, c, 3, 3), _meta(cout), "none",
                                 mode=mode)
    terms = tpk.BF16_TERMS.get(mode, 0)
    suffix = {0: "", 1: "_bf16", 2: "_mid"}[terms]
    assert [n for n, _ in recorded] == [k + ("_bf16" if terms else "") for k, *_ in NONE_SHAPES]
    for (kernel, c, cout, h), (_, args) in zip(NONE_SHAPES, recorded):
        slab = min(cout, 16)
        x, wk = args[0], args[1]
        assert tuple(x.shape) == (2, c, h, h) and args[4:9] == (2, c, h, h, cout)
        if terms and kernel == "packed_conv":  # (..., cout, terms, epilogue, blocks, smem)
            assert tuple(wk.shape) == (cout // slab, 1, 9, slab, tpk.BF16_ROW)
            assert args[9:] == (terms, 2, 132, tpk.bf16_ring_bytes(cout))
        elif terms:  # (..., cout, terms, act, blocks, smem): B2's bf16 ring
            assert tuple(wk.shape) == (cout // slab, 1, 9, slab, tpk.BF16_ROW)
            assert args[9:] == (terms, 0, 132, tpk.bf16_ring_bytes(cout))
        elif kernel == "packed_conv":  # (..., epilogue, o_slab, rows, blocks, smem)
            assert tuple(wk.shape) == (cout // slab, c, 3, 3, slab)
            assert args[9:] == (2, slab, 16, 132, tpk.none_ring_bytes(cout))
        else:  # (..., cout, act, blocks, smem): the fp32 ring, two blocks an SM
            assert tuple(wk.shape) == (cout // slab, c, 3, 3, slab)
            assert args[9:] == (0, 264, tpk.conv_ring_bytes(cout))
    assert tpk.narrow_launches == {f"packed_conv{suffix}[cout8]": 2,
                                   f"packed_conv{suffix}[cout16]": 2,
                                   f"packed_convpool{suffix}[cout16]": 1,
                                   f"packed_convpool{suffix}[cout8]": 1}
    assert tpk.epilogue_launches[f"packed_conv{suffix}[none]"] == 4
    assert tpk.epilogue_launches[f"packed_convpool{suffix}[none]"] == 2


def test_none_shared_memory_and_slabs():
    """The "none" kernel's bytes at each slab are the figures of
    csrc/packed_conv.cu (NoneTile: 3 stages of 16 channels, the halo patch
    and the weights padded to 8 or 24 floats mod 32): one block an SM at
    every slab; Cout 24 and 48 take three slabs of 8 and 16."""
    text = open(tpk.__file__.rsplit("/ops/", 1)[0] + "/csrc/packed_conv.cu").read()
    for cout, want in ((64, 190_464), (32, 196_608), (16, 168_960), (8, 153_600)):
        assert tpk.none_ring_bytes(cout) == want and f"{want:,}" in text
        assert tpk.ring_blocks_per_sm(want) == 1 and want <= tpk.SMEM_PER_BLOCK
    wrow = {s: 9 * s + (0 if s == 8 else 8) for s in (8, 16, 32, 64)}
    assert {s: r % 32 for s, r in wrow.items()} == {8: 8, 16: 24, 32: 8, 64: 8}
    assert [tpk.conv_tiling(c) for c in (24, 48)] == [(8, 16), (16, 16)]
    assert tpk.none_ring_bytes(24) == tpk.none_ring_bytes(8)


# -- one CPU train step's wrapper calls, replayed as on the card ----------------

# 256², stage 6: one packed stage in G and in D at 8 channels (D's conv2 to 16)
NARROW = dict(resolution=256, latent_dim=8, fmap_base=512, fmap_max=16)
WRAPPERS = ("packed_upconv", "packed_conv", "packed_convpool", "packed_conv_wgrad",
            "packed_conv_rgb")


def test_train_step_calls_replay_on_the_card(recorded, monkeypatch):
    """A spy on the wrappers during one CPU step at the default
    packed_train_mode records each (kernel, epilogue, mode, shapes); each,
    replayed on meta tensors through the CUDA branch at "highest", "mid" and
    "default", raises nothing, and the step's "none" launches are narrow."""
    seen, real = [], {name: getattr(tpk, name) for name in WRAPPERS}
    for name, fn in real.items():

        def spy(*args, _name=name, _real=fn, **kwargs):
            seen.append((_name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                                      for a in args),
                         {k: tuple(v.shape) if torch.is_tensor(v) else v
                          for k, v in kwargs.items()}))
            return _real(*args, **kwargs)

        monkeypatch.setattr(tpk, name, spy)
    cfg = tpg.ProGANConfig(**NARROW)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    gen = torch.Generator().manual_seed(5)
    real_images, z = torch.tanh(torch.randn((2, 256, 256, 3), generator=gen)), torch.randn(
        (2, 8), generator=gen)
    _, m = ttrain.progan_train_step(state, real_images, z, 0.7, cfg, 6, packed_d=True,
                                    packed_g=True)  # CPU tensors: the twins, no launch
    assert all(np.isfinite(float(v)) for v in m.values()) and not recorded
    for name, fn in real.items():  # the wrappers again, on meta tensors now
        monkeypatch.setattr(tpk, name, fn)
    calls = sorted(set((n, a, tuple(sorted(k.items()))) for n, a, k in seen), key=repr)
    assert {"packed_conv", "packed_convpool", "packed_conv_wgrad", "packed_upconv"} <= {
        n for n, _, _ in calls}
    assert all(dict(k).get("mode", "default") == "default" for _, _, k in calls)
    for mode in ("highest", "mid", "default"):
        tpk.reset_launches()
        recorded.clear()
        with torch.no_grad():
            for name, args, kwargs in calls:
                meta = [_meta(*a) if isinstance(a, tuple) else a for a in args]
                kw = {k: _meta(*v) if isinstance(v, tuple) else v for k, v in kwargs}
                getattr(tpk, name)(*meta, **{**kw, "mode": mode})
        assert len(recorded) == len(calls)
        suffix = {"highest": "", "default": "_bf16", "mid": "_mid"}[mode]
        # the input gradients at the step's 8 and 16 channels
        assert tpk.narrow_launches.get(f"packed_conv{suffix}[cout8]", 0) >= 1
        assert tpk.narrow_launches.get(f"packed_convpool{suffix}[cout16]", 0) >= 1
        assert tpk.epilogue_launches[f"packed_conv{suffix}[none]"] >= 1
        assert tpk.epilogue_launches[f"packed_convpool{suffix}[none]"] >= 1
