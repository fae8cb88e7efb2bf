"""The training backward at any width up to 64 (the training half of
ROADMAP.md B.a.2.4): the packed train step of the generators whose packed
stages are 4 or 2 channels wide or no multiple of 8 (fmap_base 1024, 512 and
3072 at 1024²: T, T2 and O) on the CPU, against the JAX package.

- The ``torch.autograd.Function``s of ``ops/packed_vjp.py`` at T's 8 -> 4
  and 4 -> 4, T2's 4 -> 2 and 2 -> 2 and O's 24 -> 12 and 12 -> 12: forward
  and (dx, dw, db) against ``jax.vjp`` of the JAX custom VJPs (Pallas
  kernels in interpret mode) on the same numpy inputs, weights and
  cotangent, at "highest" and "mid", to tests/test_torch_packed_vjp.py's
  ``VJP_TOL``. ``conv_lrelu`` takes the six pairs in one JAX call, its
  weights block-diagonal (zero products leave each block's sums and
  gradients as they are); ``conv_lrelu_norm`` and ``upconv_lrelu_norm``
  (PixelNorm over all Cout) one pair a call. Their backward reaches B1
  "lrelu" and B2 "lrelu" (the recompute), B2 and B5 "none" (the input
  gradients) and B6 at these widths.
- One whole ``progan_train_step(packed_g=True, packed_d=True,
  packed_train_mode="highest")`` at ``ProGANConfig(resolution=256,
  latent_dim=8, fmap_max=64)``, stage 6, batch 2, alpha 0.7, against JAX's
  from the same state: at fmap_base 256 (the packed stage 8 -> 4, 4 -> 4,
  T's last) and 768 (24 -> 12, 12 -> 12, O's). Metrics rtol 1e-4; D's
  moments (its gradients: b1 = 0) within 1e-3 of each leaf's largest entry
  and its parameters ``PARAM_TOL`` (tests/test_torch_train.py's rules); so
  the packed stage's G moments and parameters. The whole step is
  ill-conditioned to fp32 rounding at these widths (narrow PixelNorm layers
  divide it by their RMS), so each other G moment is held within the 1e-3
  rule or ``EXACT_MULT`` times JAX's own distance from the exact step (the
  port's unpacked step in float64), and a G parameter may leave
  ``PARAM_TOL`` only where the two gradients differ by as much as JAX's
  gradient itself (a first Adam update is about lr * sign(gradient)). The
  port's packed step against its unpacked step: every G moment within 1e-4
  of its leaf's largest entry.
- What the CUDA wrappers hand the kernels at these widths (meta tensors,
  no card): the weights and bias zero-padded to the slab (Cout rounded up to
  8) or B1's tile, the true C and Cout, the tiling and persistent blocks,
  the shared-memory bytes against the kernels' own arithmetic,
  ``wgrad_ksplit`` at C and Cout in {2, 4, 12}, and the launches under
  ``narrow_launches`` by the true Cout. And one CPU step at fmap_base 256,
  every wrapper call it makes replayed on meta tensors through the CUDA
  branch at "highest", "mid" and "default": each launches, none raises.
On the card chip_smoke.py phase 23 holds the kernels against these twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu.ops import packed_vjp as jvjp
from probgan_tpu.ops import pallas_packed as pk
from probgan_tpu_torch.core import convert
from probgan_tpu_torch.core.tree import tree_leaves, tree_map
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg
from probgan_tpu_torch.ops import packed as tpk
from probgan_tpu_torch.ops import packed_vjp as tvjp
from tests.test_torch_any_width import _bf16_ring_bytes, _conv_ring_bytes, _upconv_ring_bytes
from tests.test_torch_packed import TOL, _nchw, _nhwc, _oihw, _phase_blocked, _rand
from tests.test_torch_train import (
    LR,
    PARAM_TOL,
    _assert_grads,
    _assert_metrics,
    _assert_params,
)

VJP_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_torch_packed_vjp.py's
# T's, T2's and O's new (C, Cout) pairs: each stage's upconv C -> Cout and
# its conv2 Cout -> Cout
PAIRS = ((8, 4), (4, 4), (4, 2), (2, 2), (24, 12), (12, 12))
# (Function, mode, pairs of one JAX call); conv_lrelu_norm at "highest" and
# 4 -> 4 is the packed stage's conv2 in the whole step below
CASES = [
    ("conv_lrelu", "highest", PAIRS), ("conv_lrelu", "mid", PAIRS),
    ("conv_lrelu_norm", "mid", ((12, 12),)),
    ("upconv_lrelu_norm", "highest", ((4, 2),)), ("upconv_lrelu_norm", "mid", ((24, 12),)),
]
_SCALE = {"conv_lrelu": 1, "conv_lrelu_norm": 1, "upconv_lrelu_norm": 2}  # output / input size


def _hwio(w_oihw: torch.Tensor) -> np.ndarray:
    return w_oihw.detach().numpy().transpose(2, 3, 1, 0)


def _torch_vjp(fn, x, w, b, cot):
    x, w, b = (t.clone().requires_grad_(True) for t in (x, w, b))
    y = fn(x, w, b)
    return (y.detach(), *torch.autograd.grad(y, (x, w, b), cot))


@pytest.mark.parametrize("name,mode,pairs", CASES)
def test_functions_at_any_width_match_jax_vjp(name, mode, pairs):
    scale = _SCALE[name]
    p, b, h, w = 2, 1, 16, 32
    p_out = int(p * scale)
    cs, cos = [c for c, _ in pairs], [co for _, co in pairs]
    wgt = np.zeros((3, 3, sum(cs), sum(cos)), np.float32)
    slices = []
    for k, (c, co) in enumerate(pairs):
        ci, oi = sum(cs[:k]), sum(cos[:k])
        wgt[:, :, ci:ci + c, oi:oi + co] = _rand((3, 3, c, co), 41 + k, 0.3)
        slices.append((slice(ci, ci + c), slice(oi, oi + co)))
    x = _rand((b, h, w, sum(cs)), 40)
    bias = _rand((sum(cos),), 39, 0.1)
    cot = _rand((b, int(h * scale), int(w * scale), sum(cos)), 38)
    y_j, vjp_fn = jax.vjp(lambda xp, wg, bi: getattr(jvjp, name)(xp, wg, bi, p, mode),
                          _phase_blocked(x, p), jnp.asarray(wgt), jnp.asarray(bias))
    dx_j, dw_j, db_j = vjp_fn(_phase_blocked(cot, p_out))
    y_j = np.asarray(pk.packed_rgb_to_nhwc(y_j, p_out))
    dx_j = np.asarray(pk.packed_rgb_to_nhwc(dx_j, p))
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


# -- the whole step against JAX -------------------------------------------------

STAGE = 6
CONFIG = dict(resolution=256, latent_dim=8, fmap_max=64)
# How far the JAX gap of a G moment outside the packed stage may reach
# beyond the 1e-3 rule: this many times JAX's own distance from the exact
# step (the port's unpacked step in float64). fp32 rounding moves the trunk's
# moments at these widths by up to ~1e-2 of their largest entry (narrow
# PixelNorm layers divide it by their RMS), and not in one package only:
# from JAX's init at fmap_base 256 JAX's fp32 step lies 7.6e-3 from the
# float64 step and the port's 4.9e-5; from this file's init both lie
# 0.9-1.4e-3 from it and 1.1e-4 (256) / 7.8e-4 (768) from each other. The
# port with torch.backends.mkldnn off moves them by 1.5e-5 (JAX's init,
# 256) to 5.8e-3 (JAX's init, 768): no steady measure to bound by.
# ``python -m tests.test_torch_any_width_backward`` prints the four per leaf.
EXACT_MULT = 2.0


def _step_inputs():
    return _rand((2, 256, 256, 3), 50), _rand((2, 8), 51)


def _leaf_paths(tree, prefix=""):
    """Leaf paths in tree_leaves' order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _leaf_paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _leaf_paths(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _both_states(cfg, jax_init=False):
    """The port's initial state and the same state in JAX's layout: the
    port's init (JAX's first compile of each parameter shape takes ~25 s on
    the CPU), or with ``jax_init`` JAX's, carried over by core/convert.py."""
    if jax_init:
        jstate = jtrain.progan_init_state(jax.random.key(0), jpg.ProGANConfig(**dict(
            CONFIG, fmap_base=cfg.fmap_base)), lr=LR)
        return jstate, convert.convert_progan_train_state(jstate)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    g = jax.tree.map(jnp.asarray, convert.generator_params_to_jax(state.g_params))
    d = jax.tree.map(jnp.asarray, convert.discriminator_params_to_jax(state.d_params))
    opt = jtrain.progan_optimizer(LR)
    return jtrain.ProGANTrainState(g, d, opt.init(g), opt.init(d), g), state


def _steps(fmap_base, jax_init=False):
    """(port packed, port unpacked, port unpacked in float64, JAX packed)
    states after one step, the port's and JAX's metrics."""
    kw = dict(CONFIG, fmap_base=fmap_base)
    cfg, jcfg = tpg.ProGANConfig(**kw), jpg.ProGANConfig(**kw)
    jstate, state = _both_states(cfg, jax_init)
    real, z = _step_inputs()

    def port_step(st, packed, dtype=torch.float32):
        return ttrain.progan_train_step(
            st, torch.from_numpy(real).to(dtype), torch.from_numpy(z).to(dtype), 0.7, cfg,
            STAGE, lr=LR, packed_d=packed, packed_g=packed, packed_train_mode="highest")

    # the port's steps first: right after a JAX step, XLA's CPU threads slow
    # torch's own several times over
    after, m = port_step(state, True)
    unpacked, mu = port_step(state, False)
    exact, _ = port_step(tree_map(lambda t: t.double() if t.is_floating_point() else t, state),
                         False, torch.float64)
    jafter, jm = jtrain.progan_train_step(
        jstate, jnp.asarray(real), jnp.asarray(z), jnp.float32(0.7), jcfg, STAGE, lr=LR,
        packed_d=True, packed_g=True, packed_train_mode="highest")
    return after, unpacked, exact, convert.convert_progan_train_state(jafter), (m, mu, jm)


def _gaps(fmap_base, jax_init):
    """Per G moment leaf: (path, port vs JAX, port vs float64, JAX vs
    float64, port vs port with torch.backends.mkldnn off), each of the
    leaf's largest entry."""
    after, _, exact, want, _ = _steps(fmap_base, jax_init)
    torch.backends.mkldnn.enabled = False
    try:
        off = _steps(fmap_base, jax_init)[0]
    finally:
        torch.backends.mkldnn.enabled = True
    rows = []
    trees = [tree_leaves(s.g_opt[0].mu) for s in (after, want, exact, off)]
    for path, a, j, e, o in zip(_leaf_paths(after.g_opt[0].mu), *trees):
        e, scale = e.float(), j.abs().max().item() + 1e-30
        rows.append((path, *((u - v).abs().max().item() / scale
                             for u, v in ((a, j), (a, e), (j, e), (a, o)))))
    return rows


@pytest.mark.parametrize("fmap_base,widths", [(256, (8, 4)), (768, (24, 12))])
def test_packed_step_at_any_width_matches_jax(fmap_base, widths):
    cfg = tpg.ProGANConfig(**CONFIG, fmap_base=fmap_base)
    assert (cfg.nf(STAGE - 1), cfg.nf(STAGE)) == widths
    assert tpg.packed_start_stage(cfg, STAGE) == STAGE
    after, unpacked, exact, want, (m, mu, jm) = _steps(fmap_base)
    _assert_metrics(m, jm)
    _assert_metrics(mu, m)
    # D (unpacked here: its gate needs nf % 8 == 0) against JAX
    _assert_grads(after.d_opt[0].mu, want.d_opt[0].mu)
    _assert_params(after.d_params, want.d_params)
    packed = f"blocks/{STAGE - 1}/"
    paths = _leaf_paths(after.g_opt[0].mu)
    assert sum(p.startswith(packed) for p in paths) == 4  # conv1 and conv2, w and b
    mus = [tree_leaves(s.g_opt[0].mu) for s in (after, want, exact)]
    for path, a, j, e in zip(paths, *mus):
        gap, scale = (a - j).abs().max().item(), j.abs().max().item()
        bound = 1e-3 * scale + 1e-12
        if not path.startswith(packed):
            bound = max(bound, EXACT_MULT * (j - e.float()).abs().max().item())
        assert gap <= bound, (path, gap, scale, bound)
    # A first Adam update is about lr * sign(gradient): a G parameter may
    # leave PARAM_TOL of JAX's only outside the packed stage and where the
    # two gradients differ by as much as JAX's gradient itself (its sign is
    # not settled at their agreement).
    for name in ("g_params", "g_ema"):
        for path, a, j, ga, gj in zip(paths, *(tree_leaves(getattr(s, name))
                                               for s in (after, want)), *mus[:2]):
            off = ~torch.isclose(a, j, rtol=PARAM_TOL["rtol"], atol=PARAM_TOL["atol"])
            unsettled = gj.abs() <= (ga - gj).abs()
            assert not (off & (path.startswith(packed) | ~unsettled)).any(), (
                name, path, int(off.sum()))
    # the port's packed step against its unpacked step
    for path, a, u in zip(paths, tree_leaves(after.g_opt[0].mu),
                          tree_leaves(unpacked.g_opt[0].mu)):
        assert (a - u).abs().max().item() <= 1e-4 * u.abs().max().item() + 1e-12, path


# -- what the wrappers hand the kernels at these widths ------------------------


def _meta(*shape):
    return torch.zeros(shape, device="meta")


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on meta inputs as on the card: the device check passes,
    an H100's 132 SMs, and the C launch records (name, args) with the
    tensors themselves in the pointers' places; weights on the CPU so that
    their layouts can be read."""
    calls = []
    monkeypatch.setattr(tpk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(tpk, "_sms", lambda device: 132)
    monkeypatch.setattr(tpk, "_aligned16", lambda x: x)
    monkeypatch.setattr(tpk, "_ptr", lambda t: t)
    monkeypatch.setattr(tpk._build, "launch", lambda name, argtypes, device, *args:
                        calls.append((name, args)))
    tpk.reset_launches()
    yield calls
    tpk.reset_launches()


def _none_bytes(slab):
    """csrc/packed_conv.cu NoneTile::kStage x 3 stages: 16 channels a stage,
    the (TR + 2) x 40 halo patch + 8 floats and 9 x slab weights, padded to
    8 or 24 floats mod 32 (none at a slab of 8)."""
    rows = 8 if slab == 64 else 16
    wrow = 9 * slab + (0 if (9 * slab) % 32 == 8 else 8)
    return 4 * 3 * 16 * ((rows + 2) * 40 + 8 + wrow)


# (C, Cout, H): the new widths of T, T2 and O's backward at batch 2
SLICED = [(4, 4, 1024), (2, 2, 1024), (12, 12, 1024), (4, 8, 1024), (2, 4, 1024),
          (12, 24, 1024), (8, 4, 512), (24, 12, 512)]


@pytest.mark.parametrize("mode", ["highest", "default", "mid"])
def test_sliced_wrappers_pad_the_weights_and_pass_the_true_widths(recorded, mode):
    """B2 "lrelu" and "none" and B5 "none" (and "lrelu") at Cout 2, 4, 12 and
    any C: weights and bias zero-padded to Cout rounded up to 8, laid out in
    slabs of the largest of 64, 32, 16 and 8 that divides it; x and the
    output at their true channel counts; the ring's bytes."""
    terms = tpk.BF16_TERMS.get(mode, 0)
    sfx = {0: "", 1: "_bf16", 2: "_mid"}[terms]
    keys = {}
    gen = torch.Generator().manual_seed(3)
    for c, cout, h in SLICED:
        c8 = -(-cout // 8) * 8
        slab = tpk._pool_slab(c8)
        w, b = torch.randn((cout, c, 3, 3), generator=gen), torch.randn(cout, generator=gen)
        wp = torch.cat([w, torch.zeros(c8 - cout, c, 3, 3)])
        bp = torch.cat([b, torch.zeros(c8 - cout)])
        for kernel, epilogue in (("packed_conv", "lrelu"), ("packed_conv", "none"),
                                 ("packed_convpool", "none"), ("packed_convpool", "lrelu")):
            with torch.no_grad():
                y = getattr(tpk, kernel)(_meta(2, c, h, h), w, b, epilogue, mode=mode)
            pool = kernel == "packed_convpool"
            assert tuple(y.shape) == (2, cout, h // (2 if pool else 1), h // (2 if pool else 1))
            name, args = recorded[-1]
            assert name == kernel + ("_bf16" if terms else "")
            assert tuple(args[0].shape) == (2, c, h, h) and args[4:9] == (2, c, h, h, cout)
            assert torch.equal(args[2], bp)
            tiles = tpk.conv_tile_count(2, c8, h, h)
            assert tiles == 2 * (h // (8 if slab == 64 else 16)) * (h // 32) * (c8 // slab)
            if terms:
                assert torch.equal(args[1], tpk.conv_bf16_weights(wp, slab))
                smem = _bf16_ring_bytes(slab, upconv=False)
            else:
                assert torch.equal(args[1], tpk.convpool_kernel_weights(wp))
                assert args[1].shape == (c8 // slab, c, 3, 3, slab)
                if not pool:  # (..., cout, epilogue, o_slab, rows, blocks, smem)
                    assert args[9:12] == (tpk.CONV_EPILOGUES[epilogue], slab, 16)
                smem = (_none_bytes(slab) if (kernel, epilogue) == ("packed_conv", "none")
                        else _conv_ring_bytes(slab))
            assert args[-1] == smem and args[-2] == tpk.persistent_blocks(
                tiles, 132, tpk.ring_blocks_per_sm(smem))
            if cout % 8:
                key = f"{kernel}{sfx}[cout{cout}]"
                keys[key] = keys.get(key, 0) + 1
    assert {k: v for k, v in tpk.narrow_launches.items() if "[cout8]" not in k} == keys


@pytest.mark.parametrize("mode", ["highest", "default", "mid"])
def test_upconv_lrelu_runs_on_the_forward_s_tile(recorded, mode):
    """B1 "lrelu" (the recompute) at Cout 4, 2, 12, 48 and 24 takes the tile
    of "lrelu_norm" (norm_tile), the same padded taps and bias, bytes and
    blocks: one kernel with another epilogue, so the pre-activations are the
    forward's."""
    terms = tpk.BF16_TERMS.get(mode, 0)
    gen = torch.Generator().manual_seed(4)
    for c, cout, h in ((8, 4, 512), (4, 2, 512), (24, 12, 512), (96, 48, 128), (48, 24, 256)):
        w, b = torch.randn((cout, c, 3, 3), generator=gen), torch.randn(cout, generator=gen)
        with torch.no_grad():
            for epilogue in ("lrelu_norm", "lrelu"):
                y = tpk.packed_upconv(_meta(2, c, h, h), w, b, epilogue=epilogue, mode=mode)
                assert tuple(y.shape) == (2, cout, 2 * h, 2 * h)
        (_, norm), (_, pre) = recorded[-2:]
        tile = tpk.norm_tile(cout)
        assert pre[11] == norm[11] == cout and pre[1].shape == norm[1].shape
        assert torch.equal(pre[1], norm[1]) and torch.equal(pre[2], norm[2])
        assert pre[2].shape == (tile,)
        assert pre[-1] == norm[-1] == (_bf16_ring_bytes(tile, upconv=True) if terms
                                       else _upconv_ring_bytes(tile))
        assert pre[-2] == norm[-2]
        assert pre[-3] == tpk.UPCONV_EPILOGUES["lrelu"]
    sfx = {0: "", 1: "_bf16", 2: "_mid"}[terms]
    assert tpk.epilogue_launches[f"packed_upconv{sfx}[lrelu]"] == 5


@pytest.mark.parametrize("c,cout", [(2, 2), (4, 2), (4, 4), (8, 4), (12, 12), (24, 12)])
def test_wgrad_takes_any_width(recorded, c, cout):
    """B6 at C and Cout in {2, 4, 12} (and its upsampled C 4, 8, 24): the
    32-channel tiling, ``wgrad_ksplit`` of one slab and the partials at the
    true C and Cout, both kernels; counted under narrow_launches by the true
    Cout."""
    h = 1024
    ksplit = tpk.wgrad_ksplit(2, c, cout, h, h)
    assert tpk.wgrad_tiling(cout) == (32, 2, 2 * tpk.WGRAD_BLOCKS)
    assert ksplit == min(2 * (h // 2) * (h // 32), 2 * tpk.WGRAD_BLOCKS)
    for mode in ("highest", "default"):
        dw = tpk.packed_conv_wgrad(_meta(2, c, h, h), _meta(2, cout, h, h), mode=mode)
        assert tuple(dw.shape) == (cout, c, 3, 3)
        name, args = recorded[-1]
        assert name == "packed_conv_wgrad" + ("_bf16" if mode == "default" else "")
        assert tuple(args[2].shape) == (ksplit, 9, c, cout)
        assert args[4:] == (2, c, h, h, cout, 32, 2, ksplit)
    assert tpk.narrow_launches == {f"packed_conv_wgrad[cout{cout}]": 1,
                                   f"packed_conv_wgrad_bf16[cout{cout}]": 1}


WRAPPERS = ("packed_upconv", "packed_conv", "packed_convpool", "packed_conv_wgrad",
            "packed_conv_rgb")


def test_train_step_calls_replay_on_the_card(recorded, monkeypatch):
    """A spy on the wrappers during one CPU step at fmap_base 256 (G's packed
    stage 8 -> 4, 4 -> 4) records each (kernel, epilogue, mode, shapes);
    each, replayed on meta tensors through the CUDA branch at "highest",
    "mid" and "default", launches and raises nothing: B1 "lrelu" at Cout 4,
    B2 "lrelu" and "none" at 4, B5 "none" into 8 channels from 4, B6 at
    (8, 4) and (4, 4)."""
    seen, real = [], {name: getattr(tpk, name) for name in WRAPPERS}
    for name, fn in real.items():

        def spy(*args, _name=name, _real=fn, **kwargs):
            seen.append((_name, tuple(tuple(a.shape) if torch.is_tensor(a) else a
                                      for a in args),
                         {k: tuple(v.shape) if torch.is_tensor(v) else v
                          for k, v in kwargs.items()}))
            return _real(*args, **kwargs)

        monkeypatch.setattr(tpk, name, spy)
    cfg = tpg.ProGANConfig(**CONFIG, fmap_base=256)
    state = ttrain.progan_init_state(0, cfg, device="cpu")
    real_images, z = (torch.from_numpy(a) for a in _step_inputs())
    _, m = ttrain.progan_train_step(state, real_images, z, 0.7, cfg, STAGE, packed_d=True,
                                    packed_g=True)  # CPU tensors: the twins, no launch
    assert all(np.isfinite(float(v)) for v in m.values()) and not recorded
    for name, fn in real.items():  # the wrappers again, on meta tensors now
        monkeypatch.setattr(tpk, name, fn)
    calls = sorted(set((n, a, tuple(sorted(k.items()))) for n, a, k in seen), key=repr)
    for mode in ("highest", "mid", "default"):
        tpk.reset_launches()
        recorded.clear()
        with torch.no_grad():
            for name, args, kwargs in calls:
                meta = [_meta(*a) if isinstance(a, tuple) else a for a in args]
                kw = {k: _meta(*v) if isinstance(v, tuple) else v for k, v in kwargs}
                getattr(tpk, name)(*meta, **{**kw, "mode": mode})
        assert len(recorded) == len(calls)
        sfx = {"highest": "", "default": "_bf16", "mid": "_mid"}[mode]
        wg = "packed_conv_wgrad" + ("_bf16" if mode == "default" else "")
        for key in (f"packed_upconv{sfx}[cout4]", f"packed_conv{sfx}[cout4]",
                    f"{wg}[cout4]"):
            assert tpk.narrow_launches.get(key, 0) >= 1, (key, tpk.narrow_launches)
        assert tpk.epilogue_launches[f"packed_upconv{sfx}[lrelu]"] == 1
        assert tpk.epilogue_launches[f"packed_conv{sfx}[lrelu]"] == 1
        assert tpk.epilogue_launches[f"packed_conv{sfx}[none]"] == 1
        assert tpk.epilogue_launches[f"packed_convpool{sfx}[none]"] == 1


if __name__ == "__main__":  # the per-leaf gaps behind EXACT_MULT
    for jax_init in (False, True):
        for fmap_base in (256, 768):
            for path, *gaps in _gaps(fmap_base, jax_init):
                print(f"{'JAX' if jax_init else 'port'} init, fmap_base {fmap_base} {path:22s} "
                      + "  ".join(f"{name} {g:.2e}" for name, g in zip(
                          ("port vs JAX", "port vs float64", "JAX vs float64",
                           "port vs mkldnn off"), gaps)))
