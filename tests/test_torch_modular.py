"""The port's KG modular shells (``probgan_tpu_torch/models/modular.py``)
against the JAX package's (``probgan_tpu/models/modular.py``), on the CPU.

The reference's lifecycle on these classes: construct with dims,
``load_state_dict`` (the flat torch form, or the nested ``{fcN: {w, b}}``
form that both packages' checkpoint loaders return), ``.to(device)``,
``.eval()``, forward with numpy or tensor inputs, ``score_triplets`` on the
raw tables. The same numpy weights and inputs go to both shells; outputs
agree within 1e-6 (fp32 sums in another order). The first four tests mirror
``tests/test_modular_compat.py``'s on the port.

The last test holds a fault found while reading the KG surfaces (the
engine's five tasks, the REPL, ``kg_train_step``, ``kg_eval_hits``) against
the reference: ``top_k`` 0 in ``predict_tails`` and ``analyze_relations``.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from probgan_tpu.engine.inference import InferenceEngine as JaxEngine
from probgan_tpu.models import kg_gan as jax_kg
from probgan_tpu.models import modular as jax_modular
from probgan_tpu_torch.core import checkpoint as ckpt_mod
from probgan_tpu_torch.engine.inference import InferenceEngine
from probgan_tpu_torch.models import modular
from probgan_tpu_torch.models.modular import ModularDiscriminator, ModularGenerator

D, Z, H, N, R, B = 16, 8, 32, 50, 7, 4
ATOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _gen_params(seed=3):
    return _np_tree(jax_kg.init_generator(jax.random.key(seed), D, Z))


def _disc_params(seed=4):
    return _np_tree(jax_kg.init_discriminator(jax.random.key(seed), D, H))


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    node = rng.standard_normal((N, D)).astype(np.float32)
    rel = rng.standard_normal((R, D)).astype(np.float32)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    trip = np.stack([rng.integers(0, N, B), rng.integers(0, R, B), rng.integers(0, N, B)], 1)
    return node, rel, z, trip


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), atol=ATOL, rtol=0)


def test_load_state_dict_accepts_native_pytree_and_rejects_mismatch():
    params = _gen_params(7)
    gen = ModularGenerator(D, Z)
    gen.load_state_dict(params)  # the nested form, numpy leaves
    z = np.zeros((2, Z), np.float32)
    h = np.ones((2, D), np.float32)
    _close(gen(h, h, z=z), jax_kg.generator_apply(params, h, h, z))
    with pytest.raises(ValueError, match="state dict mismatch"):
        gen.load_state_dict({"fc1.weight": np.zeros((2 * D, 2 * D + Z))})


def test_torch_tensor_inputs():
    node, rel, z, _ = _tables()
    gen = ModularGenerator(D, Z, seed=1)
    with torch.no_grad():
        assert torch.equal(gen(torch.from_numpy(node[:B]), torch.from_numpy(rel[:B]), z=z),
                           gen(node[:B], rel[:B].tolist(), z=torch.from_numpy(z)))


def test_state_dict_round_trip():
    disc = ModularDiscriminator(D, H, seed=2)
    sd = disc.state_dict()
    assert set(sd) == {f"fc{i}.{k}" for i in (1, 2, 3) for k in ("weight", "bias")}
    other = ModularDiscriminator(D, H, seed=99)
    other.load_state_dict({k: v.numpy() for k, v in sd.items()})
    node = np.ones((3, D), np.float32)
    with torch.no_grad():
        assert torch.equal(other(node, node, node), disc(node, node, node))


def test_strict_load_rejects_shape_mismatch():
    """Raised at load time, as the reference's ValueError and as
    nn.Module's RuntimeError; a well-shaped dict still loads, and a
    non-strict load takes a partial one."""
    gen = ModularGenerator(embed_dim=D, noise_dim=Z)
    sd = ckpt_mod.params_to_torch_state(_gen_params(4))
    bad = dict(sd, **{"fc1.weight": np.zeros((3, 3), np.float32)})
    for kind in (ValueError, RuntimeError):
        with pytest.raises(kind, match="size mismatch"):
            gen.load_state_dict(bad)
    gen.load_state_dict(sd)
    assert torch.equal(gen.fc2.bias, torch.from_numpy(sd["fc2.bias"]))
    missing = gen.load_state_dict({"fc3.bias": np.ones(D, np.float32)}, strict=False)
    assert "fc1.weight" in missing.missing_keys and float(gen.fc3.bias.detach().sum()) == D


@pytest.mark.parametrize("call", ["nested_from_loader", "flat_numpy", "score_triplets_numpy",
                                  "gen_numpy_z", "to_auto"])
def test_reference_calls_match_the_jax_shells(call, tmp_path, monkeypatch):
    """The five calls the reference makes that the port once refused, each
    against the JAX shell on the same numpy weights and inputs."""
    g_params, d_params = _gen_params(), _disc_params()
    node, rel, z, trip = _tables(1)
    jgen, jdisc = jax_modular.ModularGenerator(D, Z), jax_modular.ModularDiscriminator(D, H)
    jgen.load_state_dict(g_params)
    jdisc.load_state_dict(d_params)
    gen, disc = ModularGenerator(D, Z), ModularDiscriminator(D, H)
    if call == "nested_from_loader":
        path = str(tmp_path / "best_checkpoint.pt")
        ckpt_mod.save_checkpoint(path, {"args": {}, "node_emb": node, "rel_emb": {"weight": rel},
                                        "generator": g_params, "discriminator": d_params,
                                        "best_val_hit10": 0.0, "best_epoch": 0,
                                        "training_history": {}})
        loaded = ckpt_mod.load_checkpoint(path)
        assert isinstance(loaded["generator"]["fc1"], dict)
        gen.load_state_dict(loaded["generator"], strict=True)
        disc.load_state_dict(loaded["discriminator"], strict=True)
    else:
        gen.load_state_dict(ckpt_mod.params_to_torch_state(g_params))
        disc.load_state_dict(ckpt_mod.params_to_torch_state(d_params))
    h, r, t = node[trip[:, 0]], rel[trip[:, 1]], node[trip[:, 2]]
    if call == "to_auto":
        seen = []

        def resolve(spec):
            seen.append(spec)
            return torch.device("cpu")  # the card's place on a machine without one

        monkeypatch.setattr(modular, "resolve_device", resolve)
        assert gen.to("auto").eval() is gen and disc.to().eval() is disc
        assert gen.to("gpu") is gen and gen.to(device="CPU") is gen
        assert seen == ["auto", "auto", "gpu", "CPU"] and not gen.training
        monkeypatch.undo()
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                gen.to("auto")
        jgen.to("auto")
        jdisc.to("auto")
    with torch.no_grad():
        if call == "score_triplets_numpy":
            logits, probs = disc.score_triplets(node, {"weight": rel}, trip)
            want_l, want_p = jdisc.score_triplets(node, {"weight": rel}, trip)
            _close(logits, want_l)
            _close(probs, want_p)
            logits2, _ = disc.score_triplets(node, rel, trip.tolist())
            assert torch.equal(logits2, logits)
        _close(gen(h, r, z=z), jgen(h, r, z=z))
        _close(disc(h, r, t), jdisc(h, r, t))
    assert gen(h, r).shape == (B, D)  # internal noise, as the reference's call sites


def test_top_k_zero_gives_empty_rankings_as_the_jax_engine(torch_ckpt_path):
    """``predict_tails`` and ``analyze_relations`` at top_k 0 return one
    empty ranking a query, as the reference's top-k does (the port once
    raised from its top-k), and a negative top_k still raises."""
    engines = []
    for cls in (JaxEngine, InferenceEngine):
        with contextlib.redirect_stdout(io.StringIO()):
            engines.append(cls(str(torch_ckpt_path), device="cpu"))
    calls = (lambda e: e.predict_tails([[0, 1], [2, 3]], 0, return_scores=True),
             lambda e: e.analyze_relations([0], [1, 2], 0))
    for call in calls:
        with contextlib.redirect_stdout(io.StringIO()):
            want, got = (call(e) for e in engines)
        assert got == want
    assert got["relation_analysis"][1]["top_relations"] == []
    for e in engines:
        with pytest.raises(ValueError), contextlib.redirect_stdout(io.StringIO()):
            e.predict_tails([[0, 1]], -1)
