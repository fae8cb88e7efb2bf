"""Train state files (probgan_tpu_torch/core/train_state.py) and the
train-state converters (core/convert.py): either package resumes from the
other's file. Tolerances as in tests/test_torch_train.py: losses rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probgan_tpu.core import train_state as jts
from probgan_tpu.engine import train as jtrain
from probgan_tpu.models import pro_gan as jpg
from probgan_tpu_torch.core import _msgpack, convert
from probgan_tpu_torch.core import train_state as tts
from probgan_tpu_torch.core.tree import from_state_dict, to_state_dict, tree_leaves, tree_map
from probgan_tpu_torch.engine import train as ttrain
from probgan_tpu_torch.models import pro_gan as tpg

SMALL = dict(resolution=16, latent_dim=8, fmap_base=64, fmap_max=16)
GROWN = dict(SMALL, resolution=32)
STAGE = 2
KG = dict(num_entities=50, num_relations=5, embed_dim=8, noise_dim=4, hidden_dim=16)


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _batch():
    return _rand((2, 16, 16, 3), 1), _rand((2, 8), 2)


def _jstep(jstate, kw=SMALL):
    real, z = _batch()
    return jtrain.progan_train_step(jstate, jnp.asarray(real), jnp.asarray(z),
                                    jnp.float32(0.5), jpg.ProGANConfig(**kw), STAGE)


def _tstep(state, kw=SMALL):
    real, z = _batch()
    return ttrain.progan_train_step(state, torch.from_numpy(real), torch.from_numpy(z), 0.5,
                                    tpg.ProGANConfig(**kw), STAGE)


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _template(kw=SMALL, seed=99):
    return ttrain.progan_init_state(seed, tpg.ProGANConfig(**kw), device="cpu")


def test_jax_file_resumes_in_the_port(tmp_path):
    """JAX trains a step and writes; the port loads and both take the next
    step: the same losses."""
    jstate, _ = _jstep(jtrain.progan_init_state(jax.random.key(0), jpg.ProGANConfig(**SMALL)))
    path = str(tmp_path / "run" / "train_state.msgpack")
    jts.save_train_state(path, jstate, {"epoch": 4, "history": {"d_loss": [1.5, 1.25]}})
    state, meta = tts.load_train_state(path, _template())
    assert meta == {"epoch": 4, "history": {"d_loss": [1.5, 1.25]}}
    assert _equal(state, convert.convert_progan_train_state(jstate))
    assert int(state.g_opt[0].count) == 1 and state.g_opt[0].count.dtype == torch.int32
    assert tuple(state.d_params["blocks"][0]["conv1"]["w"].shape) == (16, 16, 3, 3)  # OIHW
    _, jm = _jstep(jstate)
    _, m = _tstep(state)
    for name in ("d_loss", "g_loss", "real_logit", "fake_logit"):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-4, err_msg=name)


def test_port_file_resumes_in_jax_and_in_the_port(tmp_path):
    """The port trains a step and writes; the JAX package's own loader pours
    the file into a JAX template (HWIO arrays, optax's state), and the port
    reads its own file back bit for bit."""
    state, _ = _tstep(_template(seed=0))
    path = str(tmp_path / "train_state.msgpack")
    tts.save_train_state(path, state, {"epoch": 1})
    assert not (tmp_path / "train_state.msgpack.tmp").exists()  # written, then renamed
    back, meta = tts.load_train_state(path, _template())
    assert meta == {"epoch": 1} and _equal(back, state)

    jtemplate = jtrain.progan_init_state(jax.random.key(7), jpg.ProGANConfig(**SMALL))
    jstate, jmeta = jts.load_train_state(path, jtemplate)
    assert jmeta == {"epoch": 1} and type(jstate.g_opt[0]).__name__ == "ScaleByAdamState"
    assert int(jstate.d_opt[0].count) == 1
    assert np.asarray(jstate.g_params["blocks"][0]["conv1"]["w"]).shape == (3, 3, 16, 16)
    assert _equal(convert.convert_progan_train_state(jstate), state)
    # the converter's inverse gives what the file holds
    as_jax = to_state_dict(convert.progan_train_state_to_jax(state))
    on_disk = _msgpack.unpackb(open(path, "rb").read())["state"]
    flat_a, flat_b = tree_leaves(as_jax), tree_leaves(on_disk)
    assert len(flat_a) == len(flat_b)
    assert all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    _, jm = _jstep(jstate)
    _, m = _tstep(state)
    np.testing.assert_allclose(float(m["g_loss"]), float(jm["g_loss"]), rtol=1e-4)


def test_kg_state_files_cross(tmp_path):
    jstate = jtrain.kg_init_state(jax.random.key(3), **KG)
    triplets = np.array([[0, 1, 2], [3, 4, 5], [6, 0, 7]], np.int32)
    jstate, _ = jtrain.kg_train_step(jstate, jnp.asarray(triplets), jax.random.key(4))
    path = str(tmp_path / "kg.msgpack")
    jts.save_train_state(path, jstate, {"epoch": 2, "best_val_hit10": 0.5})
    template = ttrain.kg_init_state(0, device="cpu", **KG)
    state, meta = tts.load_train_state(path, template)
    assert meta["best_val_hit10"] == 0.5
    assert _equal(state, convert.convert_kg_train_state(jstate))
    assert int(state.g_opt[0].count) == 1 and len(state.g_opt[0].mu) == 3
    back = convert.convert_kg_train_state(convert.kg_train_state_to_jax(state))
    assert _equal(back, state)
    # and the port's file in the JAX loader
    tts.save_train_state(path, state, {"epoch": 3})
    jback, _ = jts.load_train_state(path, jtrain.kg_init_state(jax.random.key(5), **KG))
    np.testing.assert_array_equal(np.asarray(jback.node_emb), np.asarray(jstate.node_emb))
    np.testing.assert_array_equal(np.asarray(jback.g_opt[0].nu[1]),
                                  np.asarray(jstate.g_opt[0].nu[1]))


def test_alias_missing_upgrades_a_pre_ema_file(tmp_path):
    state, _ = _tstep(_template(seed=0))
    sd = tree_map(tts._to_disk, to_state_dict(state))
    del sd["g_ema"]
    path = str(tmp_path / "old.msgpack")
    with open(path, "wb") as f:
        f.write(_msgpack.packb({"state": sd, "meta": {}}))
    with pytest.raises(ValueError, match="keys"):
        tts.load_train_state(path, _template())
    got, _ = tts.load_train_state(path, _template(), alias_missing={"g_ema": "g_params"})
    assert _equal(got.g_ema, state.g_params) and _equal(got.g_params, state.g_params)


def test_grow_restores_a_smaller_state_into_a_larger_template(tmp_path):
    small, _ = _tstep(_template(seed=0))
    path = str(tmp_path / "small.msgpack")
    tts.save_train_state(path, small, {"stage": STAGE})
    big = _template(GROWN, seed=5)
    with pytest.raises(ValueError, match="keys"):
        tts.load_train_state(path, big)  # not a growth unless asked for
    got, meta = tts.load_train_state(path, big, grow=True)
    assert meta == {"stage": STAGE}
    n = len(small.g_params["blocks"])
    assert _equal(got.g_params["blocks"][:n], small.g_params["blocks"])
    assert _equal(got.d_opt[0].nu["from_rgb"][:n + 1], small.d_opt[0].nu["from_rgb"])
    # the extra stage keeps the template's fresh values
    assert _equal(got.g_params["blocks"][n], big.g_params["blocks"][n])
    assert _equal(got.g_opt[0].mu["to_rgb"][n + 1], big.g_opt[0].mu["to_rgb"][n + 1])
    # the grown state trains at the old stage as the small one does
    _, m_small = _tstep(small)
    _, m_big = _tstep(got, GROWN)
    np.testing.assert_allclose(float(m_big["d_loss"]), float(m_small["d_loss"]), rtol=1e-5)



def test_grow_keeps_template_leaves_off_the_cpu(tmp_path):
    """A grow restore into a template that does not live on the CPU (meta
    stands in for the card): the file's leaves move onto the template's
    device and the extra stage keeps the template's own leaves, which never
    pass through numpy (a card tensor cannot)."""
    small = _template(seed=0)
    path = str(tmp_path / "small.msgpack")
    tts.save_train_state(path, small, {"stage": STAGE})
    big = tree_map(lambda t: t.to("meta"), _template(GROWN, seed=5))
    got, _ = tts.load_train_state(path, big, grow=True)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    n = len(small.g_params["blocks"])
    assert got.g_params["blocks"][n]["conv1"]["w"] is big.g_params["blocks"][n]["conv1"]["w"]

def test_grow_error_cases(tmp_path):
    """_merge_subtree's three refusals: a file entry the template lacks, a
    leaf of another shape, a subtree where the template has a leaf."""
    small = _template()
    sd = to_state_dict(small)
    extra = dict(sd, surplus=torch.zeros(1))
    with pytest.raises(ValueError, match="'/surplus' has no counterpart"):
        tts._merge_subtree(sd, extra)
    wider = _template(dict(SMALL, fmap_max=32))
    with pytest.raises(ValueError, match=r"leaf '/g_params/base_dense/w' shape \(8, 512\) != "
                                         r"template shape \(8, 256\) \(incompatible architecture"):
        tts._merge_subtree(sd, to_state_dict(wider))
    nested = dict(sd, g_params=dict(sd["g_params"], base_dense={"w": {"0": torch.zeros(1)},
                                                                 "b": sd["g_params"]["base_dense"]["b"]}))
    with pytest.raises(ValueError, match="is a subtree in the file but a leaf in the template"):
        tts._merge_subtree(sd, nested)
    # through the loader: a wider file does not "grow" into a narrower template
    path = str(tmp_path / "wide.msgpack")
    tts.save_train_state(path, wider, {})
    with pytest.raises(ValueError, match="incompatible architecture"):
        tts.load_train_state(path, small, grow=True)
    with pytest.raises(ValueError, match="does not fit"):
        tts.load_train_state(path, small)


def test_state_dict_conventions():
    """flax's conventions, which the files rest on: NamedTuple fields by name,
    list and tuple entries under "0", "1", ..., the empty optax link as {}."""
    state = _template()
    sd = to_state_dict(state)
    assert list(sd) == ["g_params", "d_params", "g_opt", "d_opt", "g_ema"]
    assert list(sd["g_opt"]) == ["0", "1"] and sd["g_opt"]["1"] == {}
    assert list(sd["g_opt"]["0"]) == ["count", "mu", "nu"]
    assert list(sd["g_params"]["blocks"]) == ["0", "1"]
    back = from_state_dict(state, sd)
    assert type(back) is ttrain.ProGANTrainState and isinstance(back.g_params["blocks"], list)
    assert type(back.g_opt[0]) is ttrain.ScaleByAdamState and _equal(back, state)
    with pytest.raises(ValueError, match="keys"):
        from_state_dict(state, {k: v for k, v in sd.items() if k != "d_opt"})
