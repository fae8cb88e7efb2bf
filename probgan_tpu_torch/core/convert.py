"""Convert the JAX package's parameters into the port's.

Image generator
---------------

The JAX tree (``probgan_tpu/models/pro_gan.init_generator``, or a loaded
image checkpoint's ``g_params``) holds numpy-convertible arrays:

- conv weights HWIO ``[kh, kw, Cin, Cout]`` -> OIHW ``[Cout, Cin, kh, kw]``
  via ``transpose(3, 2, 0, 1)`` (the 1x1 toRGB ``[1, 1, C, 3]`` becomes
  ``[3, C, 1, 1]``). The He fan-in ``kh*kw*Cin`` then lives on axes 1-3,
  which is where the port's ``eq_conv`` reads it;
- dense weights stay ``[in, out]``. The base dense output is reshaped to
  (4, 4, nf0) HWC and permuted to NCHW inside ``_g_base``, so its columns
  keep the JAX order.

Image discriminator
-------------------
``from_rgb`` (a list of 1x1 convs), ``blocks`` and ``final_conv`` convert
like the generator's convs; ``final_dense`` and ``out_dense`` stay
``[in, out]``. ``final_dense`` reads the 4x4 map flattened in HWC order, and
``discriminator_apply`` permutes to that order before the flatten, so its
rows keep the JAX order too.

``generator_params_to_jax`` / ``discriminator_params_to_jax`` go the other
way (OIHW tensors -> HWIO numpy arrays): image checkpoints hold the JAX
layout on disk, so that either package loads what the other wrote.

Train states
------------
``convert_progan_train_state`` / ``convert_kg_train_state`` take a whole JAX
train state (``probgan_tpu/engine/train.py``'s NamedTuples, or dicts with the
same keys, holding numpy or jax arrays) with its ``optax.adam`` states
``(ScaleByAdamState(count, mu, nu), EmptyState())`` and give the port's state
(``engine/train.py``); ``*_train_state_to_jax`` go the other way, to plain
dicts, lists and tuples of numpy arrays in the JAX layout. Adam's moments have
their parameters' layout, so the parameter converters serve them.

KG models
---------
The KG MLPs (``probgan_tpu/models/kg_gan.py``) and the C17 checkpoint dict
keep their layout: ``{'fc1': {'w' [in, out], 'b' [out]}, ...}`` and the raw
``node_emb`` / ``rel_emb.weight`` tables become fp32 tensors as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    # a copy: the source may be read-only (a jax array's buffer)
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C")).to(device)


def _conv(p: dict, device) -> dict:
    w = np.asarray(p["w"], np.float32)
    if w.ndim != 4:
        raise ValueError(f"conv weight must be HWIO 4-d, got shape {w.shape}")
    return {"w": _tensor(w.transpose(3, 2, 0, 1), device), "b": _tensor(p["b"], device)}


def _dense(p: dict, device) -> dict:
    return {"w": _tensor(p["w"], device), "b": _tensor(p["b"], device)}


def convert_generator_params(jax_params: dict, device="cpu") -> dict:
    """JAX generator params (HWIO convs, [in, out] dense, numpy or jax
    arrays) -> the port's tree of fp32 tensors on ``device``."""
    return {
        "base_dense": _dense(jax_params["base_dense"], device),
        "base_conv": _conv(jax_params["base_conv"], device),
        "blocks": [
            {"conv1": _conv(b["conv1"], device), "conv2": _conv(b["conv2"], device)}
            for b in jax_params["blocks"]
        ],
        "to_rgb": [_conv(t, device) for t in jax_params["to_rgb"]],
    }


def convert_discriminator_params(jax_params: dict, device="cpu") -> dict:
    """JAX discriminator params (HWIO convs, [in, out] dense) -> the port's
    tree of fp32 tensors on ``device``."""
    return {
        "from_rgb": [_conv(t, device) for t in jax_params["from_rgb"]],
        "blocks": [
            {"conv1": _conv(b["conv1"], device), "conv2": _conv(b["conv2"], device)}
            for b in jax_params["blocks"]
        ],
        "final_conv": _conv(jax_params["final_conv"], device),
        "final_dense": _dense(jax_params["final_dense"], device),
        "out_dense": _dense(jax_params["out_dense"], device),
    }


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _conv_to_jax(p: dict) -> dict:
    return {"w": np.ascontiguousarray(_numpy(p["w"]).transpose(2, 3, 1, 0)),
            "b": _numpy(p["b"]).copy()}


def _dense_to_jax(p: dict) -> dict:
    return {"w": _numpy(p["w"]).copy(), "b": _numpy(p["b"]).copy()}


def generator_params_to_jax(params: dict) -> dict:
    """The port's generator tree (OIHW) -> the JAX layout (HWIO) as fp32
    numpy arrays: the inverse of ``convert_generator_params``."""
    return {
        "base_dense": _dense_to_jax(params["base_dense"]),
        "base_conv": _conv_to_jax(params["base_conv"]),
        "blocks": [
            {"conv1": _conv_to_jax(b["conv1"]), "conv2": _conv_to_jax(b["conv2"])}
            for b in params["blocks"]
        ],
        "to_rgb": [_conv_to_jax(t) for t in params["to_rgb"]],
    }


def discriminator_params_to_jax(params: dict) -> dict:
    """The inverse of ``convert_discriminator_params``."""
    return {
        "from_rgb": [_conv_to_jax(t) for t in params["from_rgb"]],
        "blocks": [
            {"conv1": _conv_to_jax(b["conv1"]), "conv2": _conv_to_jax(b["conv2"])}
            for b in params["blocks"]
        ],
        "final_conv": _conv_to_jax(params["final_conv"]),
        "final_dense": _dense_to_jax(params["final_dense"]),
        "out_dense": _dense_to_jax(params["out_dense"]),
    }


def convert_kg_params(jax_params: dict, device="cpu") -> dict:
    """A KG MLP's numpy tree ``{'fc1': {'w', 'b'}, ...}`` -> fp32 tensors on
    ``device`` (dense weights stay ``[in, out]``)."""
    return {name: _dense(layer, device) for name, layer in jax_params.items()}


def convert_kg_checkpoint(ckpt: dict, device="cpu") -> dict:
    """A whole C17 checkpoint dict (numpy or jax arrays, JAX-layout params)
    -> the same dict with ``node_emb``, ``rel_emb.weight`` and both MLPs as
    fp32 tensors on ``device``; scalars, ``args`` and ``training_history``
    pass through."""
    out = dict(ckpt)
    out["node_emb"] = _tensor(ckpt["node_emb"], device)
    out["rel_emb"] = {"weight": _tensor(ckpt["rel_emb"]["weight"], device)}
    out["generator"] = convert_kg_params(ckpt["generator"], device)
    out["discriminator"] = convert_kg_params(ckpt["discriminator"], device)
    return out


# ---------------------------------------------------------------------------
# train states
# ---------------------------------------------------------------------------

def _field(obj, name: str):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _adam_state(opt_state, convert, device) -> tuple:
    """optax.adam's state -> the port's, moments through ``convert``. The
    count stays on the CPU (engine/train.py reads it on the host)."""
    from probgan_tpu_torch.engine.train import EmptyState, ScaleByAdamState

    adam = opt_state[0]
    count = torch.tensor(int(np.asarray(_field(adam, "count"))), dtype=torch.int32)
    return (ScaleByAdamState(count, convert(_field(adam, "mu"), device),
                             convert(_field(adam, "nu"), device)), EmptyState())


def _adam_state_to_jax(opt_state, to_jax) -> tuple:
    adam = opt_state[0]
    return ({"count": np.asarray(adam.count.cpu().numpy(), np.int32),
             "mu": to_jax(adam.mu), "nu": to_jax(adam.nu)}, {})


def convert_progan_train_state(jax_state, device="cpu"):
    """A JAX ``ProGANTrainState`` -> the port's, on ``device``."""
    from probgan_tpu_torch.engine.train import ProGANTrainState

    g, d = convert_generator_params, convert_discriminator_params
    return ProGANTrainState(
        g_params=g(_field(jax_state, "g_params"), device),
        d_params=d(_field(jax_state, "d_params"), device),
        g_opt=_adam_state(_field(jax_state, "g_opt"), g, device),
        d_opt=_adam_state(_field(jax_state, "d_opt"), d, device),
        g_ema=g(_field(jax_state, "g_ema"), device),
    )


def progan_train_state_to_jax(state) -> dict:
    """The inverse of ``convert_progan_train_state``: a dict of the state's
    fields as numpy trees in the JAX layout."""
    g, d = generator_params_to_jax, discriminator_params_to_jax
    return {
        "g_params": g(state.g_params), "d_params": d(state.d_params),
        "g_opt": _adam_state_to_jax(state.g_opt, g),
        "d_opt": _adam_state_to_jax(state.d_opt, d),
        "g_ema": g(state.g_ema),
    }


def _kg_opt_tree(tree, device):
    """(g_params, node_emb, rel_emb): the tree the KG generator's optimizer
    covers."""
    return (convert_kg_params(tree[0], device), _tensor(tree[1], device),
            _tensor(tree[2], device))


def _kg_tree_to_jax(params: dict) -> dict:
    return {name: _dense_to_jax(layer) for name, layer in params.items()}


def convert_kg_train_state(jax_state, device="cpu"):
    """A JAX ``KGTrainState`` -> the port's, on ``device``."""
    from probgan_tpu_torch.engine.train import KGTrainState

    return KGTrainState(
        node_emb=_tensor(_field(jax_state, "node_emb"), device),
        rel_emb=_tensor(_field(jax_state, "rel_emb"), device),
        g_params=convert_kg_params(_field(jax_state, "g_params"), device),
        d_params=convert_kg_params(_field(jax_state, "d_params"), device),
        g_opt=_adam_state(_field(jax_state, "g_opt"), _kg_opt_tree, device),
        d_opt=_adam_state(_field(jax_state, "d_opt"), convert_kg_params, device),
    )


def kg_train_state_to_jax(state) -> dict:
    """The inverse of ``convert_kg_train_state``."""
    return {
        "node_emb": _numpy(state.node_emb).copy(), "rel_emb": _numpy(state.rel_emb).copy(),
        "g_params": _kg_tree_to_jax(state.g_params),
        "d_params": _kg_tree_to_jax(state.d_params),
        "g_opt": _adam_state_to_jax(
            state.g_opt,
            lambda t: (_kg_tree_to_jax(t[0]), _numpy(t[1]).copy(), _numpy(t[2]).copy())),
        "d_opt": _adam_state_to_jax(state.d_opt, _kg_tree_to_jax),
    }
