"""Checkpoint I/O for the reference checkpoint schema (C17).

The port of ``probgan_tpu/core/checkpoint.py``. Logical schema (key names
match the reference exactly):

    {
      'args': {'embed_dim': int, 'noise_dim': int, 'hidden_dim': int, ...},
      'node_emb': float32 [num_entities, embed_dim],
      'rel_emb': {'weight': float32 [num_relations, embed_dim]},
      'generator': {'fc1': {'w' [in, out], 'b' [out]}, 'fc2': .., 'fc3': ..},
      'discriminator': <same layout>,
      'best_val_hit10': float,
      'best_epoch': int,
      'training_history': dict,
    }

``load_checkpoint`` returns this dict with numpy arrays, whichever physical
format the file has; both packages read what the other writes:

- **native**: msgpack as ``flax.serialization`` writes it, read and written
  here by ``core/_msgpack.py`` (the port imports neither flax nor msgpack);
- **torch ``.pt``**: the reference's artifact, with ``nn.Linear`` layout
  (``fcN.weight [out, in]``) converted to and from ``fcN.w [in, out]``.

Detection on load is by file content (zip magic / pickle protocol for
torch), not extension. The ``orbax`` directory format is not ported: saving
to it and loading a directory raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from probgan_tpu_torch.core import _msgpack

CHECKPOINT_KEYS = (
    "args",
    "node_emb",
    "rel_emb",
    "generator",
    "discriminator",
    "best_val_hit10",
    "best_epoch",
    "training_history",
)

_ORBAX_MESSAGE = (
    "the orbax directory checkpoint format is not ported; use the native "
    "msgpack or the torch .pt format"
)


# ---------------------------------------------------------------------------
# nn.Linear layout <-> [in, out] params (KG MLPs)
# ---------------------------------------------------------------------------

def params_to_torch_state(params: dict) -> dict:
    """MLP params ``{'fcN': {'w' [in, out], 'b'}}`` -> torch-style state dict
    of numpy arrays (``fcN.weight`` transposed to ``[out, in]``)."""
    state = {}
    for name, layer in params.items():
        state[f"{name}.weight"] = _to_numpy(layer["w"]).T.copy()
        state[f"{name}.bias"] = _to_numpy(layer["b"]).copy()
    return state


def torch_state_to_params(state: dict) -> dict:
    """torch-style state dict -> MLP params of fp32 numpy arrays (weights
    transposed to ``[in, out]``)."""
    params: dict = {}
    for key, value in state.items():
        arr = np.asarray(_to_numpy(value), dtype=np.float32)
        name, _, kind = key.rpartition(".")
        layer = params.setdefault(name, {})
        if kind == "weight":
            layer["w"] = arr.T.copy()
        elif kind == "bias":
            layer["b"] = arr
        else:  # tolerate unknown key layouts
            layer[kind] = arr
    return params


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _to_numpy(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_numpy_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor) or (hasattr(tree, "shape") and hasattr(tree, "dtype")):
        return _to_numpy(tree)
    return tree


def save_checkpoint(path: str, checkpoint: dict, format: str = "auto") -> None:
    """Save a checkpoint dict (numpy arrays or tensors, ``[in, out]`` params).

    format: 'native' (msgpack), 'torch' (.pt via torch.save) or 'auto' (torch
    when the path ends in .pt, else native). 'orbax', and 'auto' on a
    ``.orbax`` path, raise NotImplementedError.
    """
    if format == "auto":
        if path.endswith(".pt"):
            format = "torch"
        elif path.rstrip("/").endswith(".orbax"):
            format = "orbax"
        else:
            format = "native"
    if format == "orbax":
        raise NotImplementedError(_ORBAX_MESSAGE)
    if format not in ("torch", "native"):
        raise ValueError(f"Unknown checkpoint format: {format!r}")
    checkpoint = _to_numpy_tree(checkpoint)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)

    if format == "torch":
        def tt(a):
            return torch.from_numpy(np.array(a, copy=True))

        state = dict(checkpoint)
        state["node_emb"] = tt(checkpoint["node_emb"])
        state["rel_emb"] = {"weight": tt(checkpoint["rel_emb"]["weight"])}
        for model in ("generator", "discriminator"):
            state[model] = {
                k: tt(v) for k, v in params_to_torch_state(checkpoint[model]).items()
            }
        torch.save(state, path)
    else:
        blob = _msgpack.packb(checkpoint)
        with open(path, "wb") as f:
            f.write(blob)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _looks_like_torch(path: str) -> bool:
    with open(path, "rb") as f:
        magic = f.read(2)
    # torch>=1.6 zip archives start with 'PK'; legacy torch pickles start with
    # pickle PROTO opcode 0x80 followed by a protocol byte 2..5. The protocol
    # check matters: a native msgpack whose top level is an empty fixmap also
    # starts with 0x80, but its next byte is a msgpack type tag, never 2..5.
    if magic[:2] == b"PK":
        return True
    return len(magic) == 2 and magic[0] == 0x80 and 2 <= magic[1] <= 5


def load_checkpoint(path: str) -> dict:
    """Load a checkpoint from either physical format into the logical schema
    with numpy arrays and ``[in, out]`` params.

    Raises FileNotFoundError("Checkpoint not found: <path>") like the
    reference, and NotImplementedError for an orbax directory.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(f"Checkpoint not found: {path}")
    if os.path.isdir(path):
        raise NotImplementedError(_ORBAX_MESSAGE)

    if _looks_like_torch(path):
        try:
            raw = torch.load(path, map_location="cpu", weights_only=True)
        except Exception:
            # weights_only rejects any pickled non-tensor object. The C17
            # schema is tensors + plain containers, so this path should be
            # rare; full unpickling executes arbitrary code from the file and
            # therefore requires an explicit opt-in for untrusted paths.
            if os.environ.get("PROBGAN_TORCH_UNSAFE_LOAD", "0") != "1":
                raise ValueError(
                    f"{path} requires full (unsafe) torch unpickling; set "
                    "PROBGAN_TORCH_UNSAFE_LOAD=1 to allow it for a trusted file"
                )
            raw = torch.load(path, map_location="cpu", weights_only=False)
        ckpt = dict(raw)
        ckpt["node_emb"] = np.asarray(_to_numpy(raw["node_emb"]), np.float32)
        ckpt["rel_emb"] = {
            "weight": np.asarray(_to_numpy(raw["rel_emb"]["weight"]), np.float32)
        }
        ckpt["generator"] = torch_state_to_params(raw["generator"])
        ckpt["discriminator"] = torch_state_to_params(raw["discriminator"])
        return ckpt

    with open(path, "rb") as f:
        blob = f.read()
    return _msgpack.unpackb(blob)
