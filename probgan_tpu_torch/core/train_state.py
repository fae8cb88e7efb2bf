"""Full train state files, for resume.

The port of ``probgan_tpu/core/train_state.py``. An inference checkpoint
carries the best model but not the optimizer state, so training cannot
continue from it; a train state file holds the complete state (params,
embedding tables, both Adam states) and loop metadata (epoch, best so far,
history).

On disk it is the JAX package's file: msgpack (``core/_msgpack.py``) of
``{"state": <state dict>, "meta": meta}``, the state dict in
``flax.serialization``'s convention (``core/tree.py``: NamedTuple fields by
name, lists and tuples as ``"0"``, ``"1"``, ...; Adam's state as ``{"0":
{"count", "mu", "nu"}, "1": {}}``) with arrays in the JAX layout. Either
package resumes from the other's file.

Layout: in a train state every 4-d leaf is a conv weight or one of its Adam
moments, OIHW in the port's memory and HWIO on disk; every other leaf keeps
its shape. The conversion is done leaf by leaf on save and on load.

Restore needs a template state of the same structure (the trainer's init for
the same architecture); values are poured into it, each onto its template
leaf's device and dtype.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from probgan_tpu_torch.core import _msgpack
from probgan_tpu_torch.core.tree import from_state_dict, to_state_dict, tree_map


def _to_disk(leaf) -> np.ndarray:
    a = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0)) if a.ndim == 4 else a


def _from_disk(leaf):
    a = np.asarray(leaf)
    return np.ascontiguousarray(a.transpose(3, 2, 0, 1)) if a.ndim == 4 else a


def _pour(template_leaf, value):
    if isinstance(value, torch.Tensor):
        # grow: a leaf the file lacks keeps the template's own value, on
        # whatever device the template lives
        return value
    value = np.asarray(value)
    if not isinstance(template_leaf, torch.Tensor):
        return value
    if tuple(value.shape) != tuple(template_leaf.shape):
        raise ValueError(f"train state leaf of shape {tuple(value.shape)} does not fit "
                         f"the template's {tuple(template_leaf.shape)}")
    return torch.from_numpy(np.array(value)).to(device=template_leaf.device,
                                                dtype=template_leaf.dtype)


def save_train_state(path: str, state: Any, meta: dict) -> None:
    """Serialize (state tree incl. the Adam states, loop metadata)."""
    payload = {"state": tree_map(_to_disk, to_state_dict(state)), "meta": meta}
    blob = _msgpack.packb(payload)
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # atomic on POSIX: no torn file after a crash


def load_train_state(
    path: str, template: Any, alias_missing: dict[str, str] | None = None,
    grow: bool = False,
) -> tuple[Any, dict]:
    """Restore a train state into ``template``'s structure. Returns
    (state, meta).

    ``alias_missing``: schema-upgrade map for files written before a
    top-level field existed: each missing key is seeded from the named
    sibling key (e.g. ``{"g_ema": "g_params"}`` for pre-EMA ProGAN states).
    Only the listed keys are upgraded; any other structure mismatch raises.

    ``grow``: progressive-growth restore: the file may be a strict SUBTREE of
    ``template`` (a ProGAN state trained to 512² poured into a 1024²
    template: the extra stage's params, EMA and Adam moments keep the
    template's fresh values while every trained leaf restores). File leaves
    absent from the template, or of another shape, still raise: growing never
    silently drops or reshapes trained weights."""
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(f.read())
    sd = tree_map(_from_disk, payload["state"])
    for missing, source in (alias_missing or {}).items():
        if missing not in sd and source in sd:
            sd[missing] = sd[source]
    if grow:
        sd = _merge_subtree(to_state_dict(template), sd)
    return from_state_dict(template, sd, _pour), payload["meta"]


def _merge_subtree(template_sd: Any, file_sd: Any, path: str = "") -> Any:
    """Pour ``file_sd`` into a copy of ``template_sd`` (state dicts; list
    entries are stringified-index keys, so grown per-stage lists merge by
    position). Every file entry must exist in the template with a matching
    leaf shape."""
    if isinstance(file_sd, dict):
        if not isinstance(template_sd, dict):
            raise ValueError(
                f"grow restore: '{path}' is a subtree in the file but a "
                f"leaf in the template"
            )
        merged = dict(template_sd)
        for key, val in file_sd.items():
            if key not in template_sd:
                raise ValueError(
                    f"grow restore: file entry '{path}/{key}' has no "
                    f"counterpart in the template state"
                )
            merged[key] = _merge_subtree(template_sd[key], val, f"{path}/{key}")
        return merged
    t_shape = getattr(template_sd, "shape", None)
    f_shape = getattr(file_sd, "shape", None)
    if t_shape is not None:
        t_shape = tuple(t_shape)
    if f_shape is not None:
        f_shape = tuple(f_shape)
    if t_shape != f_shape:
        raise ValueError(
            f"grow restore: leaf '{path}' shape {f_shape} != template "
            f"shape {t_shape} (incompatible architecture, not a growth)"
        )
    return file_sd
