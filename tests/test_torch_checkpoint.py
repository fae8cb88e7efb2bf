"""Checkpoint interchange between the port and the JAX package: each reads
what the other wrote, in both physical formats, with the format sniffed from
the content. The port's msgpack codec is held against flax's."""

import numpy as np
import pytest
import torch
from flax import serialization

from probgan_tpu.core import checkpoint as jax_ckpt
from probgan_tpu_torch.core import _msgpack, checkpoint


def _assert_same_checkpoint(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    np.testing.assert_array_equal(np.asarray(got["node_emb"]), np.asarray(want["node_emb"]))
    np.testing.assert_array_equal(np.asarray(got["rel_emb"]["weight"]),
                                  np.asarray(want["rel_emb"]["weight"]))
    for model in ("generator", "discriminator"):
        assert set(got[model]) == set(want[model])
        for layer in want[model]:
            for leaf in ("w", "b"):
                a, b = np.asarray(got[model][layer][leaf]), np.asarray(want[model][layer][leaf])
                assert a.dtype == np.float32 and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert dict(got["args"]) == dict(want["args"])
    assert float(got["best_val_hit10"]) == float(want["best_val_hit10"])
    assert int(got["best_epoch"]) == int(want["best_epoch"])
    assert got["training_history"] == want["training_history"]


def test_checkpoint_keys_match_the_jax_package():
    assert checkpoint.CHECKPOINT_KEYS == jax_ckpt.CHECKPOINT_KEYS


@pytest.mark.parametrize("fixture", ["native_ckpt_path", "torch_ckpt_path"])
def test_port_reads_what_the_jax_package_wrote(fixture, request, ckpt_dict):
    path = request.getfixturevalue(fixture)
    _assert_same_checkpoint(checkpoint.load_checkpoint(path), ckpt_dict)


@pytest.mark.parametrize("fmt,name", [("native", "ck.msgpack"), ("torch", "ck.pt"),
                                      ("auto", "auto.pt"), ("auto", "auto.msgpack")])
def test_jax_package_reads_what_the_port_wrote(fmt, name, tmp_path, ckpt_dict):
    path = str(tmp_path / "sub" / name)  # the directory is created
    checkpoint.save_checkpoint(path, ckpt_dict, format=fmt)
    _assert_same_checkpoint(jax_ckpt.load_checkpoint(path), ckpt_dict)
    _assert_same_checkpoint(checkpoint.load_checkpoint(path), ckpt_dict)
    assert checkpoint._looks_like_torch(path) == name.endswith(".pt")


def test_port_saves_tensor_leaves(tmp_path, ckpt_dict):
    from probgan_tpu_torch.core.convert import convert_kg_checkpoint

    path = str(tmp_path / "tensors.msgpack")
    checkpoint.save_checkpoint(path, convert_kg_checkpoint(ckpt_dict))
    _assert_same_checkpoint(jax_ckpt.load_checkpoint(path), ckpt_dict)


def test_format_is_sniffed_from_content_not_extension(tmp_path, ckpt_dict):
    """A reference-named best_checkpoint.pt holding msgpack, and a .msgpack
    name holding a torch zip, both load."""
    native_as_pt = str(tmp_path / "best_checkpoint.pt")
    checkpoint.save_checkpoint(native_as_pt, ckpt_dict, format="native")
    assert not checkpoint._looks_like_torch(native_as_pt)
    _assert_same_checkpoint(checkpoint.load_checkpoint(native_as_pt), ckpt_dict)
    torch_as_msgpack = str(tmp_path / "ckpt.msgpack")
    checkpoint.save_checkpoint(torch_as_msgpack, ckpt_dict, format="torch")
    assert checkpoint._looks_like_torch(torch_as_msgpack)
    _assert_same_checkpoint(checkpoint.load_checkpoint(torch_as_msgpack), ckpt_dict)
    # an empty top-level map starts with 0x80 like a legacy pickle; its
    # second byte is no pickle protocol
    empty = tmp_path / "empty.msgpack"
    empty.write_bytes(_msgpack.packb({}) + b"")
    assert not checkpoint._looks_like_torch(str(empty))


def test_params_state_round_trip(ckpt_dict):
    state = checkpoint.params_to_torch_state(ckpt_dict["generator"])
    want = jax_ckpt.params_to_torch_state(ckpt_dict["generator"])
    assert state.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(state[k], want[k])
    back = checkpoint.torch_state_to_params({k: torch.from_numpy(v) for k, v in state.items()})
    for layer in ckpt_dict["generator"]:
        np.testing.assert_array_equal(back[layer]["w"], ckpt_dict["generator"][layer]["w"])
        np.testing.assert_array_equal(back[layer]["b"], ckpt_dict["generator"][layer]["b"])


def test_missing_file_message():
    with pytest.raises(FileNotFoundError, match="Checkpoint not found: /does/not/exist.pt"):
        checkpoint.load_checkpoint("/does/not/exist.pt")


def test_orbax_is_not_ported(tmp_path, ckpt_dict):
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.save_checkpoint(str(tmp_path / "ck.orbax"), ckpt_dict)
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.save_checkpoint(str(tmp_path / "ck"), ckpt_dict, format="orbax")
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.load_checkpoint(str(tmp_path))  # a directory
    with pytest.raises(ValueError, match="Unknown checkpoint format"):
        checkpoint.save_checkpoint(str(tmp_path / "ck"), ckpt_dict, format="zip")


class _NotATensor:
    """A pickled object that weights_only=True refuses."""


def test_weights_only_rule_and_unsafe_opt_in(tmp_path, torch_ckpt_path, monkeypatch):
    # the reference's .pt (tensors and plain containers) passes without opt-in
    monkeypatch.delenv("PROBGAN_TORCH_UNSAFE_LOAD", raising=False)
    assert checkpoint.load_checkpoint(torch_ckpt_path)["best_epoch"] == 17
    raw = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    raw["extra"] = _NotATensor()
    path = str(tmp_path / "unsafe.pt")
    torch.save(raw, path)
    with pytest.raises(ValueError, match="PROBGAN_TORCH_UNSAFE_LOAD=1"):
        checkpoint.load_checkpoint(path)
    monkeypatch.setenv("PROBGAN_TORCH_UNSAFE_LOAD", "1")
    assert isinstance(checkpoint.load_checkpoint(path)["extra"], _NotATensor)


# -- the msgpack codec against flax's -------------------------------------------

_TREE = {
    "none": None, "t": True, "f": False, "small": 5, "neg": -3, "i8": -100, "u16": 40000,
    "i32": -70000, "u32": 3_000_000_000, "i64": -(2**40), "u64": 2**63 + 5,
    "float": 0.4321, "str": "héllo", "long_str": "x" * 300, "bytes": b"\x00\x01\xff",
    "list": [1, 2.5, "a", [None, {"k": 1}]], "empty": {}, "empty_list": [],
    "big_map": {str(i): i for i in range(20)}, "big_list": list(range(70000)),
    "arr": np.arange(12, dtype=np.float32).reshape(3, 4),
    "arr_i64": np.array([[1, -2], [3, 4]], np.int64), "arr_empty": np.zeros((0, 4), np.float32),
    "arr_0d": np.array(2.5, np.float64), "arr_bool": np.array([True, False]),
    "arr_16": np.arange(4, dtype=np.float32),  # a 16-byte payload is not fixext here
}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_msgpack_flax_reads_what_the_port_packs():
    _assert_tree_equal(serialization.msgpack_restore(_msgpack.packb(_TREE)), _TREE)


def test_msgpack_port_reads_what_flax_packs():
    got = _msgpack.unpackb(serialization.msgpack_serialize(_TREE))
    _assert_tree_equal(got, _TREE)
    got["arr"][0, 0] = 7.0  # leaves are writable, owned arrays


def test_msgpack_round_trip_and_bytes_equal_to_flax():
    """Same bytes as flax for the checkpoint-shaped part of the tree (ints
    take the shortest form, floats are float64, arrays are ext 1)."""
    # flax writes a dict's keys in sorted order
    tree = {k: _TREE[k] for k in sorted(("small", "neg", "u16", "float", "str", "arr", "list"))}
    assert _msgpack.packb(tree) == serialization.msgpack_serialize(tree)
    _assert_tree_equal(_msgpack.unpackb(_msgpack.packb(_TREE)), _TREE)


def test_msgpack_numpy_scalar_is_ext_3():
    tree = {"hit10": np.float32(0.25), "epoch": np.int64(17)}
    blob = serialization.msgpack_serialize(tree)
    got = _msgpack.unpackb(blob)
    assert got["hit10"].dtype == np.float32 and float(got["hit10"]) == 0.25
    assert got["epoch"].dtype == np.int64 and int(got["epoch"]) == 17
    back = serialization.msgpack_restore(_msgpack.packb(tree))
    assert back["hit10"].dtype == np.float32 and int(back["epoch"]) == 17


def test_msgpack_chunked_array_leaf(monkeypatch):
    """A leaf above the chunk limit travels as flax's chunk dict: built by
    hand at a small size, written by the port under a lowered limit, and by
    flax under the same."""
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    by_hand = {
        "__msgpack_chunked_array__": True,
        "shape": {"0": 4, "1": 6},
        "chunks": {"0": arr.reshape(-1)[:10], "1": arr.reshape(-1)[10:20],
                   "2": arr.reshape(-1)[20:]},
    }
    blob = serialization.msgpack_serialize({"node_emb": by_hand, "n": 1}, in_place=True)
    got = _msgpack.unpackb(blob)
    np.testing.assert_array_equal(got["node_emb"], arr)
    assert got["n"] == 1

    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 40)   # 10 floats per chunk
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    mine = _msgpack.packb({"node_emb": arr, "small": arr[0]})
    assert b"__msgpack_chunked_array__" in mine
    assert mine == serialization.msgpack_serialize({"node_emb": arr, "small": arr[0]})
    np.testing.assert_array_equal(serialization.msgpack_restore(mine)["node_emb"], arr)
    np.testing.assert_array_equal(_msgpack.unpackb(mine)["node_emb"], arr)


@pytest.mark.parametrize("blob,match", [
    (b"\x81\xa1a", "ends inside"), (b"\xc1", "invalid msgpack type byte"),
    (b"\x01\x02", "trailing bytes"), (b"\xd4\x07\x00", "unknown msgpack ext type"),
])
def test_msgpack_rejects_malformed_input(blob, match):
    with pytest.raises(ValueError, match=match):
        _msgpack.unpackb(blob)


def test_msgpack_rejects_unserializable_leaf():
    with pytest.raises(TypeError, match="cannot serialize"):
        _msgpack.packb({"x": object()})
