"""Trees of tensors: dicts, lists, tuples and NamedTuples with array leaves.

The port keeps parameters and optimizer moments as plain nested containers,
as the JAX package does. ``tree_map`` and ``tree_leaves`` walk them in one
fixed order (dict keys in insertion order); ``to_state_dict`` and
``from_state_dict`` give the nested-dict form that the JAX package's train
state files hold (``flax.serialization``'s convention: a NamedTuple's fields
by name, the entries of a list or tuple under ``"0"``, ``"1"``, ...).
"""

from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves of rest)`` over a tree; ``rest`` share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def to_state_dict(tree: Any) -> Any:
    """Nested dicts with string keys; leaves as they are."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return {name: to_state_dict(v) for name, v in zip(tree._fields, tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(template: Any, state: Any, leaf: Callable = lambda t, s: s,
                    path: str = "") -> Any:
    """Pour the state dict ``state`` into ``template``'s containers; each leaf
    becomes ``leaf(template leaf, state leaf)``. Raises ValueError where the
    keys of the two differ."""
    if isinstance(template, dict):
        keys = [str(k) for k in template]
        children = list(template.values())
    elif _is_namedtuple(template):
        keys, children = list(template._fields), list(template)
    elif isinstance(template, (list, tuple)):
        keys, children = [str(i) for i in range(len(template))], list(template)
    else:
        if isinstance(state, dict):
            raise ValueError(f"'{path}' is a subtree in the state dict but a leaf "
                             "in the template")
        return leaf(template, state)
    if not isinstance(state, dict) or set(state) != set(keys):
        found = sorted(state) if isinstance(state, dict) else type(state).__name__
        raise ValueError(f"the template's keys and the state dict's keys differ at "
                         f"'{path}': {sorted(keys)} vs {found}")
    values = [from_state_dict(c, state[k], leaf, f"{path}/{k}")
              for k, c in zip(keys, children)]
    if isinstance(template, dict):
        return dict(zip(template, values))
    if _is_namedtuple(template):
        return type(template)(*values)
    return type(template)(values)
