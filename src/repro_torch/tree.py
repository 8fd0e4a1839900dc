"""Trees of tensors: the port's counterpart of JAX pytrees.

A node is a dict (children in sorted-key order, as ``jax.tree`` takes
them), a NamedTuple (in field order) or a tuple or list; anything else
is a leaf. Each leaf has JAX's path key: a dict key as itself, a
NamedTuple field as ``.<field>``, a sequence index as its number,
joined with ``/`` (a ``TrainState`` gives ``.params/blocks/ln1``,
``.m/embed``, ``.step``). The leaf order and these keys are defined
here only; the checkpointer writes the keys, so its files line up with
the JAX package's.

The walks are module-level functions, not closures that call themselves:
such a closure is a reference cycle, which would keep every leaf it saw
(a whole train state and its gradients) alive until Python's cyclic
collector happened to run.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

IsLeaf = Optional[Callable[[Any], bool]]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree, is_leaf: IsLeaf):
    """[(path part, child)] of a node, in leaf order; None for a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return None
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _join(path: str, part: str) -> str:
    return f"{path}/{part}" if path else part


def _walk(t, path: str, is_leaf: IsLeaf, out: Dict[str, Any]) -> None:
    kids = _children(t, is_leaf)
    if kids is None:
        out[path] = t
        return
    for part, sub in kids:
        _walk(sub, _join(path, part), is_leaf, out)


def tree_flatten_with_path(tree, is_leaf: IsLeaf = None) -> Dict[str, Any]:
    """{path key: leaf}, in leaf order."""
    out: Dict[str, Any] = {}
    _walk(tree, "", is_leaf, out)
    return out


def _build(t, path: str, values: Dict[str, Any], is_leaf: IsLeaf):
    if _children(t, is_leaf) is None:
        return values[path]
    if isinstance(t, dict):
        return {k: _build(v, _join(path, str(k)), values, is_leaf) for k, v in t.items()}
    if _is_namedtuple(t):
        return type(t)(*(_build(getattr(t, f), _join(path, f".{f}"), values, is_leaf)
                         for f in t._fields))
    return type(t)(_build(v, _join(path, str(i)), values, is_leaf) for i, v in enumerate(t))


def tree_rebuild(tree, values: Dict[str, Any], is_leaf: IsLeaf = None):
    """``tree``'s structure with the leaf at each path key replaced by
    ``values[key]`` (a KeyError names a key ``values`` lacks)."""
    return _build(tree, "", values, is_leaf)


def tree_leaves(tree, is_leaf: IsLeaf = None) -> List[Any]:
    return list(tree_flatten_with_path(tree, is_leaf).values())


def tree_unflatten(tree, leaves: Iterable):
    """A tree of ``tree``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    keys = list(tree_flatten_with_path(tree))
    leaves = list(leaves)
    if len(leaves) != len(keys):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(keys)}")
    return tree_rebuild(tree, dict(zip(keys, leaves)))


def _walk_keys(t, keys: tuple, is_leaf: IsLeaf, out: List[Any]) -> None:
    kids = _children(t, is_leaf)
    if kids is None:
        out.append((list(keys), t))
        return
    is_dict = isinstance(t, dict)
    for part, sub in kids:
        _walk_keys(sub, keys + (part,) if is_dict else keys, is_leaf, out)


def tree_map_with_keys(fn: Callable, tree, is_leaf: IsLeaf = None):
    """``fn(keys, leaf)`` leaf by leaf, ``keys`` the dict keys on the leaf's
    path (JAX's ``DictKey`` entries: a NamedTuple field or a sequence index
    adds none), as ``jax.tree_util.tree_map_with_path`` callers read them."""
    out: List[Any] = []
    _walk_keys(tree, (), is_leaf, out)
    flat = tree_flatten_with_path(tree, is_leaf)
    return tree_rebuild(tree, {k: fn(keys, leaf)
                               for k, (keys, leaf) in zip(flat, out)}, is_leaf)


def tree_map(fn: Callable, tree, *rest, is_leaf: IsLeaf = None):
    """``fn`` applied leaf by leaf over trees of one structure (the first's);
    ``is_leaf`` stops the walk at the nodes it accepts, as in ``jax.tree.map``."""
    flat = tree_flatten_with_path(tree, is_leaf)
    others = [tree_flatten_with_path(r) for r in rest]
    return tree_rebuild(tree, {k: fn(v, *(o[k] for o in others)) for k, v in flat.items()},
                        is_leaf)


def tree_clear(tree) -> None:
    """Empty every dict and list of ``tree`` in place, so it holds its leaves
    no more (a tuple or NamedTuple cannot be emptied: the walk goes through
    it). For a tree its owner hands over and reads no more."""
    kids = _children(tree, None)
    if kids is None:
        return
    for _, sub in kids:
        tree_clear(sub)
    if isinstance(tree, (dict, list)):
        tree.clear()
