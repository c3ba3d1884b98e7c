"""Nested parameter trees in JAX's flatten order.

A tree is a tensor (a leaf), ``None`` or a tuple, named tuple, list or
dict of trees.  :func:`leaves` walks it as ``jax.tree_util.tree_leaves``
does: tuples and lists in order, dicts in sorted key order, ``None`` and
``()`` as empty nodes.  So an MLP is a tuple of (W, b) pairs, the flows'
params are lists of ``{'s1', 's2'}`` MLPs with ``()`` for the stochastic
layers, and an :class:`~dmip_tpu_torch.train.AdamState` is its count, mu,
nu and (when set) schedule count, as optax's state is flattened.

:func:`treedef` writes the ``PyTreeDef(...)`` string that JAX prints for
the same structure, and :func:`parse_treedef` reads one back (with
:data:`LEAF` at every leaf), so a checkpoint's structure can be rebuilt
without a tree to copy it from.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterator, List

LEAF = type("Leaf", (), {"__repr__": lambda self: "*"})()


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    return [tree]


def _build(like, it: Iterator):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _build(like[k], it) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_build(sub, it) for sub in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_build(sub, it) for sub in like)
    return next(it)


def unflatten(like, flat) -> Any:
    """A tree with the structure of ``like`` whose leaves are ``flat``, in
    order."""
    flat = list(flat)
    n = len(leaves(like))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a structure of {n}")
    return _build(like, iter(flat))


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 - jax.tree_util.tree_map's name
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *(leaves(r) for r in rest))])


def _def(tree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_def(tree[k])}" for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        raise ValueError(f"no PyTreeDef string for a {type(tree).__name__}")
    if isinstance(tree, tuple):
        inner = ", ".join(_def(sub) for sub in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    if isinstance(tree, list):
        return "[" + ", ".join(_def(sub) for sub in tree) + "]"
    return "*"


def treedef(tree) -> str:
    """JAX's ``str(tree_structure(tree))`` for a tree of tuples, lists,
    dicts and None."""
    return f"PyTreeDef({_def(tree)})"


_TOKEN = re.compile(r"\s*(\*|None|'[^']*'|[()\[\]{}:,]|[^\s()\[\]{}:,]+)")


def parse_treedef(text: str):
    """The structure that a ``PyTreeDef(...)`` string of tuples, lists,
    dicts, None and leaves describes, with :data:`LEAF` at every leaf.
    Dict keys must come in sorted order, as JAX writes them.  Anything else
    (a custom node such as a named tuple) raises a ValueError."""
    m = re.fullmatch(r"\s*PyTreeDef\((.*)\)\s*", text, re.S)
    if m is None:
        raise ValueError(f"not a PyTreeDef string: {text!r}")
    tokens = _TOKEN.findall(m.group(1))
    pos = 0

    def take(expected=None) -> str:
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError(f"truncated PyTreeDef: {text!r}")
        tok = tokens[pos]
        if expected is not None and tok != expected:
            raise ValueError(f"expected {expected!r}, got {tok!r} in {text!r}")
        pos += 1
        return tok

    def items(close: str, item):
        out = []
        while tokens[pos:pos + 1] != [close]:
            out.append(item())
            if tokens[pos:pos + 1] == [","]:
                take(",")
        take(close)
        return out

    def entry():
        key = take()
        if not (key.startswith("'") and key.endswith("'")):
            raise ValueError(f"expected a dict key, got {key!r} in {text!r}")
        take(":")
        return key[1:-1], node()

    def node():
        tok = take()
        if tok == "*":
            return LEAF
        if tok == "None":
            return None
        if tok == "(":
            return tuple(items(")", node))
        if tok == "[":
            return items("]", node)
        if tok == "{":
            pairs = items("}", entry)
            keys = [k for k, _ in pairs]
            if keys != sorted(keys):
                raise ValueError(f"dict keys not in JAX's sorted order: {text!r}")
            return dict(pairs)
        raise ValueError(f"unsupported node {tok!r} in {text!r}")

    tree = node()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in {text!r}")
    return tree
