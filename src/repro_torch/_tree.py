"""Nested dict/tuple trees of tensors — the reference's parameter and
optimizer-state layout (JAX pytrees) without JAX: a map over the leaves
and a flatten that names each leaf by its path, in the order and with the
key strings JAX gives (dict keys sorted, tuple and list items by index;
``None`` and empty containers hold no leaf)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees in ``rest``,
    which have its structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """[(path, leaf)] in JAX's flatten order: a path is the tuple of dict
    keys and sequence indices from the root to the leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in tree_paths(v, prefix + (i,))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def path_key(path: tuple) -> str:
    """The checkpoint key of a leaf: its path joined by "/" (the
    reference's ``0/layers/0/wq``)."""
    return "/".join(str(p) for p in path)


def tree_replace_leaves(tree, leaves: list):
    """``tree`` with its leaves, in ``tree_paths`` order, replaced by
    ``leaves``. (No closure refers to itself here: a reference cycle would
    keep every replaced leaf alive until the cyclic garbage collector
    ran.)"""
    paths = [path for path, _ in tree_paths(tree)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(paths)}")
    return _rebuild(tree, (), dict(zip(paths, leaves)))


def _rebuild(node, prefix: tuple, by_path: dict):
    if isinstance(node, dict):
        return {k: _rebuild(v, prefix + (k,), by_path) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_rebuild(v, prefix + (i,), by_path) for i, v in enumerate(node))
    if node is None:
        return None
    return by_path[prefix]
