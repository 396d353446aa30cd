"""Path-addressed utilities over nested dicts of tensors.

The port keeps the JAX package's tree convention (``utils/trees.py`` there):
params and adapters are **dict-only** nested dicts whose leaves are addressed
by '/'-joined paths such as ``"blocks/attn/q"``. Every mutation returns a new
tree; inputs are never modified. Leaves may be torch tensors or numpy arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

Tree = Any


def flatten_with_paths(tree: Tree, *, sep: str = "/") -> dict[str, Any]:
    """Flatten ``tree`` into ``{path: leaf}`` with '/'-joined string keys."""
    flat = {}

    def visit(prefix: str, node: Any) -> None:
        if isinstance(node, Mapping):
            for k in node:
                visit(f"{prefix}{sep}{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                visit(f"{prefix}{sep}{i}" if prefix else str(i), v)
        else:
            flat[prefix] = node

    visit("", tree)
    return flat


def unflatten_from_paths(flat: Mapping[str, Any], *, sep: str = "/") -> Tree:
    """Inverse of :func:`flatten_with_paths` (dict nodes only)."""
    root: dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def get_path(tree: Tree, path: str, *, sep: str = "/") -> Any:
    """Return the leaf/subtree at ``path``; raises ``KeyError`` when absent."""
    node = tree
    for p in path.split(sep):
        if isinstance(node, Mapping):
            node = node[p]
        elif isinstance(node, (list, tuple)):
            node = node[int(p)]
        else:
            raise KeyError(f"cannot descend into leaf at {p!r} of {path!r}")
    return node


def set_path(tree: Tree, path: str, value: Any, *, sep: str = "/") -> Tree:
    """Return a copy of ``tree`` with the node at ``path`` replaced."""
    parts = path.split(sep)

    def rebuild(node: Any, depth: int) -> Any:
        if depth == len(parts):
            return value
        key = parts[depth]
        if isinstance(node, Mapping):
            new = dict(node)
            new[key] = rebuild(node[key], depth + 1)
            return new
        if isinstance(node, (list, tuple)):
            idx = int(key)
            new_list = list(node)
            new_list[idx] = rebuild(node[idx], depth + 1)
            return type(node)(new_list)
        raise KeyError(f"cannot descend into leaf at {key!r} of {path!r}")

    return rebuild(tree, 0)


def update_path(tree: Tree, path: str, fn: Callable[[Any], Any], *, sep: str = "/") -> Tree:
    """Return a copy of ``tree`` with ``fn`` applied to the node at ``path``."""
    return set_path(tree, path, fn(get_path(tree, path, sep=sep)), sep=sep)


def map_leaves(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a dict-only tree."""
    return unflatten_from_paths({p: fn(v) for p, v in flatten_with_paths(tree).items()})
