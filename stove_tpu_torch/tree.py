"""Nested dict/list parameter trees: leaves, paths and maps.

The port keeps parameters as the JAX package's pytrees: nested dicts (keys
in sorted order, as `jax.tree_util` flattens them) and lists of tensors.
`paths` gives each leaf's path as the keys and indices leading to it; a
path's `keystr` is the checkpoint key the JAX package writes for it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

Path = Tuple[Any, ...]


def paths(tree: Any, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) pairs in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in paths(tree)]


def unflatten(template: Any, values: List[Any]) -> Any:
    """A tree shaped like `template` holding `values` in leaf order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over matching leaves of one or more trees of the same shape."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest))])


def keystr(path: Path) -> str:
    """jax.tree_util.keystr of a dict/list path: `['a'][0]['b']`."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)
