"""Trees of tensors, the port's stand-in for ``jax.tree``: nested dicts
(walked in sorted key order, as ``jax.tree.leaves`` walks them), lists,
tuples and NamedTuples, with tensors (or anything else that is not a
container) at the leaves; ``None`` is an empty subtree.

A leaf's path is the tuple of keys from the root: a dict key, a list or
tuple index, or a NamedTuple field name."""
from __future__ import annotations


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def items(tree, prefix: tuple = ()):
    """(path, leaf) of every leaf of ``tree``, in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], prefix + (k,))
    elif is_namedtuple(tree):
        for f in tree._fields:
            yield from items(getattr(tree, f), prefix + (f,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from items(x, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def leaves(tree) -> list:
    """The leaves of ``tree``, in order."""
    return [x for _, x in items(tree)]


def unflatten(template, values):
    """A tree of ``template``'s structure (dicts keep its key order, lists,
    tuples and NamedTuples come back as such) with ``values``, given in
    ``leaves(template)`` order, at its leaves."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if is_namedtuple(t):
            return type(t)(*[build(getattr(t, f)) for f in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def map_tree(fn, tree, *rest):
    """``fn`` of each leaf of ``tree`` and the leaves at the same places of
    the trees ``rest`` (of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])


def get(tree, path):
    for k in path:
        tree = getattr(tree, k) if is_namedtuple(tree) and \
            isinstance(k, str) else tree[k]
    return tree
