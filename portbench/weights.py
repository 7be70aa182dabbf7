"""Random weights from the seed, made on the device in a few large calls.

A family lists its tree as leaves ``(path, shape, kind, a, b)``: ``kind``
"uniform" draws from [a - b, a + b], "normal" is ``a`` times a standard
normal. All uniform leaves are slices of one ``torch.rand`` buffer, all
normal ones of one ``torch.randn`` buffer, drawn by one ``torch.Generator``
on the device; each slice starts 256 bytes into a fresh block, so every
leaf is aligned as the kernels require. The same seed gives the same tree.
"""

import math

import torch

__all__ = ["make_tree", "tree_shapes"]

_ALIGN = 64  # fp32 elements


def _blocks(n):
    return -(-n // _ALIGN) * _ALIGN


def _put(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def make_tree(spec, seed, device):
    """The tree of ``spec``'s leaves, fp32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = {"uniform": 0, "normal": 0}
    for _, shape, kind, _, _ in spec:
        sizes[kind] += _blocks(math.prod(shape))
    bufs = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
            "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    offsets = dict.fromkeys(bufs, 0)
    tree = {}
    for path, shape, kind, a, b in spec:
        n = math.prod(shape)
        leaf = bufs[kind][offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += _blocks(n)
        if kind == "uniform":
            leaf.mul_(2.0 * b).add_(a - b)
        else:
            leaf.mul_(a)
        _put(tree, path, leaf)
    return tree


def tree_shapes(tree, prefix=()):
    """{path: shape} of every tensor leaf of a nest of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(tree_shapes(v, prefix + (k,)))
    return out
