"""Weights from the seed: every leaf of the reference's weight tree cut
from one fp32 buffer, drawn on the device in one call.  The program and
the reference each get the tree made anew from the same seed."""

from __future__ import annotations

import math

import torch

from .reference.common import tree_paths


def make_weights(shapes: dict, seed: int, device, std: float) -> dict:
    """The tree of ``shapes`` (leaf -> (shape, init)): ``normal`` leaves
    N(0, std^2), ``ones`` and ``zeros`` constant; views of one buffer."""
    leaves = list(tree_paths(shapes))
    total = sum(math.prod(shape) for _, (shape, _) in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(0.0, std, generator=gen)
    tree: dict = {}
    at = 0
    for path, (shape, init) in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if init == "ones":
            t.fill_(1.0)
        elif init == "zeros":
            t.zero_()
        elif init != "normal":
            raise ValueError(f"unknown init {init!r}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree
