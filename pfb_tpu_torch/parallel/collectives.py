"""Collectives over the shards of one mesh axis (the port's counterparts
of ``lax.psum``, ``all_to_all(tiled=True)``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)`` and ``ppermute`` inside ``shard_map``).

Each function takes ``xs``, the tensors of the shards along one axis in
mesh order, and ``devs``, their devices, and returns one tensor per shard
on its device. Sums are taken in mesh order, so reruns are bitwise equal.
Tensors move with ``.to(device)``, which copies only where the devices
differ; shards on one device receive one shared result where the result
is the same, so on one card an all-to-all is a split and a cat. Results
may share memory with the inputs: the callers never write into them.
"""

import torch


def _per_device(devs, make):
    """[make(d) for d in devs], computed once per device."""
    cache = {}
    out = []
    for d in devs:
        key = str(d)
        if key not in cache:
            cache[key] = make(d)
        out.append(cache[key])
    return out


def psum(xs, devs):
    """Every shard receives xs[0] + xs[1] + ... (in that order)."""
    def total(d):
        out = xs[0].to(d)
        for x in xs[1:]:
            out = out + x.to(d)
        return out
    return _per_device(devs, total)


def all_gather(xs, devs, dim):
    """Every shard receives the concatenation of xs along ``dim``."""
    return _per_device(devs, lambda d: torch.cat([x.to(d) for x in xs],
                                                 dim))


def all_to_all(xs, devs, split_dim, concat_dim):
    """Shard r receives the r-th of len(xs) equal pieces along
    ``split_dim`` of every shard's tensor, concatenated in mesh order
    along ``concat_dim``."""
    n = len(xs)
    size = xs[0].shape[split_dim]
    if size % n:
        raise ValueError(f"all_to_all: {size} not divisible by {n}")
    pieces = [x.split(size // n, dim=split_dim) for x in xs]
    return [torch.cat([p[r].to(devs[r]) for p in pieces], concat_dim)
            for r in range(n)]


def psum_scatter(xs, devs, dim):
    """Shard r receives the r-th of len(xs) equal pieces along ``dim`` of
    the sum of xs (summed in mesh order on its device)."""
    n = len(xs)
    tot = psum(xs, devs)
    size = tot[0].shape[dim]
    if size % n:
        raise ValueError(f"psum_scatter: {size} not divisible by {n}")
    return [tot[r].narrow(dim, r * (size // n), size // n)
            for r in range(n)]


def ppermute(xs, devs, pairs):
    """Shard dst receives xs[src] for each (src, dst) in ``pairs``;
    shards that receive nothing get zeros."""
    out = [None] * len(xs)
    for src, dst in pairs:
        out[dst] = xs[src].to(devs[dst])
    return [torch.zeros_like(x) if o is None else o
            for x, o in zip(xs, out)]
