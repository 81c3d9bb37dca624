"""Collectives over the shards of one mesh axis (the port's counterparts
of ``lax.psum``, ``all_to_all(tiled=True)``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)`` and ``ppermute`` inside ``shard_map``).

Each function takes ``xs``, the tensors of this process's shards of one
group along an axis in mesh order, and ``devs``, their devices (a
:class:`Group`, or a plain list when the group is all of ``xs``), and
returns one tensor per local shard on its device. Sums are taken in mesh
order, so reruns are bitwise equal, and a group that crosses processes
gives the numbers of the same group in one process bit for bit: its
partials are gathered and summed in that order.

Within a process tensors move with ``.to(device)``, which copies only
where the devices differ; shards on one device receive one shared result
where the result is the same, so on one card an all-to-all is a split and
a cat. Between processes they move through host memory over gloo
(``.cpu()``, the collective, ``.to(device)``): gloo takes CUDA tensors
for all-reduce and broadcast only, and NCCL refuses two ranks on one
card. Results may share memory with the inputs: the callers never write
into them.
"""

import torch


class Group(list):
    """The devices of the local shards of one group along a mesh axis, in
    mesh order, with the group's ``size`` and the position ``first`` of the
    first local shard in it. The group ``spans`` processes when it holds
    shards this process does not; the mesh (``Mesh.check_spans``) then
    gives every process the same number of its shards, process r holding
    positions r m ... r m + m - 1."""

    def __init__(self, devs, size=None, first=0):
        super().__init__(devs)
        self.size = len(self) if size is None else size
        self.first = first

    @property
    def spans(self):
        return len(self) < self.size


def as_group(devs):
    """``devs`` as a :class:`Group` (a plain list: the whole group)."""
    return devs if isinstance(devs, Group) else Group(devs)


def group_size(devs):
    """The number of shards in the group of ``devs``."""
    return as_group(devs).size


def _wire(t):
    """A contiguous host tensor gloo can move (complex as real pairs)."""
    t = t.detach().cpu()
    return (torch.view_as_real(t) if t.is_complex() else t).contiguous()


def _unwire(t, like):
    return torch.view_as_complex(t) if like.is_complex() else t


def world_gather(xs):
    """Every process's ``xs`` (equal counts, shapes and dtypes), in
    process order, as host tensors: the all-gather of a group that spans
    every process."""
    import torch.distributed as dist
    send = torch.stack([_wire(x) for x in xs])
    bufs = [torch.empty_like(send) for _ in range(dist.get_world_size())]
    dist.all_gather(bufs, send)
    return [_unwire(b[j], xs[0]) for b in bufs for j in range(len(xs))]


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


def _all(xs, devs):
    """Every shard's tensor of the group, in mesh order."""
    return world_gather(xs) if as_group(devs).spans else xs


def psum(xs, devs):
    """Every shard receives x_0 + x_1 + ... over the group (in that
    order)."""
    allx = _all(xs, devs)

    def total(d):
        out = allx[0].to(d)
        for x in allx[1:]:
            out = out + x.to(d)
        return out
    return _per_device(devs, total)


def all_gather(xs, devs, dim):
    """Every shard receives the concatenation of the group's tensors along
    ``dim``."""
    allx = _all(xs, devs)
    return _per_device(devs, lambda d: torch.cat([x.to(d) for x in allx],
                                                 dim))


def all_to_all(xs, devs, split_dim, concat_dim):
    """The shard at group position r receives the r-th of n (the group's
    size) equal pieces along ``split_dim`` of every shard's tensor,
    concatenated in mesh order along ``concat_dim`` (across processes,
    from the gathered tensors of every shard)."""
    g = as_group(devs)
    n = g.size
    size = xs[0].shape[split_dim]
    if size % n:
        raise ValueError(f"all_to_all: {size} not divisible by {n}")
    pieces = [x.split(size // n, dim=split_dim) for x in _all(xs, devs)]
    return [torch.cat([p[g.first + k].to(d) for p in pieces], concat_dim)
            for k, d in enumerate(g)]


def psum_scatter(xs, devs, dim):
    """The shard at group position r receives the r-th of n equal pieces
    along ``dim`` of the group's sum (summed in mesh order on its
    device)."""
    g = as_group(devs)
    n = g.size
    tot = psum(xs, devs)
    size = tot[0].shape[dim]
    if size % n:
        raise ValueError(f"psum_scatter: {size} not divisible by {n}")
    return [t.narrow(dim, (g.first + k) * (size // n), size // n)
            for k, t in enumerate(tot)]


def ppermute(xs, devs, pairs):
    """The shard at group position dst receives the tensor of src for each
    (src, dst) in ``pairs``; shards that receive nothing get zeros."""
    g = as_group(devs)
    allx = _all(xs, devs)
    src_of = {dst: src for src, dst in pairs}
    out = []
    for k, (x, d) in enumerate(zip(xs, g)):
        src = src_of.get(g.first + k)
        out.append(torch.zeros_like(x) if src is None else allx[src].to(d))
    return out
