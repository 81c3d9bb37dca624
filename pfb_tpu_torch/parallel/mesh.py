"""Device meshes and sharded tensors (counterpart of
pfb_tpu/parallel/mesh.py).

The JAX package runs its distributed steps as ``shard_map`` programs
over a ``jax.sharding.Mesh``. The port's mesh is single-process: a
(nband, nspace) grid of ``torch.device`` with axes ("band", "space"),
whose entries may repeat. Several *virtual shards* can then share one
card (or the CPU in the tests), which is how the space-sharded path runs
on a machine with one GPU; on a host with several cards the same code
puts one shard per card and moves tensors between them with ``.to``.

A :class:`Sharded` tensor is the per-shard tensors plus a spec naming,
per dimension, the mesh axis that splits it (``None``: not split), as a
``PartitionSpec`` does. Shards that the spec does not tell apart and
that sit on one device share ONE tensor (and the dist functions compute
on it once): replicated means one tensor per device, not one per shard.
A layout is named by its spec tuple alone (parallel/dist.py's ``CUBE``,
``COEFF`` and the rest), where the JAX package builds NamedShardings.
"""

import torch

from pfb_tpu_torch.config import default_device

AXES = ("band", "space")


def default_devices():
    """Every visible CUDA device, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device(f"cuda:{i}")
                for i in range(torch.cuda.device_count())]
    return [default_device()]


def _device(d):
    """torch.device with a CUDA index filled in ("cuda" -> "cuda:<current>"),
    so that a device compares and prints as its tensors' ``.device``."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A (nband, nspace) grid of devices with axes ("band", "space").
    Shard i = b * nspace + s sits on ``devices[i]``."""

    def __init__(self, grid):
        self.grid = [[_device(d) for d in row] for row in grid]
        self.shape = {"band": len(self.grid), "space": len(self.grid[0])}
        if any(len(row) != self.shape["space"] for row in self.grid):
            raise ValueError("mesh rows of different lengths")
        self.devices = [d for row in self.grid for d in row]
        self.size = len(self.devices)

    def coords(self, i):
        return divmod(i, self.shape["space"])

    def index(self, i, axis):
        """Position of shard i along ``axis``."""
        return self.coords(i)[AXES.index(axis)]

    def groups(self, axis):
        """The shards along ``axis``, one list per position on the other
        axis (or one list of every shard for axis ("band", "space"))."""
        nb, ns = self.shape["band"], self.shape["space"]
        if axis == "band":
            return [[b * ns + s for b in range(nb)] for s in range(ns)]
        if axis == "space":
            return [[b * ns + s for s in range(ns)] for b in range(nb)]
        return [list(range(self.size))]

    def __repr__(self):
        return f"Mesh({self.shape['band']} x {self.shape['space']}, " \
               f"{sorted({str(d) for d in self.devices})})"


def make_mesh(nband=None, nspace=1, devices=None):
    """Mesh with ("band", "space") axes over ``devices`` (None: every
    visible CUDA device, or the CPU); ``nband * nspace`` must equal the
    device count, as in the JAX package. A list that repeats a device
    gives virtual shards on it."""
    if devices is None:
        devices = default_devices()
    n = len(devices)
    if nband is None:
        nband = n // nspace
    assert nband * nspace == n, f"{nband} x {nspace} != {n} devices"
    return Mesh([devices[b * nspace:(b + 1) * nspace]
                 for b in range(nband)])


def _spec(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    if len(spec) != ndim:
        raise ValueError(f"spec {spec} for a {ndim}-d tensor")
    return spec


class Sharded:
    """Per-shard tensors of a global tensor of ``shape`` laid out by
    ``spec`` over ``mesh``. A split dimension of length n over an axis of
    size m gives blocks of ceil(n / m); the padding of the last blocks
    (made by :func:`shard`'s ``pad_value``) is cut off by
    :meth:`gather`."""

    def __init__(self, mesh, spec, shape, parts):
        self.mesh = mesh
        self.shape = tuple(shape)
        self.spec = _spec(spec, len(self.shape))
        self.parts = list(parts)
        if len(self.parts) != mesh.size:
            raise ValueError(f"{len(self.parts)} parts for {mesh}")

    @property
    def dtype(self):
        return self.parts[0].dtype

    def block(self, b, s=0):
        return self.parts[b * self.mesh.shape["space"] + s]

    def gather(self, device=None):
        """The global tensor on ``device`` (default: shard 0's)."""
        device = self.mesh.devices[0] if device is None else device
        nb, ns = self.mesh.shape["band"], self.mesh.shape["space"]
        db = self.spec.index("band") if "band" in self.spec else None
        ds = self.spec.index("space") if "space" in self.spec else None
        rows = []
        for b in range(nb if db is not None else 1):
            row = [self.block(b, s).to(device)
                   for s in range(ns if ds is not None else 1)]
            rows.append(torch.cat(row, ds) if ds is not None else row[0])
        out = torch.cat(rows, db) if db is not None else rows[0]
        return out[tuple(slice(0, n) for n in self.shape)]

    def numpy(self):
        return self.gather(torch.device("cpu")).numpy()

    def __repr__(self):
        return f"Sharded({self.shape}, {self.spec}, {self.mesh})"


def shard(x, mesh, spec, pad_value=0.0):
    """Lay a tensor out over the mesh (the counterpart of
    ``jax.device_put(x, NamedSharding(mesh, spec))``). A split dimension
    that the axis does not divide is padded with ``pad_value``. Shards
    with the same block on one device share one tensor; a block that is a
    contiguous view of ``x`` on its device is not copied."""
    x = torch.as_tensor(x)
    spec = _spec(spec, x.dim())
    pads = [0] * x.dim()
    for d, a in enumerate(spec):
        if a is not None:
            m = mesh.shape[a]
            pads[d] = -(-x.shape[d] // m) * m - x.shape[d]
    xp = x
    if any(pads):
        flat = []
        for p in reversed(pads):
            flat += [0, p]
        xp = torch.nn.functional.pad(x, flat, value=pad_value)
    cache = {}
    parts = []
    for i, dev in enumerate(mesh.devices):
        b, s = mesh.coords(i)
        idx = []
        key = []
        for d, a in enumerate(spec):
            if a is None:
                idx.append(slice(None))
                continue
            m = mesh.shape[a]
            n = xp.shape[d] // m
            j = b if a == "band" else s
            idx.append(slice(j * n, (j + 1) * n))
            key.append((d, j))
        key = (tuple(key), str(dev))
        if key not in cache:
            cache[key] = xp[tuple(idx)].to(dev).contiguous()
        parts.append(cache[key])
    return Sharded(mesh, spec, x.shape, parts)


def as_sharded(x, mesh, spec, pad_value=0.0):
    """``x`` laid out by ``spec``: a :class:`Sharded` with that spec
    passes through; any other layout is gathered on shard 0's device and
    laid out again (one copy of the global tensor)."""
    if isinstance(x, Sharded):
        if x.mesh is mesh and x.spec == _spec(spec, len(x.shape)):
            return x
        x = x.gather()
    return shard(x, mesh, spec, pad_value=pad_value)


def gather(x, device=None):
    """The global tensor of a :class:`Sharded` (the counterpart of
    ``np.asarray(sharded)``); a plain tensor passes through."""
    return x.gather(device) if isinstance(x, Sharded) else x


def smap(fn, *lists):
    """[fn(*args) for args in zip(*lists)], computed once for argument
    tuples that are the same objects (the shards that share a tensor)."""
    cache = {}
    out = []
    for args in zip(*lists):
        key = tuple(id(a) for a in args)
        if key not in cache:
            cache[key] = fn(*args)
        out.append(cache[key])
    return out


def along(mesh, axis, fn, *lists):
    """Run the group function ``fn(*sublists, devices)`` on each group of
    shards along ``axis`` (:meth:`Mesh.groups`) and scatter its per-shard
    results back; groups holding the same objects on the same devices run
    once."""
    out = [None] * mesh.size
    cache = {}
    for g in mesh.groups(axis):
        devs = [mesh.devices[i] for i in g]
        sub = [[lst[i] for i in g] for lst in lists]
        key = (tuple(tuple(id(v) for v in s) for s in sub),
               tuple(str(d) for d in devs))
        if key not in cache:
            cache[key] = fn(*sub, devs)
        for i, r in zip(g, cache[key]):
            out[i] = r
    return out
