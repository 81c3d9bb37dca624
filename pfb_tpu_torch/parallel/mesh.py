"""Device meshes and sharded tensors (counterpart of
pfb_tpu/parallel/mesh.py).

The JAX package runs its distributed steps as ``shard_map`` programs
over a ``jax.sharding.Mesh``. The port's mesh is a (nband, nspace) grid
of shards with axes ("band", "space"), each on a ``torch.device``, whose
entries may repeat. Several *virtual shards* can then share one card (or
the CPU in the tests), which is how the space-sharded path runs on a
machine with one GPU; on a host with several cards the same code puts one
shard per card and moves tensors between them with ``.to``.

A mesh may span processes (``parallel/runtime.py:set_client(coordinator=
...)``, torch.distributed over gloo). The global mesh is process-major,
as JAX's is: process r holds shards r L ... r L + L - 1 on the L devices
it was given, and only those; the collectives along an axis whose groups
cross processes move tensors between them (parallel/collectives.py).

A :class:`Sharded` tensor is this process's per-shard tensors plus a spec
naming, per dimension, the mesh axis that splits it (``None``: not
split), as a ``PartitionSpec`` does. Shards that the spec does not tell
apart and that sit on one device share ONE tensor (and the dist functions
compute on it once): replicated means one tensor per device, not one per
shard. A layout is named by its spec tuple alone (parallel/dist.py's
``CUBE``, ``COEFF`` and the rest), where the JAX package builds
NamedShardings.
"""

import torch

from pfb_tpu_torch.config import default_device
from pfb_tpu_torch.parallel.collectives import Group, world_gather

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


def _world():
    """(rank, process count) of the torch.distributed group, (0, 1) when
    none is initialised."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A (nband, nspace) grid of shards with axes ("band", "space"); shard
    i = b * nspace + s. This process (``rank`` of ``nproc``) holds the
    shards ``local`` = offset ... offset + L - 1, offset = rank L, on its
    L ``devices``."""

    def __init__(self, nband, nspace, devices, rank=0, nproc=1):
        self.shape = {"band": nband, "space": nspace}
        self.size = nband * nspace
        self.devices = [_device(d) for d in devices]
        L = len(self.devices)
        if L * nproc != self.size:
            raise ValueError(f"{nband} x {nspace} shards over {nproc} "
                             f"process(es) of {L} device(s)")
        self.rank, self.nproc = rank, nproc
        self.offset = rank * L
        self.local = range(self.offset, self.offset + L)

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

    def check_spans(self):
        """Every group along every axis either sits in one process or
        holds the same number of shards in every process: the condition
        under which the collectives of a group that crosses processes are
        one world collective, called by every process in the same order."""
        L = len(self.devices)
        for axis in ("band", "space", ("band", "space")):
            for g in self.groups(axis):
                per = {}
                for i in g:
                    per[i // L] = per.get(i // L, 0) + 1
                if len(per) > 1 and (len(per) != self.nproc or
                                     len(set(per.values())) > 1):
                    raise ValueError(
                        f"{self}: a group along {axis} holds shards "
                        f"{per} of the {self.nproc} processes; each "
                        "group must sit in one process or hold as many "
                        "shards of each")

    def __repr__(self):
        procs = f", process {self.rank} of {self.nproc}" \
            if self.nproc > 1 else ""
        return f"Mesh({self.shape['band']} x {self.shape['space']}, " \
               f"{sorted({str(d) for d in self.devices})}{procs})"


def make_mesh(nband=None, nspace=1, devices=None):
    """Mesh with ("band", "space") axes over ``devices`` (None: every
    visible CUDA device, or the CPU) of every process of the
    torch.distributed group (this one alone when none is initialised);
    ``nband * nspace`` must equal the global device count, as in the JAX
    package. A list that repeats a device gives virtual shards on it."""
    if devices is None:
        devices = default_devices()
    rank, nproc = _world()
    n = len(devices) * nproc
    if nband is None:
        nband = n // nspace
    assert nband * nspace == n, f"{nband} x {nspace} != {n} devices"
    mesh = Mesh(nband, nspace, devices, rank=rank, nproc=nproc)
    if nproc > 1:
        mesh.check_spans()
    return mesh


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
        if len(self.parts) != len(mesh.devices):
            raise ValueError(f"{len(self.parts)} parts for {mesh}")

    @property
    def dtype(self):
        return self.parts[0].dtype

    def block(self, b, s=0):
        """The part of shard (b, s), which this process must hold."""
        return self.parts[b * self.mesh.shape["space"] + s -
                          self.mesh.offset]

    def gather(self, device=None):
        """The global tensor on ``device`` (default: this process's first
        shard's). Across processes every process must call it: each
        receives every shard's part (an all-gather)."""
        device = self.mesh.devices[0] if device is None else device
        nb, ns = self.mesh.shape["band"], self.mesh.shape["space"]
        db = self.spec.index("band") if "band" in self.spec else None
        ds = self.spec.index("space") if "space" in self.spec else None
        parts = self.parts if self.mesh.nproc == 1 else \
            world_gather(self.parts)
        rows = []
        for b in range(nb if db is not None else 1):
            row = [parts[b * ns + s].to(device)
                   for s in range(ns if ds is not None else 1)]
            rows.append(torch.cat(row, ds) if ds is not None else row[0])
        out = torch.cat(rows, db) if db is not None else rows[0]
        return out[tuple(slice(0, n) for n in self.shape)]

    def numpy(self):
        return self.gather(torch.device("cpu")).numpy()

    def __repr__(self):
        return f"Sharded({self.shape}, {self.spec}, {self.mesh})"


def shard(x, mesh, spec, pad_value=0.0):
    """Lay a global tensor out over the mesh (the counterpart of
    ``jax.device_put(x, NamedSharding(mesh, spec))``, or across processes
    of ``jax.make_array_from_callback``: this process keeps its shards'
    blocks). A split dimension that the axis does not divide is padded
    with ``pad_value``. Shards with the same block on one device share one
    tensor; a block that is a contiguous view of ``x`` on its device is
    not copied."""
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
    for i, dev in zip(mesh.local, mesh.devices):
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
    """Run the group function ``fn(*sublists, devs)`` on each group of
    shards along ``axis`` (:meth:`Mesh.groups`) that this process holds
    shards of, and scatter its per-shard results back. ``devs`` is a
    :class:`~.collectives.Group`: the devices of the group's local shards
    (all of its shards in a one-process mesh), and the sublists hold those
    shards' entries. Groups holding the same objects on the same devices
    run once; a group that crosses processes runs every time, so that
    every process makes the same collective calls in the same order."""
    out = [None] * len(mesh.devices)
    cache = {}
    off = mesh.offset
    for g in mesh.groups(axis):
        mine = [i for i in g if i in mesh.local]
        if not mine:
            continue
        devs = Group([mesh.devices[i - off] for i in mine], len(g),
                     g.index(mine[0]))
        sub = [[lst[i - off] for i in mine] for lst in lists]
        if devs.spans:
            res = fn(*sub, devs)
        else:
            key = (tuple(tuple(id(v) for v in s) for s in sub),
                   tuple(str(d) for d in devs))
            if key not in cache:
                cache[key] = fn(*sub, devs)
            res = cache[key]
        for i, r in zip(mine, res):
            out[i - off] = r
    return out
