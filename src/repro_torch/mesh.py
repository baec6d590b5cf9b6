"""Device meshes: named axes over devices (``jax.sharding.Mesh``).

A ``Mesh`` has ``axis_names``, ``shape`` (an ordered dict of axis name to
size), ``size`` and ``devices`` (None for an abstract mesh that binds no
device).  ``spec_axes`` lists the axes a sharding spec names.  These are
placement primitives for the layers that place tensors (the shardings,
the checkpoint store, the data pipeline); ``launch/mesh.py`` builds the
meshes a run uses.

A mesh of more than one device runs a process per device (a rank of an
initialised ``torch.distributed`` group) and binds a ``DeviceMesh`` over
the ranks (``device_mesh``).  Placement is global-view, the counterpart of
``NamedSharding``: ``place`` turns a whole tensor into a ``DTensor`` whose
shards follow a spec (``placements``), and the model then runs on
``DTensor``s as JAX's jitted code runs on sharded arrays.  The collectives
that the reference spells out inside ``shard_map`` (``psum``,
``all_gather``, ``pmean``) are the helpers at the end of this class, each
on the group of one named axis.

A checkpoint's leaves move one at a time between the origin rank and
the others (``gather_whole``, ``Mesh.place_from_root``), so no other
rank holds a leaf whole.  Redistribution is ``DTensor``'s own.  On CUDA one functional collective
is routed through its c10d form (``route_all_gather``), since gloo on
CUDA tensors (ranks that share one card) cannot run the functional one.

A mesh of one device places every tensor whole on that device
(``device_for``); there a spec that shards over an axis of size > 1
raises ``ConfigError``.
"""
from __future__ import annotations

import contextlib
import math
from collections import OrderedDict

import torch

from .errors import ConfigError


class Mesh:
    """Named axes of ``sizes`` over ``devices`` (None: an abstract mesh
    that binds no device), and over the ranks of ``device_mesh`` (a torch
    ``DeviceMesh`` with the same axis names and sizes) when it runs a
    process per device."""

    def __init__(self, sizes, axis_names, devices=None, device_mesh=None):
        sizes, axis_names = tuple(sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ConfigError(f"mesh axes {axis_names} do not match sizes "
                              f"{sizes}")
        self.axis_names = axis_names
        self.shape = OrderedDict(zip(axis_names, sizes))
        self.size = math.prod(sizes)
        if devices is not None:
            devices = tuple(torch.device(d) for d in devices)
            if len(devices) != self.size:
                raise ConfigError(f"a mesh of {self.size} positions needs as "
                                  f"many devices, got {len(devices)}")
        self.devices = devices
        if device_mesh is not None and (
                tuple(device_mesh.mesh_dim_names or ()) != axis_names
                or tuple(device_mesh.shape) != sizes):
            raise ConfigError(f"device mesh {device_mesh} does not have the "
                              f"axes {dict(self.shape)}")
        if device_mesh is not None:
            check_torch_names()
        self.device_mesh = device_mesh

    def __repr__(self) -> str:
        axes = ", ".join(f"{a!r}: {n}" for a, n in self.shape.items())
        where = "abstract" if self.devices is None else \
            ", ".join(str(d) for d in self.devices)
        return f"Mesh({axes}; {where})"

    @property
    def spmd(self) -> bool:
        """True when the mesh runs a process per device over more than one
        device: tensors are ``DTensor``s and collectives cross ranks."""
        return self.device_mesh is not None and self.size > 1

    @property
    def device(self) -> torch.device:
        """This process's device: the rank's own on a mesh of ranks, the
        one device of a one-device mesh."""
        if self.device_mesh is not None:
            return self.devices[self.device_mesh.get_rank()]
        if self.devices is None or len(self.devices) != 1:
            raise ConfigError(f"{self} does not bind exactly one device")
        return self.devices[0]

    def device_for(self, spec) -> torch.device:
        """The device that holds a tensor of ``spec`` whole.  Every axis
        the spec names must have size 1 and the mesh must bind one device;
        else ConfigError (a mesh of ranks places with ``place``)."""
        wide = [a for a in spec_axes(spec) if self.shape.get(a, 1) > 1]
        unknown = [a for a in spec_axes(spec) if a not in self.shape]
        if unknown:
            raise ConfigError(f"spec {spec!r} names axes {unknown} that "
                              f"{self} does not have")
        if wide:
            raise ConfigError(f"spec {spec!r} shards over mesh axes {wide} "
                              f"of size > 1: place it with Mesh.place on a "
                              f"mesh of ranks")
        if self.devices is None or len(self.devices) != 1:
            raise ConfigError(f"{self} does not bind exactly one device")
        return self.devices[0]

    # ------------------------------------------------------ placement
    def placements(self, spec, shape=None) -> list:
        """``spec`` as one ``Shard(dim)`` or ``Replicate()`` per mesh axis.
        A tuple entry shards its dim over several axes, major to minor,
        which must follow the mesh's axis order (as ``DTensor`` lays them
        out).  An axis of size 1 replicates.  With ``shape``, a dim that
        its axes do not divide raises ConfigError, as ``device_put`` does
        in the reference."""
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.axis_names]
        seen: set = set()
        for dim, entry in enumerate(spec or ()):
            axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
            unknown = [a for a in axes if a not in self.shape]
            if unknown:
                raise ConfigError(f"spec {spec!r} names axes {unknown} that "
                                  f"{self} does not have")
            idx = [self.axis_names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ConfigError(f"spec entry {entry!r} lists mesh axes out "
                                  f"of the mesh's order {self.axis_names}")
            ways = math.prod(self.shape[a] for a in axes)
            if shape is not None and (dim >= len(shape)
                                      or shape[dim] % ways):
                raise ConfigError(f"spec {spec!r} shards dim {dim} of shape "
                                  f"{tuple(shape)} {ways} ways, which does "
                                  f"not divide it")
            for i in idx:
                if i in seen:
                    raise ConfigError(f"spec {spec!r} uses mesh axis "
                                      f"{self.axis_names[i]!r} twice")
                seen.add(i)
                if self.shape[self.axis_names[i]] > 1:
                    out[i] = Shard(dim)
        return out

    def place(self, tensor: torch.Tensor, spec):
        """``tensor`` placed as ``spec`` says: on a mesh of ranks a
        ``DTensor`` whose data comes from the rank at the mesh's origin
        (``place_from_root``: the other ranks give only the shape and
        dtype); on a one-device mesh the tensor whole on that device."""
        if not self.spmd:
            return tensor.to(self.device_for(spec))
        origin = not any(self.device_mesh.get_coordinate())
        return self.place_from_root(tensor if origin else None, tensor.shape,
                                    tensor.dtype, spec)

    def place_tree(self, tree, specs):
        """``place`` on every leaf of a tree with the spec at the same path
        of ``specs`` (``map_specs``).  A leaf on the meta device stands for
        a tensor of its shape and dtype that this rank does not hold (on a
        mesh of ranks only the origin gives the data)."""
        def leaf(x, spec):
            return self.place_from_root(None if x.is_meta else x, x.shape,
                                        x.dtype, spec)
        return map_specs(tree, specs, leaf)

    def place_from_root(self, tensor, shape, dtype, spec):
        """A tensor of ``shape`` and ``dtype`` placed as ``spec`` says, whose
        data only the rank at the mesh's origin gives (``tensor``; None or
        ignored on every other rank).  The blocks go out one mesh axis at
        a time, major to minor: along a sharded axis the rank holding a
        block scatters its parts, along a replicated one it broadcasts
        it, so no rank but the origin ever holds more than the block of
        the axes before its own.  On a one-device mesh, ``place``."""
        if not self.spmd:
            return self.place(tensor, spec)
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor
        pl = self.placements(spec, shape)
        dm = self.device_mesh
        at = dm.get_coordinate()
        shapes = _block_shapes(shape, pl, dm.shape)
        block = None
        if not any(at):
            if tensor is None:
                raise ConfigError(f"the mesh's origin gives no data for a "
                                  f"tensor of shape {tuple(shape)}")
            block = tensor.to(self.device).contiguous()
        for i, (p, n) in enumerate(zip(pl, dm.shape)):
            if n == 1 or any(at[i + 1:]):
                continue           # not (yet) holding a block of axis i
            src = _rank_at(dm, at, i)
            if p.is_shard():
                out = torch.empty(shapes[i + 1], dtype=dtype,
                                  device=self.device)
                parts = None
                if at[i] == 0:
                    parts = [_bytes(c.contiguous()) for c in
                             block.chunk(n, dim=p.dim)]
                    tensor = block = None  # the parts are all it sends
                dist.scatter(_bytes(out), parts, src=src,
                             group=dm.get_group(i))
                block = out
            else:
                if at[i] != 0:
                    block = torch.empty(shapes[i], dtype=dtype,
                                        device=self.device)
                dist.broadcast(_bytes(block), src=src, group=dm.get_group(i))
        return DTensor.from_local(block, dm, pl, shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))

    # ---------------------------------------------------- collectives
    def group(self, axis: str):
        """The process group of the ranks that differ only in ``axis``."""
        if axis not in self.shape:
            raise ConfigError(f"{self} has no axis {axis!r}")
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.device_mesh.get_local_rank(axis)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over the ranks of ``axis``, on every one of them
        (``lax.psum``; its gradient is the psum of the gradients)."""
        if self.shape.get(axis, 1) == 1:
            return x
        return _PSum.apply(x, self.group(axis))

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Elementwise max of ``x`` over the ranks of ``axis``
        (``lax.pmax``), without a gradient: callers pass detached
        values."""
        if self.shape.get(axis, 1) == 1:
            return x
        import torch.distributed as dist
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group(axis))
        return out

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Mean of ``x`` over the ranks of ``axes`` (``lax.pmean``)."""
        n = 1
        for a in axes:
            x = self.psum(x, a)
            n *= self.shape[a]
        return x / n if n > 1 else x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) \
            -> torch.Tensor:
        """The shards of ``axis`` concatenated on ``dim`` in rank order
        (``lax.all_gather(..., tiled=True)``); its gradient is the sum of
        the gradients, each rank keeping its own slice."""
        if self.shape.get(axis, 1) == 1:
            return x
        return _AllGather.apply(x, self.group(axis), dim,
                                self.index(axis), self.shape[axis])


def gather_whole(x):
    """``x`` (a ``DTensor``) whole on the rank at its mesh's origin, None
    on every other rank.  The blocks come in one mesh axis at a time,
    minor to major: along each sharded axis the rank at coordinate 0
    gathers its peers' blocks (``dist.gather``, no all-gather), so no rank
    but the origin ever holds more than the block of the axes before its
    own.  Partial placements are reduced first."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    dm = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(dm, [Replicate() if p.is_partial() else p
                                for p in x.placements])
    odd = [p for p in x.placements if type(p) not in (Shard, Replicate)]
    if odd:
        raise ConfigError(f"cannot gather a DTensor placed as {odd}")
    pl = list(x.placements)
    at = dm.get_coordinate()
    shapes = _block_shapes(x.shape, pl, dm.shape)
    block = x.to_local()
    for i in reversed(range(dm.ndim)):
        n = dm.shape[i]
        if n == 1 or any(at[i + 1:]) or not pl[i].is_shard():
            continue
        part = block.contiguous()
        parts = None
        if at[i] == 0:
            parts = [torch.empty(shapes[i + 1], dtype=part.dtype,
                                 device=part.device) for _ in range(n)]
        dist.gather(_bytes(part), [_bytes(q) for q in parts or ()] or None,
                    dst=_rank_at(dm, at, i), group=dm.get_group(i))
        del part
        block = torch.cat(parts, dim=pl[i].dim) if parts else None
    return block if not any(at) else None


def _block_shapes(shape, placements, sizes) -> list[tuple]:
    """The shape of a rank's block before each mesh axis cuts it and, last,
    its local shape: ``Shard(d)`` on an axis of size n divides dim d by n
    (ConfigError when n does not divide it)."""
    cur = list(shape)
    out = [tuple(cur)]
    for p, n in zip(placements, sizes):
        if p.is_shard() and n > 1:
            if cur[p.dim] % n:
                raise ConfigError(f"a block of shape {tuple(cur)} does not "
                                  f"divide {n} ways on dim {p.dim}")
            cur[p.dim] //= n
        out.append(tuple(cur))
    return out


def _rank_at(dm, at, i: int) -> int:
    """The global rank at coordinates ``at`` with axis ``i``'s set to 0."""
    c = list(at)
    c[i] = 0
    return int(dm.mesh[tuple(c)])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes (collectives move bytes, whatever the
    dtype, so every backend carries every dtype bit for bit)."""
    return t.reshape(-1).view(torch.uint8)


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


_ROUTES: list = []        # torch.library registrations: live as long as the
                          # process, which holds the op registry they change


_ALL_GATHER = "_c10d_functional::all_gather_into_tensor"


def route_all_gather() -> None:
    """Route the CUDA kernel of torch's functional all-gather
    (``_c10d_functional.all_gather_into_tensor``: what ``DTensor``'s
    redistributions and ``full_tensor`` call) through c10d's
    ``all_gather_into_tensor`` (``_routed_all_gather``).  On the gloo
    backend with CUDA tensors the functional form ends the process with
    SIGSEGV (torch 2.11, two ranks sharing one H100;
    experiments/torch/gloo_cuda_probe.py) while the c10d form and every
    other functional collective run.  The c10d form runs on NCCL too, so
    every CUDA mesh of ranks installs it, whatever its backend (not yet
    run on NCCL across cards).  Once a process."""
    if _ROUTES:
        return
    check_torch_names()
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", _routed_all_gather, "CUDA")
    _ROUTES.append(lib)


def _routed_all_gather(x, group_size, group_name):
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(),
                                group=_resolve_process_group(group_name))
    return out


def all_gather_routed() -> bool:
    """Whether the CUDA kernel of torch's functional all-gather is
    ``route_all_gather``'s (read from the dispatcher's table, which names
    the file that registered each kernel)."""
    table = torch._C._dispatch_dump_table(_ALL_GATHER)
    return any(line.startswith("CUDA:") and __file__ in line
               for line in table.splitlines())


def check_torch_names() -> None:
    """The private torch names a mesh of ranks relies on must exist: the
    flag ``replicating`` sets and the group lookup of the all-gather
    route.  A torch that renamed either raises ConfigError here, when a
    mesh of ranks is bound, rather than running without them."""
    from torch.distributed import distributed_c10d
    from torch.distributed.tensor import DTensor
    missing = [n for obj, n in ((DTensor._op_dispatcher,
                                 "_allow_implicit_replication"),
                                (distributed_c10d, "_resolve_process_group"))
               if not hasattr(obj, n)]
    if missing:
        raise ConfigError(f"torch {torch.__version__} lacks {missing}, which "
                          f"repro_torch.mesh's replicating() and "
                          f"route_all_gather() use: check both again on "
                          f"this version")


@contextlib.contextmanager
def replicating():
    """Inside the block plain tensors join ``DTensor`` arithmetic as
    replicated values (``implicit_replication``), and nesting is safe: the
    setting the block found is restored when it ends."""
    from torch.distributed.tensor import DTensor
    od = DTensor._op_dispatcher
    prev = od._allow_implicit_replication
    od._allow_implicit_replication = True
    try:
        yield
    finally:
        od._allow_implicit_replication = prev


def _gather(x: torch.Tensor, group, dim: int, n: int) -> torch.Tensor:
    import torch.distributed as dist
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, index, n):
        ctx.group, ctx.dim, ctx.index, ctx.n = group, dim, index, n
        ctx.width = x.shape[dim]
        return _gather(x, group, dim, n)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        g = g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width)
        return g.contiguous(), None, None, None, None


def map_specs(tree, specs, leaf):
    """``leaf(x, spec)`` on every leaf of a tree of dicts, lists and tuples
    and the spec at the same path of ``specs`` (a tree of specs)."""
    if isinstance(tree, dict):
        return {k: map_specs(v, specs[k], leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(v, s, leaf) for v, s in zip(tree, specs))
    return leaf(tree, specs)


def spec_axes(spec) -> list[str]:
    """Every mesh axis name in ``spec`` or a tree of specs (dicts, lists
    and tuples; an entry is None, an axis name or a tuple of names)."""
    if spec is None:
        return []
    if isinstance(spec, str):
        return [spec]
    if isinstance(spec, dict):
        spec = list(spec.values())
    if not isinstance(spec, (list, tuple)):
        raise ConfigError(f"sharding spec entry {spec!r} is neither a mesh "
                          f"axis name nor None")
    return [a for v in spec for a in spec_axes(v)]
