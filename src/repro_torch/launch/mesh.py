"""Building device meshes: the production pod and the elastic mesh.

``make_production_mesh`` describes the pod that the shardings and the dry
run are written for (16x16 chips, or 2x16x16 over two pods) without
binding any device: like JAX's abstract mesh, it names a deployment that
this process does not drive.  ``make_mesh_for`` binds real devices, as many
as the mesh holds and only while they are present.  The ``Mesh`` type and
``spec_axes`` live in ``repro_torch.mesh``, below the layers that place
tensors; they are re-exported here.

A mesh of more than one device runs a process per device: each process
calls ``init_distributed`` (rank and world size from its arguments or from
the environment, as ``torchrun`` sets them), then ``make_mesh_for(n)``
binds a (data, model) ``DeviceMesh`` over the ``n`` ranks.  Rank r drives
``cuda:(local_rank % device_count)``.  NCCL, the default on CUDA, needs a
card a rank; ranks that share cards need the gloo backend, named by the
caller.
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue

import torch

from ..errors import ConfigError
from ..kernels import ops
from ..mesh import Mesh, route_all_gather, spec_axes
from ..obs import monotonic

__all__ = ["Mesh", "spec_axes", "make_production_mesh", "mesh_shape_for",
           "make_mesh_for", "init_distributed", "rank_device"]

TIMEOUT_S = 600.0            # a collective that waits longer fails the rank


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips, axes (data, model).  Multi-pod:
    2x16x16 = 512 chips, axes (pod, data, model); the 'pod' axis is pure
    DP across the pods.  Abstract: it binds no device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def mesh_shape_for(n_devices: int, model_axis: int = 16) -> tuple[int, int]:
    """(data, model) of the best mesh for ``n_devices``: the model axis as
    wide as ``model_axis`` allows while it divides the device count."""
    if n_devices < 1:
        raise ConfigError(f"a mesh needs a device, got {n_devices}")
    model = min(model_axis, n_devices)
    while n_devices % model:
        model //= 2
    return n_devices // model, model


def _env_int(name: str, given):
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise ConfigError(f"no {name}: pass it or set it in the environment "
                          f"(torchrun does)")
    return int(os.environ[name])


def rank_device(local_rank: int, device_type: str) -> torch.device:
    """The device of the rank with ``local_rank`` on its host: card
    ``local_rank % device_count`` on CUDA, the CPU otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    n = torch.cuda.device_count()
    if n < 1:
        raise ConfigError("a CUDA rank, but no card is present")
    return torch.device("cuda", local_rank % n)


def init_distributed(backend: str | None = None, *, rank: int | None = None,
                     world_size: int | None = None,
                     local_rank: int | None = None,
                     init_method: str | None = None, device=None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join this process to the default process group and return its
    device.  ``device``'s type (default: the engine's device) picks the
    default backend: NCCL on CUDA, gloo on the CPU.  Rank, world size and
    local rank come from the arguments or from ``RANK``, ``WORLD_SIZE``
    and ``LOCAL_RANK``; ``init_method`` defaults to ``env://``
    (``MASTER_ADDR``/``MASTER_PORT``).  More ranks than cards on a host
    run only with ``backend="gloo"`` named here (NCCL raises
    ConfigError).  A collective that waits ``timeout_s`` fails the
    rank."""
    import torch.distributed as dist
    device = ops.ready_device() if device is None else torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    rank = _env_int("RANK", rank)
    world_size = _env_int("WORLD_SIZE", world_size)
    local_rank = rank if local_rank is None and "LOCAL_RANK" not in \
        os.environ else _env_int("LOCAL_RANK", local_rank)
    if not 0 <= rank < world_size:
        raise ConfigError(f"rank {rank} outside a world of {world_size}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ConfigError("the NCCL backend runs on CUDA devices")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        if local_world > torch.cuda.device_count():
            raise ConfigError(f"NCCL needs a card a rank: {local_world} "
                              f"ranks on {torch.cuda.device_count()} "
                              f"card(s); name backend='gloo' to share cards")
    elif backend != "gloo":
        raise ConfigError(f"unknown backend {backend!r}")
    dev = rank_device(local_rank, device.type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        raise ConfigError("the default process group is already initialised")
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh_for(n_devices: int, model_axis: int = 16, device=None) -> Mesh:
    """Elastic helper: the best (data, model) mesh for whatever devices
    survive.  With an initialised process group of ``n_devices`` ranks it
    binds a ``DeviceMesh`` over them (rank r on
    ``cuda:(r % device_count)``, or the CPU); without one, a one-device
    mesh on ``device`` (default: the engine's device,
    ``kernels.ops.ready_device()``).  Any other count raises
    ConfigError."""
    import torch.distributed as dist
    shape = mesh_shape_for(n_devices, model_axis)
    axes = ("data", "model")
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_devices != world:
            raise ConfigError(f"a mesh of {n_devices} devices over a process "
                              f"group of {world} ranks")
        from torch.distributed.device_mesh import init_device_mesh
        kind = (torch.device(device) if device is not None
                else ops.device()).type
        devices = [rank_device(r, kind) for r in range(world)]
        if kind == "cuda":
            route_all_gather()
        dm = init_device_mesh(kind, shape, mesh_dim_names=axes)
        return Mesh(shape, axes, devices, device_mesh=dm)
    device = ops.ready_device() if device is None else torch.device(device)
    if n_devices != 1:
        raise ConfigError(f"a mesh of {n_devices} devices needs a process "
                          f"per device: call init_distributed in each")
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
    return Mesh(shape, axes, [device])


def run_ranks(fn, world: int, args: tuple = (), *, backend: str,
              device: str = "cpu", timeout_s: float = TIMEOUT_S,
              threads: int | None = None, workdir: str | None = None) \
        -> list:
    """Run ``fn(*args)`` in ``world`` new processes, one a rank of a
    process group of ``backend`` on ``device``'s type (rank r on
    ``rank_device(r, ...)``), and return each rank's result in rank
    order.  The processes are spawned (``fn`` and ``args`` are pickled:
    ``fn`` must be importable by name), meet through a file under
    ``workdir`` (a new temporary directory by default), set the engine's
    device, and ``threads`` intra-op threads when given.  A collective
    that waits ``timeout_s`` fails its rank; a rank that raises or ends
    without a result ends every rank and raises ``InvariantViolation``
    with the failing ranks' tracebacks."""
    import multiprocessing as mp
    import shutil
    import tempfile

    from ..errors import InvariantViolation
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="ranks-") if own else workdir
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = "file://" + os.path.join(os.path.abspath(workdir), "pg")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world, backend, device, init,
                               timeout_s, threads, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    failure = None
    try:
        while len(got) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.pid for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()]
                if dead:
                    # a rank gone without a result: give its last message a
                    # moment to arrive before calling it lost
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        failure = f"rank process(es) {dead} ended without " \
                                  f"a result"
                        break
                else:
                    continue
            if ok:
                got[rank] = pickle.loads(value)
            else:
                failure = _failures(rank, value, results)
    finally:
        for p in procs:
            p.join(timeout=5.0 if failure is None else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    if failure is not None:
        codes = {r: p.exitcode for r, p in enumerate(procs)}
        raise InvariantViolation(f"{failure}\nexit codes by rank: {codes}")
    return [got[r] for r in range(world)]


def _failures(rank: int, trace: str, results, grace_s: float = 3.0) -> str:
    """The failure report: the first failing rank's traceback and those of
    the ranks that fail within ``grace_s`` after it (a rank that raises
    makes its peers' collectives fail too; the first is not always the
    cause)."""
    seen = {rank: trace}
    end = monotonic() + grace_s
    while monotonic() < end:
        try:
            r, ok, value = results.get(timeout=max(0.01, end - monotonic()))
        except queue.Empty:
            break
        if not ok:
            seen[r] = value
    return "\n".join(f"rank {r} failed:\n{t}" for r, t in
                     sorted(seen.items()))


def _rank_main(fn, args, rank, world, backend, device, init, timeout_s,
               threads, results) -> None:
    """One rank of ``run_ranks``: join the group, run ``fn``, report."""
    import traceback

    import torch.distributed as dist
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        ops.set_device(device)
        init_distributed(backend, rank=rank, world_size=world,
                         local_rank=rank, init_method=init, device=device,
                         timeout_s=timeout_s)
        # pickled here, by value: a tensor put on the queue as it is would
        # be shared through a file descriptor that dies with this process
        results.put((rank, True, pickle.dumps(fn(*args))))
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
