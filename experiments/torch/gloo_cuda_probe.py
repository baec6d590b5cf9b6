"""Which collectives the gloo backend runs on CUDA tensors, with two ranks
that share one card, and whether a one-rank NCCL group starts.

    python experiments/torch/gloo_cuda_probe.py [CASE ...]

Each case runs in its own pair of spawned ranks, so a case that crashes a
rank ends only itself; it prints one line a case: ok, the error it raised,
or the signal that ended a rank.  Cases: the c10d collectives, torch's
functional collectives (what DTensor's redistributions call), DTensor
placement and redistribution, and the same functional collectives routed
through the c10d ones (``routed_*``).
"""
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES = ["c10d_all_gather_into_tensor", "c10d_reduce_scatter",
         "c10d_all_to_all", "c10d_scatter", "funcol_all_reduce",
         "funcol_all_gather", "funcol_all_gather_nowait",
         "funcol_reduce_scatter", "funcol_all_to_all", "dtensor_place_shard",
         "dtensor_place_replicate", "dtensor_s_to_r", "dtensor_p_to_s",
         "dtensor_s0_to_s1", "routed_funcol_all_gather", "routed_s_to_r",
         "routed_p_to_s", "routed_s0_to_s1", "routed_matmul_backward"]


def _route():
    """The CUDA kernels of the functional collectives, re-registered as
    calls of the c10d collectives."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def ag(x, n, name):
        out = x.new_empty((x.shape[0] * n,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(name))
        return out

    def rs(x, op, n, name):
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x.contiguous(),
                                   group=_resolve_process_group(name))
        return out

    def ar(x, op, name):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=_resolve_process_group(name))
        return out

    def a2a(x, out_splits, in_splits, name):
        out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), list(out_splits),
                               list(in_splits),
                               group=_resolve_process_group(name))
        return out

    for name, fn in (("all_gather_into_tensor", ag),
                     ("reduce_scatter_tensor", rs), ("all_reduce", ar),
                     ("all_to_all_single", a2a)):
        lib.impl(name, fn, "CUDA")
    return lib


def _case(rank, world, path, case):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    from torch.distributed import _functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    keep = _route() if case.startswith("routed") else None
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    w = dist.group.WORLD
    m = torch.arange(16, dtype=torch.float32, device=dev).reshape(4, 4)
    dm = init_device_mesh("cuda", (world,))

    def dt():
        return distribute_tensor(m, dm, [Shard(0)])
    if case == "c10d_all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(8 * world, device=dev), x)
    elif case == "c10d_reduce_scatter":
        dist.reduce_scatter_tensor(torch.empty(8 // world, device=dev), x)
    elif case == "c10d_all_to_all":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif case == "c10d_scatter":
        out = torch.empty(4, device=dev)
        dist.scatter(out, list(x.chunk(world)) if rank == 0 else None, 0)
    elif case == "funcol_all_reduce":
        fc.all_reduce(x, "sum", w).wait()
    elif case in ("funcol_all_gather", "routed_funcol_all_gather"):
        fc.all_gather_tensor(x, 0, w).wait()
    elif case == "funcol_all_gather_nowait":
        torch.ops._c10d_functional.all_gather_into_tensor(
            x, world, w.group_name)
    elif case == "funcol_reduce_scatter":
        fc.reduce_scatter_tensor(x, "sum", 0, w).wait()
    elif case == "funcol_all_to_all":
        fc.all_to_all_single(x, None, None, w).wait()
    elif case == "dtensor_place_shard":
        distribute_tensor(m, dm, [Shard(0)], src_data_rank=0).to_local()
    elif case == "dtensor_place_replicate":
        distribute_tensor(m, dm, [Replicate()], src_data_rank=0).to_local()
    elif case in ("dtensor_s_to_r", "routed_s_to_r"):
        dt().redistribute(dm, [Replicate()]).to_local()
    elif case in ("dtensor_p_to_s", "routed_p_to_s"):
        dt().sum(0).redistribute(dm, [Shard(0)]).to_local()
    elif case in ("dtensor_s0_to_s1", "routed_s0_to_s1"):
        dt().redistribute(dm, [Shard(1)]).to_local()
    elif case == "routed_matmul_backward":
        a = distribute_tensor(m.clone().requires_grad_(), dm, [Shard(1)])
        b = distribute_tensor(m.clone().requires_grad_(), dm, [Shard(0)])
        (a @ b).sum().backward()
        assert float(((m @ m).sum() - (a @ b).full_tensor().sum()).abs()) < 1e-3
    torch.cuda.synchronize()
    dist.barrier()
    del keep
    dist.destroy_process_group()


def _nccl_one(rank, path, out):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{path}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x, group=dm.get_group("model"))
    torch.cuda.synchronize()
    with open(out, "w") as f:
        f.write(f"nccl one rank 1x1 mesh all_reduce: {x.tolist()}\n")
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    d = tempfile.mkdtemp()
    out2 = os.path.join(d, "out2.txt")
    try:
        mp.spawn(_nccl_one, args=(os.path.join(d, "pg2"), out2), nprocs=1)
        print(open(out2).read().strip(), flush=True)
    except Exception as e:  # noqa: BLE001 — a probe reports every failure
        print("nccl one rank:", type(e).__name__, str(e)[-300:], flush=True)
    for i, case in enumerate(sys.argv[1:] or CASES):
        try:
            mp.spawn(_case, args=(2, os.path.join(d, f"pg{i}"), case),
                     nprocs=2)
            print(f"{case}: ok", flush=True)
        except Exception as e:  # noqa: BLE001 — a probe reports every failure
            msg = str(e).strip().splitlines()
            print(f"{case}: {type(e).__name__}: "
                  f"{msg[-1][:200] if msg else ''}", flush=True)
