"""Rank bodies of the port's mesh tests (not collected; no JAX): each
function runs in every rank process that
``repro_torch.launch.mesh.run_ranks`` spawns, on gloo over the CPU, and
returns numpy results (rank 0's whole tensors, every rank's local
shards).
"""
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointStore
from repro_torch.ckpt.store import _leaf_paths
from repro_torch.configs import ARCHS, smoke
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models import model as M
from repro_torch.shardings import Sharding
from repro_torch.train import AdamWConfig, make_train_step, shard_batch
from repro_torch.train.step import state_from_numpy

DECODES = 2                    # as tests/torch_mesh_reference.py


def config(arch: str, fsdp: bool = False):
    cfg = smoke(ARCHS[arch])
    return replace(cfg, fsdp=True) if fsdp else cfg


def unflat(flat: dict, prefix: str) -> dict:
    """A nested dict from ``prefix/a/b`` keys (dict nodes only)."""
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy, bfloat16 widened to float32 (exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def whole(x) -> np.ndarray:
    """A tensor, ``DTensor`` (gathered: every rank joins) or number as a
    numpy array."""
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return _np(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def local(x) -> np.ndarray:
    return _np(x.to_local())


def parity(d: str, cases: list) -> dict:
    """For each case, on the (2, 2) mesh: one train step of the carried
    state of ``d/in_<case>.npz`` (metrics and the new state, whole),
    prefill and decode logits, and the state saved from the mesh and
    restored with ``restore(mesh=, specs=)`` (this rank's local shards,
    and the uids of the mesh save and of a one-device save).  Rank 0 also
    runs the step mesh-less (``one/...``)."""
    mesh = make_mesh_for(4, model_axis=2)
    rank = dist.get_rank()
    out = {}
    for case in cases:
        inp = dict(np.load(f"{d}/in_{case}.npz"))
        cfg = config(str(inp["cfg/arch"]), bool(inp["cfg/fsdp"]))
        state = state_from_numpy(unflat(inp, "state"), device="cpu")
        batch = unflat(inp, "batch")
        B, S = batch["tokens"].shape
        shd = Sharding(mesh, cfg, B)
        opt = AdamWConfig(lr=float(inp["cfg/lr"]), warmup_steps=1)
        sspec = shd.state_specs(state)
        st = mesh.place_tree(state, sspec)
        sb = shard_batch(batch, mesh, shd)
        new, m = make_train_step(cfg, shd, opt)(st, sb)
        r = {f"loss/{k}": whole(v) for k, v in m.items()}
        r.update({f"new/{n}": whole(t) for n, t in _leaf_paths(new)})

        params = st["params"]
        with torch.no_grad():
            cache, logits = M.prefill(params, {"tokens": sb["tokens"]}, cfg,
                                      shd, cache_len=S + DECODES + 2)
            r["prefill"] = whole(logits)
            tok = r["prefill"].argmax(-1)[:, None].astype(np.int32)
            for i in range(DECODES):
                db = shard_batch({"tokens": tok, "pos": np.full(
                    (B,), S + i, np.int32)}, mesh, shd)
                cache, logits = M.decode_step(params, cache, db, cfg, shd)
                r[f"decode{i}"] = whole(logits)
                tok = r[f"decode{i}"].argmax(-1)[:, None].astype(np.int32)

        ck = CheckpointStore()
        r["uid"] = np.frombuffer(ck.save(st, "run", step=0), np.uint8)
        back = ck.restore(state, "run", mesh=mesh, specs=sspec)
        r.update({f"local/{n}": local(t) for n, t in _leaf_paths(back)})
        if rank == 0:
            r["one_uid"] = np.frombuffer(
                CheckpointStore().save(state, "run", step=0), np.uint8)
            _, m1 = make_train_step(cfg, Sharding(None, cfg), opt)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()})
            r.update({f"one/{k}": whole(v) for k, v in m1.items()})
        out[case] = r
    return out


# ------------------------------------------------- tests/test_torch_multicard

SPECS = [(), (None,), ("data",), ("model",), (None, "model"),
         ("data", "model"), ("model", None, "data"), (("data", "model"),),
         (None, ("data", "model")), (None, None, ("data", "model"))]
# spec -> the shape placed with it; each raises ConfigError
BAD_SPECS = {"uneven": ((None, None, ("data", "model")), (4, 8, 6)),
             "unknown": (("pod",), (4, 8, 4)),
             "out_of_order": ((("model", "data"),), (4, 8, 4)),
             "twice": (("data", "data"), (4, 8, 4)),
             "too_long": ((None,) * 4, (4, 8, 4))}


# a state of LEAVES leaves of LEAF_SHAPE float32 (256 KiB each), sharded
# four ways, two ways and replicated over one axis, for the memory checks
LEAVES = 16
LEAF_SHAPE = (256, 256)
LEAF_SPECS = ((("data", "model"), None), (None, "model"), ("data", None),
              ("data", "model"))


def _status_bytes(field: str) -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) * 1024
    raise KeyError(field)


def _peak(fn):
    """``fn()`` and the most resident memory this process held during it
    beyond what it held before (the kernel's high-water mark, reset
    first).  Every allocation of 64 KiB or more is its own mapping, so a
    freed tensor leaves the resident set at once."""
    import ctypes
    import gc
    ctypes.CDLL(None).mallopt(-3, 1 << 16)       # M_MMAP_THRESHOLD
    gc.collect()
    with open("/proc/self/clear_refs", "w") as f:
        f.write("5")
    base = _status_bytes("VmRSS")
    res = fn()
    return res, _status_bytes("VmHWM") - base


def _leaf_state(mesh, n: int, shape) -> dict:
    """``n`` seeded leaves, each rank building only its own blocks (every
    rank draws the same whole and keeps its slice)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    gen = torch.Generator().manual_seed(7)
    out = {}
    for i in range(n):
        spec = LEAF_SPECS[i % len(LEAF_SPECS)]
        w = torch.randn(shape, generator=gen)
        d = distribute_tensor(w, mesh.device_mesh,
                              mesh.placements(spec, w.shape),
                              src_data_rank=None)
        out[f"w{i:02d}"] = DTensor.from_local(
            d.to_local().clone(), mesh.device_mesh, d.placements)
        del w, d
    return out


def leafwise_memory(mesh) -> dict:
    """A mesh save and restore of ``_leaf_state``: each one's peak resident
    memory on this rank, this rank's shard bytes, whether the restore gave
    back every shard bit for bit, and (rank 0) the uid of a one-device
    save of the same values."""
    specs = {f"w{i:02d}": LEAF_SPECS[i % len(LEAF_SPECS)]
             for i in range(LEAVES)}
    warm = _leaf_state(mesh, 4, (8, 8))    # first calls load their code
    ck = CheckpointStore()
    ck.save(warm, "warm", step=0)
    ck.restore(warm, "warm", mesh=mesh, specs=specs)
    state = _leaf_state(mesh, LEAVES, LEAF_SHAPE)
    ck = CheckpointStore()
    uid, save_peak = _peak(lambda: ck.save(state, "run", step=0))
    like = {k: torch.empty(LEAF_SHAPE, device="meta") for k in state}
    back, restore_peak = _peak(lambda: ck.restore(like, "run", mesh=mesh,
                                                  specs=specs))
    out = {"uid": uid, "save": save_peak, "restore": restore_peak,
           "shard_bytes": sum(v.to_local().nbytes for v in state.values()),
           "equal": all(torch.equal(back[k].to_local(), v.to_local())
                        and back[k].placements == v.placements
                        for k, v in state.items())}
    if dist.get_rank() == 0:
        gen = torch.Generator().manual_seed(7)
        out["one_uid"] = CheckpointStore().save(
            {f"w{i:02d}": torch.randn(LEAF_SHAPE, generator=gen)
             for i in range(LEAVES)}, "run", step=0)
    return out


def _errors(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads the type
        return type(e).__name__
    return "none"


def mesh_checks(d: str) -> dict:
    """On the (2, 2) mesh: the mesh itself, ``placements``/``place`` for
    every spec form, ``constrain`` round trips, ``shard_batch``, a train
    state saved from the mesh to a durable store at ``d/ckpt`` and
    restored by specs, and a microbatched step."""
    from repro_torch.launch.mesh import mesh_shape_for
    from repro_torch.train import SyntheticLM, init_train_state
    mesh = make_mesh_for(4, model_axis=2)
    rank = dist.get_rank()
    out = {"rank": rank, "shape": dict(mesh.shape),
           "ranks": mesh.device_mesh.mesh.tolist(),
           "names": mesh.device_mesh.mesh_dim_names,
           "device": str(mesh.device),
           "index": {a: mesh.index(a) for a in mesh.axis_names},
           "shapes_for": {(n, a): mesh_shape_for(n, a) for n in (1, 2, 4)
                          for a in (1, 2, 16)},
           "leafwise": leafwise_memory(mesh)}
    x = torch.arange(4 * 8 * 4, dtype=torch.float32).reshape(4, 8, 4)
    for spec in SPECS:
        t = mesh.place(x, spec)
        out[f"place/{spec}"] = ([str(p) for p in mesh.placements(spec)],
                                local(t), np.array_equal(whole(t),
                                                         x.numpy()))
    for name, (spec, shape) in BAD_SPECS.items():
        out[f"bad/{name}"] = _errors(
            lambda: mesh.place(torch.zeros(shape), spec))

    cfg = config("tinyllama-1.1b")
    shd = Sharding(mesh, cfg, 4)
    t = mesh.place(x, ("data",))
    for names in [("batch", "seq", None), ("batch", "seq_res", None),
                  (None, "heads", None), ("batch", None, "vocab"),
                  (None, None, None)]:
        c = shd.constrain(t, *names)
        back = shd.constrain(c, "batch", None, None)
        out[f"constrain/{names}"] = (
            [str(p) for p in c.placements], np.array_equal(whole(c),
                                                           x.numpy()),
            [str(p) for p in back.placements], np.array_equal(
                whole(back), x.numpy()))
    out["constrain/plain"] = _errors(lambda: shd.constrain(x, "batch"))

    data = SyntheticLM(cfg.vocab, 32, 4).batch_at(0)
    sb = shard_batch(data, mesh, shd)
    out["batch"] = {k: ([str(p) for p in v.placements], local(v))
                    for k, v in sb.items()}

    ck = CheckpointStore(durable_root=f"{d}/ckpt") if rank == 0 else \
        CheckpointStore()
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             shards=4, device="cpu", shd=shd)
    specs = shd.state_specs(state)
    out["uid"] = ck.save(state, "run", step=0)
    if rank == 0:
        ck.sync()
        ck.db.store.close()
        out["one_uid"] = CheckpointStore().save(init_train_state(
            cfg, torch.Generator().manual_seed(0), shards=4, device="cpu"),
            "run", step=0)
    out["full"] = {n: whole(v) for n, v in _leaf_paths(state)}
    out["local"] = {n: (local(v), [str(p) for p in v.placements])
                    for n, v in _leaf_paths(state)}
    out["specs"] = specs

    # a microbatched step on the mesh (float32 state and gradients)
    st = M.tree_map(lambda a: a.float() if a.is_floating_point() else a,
                    state)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    new, m = make_train_step(cfg, shd, opt, microbatch=2,
                             grad_dtype=torch.float32)(st, sb)
    out["mb/loss"] = float(whole(m["loss"]))
    out["mb/master"] = {n: whole(v) for n, v in
                        _leaf_paths(new["opt"]["master"])}
    return out


def remesh_checks(d: str) -> dict:
    """Two ranks restart from the durable store that ``mesh_checks``'s
    four wrote: restore onto (1, 2), then ``TrainController.remesh`` onto
    (2, 1); each rank's local shards of both."""
    from repro_torch.runtime import TrainController
    from repro_torch.train import SyntheticLM, init_train_state
    cfg = config("tinyllama-1.1b")
    rank = dist.get_rank()
    m12 = make_mesh_for(2)
    m21 = make_mesh_for(2, model_axis=1)
    like = init_train_state(cfg, torch.Generator().manual_seed(0),
                            shards=4, device="meta")
    s12 = Sharding(m12, cfg, 4)
    ck = CheckpointStore(durable_root=f"{d}/ckpt") if rank == 0 else \
        CheckpointStore()
    state = ck.restore(like, "run", mesh=m12, specs=s12.state_specs(like))
    out = {"rank": rank, "shapes": (dict(m12.shape), dict(m21.shape)),
           "r12": {n: (local(v), [str(p) for p in v.placements])
                   for n, v in _leaf_paths(state)}}
    ctl = TrainController(make_train_step(cfg, s12), state,
                          SyntheticLM(cfg.vocab, 32, 4), ck, branch="run")
    s21 = Sharding(m21, cfg, 4)
    got = ctl.remesh(m21, s21.state_specs(like))
    out["r21"] = {n: (local(v), [str(p) for p in v.placements])
                  for n, v in _leaf_paths(got)}
    missing = _errors(lambda: ck.restore(like, "nope", mesh=m21,
                                         specs=s21.state_specs(like)))
    out["missing"] = missing
    if rank == 0:
        ck.db.store.close()
    out["routed"] = routed_all_gather(m12)
    return out


def routed_all_gather(mesh) -> dict:
    """Whether a CPU mesh left torch's functional all-gather alone, then
    ``route_all_gather`` and its CUDA kernel called on this rank's CPU
    row (the dispatcher sent straight to the CUDA entry) over 'model'."""
    from repro_torch.mesh import all_gather_routed, route_all_gather
    out = {"before": all_gather_routed()}
    route_all_gather()
    out["after"] = all_gather_routed()
    op = torch.ops._c10d_functional.all_gather_into_tensor.default
    cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
    row = torch.full((1, 3), float(dist.get_rank()))
    out["gathered"] = _np(op.redispatch(cuda, row, mesh.shape["model"],
                                        mesh.group("model").group_name))
    return out


def failing(bad_rank: int) -> int:
    """Rank ``bad_rank`` raises before a collective the others wait in."""
    if dist.get_rank() == bad_rank:
        raise ValueError("this rank fails")
    t = torch.ones(1)
    dist.all_reduce(t)
    return int(t.item())
