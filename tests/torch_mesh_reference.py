"""The JAX reference on a 2x2 CPU mesh, for tests/test_torch_multicard_parity.py
(not collected: run as a subprocess, since the device count is fixed when
JAX starts).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python tests/torch_mesh_reference.py DIR CASE [CASE ...]

For each CASE it reads DIR/in_<CASE>.npz (the carried float32 train state
under its tree paths ``state/...``, the batch under ``batch/...``, and the
config under ``cfg/...``: the arch's smoke config, with FSDP when
``cfg/fsdp``) and writes DIR/out_<CASE>.npz:

  * ``loss/<k>``: the metrics of one ``make_train_step`` jitted on the
    ('data', 'model') = (2, 2) mesh with ``state_specs``/``batch_specs``
    as in_shardings and the batch placed by ``shard_batch``;
  * ``new/<path>``: the updated state;
  * ``one/<k>``: the same step's metrics on one device (mesh-less);
  * ``prefill``, ``decode<i>``: the logits of ``prefill`` and of
    ``decode_step``s on the mesh, params and cache placed by their specs;
  * ``uid``: the uid of the carried state saved from the mesh to a
    ``CheckpointStore`` at step 0 on branch "run";
  * ``restore/<path>``: that checkpoint restored with
    ``restore(mesh=, specs=state_specs)``, each leaf whole, and
    ``restore_index/<path>``: the index of the shard each device holds
    (device order, as rows of start/stop per dim).
"""
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro.ckpt import CheckpointStore  # noqa: E402
from repro.configs import ARCHS, smoke  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.shardings import Sharding  # noqa: E402
from repro.train import AdamWConfig, make_train_step  # noqa: E402
from repro.train.data import shard_batch  # noqa: E402

DECODES = 2


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


def flat(tree, prefix: str) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[f"{prefix}/{name}"] = np.asarray(leaf)
    return out


def shard_index(arr) -> np.ndarray:
    """(device, dim, start/stop) of each shard of ``arr``, in mesh device
    order."""
    rows = []
    for sh in sorted(arr.addressable_shards, key=lambda s: s.device.id):
        rows.append([[sl.start or 0, arr.shape[d] if sl.stop is None
                      else sl.stop] for d, sl in enumerate(sh.index)])
    return np.asarray(rows, np.int64).reshape(len(rows), arr.ndim, 2)


def run(d: str, case: str) -> None:
    inp = dict(np.load(os.path.join(d, f"in_{case}.npz")))
    cfg = smoke(ARCHS[str(inp["cfg/arch"])])
    if bool(inp["cfg/fsdp"]):
        from dataclasses import replace
        cfg = replace(cfg, fsdp=True)
    state = jax.tree.map(jnp.asarray, unflat(inp, "state"))
    state["opt"]["step"] = jnp.asarray(inp["state/opt/step"])
    batch = unflat(inp, "batch")
    B = batch["tokens"].shape[0]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shd = Sharding(mesh, cfg, B)
    opt = AdamWConfig(lr=float(inp["cfg/lr"]), warmup_steps=1)
    out = {}

    sspec = shd.state_specs(state)
    place = (lambda t, s: jax.tree.map(
        lambda a, p: jax.device_put(a, NamedSharding(mesh, p)), t, s))
    st = place(state, sspec)
    sb = shard_batch(batch, mesh, shd)
    step = jax.jit(make_train_step(cfg, shd, opt))
    new, m = step(st, sb)
    out.update({f"loss/{k}": np.asarray(v) for k, v in m.items()})
    out.update(flat(new, "new"))
    one = jax.jit(make_train_step(cfg, Sharding(None, cfg), opt))
    _, m1 = one(state, {k: jnp.asarray(v) for k, v in batch.items()})
    out.update({f"one/{k}": np.asarray(v) for k, v in m1.items()})

    params = st["params"]
    S = batch["tokens"].shape[1]
    T = S + DECODES + 2
    pb = {"tokens": sb["tokens"]}
    cache, logits = jax.jit(lambda p, b: M.prefill(p, b, cfg, shd,
                                                   cache_len=T))(params, pb)
    out["prefill"] = np.asarray(logits)
    cache = place(cache, shd.cache_specs(cache))
    dec = jax.jit(lambda p, c, b: M.decode_step(p, c, b, cfg, shd))
    tok = np.asarray(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))
    for i in range(DECODES):
        pos = np.full((B,), S + i, np.int32)
        db = shard_batch({"tokens": tok, "pos": pos}, mesh, shd)
        cache, logits = dec(params, cache, db)
        out[f"decode{i}"] = np.asarray(logits)
        tok = np.asarray(jnp.argmax(logits, -1)[:, None].astype(jnp.int32))

    ck = CheckpointStore()
    out["uid"] = np.frombuffer(ck.save(st, "run", step=0), np.uint8)
    back = ck.restore(st, "run", mesh=mesh, specs=sspec)
    out.update(flat(back, "restore"))
    for k, v in flat(jax.tree.map(shard_index, back), "restore_index").items():
        out[k] = v
    np.savez(os.path.join(d, f"out_{case}.npz"), **out)


if __name__ == "__main__":
    d = sys.argv[1]
    for a in sys.argv[2:]:
        run(d, a)
