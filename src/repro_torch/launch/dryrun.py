"""Production dry-run: for EVERY (architecture x input shape) cell, the step
(``make_train_step`` with the cell's microbatch, ``prefill`` or
``decode_step``) runs at the global shape on the meta device, and its
per-device cost is derived for the 16x16 single-pod mesh AND the 2x16x16
multi-pod mesh.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--microbatch N] [--variant V]
        [--force] [--override k=v ...]

Nothing is allocated: params, train state and caches are built on meta
(the counterpart of ``jax.eval_shape``), and so are the inputs
(``configs.input_specs``).  The step runs once under ``roofline.OpCost``;
both meshes derive from that one census:

  * ``memory.argument/output/alias_bytes`` are exact per device: each
    leaf's shard under its spec (``Sharding.param_specs``, ``state_specs``,
    ``cache_specs``, ``batch_specs``), each dim divided by the sizes of the
    mesh axes it names.  Alias bytes are the donated train state (train)
    or cache (decode), as in the reference's ``donate_argnums``;
  * ``cost.*_per_device`` and ``loop_aware`` are the census of the global
    step divided by the mesh size.  The reference's partitioned HLO also
    counts work that every device repeats (replicated ops), which this
    division spreads instead;
  * ``temp_bytes`` is the peak of live intermediate bytes that the census
    tracked, divided by the mesh size in the same way;
  * ``collectives`` is the census's; a production mesh, which this process
    cannot run, has none counted, so it is null there (the roofline takes
    it as 0).

The census runs the global step with the mesh's tensor-parallel padding
(``init_params(shards=tp)``) and no mesh in the compute: expert dispatch
runs over all the tokens with the global capacity, which gives the same
expert slots, GEMM FLOPs and buffer bytes as the reference's per-shard
bodies summed.  Each cell's record goes to
``experiments/torch/dryrun/<arch>__<shape>__<mesh>.json``; the roofline
table (``python -m repro_torch.roofline``) reads them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import traceback
from pathlib import Path

import torch

from ..configs import ARCHS, SHAPES, input_specs, shapes_for
from ..errors import ConfigError, InvariantViolation
from ..models import model as model_mod
from ..obs import monotonic
from ..roofline import OpCost
from ..shardings import Sharding
from ..train import AdamWConfig, init_train_state, make_train_step
from ..mesh import spec_axes
from .mesh import make_production_mesh

OUTDIR = Path(__file__).resolve().parents[3] / "experiments" / "torch" / \
    "dryrun"
META = torch.device("meta")


def _shard_bytes(x: torch.Tensor, spec, mesh) -> int:
    """Bytes of one device's shard of ``x`` under ``spec``: each dim
    divided (rounding up) by the sizes of the mesh axes it names."""
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    n = 1
    for dim, entry in zip(x.shape, spec):
        ways = math.prod(mesh.shape[a] for a in spec_axes(entry))
        n *= -(-dim // ways)
    return n * x.element_size()


def tree_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of a tree of tensors under a tree of specs of the
    same structure (a tensor's spec is a tuple; dicts, lists and tuples of
    the value tree are walked alongside the spec tree)."""
    if isinstance(tree, torch.Tensor):
        return _shard_bytes(tree, specs, mesh)
    if isinstance(tree, dict):
        return sum(tree_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v, s, mesh) for v, s in zip(tree, specs))
    return 0


def step_inputs(cfg, shape, device=META) -> dict:
    """The step's inputs (``configs.input_specs``) on ``device``: zeros,
    decode positions at the middle of the cache."""
    out = {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
           for k, s in input_specs(cfg, shape).items()}
    if "pos" in out:
        out["pos"] += shape.seq_len // 2
    return out


@dataclasses.dataclass
class Census:
    """One cell's step run once on meta: its argument and output trees,
    which argument is donated, the census totals and the timings."""
    cfg: object
    shape: object
    tp: int
    microbatch: int
    args: dict
    outputs: dict
    donated: str | None
    totals: dict
    build_s: float
    census_s: float


def census_cell(cfg, shape, tp: int, microbatch: int = 1,
                device=META) -> Census:
    """Build ``cfg``'s params (or train state, or cache) on ``device``
    (meta: nothing allocated), padded for a model axis of ``tp``, and run
    the step of ``shape`` once at its global shape under ``OpCost``.  On
    a real device the params are drawn from a seed and the inputs are
    zeros (decode positions at the cache's middle)."""
    device = torch.device(device)
    run_shd = Sharding(None, cfg)
    gen = torch.Generator(device=device if device.type != "meta"
                          else "cpu").manual_seed(0)
    t0 = monotonic()
    args = {}
    if shape.kind == "train":
        args["state"] = init_train_state(cfg, gen, shards=tp, device=device)
    else:
        args["params"] = model_mod.init_params(cfg, gen, shards=tp,
                                               device=device)
        if shape.kind == "decode":
            args["cache"] = model_mod.init_cache(
                cfg, shape.global_batch, shape.seq_len, device=device)
    args["batch"] = batch = step_inputs(cfg, shape, device)
    build_s = monotonic() - t0
    t0 = monotonic()
    with OpCost() as cost:
        if shape.kind == "train":
            step = make_train_step(cfg, run_shd, AdamWConfig(),
                                   microbatch=microbatch)
            new_state, metrics = step(args["state"], batch)
            outputs = {"state": new_state, "metrics": metrics}
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    cache, logits = model_mod.prefill(
                        args["params"], batch, cfg, run_shd)
                else:
                    cache, logits = model_mod.decode_step(
                        args["params"], args["cache"], batch, cfg, run_shd)
            outputs = {"cache": cache, "logits": logits}
    donated = {"train": "state", "decode": "cache"}.get(shape.kind)
    return Census(cfg, shape, tp, microbatch, args, outputs, donated,
                  cost.totals(), build_s, monotonic() - t0)


def _specs(shd, tree: dict) -> dict:
    """Specs of an argument or output tree of the step."""
    out = {}
    for name, sub in tree.items():
        if name == "state":
            out[name] = shd.state_specs(sub)
        elif name == "params":
            out[name] = shd.param_specs(sub)
        elif name == "cache":
            out[name] = shd.cache_specs(sub)
        elif name == "batch":
            out[name] = shd.batch_specs(sub)
        elif name == "logits":
            out[name] = shd.spec("batch", "vocab")
        else:                              # metrics: replicated scalars
            out[name] = {k: () for k in sub}
    return out


def cell_record(c: Census, mesh, arch: str, shape_name: str,
                variant: str = "base") -> dict:
    """The dry-run record of ``c`` on ``mesh``, with the reference's keys."""
    cfg, shape = c.cfg, c.shape
    shd = Sharding(mesh, cfg, shape.global_batch)
    if shd.tp != c.tp:
        raise InvariantViolation(f"the census was padded for a model axis of "
                                 f"{c.tp}, {mesh} has {shd.tp}")
    n = mesh.size
    arg_specs = _specs(shd, c.args)
    out_specs = _specs(shd, c.outputs)
    arg_b = tree_bytes(c.args, arg_specs, mesh)
    out_b = tree_bytes(c.outputs, out_specs, mesh)
    alias_b = (tree_bytes(c.args[c.donated], arg_specs[c.donated], mesh)
               if c.donated else 0)
    temp_b = -(-c.totals["peak_live_bytes"] // n)
    runnable = mesh.devices is not None
    t = c.totals
    coll = ({"bytes_per_op": dict(t["collective_bytes_by_op"]),
             "counts": {}, "total_bytes": t["collective_bytes_per_device"],
             "n_while_bodies": 0} if runnable else None)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape.values()),
        "variant": variant,
        "microbatch": c.microbatch,
        "n_chips": n,
        "lower_s": round(c.build_s, 2), "compile_s": round(c.census_s, 2),
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": temp_b,
            "alias_bytes": alias_b,
            "peak_per_device_gb": round(
                (arg_b + temp_b + out_b - alias_b) / 2**30, 3),
        },
        "cost": {"flops_per_device": t["flops_per_device"] / n,
                 "bytes_per_device": t["hbm_bytes_per_device"] / n,
                 "transcendentals": t["transcendentals"] / n},
        "collectives": coll,
        "loop_aware": {
            "flops_per_device": t["flops_per_device"] / n,
            "hbm_bytes_per_device": t["hbm_bytes_per_device"] / n,
            "collective_bytes_per_device":
                t["collective_bytes_per_device"] / n if runnable else None,
            "collective_bytes_by_op":
                {k: v / n for k, v in t["collective_bytes_by_op"].items()}
                if runnable else None},
        "params_total": cfg.params_count(),
        "params_active": cfg.active_params_count(),
        "tokens_per_step": (shape.global_batch * shape.seq_len
                            if shape.kind != "decode"
                            else shape.global_batch),
        "kind": shape.kind,
    }


def _cfg(arch: str, overrides: dict | None):
    cfg = ARCHS[arch]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               microbatch: int = 1, variant: str = "base",
               overrides: dict | None = None) -> dict:
    """One cell's record on the production mesh."""
    cfg = _cfg(arch, overrides)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    tp = Sharding(mesh, cfg, shape.global_batch).tp
    mb = microbatch if microbatch > 1 else cfg.train_microbatch
    c = census_cell(cfg, shape, tp, mb)
    return cell_record(c, mesh, arch, shape_name, variant)


def lower_both(arch: str, shape_name: str, microbatch: int = 1,
               variant: str = "base", overrides: dict | None = None,
               meshes=(False, True), *, shape=None) -> dict:
    """The records of one cell on each production mesh of ``meshes``
    (multi_pod flags), from one census: {multi_pod: record}.  ``shape``
    (a ``configs.ShapeConfig``) replaces ``SHAPES[shape_name]``, for a
    smaller run of the same kind."""
    cfg = _cfg(arch, overrides)
    shape = shape or SHAPES[shape_name]
    mesh_of = {mp: make_production_mesh(multi_pod=mp) for mp in meshes}
    tps = {Sharding(m, cfg, shape.global_batch).tp for m in mesh_of.values()}
    if len(tps) != 1:
        raise ConfigError(f"meshes {list(mesh_of.values())} pad for model "
                          f"axes {sorted(tps)}: one census cannot serve both")
    mb = microbatch if microbatch > 1 else cfg.train_microbatch
    c = census_cell(cfg, shape, tps.pop(), mb)
    return {mp: cell_record(c, m, arch, shape_name, variant)
            for mp, m in mesh_of.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description="multi-pod dry-run on meta")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--variant", default="base")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg overrides for perf variants, e.g. "
                         "moe_impl=onehot remat_policy=dots kv_quant=0")
    args = ap.parse_args(argv)
    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        overrides[k] = (int(v) if v.lstrip("-").isdigit()
                        else v == "True" if v in ("True", "False") else v)
    if "kv_quant" in overrides:
        overrides["kv_quant"] = bool(overrides["kv_quant"])
    if "fsdp" in overrides:
        overrides["fsdp"] = bool(overrides["fsdp"])

    OUTDIR.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = {"single": (False,), "multi": (True,),
              "both": (False, True)}[args.mesh]
    failures = []
    for arch in archs:
        cfg = ARCHS[arch]
        shapes = [args.shape] if args.shape else shapes_for(cfg)
        for shape in shapes:
            tags = {}
            for mp in meshes:
                tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}"
                if args.variant != "base":
                    tag += f"__{args.variant}"
                if (OUTDIR / f"{tag}.json").exists() and not args.force:
                    print(f"[skip] {tag}")
                    continue
                tags[mp] = tag
            if not tags:
                continue
            print(f"[run ] {arch}__{shape} ...", flush=True)
            try:
                recs = lower_both(arch, shape, microbatch=args.microbatch,
                                  variant=args.variant, overrides=overrides,
                                  meshes=tuple(tags))
            except Exception as e:  # noqa: BLE001 — reported, then exit 1
                failures.append((f"{arch}__{shape}", repr(e)))
                print(f"[FAIL] {arch}__{shape}: {e}")
                traceback.print_exc()
                continue
            for mp, tag in tags.items():
                res = recs[mp]
                (OUTDIR / f"{tag}.json").write_text(json.dumps(res, indent=1))
                print(f"[ ok ] {tag}: census={res['compile_s']}s "
                      f"peak={res['memory']['peak_per_device_gb']}GB "
                      f"flops/dev={res['cost']['flops_per_device']:.3g}",
                      flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("\nDRY-RUN: every requested cell ran on meta.")


if __name__ == "__main__":
    main()
