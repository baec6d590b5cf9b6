"""Logical-axis sharding rules: DP / FSDP / TP / EP / SP mapping onto a
device mesh (``repro_torch.mesh``).

Policy (the reference's, rule for rule):
  * batch       -> ('pod','data')  (DP; dropped if batch doesn't divide)
  * heads/ff/
    dinner/...  -> 'model'          (TP; dropped when the dim doesn't
                                     divide — e.g. xlstm's 4 heads stay
                                     replicated and only the vocab is TP)
  * experts     -> 'model'          (EP, ``moe_shard_map``)
  * cache_seq   -> 'model'          (decode KV caches shard on sequence)
  * vocab       -> 'model'          (embed d-dim + unembed vocab-dim; vocab
                                     padded up to a multiple of the axis)
  * FSDP (qwen1.5-110b): parameter d_model dim additionally sharded over
    'data' (ZeRO-3).

A spec is a tuple of mesh axis names (None for a replicated dim, a tuple of
names for a dim over several axes), the counterpart of a ``PartitionSpec``.
The rules come from ``mesh.axis_names`` and ``mesh.shape`` alone, so a mesh
that binds no device (``make_production_mesh``) gives the production specs.

On a mesh of ranks (``Mesh.spmd``) the model runs on ``DTensor``s:
``constrain`` moves a tensor to a spec's placements (the counterpart of
``with_sharding_constraint``), and ``region`` lets the
plain tensors made inside the model (masks, positions, RoPE tables) join
``DTensor`` arithmetic as replicated values.  ``moe_shard_map`` and the
vocab-parallel loss run their bodies on each rank's local shards, as the
reference's ``shard_map`` does (``enter`` / ``leave``), with the
collectives spelled out.  On one card ``constrain`` is the identity and
``moe_shard_map`` runs its body whole; there an axis of size > 1 raises
``ConfigError`` (a mesh of ranks is needed).  ``Sharding(None, cfg)`` has
no mesh, tensor-parallel degree 1, data-parallel size 1 and no rules, as
in the reference.
"""
from __future__ import annotations

import contextlib
import math

import torch

from .errors import ConfigError, InvariantViolation
from .mesh import map_specs, replicating, spec_axes
from .models.layers import padded_heads


def _canonical(entry):
    """A spec entry as a PartitionSpec keeps it: a tuple of one axis name
    is the name, an empty tuple None."""
    if isinstance(entry, (tuple, list)):
        return None if not entry else entry[0] if len(entry) == 1 \
            else tuple(entry)
    return entry


def P(*entries) -> tuple:
    """A spec: the counterpart of ``PartitionSpec(*entries)``, a tuple."""
    return tuple(_canonical(e) for e in entries)


def _walk(tree, leaf, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, leaf, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, leaf, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return leaf(path, tree)


class Sharding:
    """Resolves logical axis names to mesh axes for one (cfg, batch)."""

    def __init__(self, mesh, cfg, global_batch: int | None = None):
        self.mesh = mesh
        self.cfg = cfg
        if mesh is None:
            self.dp_axes: tuple = ()
            self.tp = 1
            self.dp_size = 1
            self.rules: dict = {}
            return
        names = mesh.axis_names
        self.dp_axes = tuple(a for a in ("pod", "data") if a in names)
        self.tp = mesh.shape["model"]
        self.dp_size = math.prod(mesh.shape[a] for a in self.dp_axes)
        batch_ok = (global_batch is None
                    or global_batch % max(1, self.dp_size) == 0)
        tp = self.tp

        def tp_if(n):  # shard over model iff divisible
            return "model" if n and n % tp == 0 else None

        cfg_hp = padded_heads(cfg, tp)
        # xlstm: no weight dim divides the model axis, so 'model' would sit
        # idle — fold it into the batch axes (pure DP over all chips).
        batch_axes: tuple | None = self.dp_axes if batch_ok else None
        self.batch_uses_model = False
        if cfg.family == "ssm" and global_batch is not None:
            for cand in (self.dp_axes + ("model",), self.dp_axes):
                n = math.prod(mesh.shape[a] for a in cand)
                if cand and global_batch % n == 0:
                    batch_axes = cand
                    self.batch_uses_model = "model" in cand
                    break
        self.rules = {
            "batch": batch_axes if batch_axes else None,
            "seq": None,
            "cache_seq": "model",
            "heads": tp_if(cfg_hp),
            "kv_heads": tp_if(cfg.n_kv_heads),
            "heads_flat": tp_if(cfg_hp * cfg.dh) if tp_if(cfg_hp) else None,
            "kv_flat": tp_if(cfg.n_kv_heads * cfg.dh)
            if tp_if(cfg.n_kv_heads) else None,
            "ff": tp_if(cfg.d_ff),
            "shared_ff": tp_if(cfg.n_shared_experts * cfg.moe_d_ff),
            "vocab": None if self.batch_uses_model else "model",
            "dmodel_tp": None if self.batch_uses_model
            else tp_if(cfg.d_model),
            "dinner": tp_if(cfg.d_inner) if cfg.ssm_state else None,
            "ssm_heads": tp_if(cfg.n_ssm_heads) if cfg.ssm_state else None,
            "experts": tp_if(cfg.n_experts),
            "fsdp": "data" if cfg.fsdp else None,
            # sequence parallelism: FSDP archs keep the residual stream
            # sequence-sharded over 'model' between layers
            "seq_res": "model" if cfg.fsdp else None,
        }

    @property
    def padded_vocab(self) -> int:
        """The vocab padded to a multiple of the model axis (of 16 without
        a mesh, as in the reference)."""
        v = self.cfg.vocab
        tp = self.tp if self.mesh is not None else 16
        return -(-v // tp) * tp

    def spec(self, *names) -> tuple:
        return P(*[self.rules.get(n, None) if isinstance(n, str) else n
                   for n in names])

    @property
    def spmd(self) -> bool:
        """True on a mesh of ranks: the model runs on ``DTensor``s."""
        return self.mesh is not None and getattr(self.mesh, "spmd", False)

    def constrain(self, x, *names):
        """``x`` moved to the placements of ``spec(*names)`` on a mesh of
        ranks (``with_sharding_constraint``); the identity without one (one
        card holds each tensor whole)."""
        if not self.spmd:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            raise InvariantViolation(f"constrain{names} of a plain tensor on "
                                     f"{self.mesh}: the model runs on "
                                     f"DTensors there")
        return x.redistribute(self.mesh.device_mesh,
                              self.mesh.placements(self.spec(*names)))

    def constrain_tree(self, tree, specs):
        """``constrain`` of every leaf of ``tree`` to the spec at its path
        in ``specs`` (a tree of specs, as ``cache_specs`` gives); a dim
        that its axes do not divide raises ConfigError, as placing the
        tree would in the reference."""
        if not self.spmd:
            return tree
        return map_specs(tree, specs, lambda x, sp: x.redistribute(
            self.mesh.device_mesh, self.mesh.placements(sp, x.shape)))

    def region(self):
        """The context the model runs in: on a mesh of ranks, plain tensors
        made inside it join ``DTensor`` arithmetic as replicated values
        (``implicit_replication``); without one, nothing."""
        if not self.spmd:
            return contextlib.nullcontext()
        return replicating()

    # ------------------------------------- shard_map boundaries (SPMD)
    def enter(self, x, spec):
        """The local shard of ``x`` (a ``DTensor``) placed as ``spec``, the
        input side of ``shard_map``: its gradient is summed over the axes
        that ``spec`` does not name (where every rank holds it whole)."""
        from torch.distributed.tensor import Partial, Replicate
        pl = self.mesh.placements(spec)
        x = x.redistribute(self.mesh.device_mesh, pl)
        grad = [Partial() if isinstance(p, Replicate) else p for p in pl]
        return x.to_local(grad_placements=grad)

    def leave(self, local: torch.Tensor, spec):
        """A ``DTensor`` of ranks' ``local`` shards placed as ``spec``, the
        output side of ``shard_map``: every rank holds the same value on
        the axes that ``spec`` does not name, so its gradient there is
        divided by their size (the psums inside sum it back)."""
        from torch.distributed.tensor import DTensor, Replicate
        pl = self.mesh.placements(spec)
        n = math.prod(size for p, size in zip(pl, self.mesh.shape.values())
                      if isinstance(p, Replicate))
        if n > 1 and local.requires_grad:
            local = _ScaleGrad.apply(local, 1.0 / n)
        return DTensor.from_local(local, self.mesh.device_mesh, pl,
                                  run_check=False)

    def enter_tree(self, tree, specs):
        """``enter`` on every leaf of ``tree`` with the spec at its path of
        ``specs``."""
        return map_specs(tree, specs, self.enter)

    def leave_tree(self, tree, specs):
        """``leave`` on every leaf of ``tree`` with the spec at its path of
        ``specs``."""
        return map_specs(tree, specs, self.leave)

    @property
    def data_parallel(self) -> bool:
        """True on a mesh of ranks whose batch covers every mesh axis
        (xlstm's batch over ('data', 'model')): no param is sharded, so
        each rank runs the one-device model on its own rows."""
        return self.spmd and self.batch_uses_model and \
            set(self.batch_axes()) >= {a for a, n in self.mesh.shape.items()
                                       if n > 1}

    def batch_axes(self) -> list[str]:
        """The mesh axes the batch dim shards over."""
        return spec_axes((self.rules.get("batch"),))

    # ---------------- parameter specs ----------------
    def _leaf_spec(self, path: str, leaf) -> tuple:
        """A parameter leaf's spec.  Without a mesh the rules are empty and
        ``rules["fsdp"]`` raises KeyError, as in the reference."""
        r = self.rules
        fsdp = r["fsdp"]
        parts = path.split("/")
        name = parts[-1]
        stacked = parts[0] in ("layers", "groups")
        pre = (None,) if stacked else ()
        nd = getattr(leaf, "ndim", 0) - len(pre)

        def sp(*axes):
            return P(*pre, *axes)

        if name == "embed":
            return P(fsdp, r["dmodel_tp"])
        if name == "unembed":
            return P(fsdp, r["vocab"])
        if self.cfg.family == "ssm":       # xlstm: DP + vocab TP only
            return sp(*([None] * nd))
        if nd == 3 and name in ("w_in", "w_gate", "w_out"):
            # routed expert stacks: EP over model, FSDP over data on the
            # contracted dim
            return sp(r["experts"], fsdp, None)
        col = {"wq": r["heads_flat"], "wk": r["kv_flat"], "wv": r["kv_flat"],
               "w_in": r["ff"], "w_gate": r["ff"],
               "shared_w_in": r["shared_ff"], "shared_w_gate": r["shared_ff"],
               "in_z": r["dinner"], "in_x": r["dinner"],
               "in_dt": r["ssm_heads"]}
        if name in col:
            return sp(fsdp, col[name])
        row = {"wo": r["heads_flat"], "w_out": r["ff"],
               "shared_w_out": r["shared_ff"], "out_proj": r["dinner"]}
        if name in row:
            return sp(row[name], fsdp)
        if name == "bq":
            return sp(r["heads_flat"])
        if name == "conv_w":
            return sp(None, r["dinner"])
        if name in ("A_log", "D", "dt_bias"):
            return sp(r["ssm_heads"])
        if name == "norm" and self.cfg.ssm_state:
            return sp(r["dinner"])
        return sp(*([None] * nd))          # norms, router, biases, stubs

    def param_specs(self, params):
        return _walk(params, self._leaf_spec)

    def batch_specs(self, batch_tree):
        """Inputs: dim0 = global batch over DP axes."""
        return _walk(batch_tree, lambda _, x: self.spec(
            "batch", *([None] * (x.ndim - 1))))

    def cache_specs(self, cache_tree):
        """Decode caches: KV caches shard (layer, batch, seq->model, ...);
        recurrent states shard batch only."""
        r = self.rules
        cfg = self.cfg

        def leaf(path, x):
            name = path.split("/")[-1]
            if name in ("k", "v", "attn_k", "attn_v"):
                return P(None, r.get("batch"), "model", None, None)
            if name in ("ks", "vs"):
                return P(None, r.get("batch"), "model", None)
            if name == "conv":
                return P(None, r.get("batch"), None, r.get("dinner"))
            if name == "ssd":
                return P(None, r.get("batch"), r.get("ssm_heads"), None, None)
            nd = getattr(x, "ndim", 0)
            if nd == 0:
                return P()
            # xlstm stacked recurrent states: leading stack dims precede B
            if "mlstm" in path:
                lead = 2 if cfg.slstm_at else 1
                return P(*([None] * lead), r.get("batch"),
                        *([None] * (nd - lead - 1)))
            if "slstm" in path:
                return P(None, r.get("batch"), *([None] * (nd - 2)))
            return P(r.get("batch"), *([None] * (nd - 1)))
        return _walk(cache_tree, leaf)

    def state_specs(self, state_tree):
        """Train state: params/master/mu/nu share the param specs."""
        pspec = self.param_specs(state_tree["params"])
        return {"params": pspec,
                "opt": {"mu": pspec, "nu": pspec, "master": pspec,
                        "step": ()}}

    # ---------------- MoE expert parallelism ----------------
    def moe_shard_map(self, local_fn, xt, p):
        """The gather-EP MoE body for each (dp shard, model shard) of the
        mesh, the reference's ``shard_map``: each rank's tokens are its dp
        shard (replicated over 'model'), its experts are
        ``e_start = model_rank * e_local`` on, FSDP's expert weights are
        all-gathered over 'data' on dim 1, the body sums the combine over
        'model', and the aux losses are averaged over the DP axes.  On one
        card the one shard holds every token and expert (``e_start`` 0,
        ``e_local`` E) and the collectives are identities; an axis of size
        > 1 that is not a mesh of ranks raises ConfigError."""
        E = self.cfg.n_experts
        routed = {k: p[k] for k in ("router", "w_in", "w_gate", "w_out")
                  if k in p}
        if not self.spmd:
            axes = {"model", *self.batch_axes(),
                    *((self.rules["fsdp"],) if self.rules["fsdp"] else ())}
            wide = sorted(a for a in axes if self.mesh.shape.get(a, 1) > 1)
            if wide:
                raise ConfigError(f"the expert-parallel MoE over mesh axes "
                                  f"{wide} of size > 1 runs on a mesh of "
                                  f"ranks (the multi-card port: "
                                  f"init_distributed, make_mesh_for)")
            return local_fn(xt, routed, e_start=0, e_local=E,
                            axis_name="model")
        mesh = self.mesh
        e_local = E // self.tp
        dp = self.rules["batch"]
        fsdp = self.rules["fsdp"]
        pspec = {"router": P(None, None),
                 "w_in": P(self.rules["experts"], fsdp, None),
                 "w_gate": P(self.rules["experts"], fsdp, None),
                 "w_out": P(self.rules["experts"], fsdp, None)}
        x_l = self.enter(xt, P(dp, None))
        p_l = {k: self.enter(v, pspec[k]) for k, v in routed.items()}
        if fsdp:   # ZeRO-3: re-assemble expert weights for the GEMMs
            for k in ("w_in", "w_gate", "w_out"):
                if k in p_l:
                    p_l[k] = mesh.all_gather(p_l[k], fsdp, dim=1)
        out, lb, z = local_fn(x_l, p_l, e_start=mesh.index("model") * e_local,
                              e_local=e_local, axis_name="model",
                              mesh=mesh)
        if self.dp_axes:
            lb = mesh.pmean(lb, self.dp_axes)
            z = mesh.pmean(z, self.dp_axes)
        return self.leave(out, P(dp, None)), self.leave(lb, P()), \
            self.leave(z, P())


class _ScaleGrad(torch.autograd.Function):
    """The identity, with its gradient scaled by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def make_sharding(mesh, cfg, global_batch=None) -> Sharding:
    return Sharding(mesh, cfg, global_batch)
