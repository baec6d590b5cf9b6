"""Logical-axis sharding rules, as far as one device.

The reference maps logical axis names (batch, heads, ff, experts, vocab,
...) onto a device mesh for DP / FSDP / TP / EP / SP.  The port runs on one
device: ``Sharding(None, cfg)`` has no mesh, tensor-parallel degree 1, data
parallel size 1 and no rules, and ``constrain`` is the identity.  A spec is
a tuple of mesh axis names (None for a replicated dim), the counterpart of
a ``PartitionSpec``.  A mesh, and the expert-parallel ``moe_shard_map``,
raise ``ConfigError`` until the mesh tooling is ported.
"""
from __future__ import annotations

from .errors import ConfigError


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
        if mesh is not None:
            raise ConfigError("Sharding over a device mesh is not ported "
                              "yet; use Sharding(None, cfg)")
        self.mesh = None
        self.cfg = cfg
        self.dp_axes: tuple = ()
        self.tp = 1
        self.dp_size = 1
        self.rules: dict = {}

    @property
    def padded_vocab(self) -> int:
        """The vocab padded to a multiple of 16: without a mesh the
        reference pads for its 16-way model axis."""
        return -(-self.cfg.vocab // 16) * 16

    def spec(self, *names) -> tuple:
        return tuple(self.rules.get(n, None) if isinstance(n, str) else n
                     for n in names)

    def constrain(self, x, *names):
        return x

    # ---------------- parameter specs ----------------
    def _leaf_spec(self, path: str, leaf) -> tuple:
        """A parameter leaf's spec.  The reference's rule starts from
        ``rules["fsdp"]``, which a mesh-less Sharding lacks, so on one
        device it raises KeyError (src/repro/shardings.py:111); so does
        this one.  The per-leaf rules come with the mesh port."""
        return (self.rules["fsdp"],)

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
                return (None, r.get("batch"), "model", None, None)
            if name in ("ks", "vs"):
                return (None, r.get("batch"), "model", None)
            if name == "conv":
                return (None, r.get("batch"), None, r.get("dinner"))
            if name == "ssd":
                return (None, r.get("batch"), r.get("ssm_heads"), None, None)
            nd = getattr(x, "ndim", 0)
            if nd == 0:
                return ()
            # xlstm stacked recurrent states: leading stack dims precede B
            if "mlstm" in path:
                lead = 2 if cfg.slstm_at else 1
                return (*([None] * lead), r.get("batch"),
                        *([None] * (nd - lead - 1)))
            if "slstm" in path:
                return (None, r.get("batch"), *([None] * (nd - 2)))
            return (r.get("batch"), *([None] * (nd - 1)))
        return _walk(cache_tree, leaf)

    def state_specs(self, state_tree):
        """Train state: params/master/mu/nu share the param specs."""
        pspec = self.param_specs(state_tree["params"])
        return {"params": pspec,
                "opt": {"mu": pspec, "nu": pspec, "master": pspec,
                        "step": ()}}

    def moe_shard_map(self, local_fn, xt, p):
        raise ConfigError("the expert-parallel MoE over a mesh is not "
                          "ported yet")


def make_sharding(mesh, cfg, global_batch=None) -> Sharding:
    return Sharding(mesh, cfg, global_batch)
