"""Roofline analysis of dry-run records, with one NVIDIA H100's constants.

Three terms per (arch x shape x mesh) cell:

    compute    = FLOPs_per_device / PEAK_FLOPS        (bf16 dense peak)
    memory     = bytes_per_device / HBM_BW            (HBM bandwidth)
    collective = collective_bytes_per_device / LINK_BW (NVLink)

The reference derives the totals from XLA's optimized HLO text; PyTorch has
no HLO.  Its counterpart here is ``OpCost``, a ``TorchDispatchMode`` census
of the aten ops that one call runs (``analyze_ops(fn, *args)``), with the
same three totals:

  * dot FLOPs = 2 * output elements * contraction, for mm, bmm, addmm,
    baddbmm, mv, addmv and dot (einsum and matmul reach these), backward
    ops included; fused attention ops count as
    ``torch.utils.flop_counter`` counts them (full S x S: causal masking
    is not discounted);
  * bytes ~ 2 * result bytes of every op that materialises a tensor (a
    write + read-back proxy).  Views (view, reshape alias, expand,
    permute, transpose, slice, select, detach, ``_unsafe_view``,
    ``as_strided``, ...) are skipped, as the reference skips bitcast and
    get-tuple-element; an in-place update counts the update's bytes, as
    the reference counts a dynamic-update-slice.  Eager PyTorch fuses
    nothing, so every elementwise op's result counts, where XLA's fusions
    hide theirs;
  * collective bytes = result bytes of the c10d functional collectives
    (zero on one card).

The port's layers are Python loops, so the census covers every iteration
of every loop by construction: there is no trip count to recover.  On meta
tensors (a dry run, nothing allocated) the models' attention runs as the
fused flash-attention op that the card runs (``models.layers.
sdpa_attention``), so the census sees no S x S scores there either.

MODEL_FLOPS = 6*N*D (train) or 2*N*D (otherwise; N the active params for
MoE) is the "useful compute" yardstick; the ratio MODEL_FLOPS / FLOPs
exposes recompute, padding and attention's share.
"""
from __future__ import annotations

import argparse
import json
import weakref
from collections import Counter
from pathlib import Path

import torch
from torch.utils import checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# One H100 SXM (NVIDIA's data sheet; dense rates without sparsity, at the
# 700 W power limit)
PEAK_FLOPS = 989e12        # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12           # HBM3 bytes/s
LINK_BW = 900e9            # NVLink 4 bytes/s a GPU (18 links, both ways)

_aten = torch.ops.aten
# contraction size K of each dot-like op, from its arguments
_DOT_K = {
    _aten.mm: lambda a: a[0].shape[-1],
    _aten.bmm: lambda a: a[0].shape[-1],
    _aten.addmm: lambda a: a[1].shape[-1],
    _aten.baddbmm: lambda a: a[1].shape[-1],
    _aten.mv: lambda a: a[0].shape[-1],
    _aten.addmv: lambda a: a[1].shape[-1],
    _aten.dot: lambda a: a[0].shape[-1],
}
_ATTENTION = {p for p in flop_registry
              if isinstance(p, torch._ops.OpOverloadPacket)
              and "attention" in p.__name__}
# aliasing results that the schema does not mark as views
_VIEWS = {_aten._unsafe_view, _aten.lift_fresh, _aten.alias}
# allocations that write nothing
_UNWRITTEN = {_aten.empty, _aten.empty_like, _aten.empty_strided,
              _aten.new_empty, _aten.new_empty_strided}
_TRANSCENDENTAL = {_aten.exp, _aten.expm1, _aten.exp2, _aten.log,
                   _aten.log1p, _aten.log2, _aten.tanh, _aten.sigmoid,
                   _aten.rsqrt, _aten.sqrt, _aten.sin, _aten.cos,
                   _aten.erf, _aten.pow, _aten.silu, _aten.gelu,
                   _aten.softplus, _aten.log_sigmoid_forward,
                   _aten._softmax, _aten._log_softmax, _aten.logsumexp}
_COLLECTIVE_NS = "_c10d_functional"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


class _Unkeyed(Exception):
    """An argument the memo cannot key (a tensor off meta, an object)."""


def _signature(x):
    """A hashable stand-in for an op's arguments on meta tensors (a tensor
    by its shape, strides and dtype); _Unkeyed where there is none."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Unkeyed
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise _Unkeyed


def _recipe(out):
    """How to remake ``out`` (tensors by shape, strides and dtype)."""
    if isinstance(out, torch.Tensor):
        return ("t", out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_recipe(v) for v in out))
    return ("v", out)


def _remake(recipe):
    if recipe[0] == "t":
        return torch.empty_strided(recipe[1], recipe[2], dtype=recipe[3],
                                   device="meta")
    if recipe[0] == "v":
        return recipe[1]
    return recipe[0](_remake(r) for r in recipe[1])


def _kind(func) -> str:
    """How the census treats ``func`` (an OpOverload)."""
    packet = func.overloadpacket
    if func.namespace == _COLLECTIVE_NS:
        return "skip" if packet.__name__ == "wait_tensor" else "collective"
    if func.is_view or packet in _VIEWS:
        return "skip"
    if packet in _UNWRITTEN:
        return "alloc"
    if func._schema.is_mutable:
        return "update"
    if packet in _DOT_K:
        return "dot"
    if packet in _ATTENTION:
        return "attention"
    return "op"


class OpCost(TorchDispatchMode):
    """Census of the aten ops run while it is active: dot FLOPs (by op),
    bytes, collective bytes (by op), transcendental elements, ops, and the
    peak of live result bytes (``temp``: tensors that ops made, counted
    from their creation until they are freed)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Counter = Counter()
        self.bytes = 0
        self.coll = 0
        self.coll_ops: Counter = Counter()
        self.transcendentals = 0
        self.ops = 0
        self.live = 0
        self.peak_live = 0
        self._kinds: dict = {}
        self._memo: dict = {}

    def __enter__(self):
        # under a dispatch mode, torch.utils.checkpoint's early stop ends a
        # recomputation sooner than in a plain run, which recomputes the
        # whole layer body (torch.profiler counts more MLP output products
        # in a plain step than a mode sees): the census turns early stop
        # off to count what runs
        self._early_stop = checkpoint.set_checkpoint_early_stop(False)
        self._early_stop.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._early_stop.__exit__(*exc)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _update(self, func, args, out) -> None:
        """An in-place update counts the update's bytes: the largest tensor
        argument that the op reads, at most the updated tensor's size."""
        written = [a for a, s in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and s.alias_info
                   and s.alias_info.is_write]
        read = [_nbytes(a) for a in args if isinstance(a, torch.Tensor)
                and not any(a is w for w in written)]
        cap = (sum(_nbytes(w) for w in written)
               or sum(_nbytes(t) for t in _tensors(out)))
        self.ops += 1
        self.bytes += 2 * (min(max(read), cap) if read else cap)

    @staticmethod
    def _cost(func, kind, args, kwargs, out) -> tuple:
        """What one call of ``func`` adds, from its shapes alone: (recipe
        of the result, op name, dot FLOPs, bytes, collective bytes,
        transcendental elements, result tensors' bytes)."""
        outs = _tensors(out)
        sizes = tuple(_nbytes(t) for t in outs)
        packet = func.overloadpacket
        flops = coll = 0
        if kind == "collective":
            coll = sum(sizes)
        elif kind == "dot":
            flops = 2 * outs[0].numel() * _DOT_K[packet](args)
        elif kind == "attention":
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        trans = (sum(t.numel() for t in outs) if packet in _TRANSCENDENTAL
                 else 0)
        nbytes = 0 if kind == "alloc" else 2 * sum(sizes)
        return (_recipe(out), packet.__name__, flops, nbytes, coll, trans,
                sizes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        kwargs = kwargs or {}
        if kind == "skip":
            return func(*args, **kwargs)
        if kind == "update":
            out = func(*args, **kwargs)
            self._update(func, args, out)
            return out
        # on meta tensors an op is run once per signature of its arguments
        # and its result remade after: many meta kernels are written in
        # Python and cost far more than a dispatch, and a model's layers
        # repeat their shapes
        try:
            key = (func, _signature(args),
                   _signature(kwargs) if kwargs else None)
        except _Unkeyed:
            key = None
        entry = self._memo.get(key) if key is not None else None
        if entry is None:
            out = func(*args, **kwargs)
            entry = self._cost(func, kind, args, kwargs, out)
            if key is not None and all(t.is_meta for t in _tensors(out)):
                self._memo[key] = entry
        else:
            out = _remake(entry[0])
        _, name, flops, nbytes, coll, trans, sizes = entry
        self.ops += 1
        if flops:
            self.flops += flops
            self.flops_by_op[name] += flops
        if coll:
            self.coll += coll
            self.coll_ops[name] += coll
        self.transcendentals += trans
        self.bytes += nbytes
        for t, nb in zip(_tensors(out), sizes):
            self.live += nb
            weakref.finalize(t, self._free, nb)
        self.peak_live = max(self.peak_live, self.live)
        return out

    def totals(self) -> dict:
        return {"flops_per_device": self.flops,
                "hbm_bytes_per_device": self.bytes,
                "collective_bytes_per_device": self.coll,
                "collective_bytes_by_op": dict(self.coll_ops),
                "flops_by_op": dict(self.flops_by_op),
                "transcendentals": self.transcendentals,
                "peak_live_bytes": self.peak_live,
                "ops": self.ops}


def analyze_ops(fn, *args, **kwargs) -> dict:
    """The census (``OpCost.totals``) of one call ``fn(*args, **kwargs)``
    on this process's device."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return cost.totals()


def roofline_terms(cell: dict) -> dict:
    """cell: one dry-run JSON record (launch/dryrun.py).  A record whose
    collectives were not counted (a mesh this process cannot run) has
    ``collectives`` null and contributes no collective term."""
    la = cell.get("loop_aware", {})
    flops = la.get("flops_per_device") or cell["cost"]["flops_per_device"]
    bts = la.get("hbm_bytes_per_device") or cell["cost"]["bytes_per_device"]
    coll = la.get("collective_bytes_per_device")
    if coll is None:
        coll = (cell.get("collectives") or {}).get("total_bytes") or 0
    compute_s = flops / PEAK_FLOPS
    memory_s = bts / HBM_BW
    coll_s = coll / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    # MODEL_FLOPS: 6*N*D for train (fwd+bwd), 2*N*D for inference
    n = (cell["params_active"] if cell["params_active"] else
         cell["params_total"])
    D = cell["tokens_per_step"]
    mf = (6 if cell["kind"] == "train" else 2) * n * D
    mf_per_dev = mf / cell["n_chips"]
    return dict(terms, dominant=dom.replace("_s", ""),
                model_flops_per_device=mf_per_dev,
                useful_ratio=(mf_per_dev / flops) if flops else 0.0,
                roofline_fraction=(mf_per_dev / PEAK_FLOPS)
                / max(compute_s, memory_s, coll_s)
                if max(compute_s, memory_s, coll_s) > 0 else 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.roofline",
        description="roofline table of dry-run records (H100 constants)")
    ap.add_argument("--dir", default=str(Path(__file__).resolve().parents[2]
                                         / "experiments" / "torch"
                                         / "dryrun"))
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--variant", default="base")
    args = ap.parse_args(argv)
    rows = []
    for f in sorted(Path(args.dir).glob("*.json")):
        cell = json.loads(f.read_text())
        if cell["mesh"] != args.mesh or cell.get("variant",
                                                 "base") != args.variant:
            continue
        t = roofline_terms(cell)
        rows.append((cell, t))
    hdr = (f"{'arch':22s} {'shape':12s} {'compute_s':>10s} {'memory_s':>10s}"
           f" {'coll_s':>10s} {'dom':>7s} {'useful':>7s} {'roofline':>9s}"
           f" {'peakGB':>7s}")
    print(hdr)
    print("-" * len(hdr))
    for cell, t in rows:
        print(f"{cell['arch']:22s} {cell['shape']:12s} "
              f"{t['compute_s']:10.4g} {t['memory_s']:10.4g} "
              f"{t['collective_s']:10.4g} {t['dominant']:>7s} "
              f"{t['useful_ratio']:7.3f} {t['roofline_fraction']:9.3f} "
              f"{cell['memory']['peak_per_device_gb']:7.2f}")


if __name__ == "__main__":
    main()
