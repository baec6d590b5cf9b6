"""The port's dry run (repro_torch.launch.dryrun), on meta on the CPU.

  * ``lower_cell`` on every smoke arch x live shape (the smoke config as
    overrides, the shapes cut to 64 positions and 32 rows): records with
    the reference's keys (read from src/repro/launch/dryrun.py's source,
    which a test never imports: it sets XLA_FLAGS to 512 devices), both
    production meshes from one census, per-device bytes from the specs.
  * One full-width cell (tinyllama-1.1b train_4k) on meta, with resident
    memory growing by less than 1 GB.
  * The command line writes its records where told and the roofline
    table reads them.
"""
import ast
import dataclasses
import json
import pathlib

import pytest
import torch

from repro_torch import roofline
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, shapes_for, smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_for, make_production_mesh
from repro_torch.shardings import Sharding
from torch_threads import torch_one_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = {"train": (64, 32), "prefill": (64, 32), "decode": (64, 32)}


def reference_record_keys() -> tuple[list, dict]:
    """The keys of the reference's record, and of its nested dicts, from
    the source of ``lower_cell``."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "lower_cell")
    d = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) == "result")
    nested = {k.value: [kk.value for kk in v.keys]
              for k, v in zip(d.keys, d.values) if isinstance(v, ast.Dict)}
    return [k.value for k in d.keys], nested


def smoke_overrides(arch: str) -> dict:
    cfg = smoke(ARCHS[arch])
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name"}


def small_shape(name: str) -> ShapeConfig:
    sh = SHAPES[name]
    S, B = SMALL[sh.kind]
    return ShapeConfig(name, S, 1 if sh.global_batch == 1 else B, sh.kind)


CELLS = [(a, s) for a in sorted(ARCHS) for s in shapes_for(ARCHS[a])]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_lower_cell_on_every_smoke_cell(arch, shape):
    keys, nested = reference_record_keys()
    sh = small_shape(shape)
    recs = dryrun.lower_both(arch, shape, overrides=smoke_overrides(arch),
                             shape=sh)
    cfg = dataclasses.replace(ARCHS[arch], **smoke_overrides(arch))
    for multi_pod, rec in recs.items():
        assert list(rec) == keys
        for k, sub in nested.items():
            assert list(rec[k]) == sub, k
        mesh = make_production_mesh(multi_pod=multi_pod)
        assert rec["mesh"] == ("2x16x16" if multi_pod else "16x16")
        assert rec["n_chips"] == mesh.size
        assert rec["collectives"] is None
        assert rec["loop_aware"]["collective_bytes_per_device"] is None
        assert rec["kind"] == sh.kind and rec["shape"] == shape
        assert rec["microbatch"] == cfg.train_microbatch
        m = rec["memory"]
        assert m["argument_bytes"] > 0 and m["output_bytes"] > 0
        assert (m["alias_bytes"] > 0) == (sh.kind != "prefill")
        assert m["alias_bytes"] <= m["argument_bytes"]
        assert rec["cost"]["flops_per_device"] > 0
        terms = roofline.roofline_terms(rec)
        n = cfg.active_params_count() or cfg.params_count()
        tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
        assert terms["model_flops_per_device"] * mesh.size == \
            pytest.approx((6 if sh.kind == "train" else 2) * n * tokens,
                          rel=1e-12)
    one, two = recs[False], recs[True]
    assert one["cost"]["flops_per_device"] == \
        2 * two["cost"]["flops_per_device"]       # one census, 256 vs 512


def test_shard_bytes_follow_the_specs():
    mesh = make_production_mesh(multi_pod=True)
    x = torch.empty(64, 100, 48, device="meta", dtype=torch.bfloat16)
    assert dryrun.tree_bytes(x, (None, None, None), mesh) == x.numel() * 2
    assert dryrun.tree_bytes(x, (("pod", "data"), "model", None), mesh) == \
        2 * 7 * 48 * 2                             # 64/32 rows, ceil(100/16)
    tree = {"a": [x, x], "b": (x,)}
    specs = {"a": [("model",), ()], "b": ((None, "model"),)}
    assert dryrun.tree_bytes(tree, specs, mesh) == \
        (4 * 100 * 48 + 64 * 100 * 48 + 64 * 7 * 48) * 2


def test_a_full_width_cell_on_meta_allocates_nothing():
    """tinyllama-1.1b train_4k at full width and depth (15.4 GB of train
    state, 256 x 4096 tokens): resident memory grows by under 1 GB."""
    def hwm() -> int:
        for line in pathlib.Path("/proc/self/status").read_text().split("\n"):
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) * 1024
        raise AssertionError("no VmHWM in /proc/self/status")

    before = hwm()
    rec = dryrun.lower_cell("tinyllama-1.1b", "train_4k", False)
    assert hwm() - before < 1 << 30
    cfg = ARCHS["tinyllama-1.1b"]
    shd = Sharding(make_production_mesh(), cfg, 256)
    assert shd.tp == 16 and rec["microbatch"] == cfg.train_microbatch == 2
    assert rec["memory"]["argument_bytes"] < 2e9   # 15.4 GB over 256 chips
    assert rec["memory"]["alias_bytes"] > 0.99 * (
        rec["memory"]["argument_bytes"] - 256 * 4096 * 2 * 4 // 16)
    t = roofline.roofline_terms(rec)
    assert t["dominant"] == "compute" and 0 < t["useful_ratio"] < 1


def test_the_one_card_mesh_counts_its_collectives():
    """On a mesh this process runs (make_mesh_for(1)), the census's
    collectives are counted: none on one device."""
    cfg = smoke(ARCHS["olmoe-1b-7b"])
    c = dryrun.census_cell(cfg, ShapeConfig("p", 32, 4, "prefill"), 1)
    rec = dryrun.cell_record(c, make_mesh_for(1, device="cpu"), cfg.name,
                             "p")
    assert rec["collectives"]["total_bytes"] == 0
    assert rec["loop_aware"]["collective_bytes_per_device"] == 0
    assert rec["n_chips"] == 1 and rec["mesh"] == "1x1"


def test_the_command_line_and_the_roofline_table(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.setattr(dryrun, "OUTDIR", tmp_path)
    dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k"])
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["xlstm-125m__long_500k__16x16.json",
                     "xlstm-125m__long_500k__2x16x16.json"]
    rec = json.loads((tmp_path / files[0]).read_text())
    assert rec["arch"] == "xlstm-125m" and rec["kind"] == "decode"
    dryrun.main(["--arch", "xlstm-125m", "--shape", "long_500k"])
    assert capsys.readouterr().out.count("[skip]") == 2
    roofline.main(["--dir", str(tmp_path), "--mesh", "2x16x16"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].split() == ["arch", "shape", "compute_s", "memory_s",
                              "coll_s", "dom", "useful", "roofline",
                              "peakGB"]
    assert len(out) == 3 and out[2].split()[:2] == ["xlstm-125m",
                                                    "long_500k"]
