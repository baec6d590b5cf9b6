"""BENCHMARK.json against the files the harness finds by name, and a cell
and a metric added with new files alone."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from bench.harness import core
from bench.tests import tiny

BENCH = core.load_benchmark()
# the pending cells' end-to-end metric of a commit, which a cell added in
# a test reports
COMMIT_MS = next(m for m in tiny.PENDING["end_to_end"]
                 if m["name"] == "commit_ms")


def test_every_name_resolves_to_its_files():
    names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"] == f"bench/configs/{c['name']}.json"
        assert core.load_config(c["name"])["name"] == c["name"]
    for cell in BENCH["workloads"]:
        assert cell["config"] in names and cell["chips"] == 1
        mix = core.load_traffic(cell["traffic"])
        assert mix["name"] == cell["traffic"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(core.reader(m["name"]))


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in core.metrics_of(BENCH, cell,
                                                           False)}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in core.metrics_of(BENCH, cell["name"],
                                                  False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.metrics_of(BENCH, cell["name"], True)


def _copy(tmp_path):
    bench_dir = tmp_path / "bench"
    shutil.copytree(core.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return bench_dir


def test_a_cell_and_a_metric_are_added_with_files_alone(tmp_path):
    bench_dir = _copy(tmp_path)
    mix = core.load_traffic("scattered-commit")
    mix.update(name="clustered-commit", edit_pattern="contiguous")
    (bench_dir / "traffic" / "clustered-commit.json").write_text(
        json.dumps(mix))
    (bench_dir / "metrics" / "commits_done.py").write_text(
        "def read(run):\n    return float(run.window.completed)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "analytics.clustered-commit", "config": "analytics-250k",
        "traffic": "clustered-commit", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append(dict(COMMIT_MS,
                                    workloads=["analytics.clustered-commit"]))
    bench["per_layer"].append({
        "name": "commits_done.clustered", "unit": "commits",
        "better": "higher", "source": "host_clock", "layer": "test",
        "moves": "commit_ms", "workloads": ["analytics.clustered-commit"]})
    result, _ = tiny.run("analytics.clustered-commit", bench=bench,
                         bench_dir=bench_dir,
                         config=tiny.config_of("analytics.scattered-commit"),
                         traffic=None, trace=True)
    assert result["correct"], result["checks"]
    assert result["metrics"]["commits_done.clustered"]["value"] >= 1


READ_HEAD = '''"""Reads master's head back whole."""


def run(fam, spans):
    return float(fam.read(fam.head["master"], spans)), None
'''

COUNTER = '''"""A family that only counts: its judge wants every count seen."""


class Family:
    def __init__(self, config, traffic, seed):
        self.n, self.seen = int(config["start"]), []

    def setup(self, spans):
        pass

    def step(self):
        self.n += 1
        return self.n

    def counters(self):
        from repro_torch.kernels import ops
        return {"launches": ops.launches()}

    def finish(self):
        pass

    def judge(self, device):
        gaps = sum(b != a + 1 for a, b in zip(self.seen, self.seen[1:]))
        return {"count_gaps": (gaps, 0)}
'''

COUNT = '''def run(fam, spans):
    fam.seen.append(fam.step())
    return 1.0, None
'''

COUNTER_FAULTS = '''"""The counter's controls and faults, and the size of its tests."""

TEST_SCALE = ("start", 5)


def controls(config, traffic):
    return ("skip_one",)


def faults(config, traffic):
    return ("unchanged_state", "half_batch", "altered_answer")


def skip_one(fam):
    step = fam.step

    def skipping():
        if fam.n == 10:
            step()
        return step()

    fam.step = skipping


def unchanged_state(fam):
    fam.step = lambda: fam.n


def half_batch(fam):
    step = fam.step

    def halving():
        step()
        return step()

    fam.step = halving


def altered_answer(fam):
    step = fam.step
    fam.step = lambda: step() ^ 1
'''


def test_an_operation_and_a_family_are_added_with_files_alone(tmp_path):
    bench_dir = _copy(tmp_path)
    (bench_dir / "ops" / "read-head.py").write_text(READ_HEAD)
    (bench_dir / "families" / "counter.py").write_text(COUNTER)
    (bench_dir / "ops" / "count.py").write_text(COUNT)
    (bench_dir / "metrics" / "ops_done.py").write_text(
        "def read(run):\n    return float(run.window.completed)\n")
    for name, mix in (("head", {"op": "read-head", "check_reads": 2,
                                "check_versions": 1}),
                      ("counting", {"op": "count"})):
        (bench_dir / "traffic" / f"{name}.json").write_text(
            json.dumps({"name": name, **mix}))
    (bench_dir / "configs" / "counter.json").write_text(json.dumps(
        {"name": "counter", "family": "counter", "start": 5}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "counter", "source": "a test",
                             "file": "bench/configs/counter.json",
                             "reduced": [], "why": "a test"})
    for cell, cfg, mix in (("analytics.head", "analytics-250k", "head"),
                           ("counter.counting", "counter", "counting")):
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "a test cell"})
    bench["end_to_end"].append({"name": "ops_done", "unit": "ops",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock"})
    for cell, config in (("analytics.head",
                          tiny.config_of("analytics.checkout")),
                         ("counter.counting", None)):
        result, details = tiny.run(cell, bench=bench, bench_dir=bench_dir,
                                   config=config, traffic=None)
        assert result["correct"], result["checks"]
        assert result["metrics"]["ops_done"]["value"] >= 1
    assert set(result["checks"]) == {"count_gaps", "failed_ops"}


def _collect(root):
    """``pytest --collect-only`` of ``root``'s ``bench/tests``, in a
    process of its own that imports the benchmark from ``root``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([str(root), str(core.REPO / "src")])
    return subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "bench/tests"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)


def test_a_durable_ledger_cell_and_a_family_s_cell_are_tested_from_files_alone(
        tmp_path):
    """A ledger cell of YCSB workload A's blocks on a durable deployment,
    and a cell of a new family, each added with its own files and a
    ``BENCHMARK.json`` entry: the tests build their cases (a sound run,
    each fault that applies, the controls), which pass on the CPU, and
    the copy's tests collect without an error."""
    bench_dir = _copy(tmp_path)
    cfg = dict(tiny.PENDING["configs"]["ledger-pending-durable"],
               name="ledger-ycsb", value_bytes=1000, accounts=20000)
    files = {"configs/ledger-ycsb.json": cfg,
             "traffic/ycsb-a-blocks.json": {
                 "name": "ycsb-a-blocks", "op": "block", "reads": 250,
                 "writes": 250, "key_dist": "zipfian", "check_blocks": 2},
             "configs/counter.json": {"name": "counter", "family": "counter",
                                      "start": 5},
             "traffic/counting.json": {"name": "counting", "op": "count"}}
    for path, data in files.items():
        (bench_dir / path).write_text(json.dumps(data))
    (bench_dir / "families" / "counter.py").write_text(COUNTER)
    (bench_dir / "ops" / "count.py").write_text(COUNT)
    (bench_dir / "faults" / "counter.py").write_text(COUNTER_FAULTS)
    bench = json.loads(json.dumps(BENCH))
    new = {"ledger.ycsb-a-blocks": ("ledger-ycsb", "ycsb-a-blocks"),
           "counter.counting": ("counter", "counting")}
    bench["end_to_end"].append(dict(COMMIT_MS, workloads=[]))
    for name, (config, mix) in new.items():
        bench["configs"].append({"name": config, "source": "a test",
                                 "file": f"bench/configs/{config}.json",
                                 "reduced": [], "why": "a test"})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1,
                                   "why": "a test cell"})
        bench["end_to_end"][-1]["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cases = tiny.cases(bench, bench_dir)
    faults = ("unchanged_state", "half_batch", "altered_answer", "control")
    assert cases["controls"]["ledger.ycsb-a-blocks"] == (
        "drop_write", "skip_sync", "lost_leaves")
    assert cases["controls"]["counter.counting"] == ("skip_one",)
    want = {("ledger.ycsb-a-blocks", "skip_sync"),
            ("ledger.ycsb-a-blocks", "lost_leaves")} | {
        (cell, f) for cell in new for f in faults}
    assert {c for c in cases["broken"] if c[0] in new} == want
    for cell in new:
        assert cell in cases["cells"]
        result, _ = tiny.run(cell, bench=bench, bench_dir=bench_dir)
        assert result["correct"], (cell, result["checks"])
        assert "commit_ms" in result["metrics"]
    for cell, fault in sorted(want):
        fault = cases["controls"][cell][0] if fault == "control" else fault
        result, _ = tiny.run(cell, fault=fault, bench=bench,
                             bench_dir=bench_dir)
        assert not result["correct"], (cell, fault, result["checks"])

    out = _collect(tmp_path)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "error" not in out.stdout.splitlines()[-1], out.stdout[-4000:]
    for cell, fault in want:
        assert (f"test_a_broken_timed_path_is_not_correct[{cell}-{fault}]"
                in out.stdout), (cell, fault)
    for cell in new:
        assert f"test_cell_runs_correct_on_the_cpu[{cell}]" in out.stdout


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        core.cell_of(BENCH, "no.such-cell")
    with pytest.raises(FileNotFoundError):
        core.reader("no_such_metric.commit")
    with pytest.raises(FileNotFoundError):
        core.operation("no-such-op")
    with pytest.raises(FileNotFoundError):
        core.family("no_such_family")


NAME = r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}"
UNIT = r"[A-Za-z0-9_/%.-]{1,16}"


def test_benchmark_json_keeps_to_the_contract_s_limits():
    import re
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 << 10
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert re.fullmatch(NAME, n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(re.fullmatch(NAME, k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.fullmatch(UNIT, m["unit"]) and m["better"] in (
            "lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    layers = {}
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
