"""BENCHMARK.json against the files the harness finds by name, and a cell
and a metric added with new files alone."""
import json
import shutil

import pytest

from bench.harness import core
from bench.tests import tiny

BENCH = core.load_benchmark()


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
    for sub in ("configs", "traffic", "metrics", "families", "ops"):
        shutil.copytree(core.BENCH_DIR / sub, bench_dir / sub)
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
    bench["end_to_end"][0]["workloads"].append("analytics.clustered-commit")
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
    fam.n += 1
    fam.seen.append(fam.n)
    return 1.0, None
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
