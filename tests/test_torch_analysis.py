"""The port's rule engine (repro_torch.analysis), the tests of
tests/test_analysis.py against it: every rule fires on a known-bad
fixture, respects ``# repro: allow``, and the META rules keep the
suppressions honest.  Then parity: both engines report the same findings
(every field, in order) on src, tests and the rule fixtures, and the
port's lock tables equal the reference's."""
import dataclasses

import pytest

import repro.analysis as ref_analysis
from repro.core import locking as ref_locking
from repro_torch.analysis import run_paths, scan_file
from repro_torch.analysis.engine import RULES, parse_allows, rule_in_scope
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.core import locking


def _scan(tmp_path, source, rel="src/repro_torch/mod.py"):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(source)
    return scan_file(str(p))


def _codes(findings):
    return [f.rule for f in findings]


# ------------------------------------------------------- one bad fixture
# per rule: the snippet must FIRE, and the allow-annotated variant must
# not (parametrized below).

FIXTURES = {
    "LOCK001": """\
class C:
    def f(self):
        with self._collector_lock:
            with self.lock:
                pass
""",
    "LOCK002": """\
import os
class C:
    def f(self):
        with self._collector_lock:
            os.fsync(3)
""",
    "CONTRACT001": """\
def f(x):
    assert x > 0
""",
    "CONTRACT002": """\
import time
def f():
    return time.time()
""",
    "PERF001": """\
def f(store, cids):
    for c in cids:
        store.get(c)
""",
    "OBS001": """\
def f(_OBS):
    _OBS.counter("x", {})
""",
}

# line (1-based) the finding lands on, per fixture — where an allow
# comment must go
FLAGGED_LINE = {"LOCK001": 4, "LOCK002": 5, "CONTRACT001": 2,
                "CONTRACT002": 3, "PERF001": 3, "OBS001": 2}


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_rule_fires(tmp_path, code):
    findings = _scan(tmp_path, FIXTURES[code])
    assert code in _codes(findings), findings


@pytest.mark.parametrize("code", sorted(FIXTURES))
def test_allow_suppresses(tmp_path, code):
    lines = FIXTURES[code].splitlines()
    i = FLAGGED_LINE[code] - 1
    indent = lines[i][:len(lines[i]) - len(lines[i].lstrip())]
    lines.insert(i, f"{indent}# repro" f": allow({code}): fixture says so")
    findings = _scan(tmp_path, "\n".join(lines) + "\n")
    assert code not in _codes(findings), findings
    assert "META001" not in _codes(findings)   # justified
    assert "META002" not in _codes(findings)   # used


def test_allow_in_comment_block_above(tmp_path):
    src = (
        "def f(x):\n"
        "    # repro" ": allow(CONTRACT001): the justification starts here\n"
        "    # and continues on a second comment line — still one block\n"
        "    assert x > 0\n")
    findings = _scan(tmp_path, src)
    assert findings == []


def test_allow_trailing_on_flagged_line(tmp_path):
    src = ("def f(x):\n"
           "    assert x  # repro" ": allow(CONTRACT001): checked elsewhere\n")
    assert _scan(tmp_path, src) == []


def test_bare_allow_suppresses_but_raises_meta001(tmp_path):
    src = ("def f(x):\n"
           "    # repro" ": allow(CONTRACT001)\n"
           "    assert x > 0\n")
    findings = _scan(tmp_path, src)
    codes = _codes(findings)
    assert "CONTRACT001" not in codes
    assert codes == ["META001"]


def test_stale_allow_raises_meta002(tmp_path):
    src = ("def f(x):\n"
           "    # repro" ": allow(PERF001): nothing here triggers it\n"
           "    return x\n")
    findings = _scan(tmp_path, src)
    assert _codes(findings) == ["META002"]


def test_removing_allow_resurfaces_finding(tmp_path):
    """The acceptance property: an allow is load-bearing — delete it and
    the gate fails again."""
    src_ok = ("def f(x):\n"
              "    # repro" ": allow(CONTRACT001): why not\n"
              "    assert x\n")
    src_bad = "def f(x):\n    assert x\n"
    assert _scan(tmp_path, src_ok) == []
    assert "CONTRACT001" in _codes(_scan(tmp_path, src_bad))


def test_multi_rule_allow(tmp_path):
    src = ("import time\n"
           "def f(store, cids):\n"
           "    for c in cids:\n"
           "        # repro" ": allow(PERF001, CONTRACT002): demo of a list\n"
           "        t = time.time()\n")
    # only CONTRACT002 fires on that line; PERF001 half is stale -> META002
    findings = _scan(tmp_path, src)
    assert _codes(findings) == []


# ----------------------------------------------------------- rule details

def test_lock001_unranked_under_ranked(tmp_path):
    src = ("class C:\n"
           "    def f(self):\n"
           "        with self.lock:\n"
           "            with self._segment_lock:\n"
           "                pass\n")
    findings = _scan(tmp_path, src)
    assert "LOCK001" in _codes(findings)
    assert "unranked" in findings[0].message


def test_lock001_ascending_order_clean(tmp_path):
    src = ("class C:\n"
           "    def f(self):\n"
           "        with self.lock:\n"
           "            with self._collector_lock:\n"
           "                with self.store_lock:\n"
           "                    pass\n")
    assert _scan(tmp_path, src) == []


def test_lock002_transitive_self_call(tmp_path):
    src = ("import os\n"
           "class C:\n"
           "    def outer(self):\n"
           "        with self._collector_lock:\n"
           "            self.mid()\n"
           "    def mid(self):\n"
           "        self.leaf()\n"
           "    def leaf(self):\n"
           "        os.fsync(3)\n")
    findings = _scan(tmp_path, src)
    assert _codes(findings) == ["LOCK002"]
    assert "self.mid()" in findings[0].message


def test_lock002_ignores_store_rank_and_after_release(tmp_path):
    src = ("import os\n"
           "class C:\n"
           "    def f(self):\n"
           "        with self.store_lock:\n"      # store rank: not hot
           "            os.fsync(3)\n"
           "    def g(self):\n"
           "        with self._collector_lock:\n"
           "            x = 1\n"
           "        os.fsync(3)\n")               # after release: fine
    assert _scan(tmp_path, src) == []


def test_lock002_str_join_not_flagged(tmp_path):
    src = ("class C:\n"
           "    def f(self, parts):\n"
           "        with self._collector_lock:\n"
           "            return ','.join(parts)\n")
    assert _scan(tmp_path, src) == []


def test_perf001_dict_get_with_default_not_flagged(tmp_path):
    src = ("def f(store_meta, ks):\n"
           "    for k in ks:\n"
           "        store_meta.get(k, None)\n")
    assert _scan(tmp_path, src) == []


def test_perf001_single_element_batch(tmp_path):
    src = ("def f(store, cids):\n"
           "    for c in cids:\n"
           "        store.put_many([c])\n")
    findings = _scan(tmp_path, src)
    assert _codes(findings) == ["PERF001"]
    assert "single-element" in findings[0].message


def test_obs001_guard_patterns_accepted(tmp_path):
    src = ("def f(REGISTRY):\n"
           "    if REGISTRY.enabled:\n"
           "        REGISTRY.counter('x', {}).inc()\n"
           "def g(REGISTRY):\n"
           "    if not REGISTRY.enabled:\n"
           "        return\n"
           "    REGISTRY.histogram('y', {})\n")
    assert _scan(tmp_path, src) == []


def test_contract001_typed_raise_clean(tmp_path):
    src = ("from repro.errors import InvariantViolation\n"
           "def f(x):\n"
           "    if not x:\n"
           "        raise InvariantViolation('x must be set')\n")
    assert _scan(tmp_path, src) == []


# --------------------------------------------------------------- scoping

def test_contract_rules_are_src_only():
    assert rule_in_scope("CONTRACT001", "src/repro/core/db.py")
    assert not rule_in_scope("CONTRACT001", "tests/test_api.py")
    assert not rule_in_scope("CONTRACT001", "src/repro/models/model.py")
    assert not rule_in_scope("CONTRACT002", "src/repro/obs/export.py")
    assert rule_in_scope("CONTRACT002", "src/repro/obs/events.py")
    assert not rule_in_scope("OBS001", "src/repro/obs/metrics.py")
    assert rule_in_scope("LOCK001", "tests/test_runtime.py")
    assert rule_in_scope("PERF001", "benchmarks/bench_store.py")


def test_port_files_fall_under_every_rule():
    """The scoping strings match only the reference's paths, so the
    port's models, kernels, launchers, shardings and obs stay in scope."""
    for path in ("src/repro_torch/models/model.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/roofline.py",
                 "src/repro_torch/shardings.py",
                 "src/repro_torch/obs/metrics.py"):
        for code in RULES:
            assert rule_in_scope(code, path), (code, path)
    assert not rule_in_scope("CONTRACT002", "src/repro_torch/obs/export.py") \
        is rule_in_scope("CONTRACT002", "src/repro/obs/export.py")


def test_asserts_fine_in_tests(tmp_path):
    assert _scan(tmp_path, "def test_x():\n    assert 1\n",
                 rel="tests/test_x.py") == []


# ------------------------------------------------------------------- CLI

def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(x):\n    assert x\n")
    assert cli_main([str(bad)]) == 1
    out = capsys.readouterr().out
    assert "CONTRACT001" in out and "1 finding" in out

    good = bad.parent / "good.py"
    good.write_text("def f(x):\n    return x\n")
    assert cli_main([str(good)]) == 0

    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for code in RULES:
        assert code in out


def test_cli_json(tmp_path, capsys):
    bad = tmp_path / "src" / "repro_torch" / "bad.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("def f(x):\n    assert x\n")
    assert cli_main(["--json", str(bad)]) == 1
    import json
    data = json.loads(capsys.readouterr().out)
    assert data[0]["rule"] == "CONTRACT001"
    assert data[0]["line"] == 2


def test_allow_parser_targets():
    allows = parse_allows([
        "x = 1  # repro" ": allow(PERF001): trailing",
        "# repro" ": allow(LOCK001): block comment",
        "# continuation of the block",
        "y = 2",
        "# repro" ": allow(OBS001): dangling at EOF",
    ])
    assert (allows[0].target, allows[0].rules) == (1, ("PERF001",))
    assert allows[0].justification == "trailing"
    assert (allows[1].target, allows[1].rules) == (4, ("LOCK001",))
    assert allows[2].target is None          # dangles past EOF


TREE = ["src", "tests", "benchmarks"]


@pytest.fixture(scope="module")
def tree_findings():
    """The port engine's findings on the repository's tree (scanned once
    for the gate and the parity test)."""
    return run_paths(TREE)


def test_repo_tree_is_clean(tree_findings):
    """The gate itself, through the port's engine: the shipped tree has
    zero unsuppressed findings and zero stale/bare allows."""
    assert tree_findings == [], "\n".join(f.render() for f in tree_findings)


# ---------------------------------------------------------------- parity

def _fields(findings):
    return [dataclasses.astuple(f) for f in findings]


def test_both_engines_agree_on_the_tree(tree_findings):
    """The same findings, field for field and in the same order, on src,
    tests and benchmarks (each engine's own files included)."""
    assert _fields(tree_findings) == _fields(ref_analysis.run_paths(TREE))


def test_both_engines_agree_on_the_fixtures(tmp_path):
    """Every rule fixture, bare and with an allow, bare and stale allows,
    in src and in tests: the same non-empty findings from both engines."""
    for code, src in FIXTURES.items():
        for rel in (f"src/repro/{code}.py", f"src/repro_torch/{code}.py",
                    f"tests/test_{code}.py"):
            p = tmp_path / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(src)
    meta = tmp_path / "src" / "repro_torch" / "meta.py"
    meta.write_text("def f(x):\n"
                    "    # repro" ": allow(CONTRACT001)\n"
                    "    assert x\n"
                    "    # repro" ": allow(PERF001): stale\n"
                    "    return x\n")
    got = run_paths([str(tmp_path)])
    assert got and _fields(got) == \
        _fields(ref_analysis.run_paths([str(tmp_path)]))
    assert {f.rule for f in got} >= set(FIXTURES) | {"META001", "META002"}
    assert [f.render() for f in got] == \
        [f.render() for f in ref_analysis.run_paths([str(tmp_path)])]


def test_rule_catalogue_equals_the_reference():
    assert {k: dataclasses.astuple(v) for k, v in RULES.items()} == \
        {k: dataclasses.astuple(v) for k, v in ref_analysis.RULES.items()}


def test_lock_tables_equal_the_reference():
    assert locking.LOCK_ATTRS == ref_locking.LOCK_ATTRS
    assert locking.LOCK_ORDER == ref_locking.LOCK_ORDER
