"""The port's engine examples (examples/torch/*.py, on the CPU) print what
the reference examples (examples/*.py) print, line for line, except for
the times: a time (``1.22ms``, ``0.45s``) and, on a line that holds one,
a ratio of times (``(1x)``) are masked before the lines are compared."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIME = re.compile(r"\d+(\.\d+)?(ms|s)\b")
RATIO = re.compile(r"\(\d+(\.\d+)?x\)")


def _run(*argv: str) -> list[str]:
    # one torch thread a process: the suite's workers share the cores
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def _masked(lines: list[str]) -> list[str]:
    out = []
    for line in lines:
        if TIME.search(line):
            line = RATIO.sub("(<ratio>)", TIME.sub("<time>", line))
        out.append(line)
    return out


@pytest.mark.parametrize("name", ["quickstart", "blockchain_demo",
                                  "collab_analytics", "wiki_demo"])
def test_port_example_prints_the_reference_output(name):
    want = _run(f"examples/{name}.py")
    got = _run(f"examples/torch/{name}.py", "--device", "cpu")
    assert len(want) >= 4
    assert _masked(got) == _masked(want)


def test_the_mask_hides_times_only():
    line = "state scan acct007: 20 versions | forkbase 1.22ms vs replay 1.35ms (1x)"
    assert _masked([line]) == ["state scan acct007: 20 versions | forkbase "
                               "<time> vs replay <time> (<ratio>)"]
    assert _masked(["storage: 0.38MB physical, 1.00x dedup"]) == \
        ["storage: 0.38MB physical, 1.00x dedup"]
