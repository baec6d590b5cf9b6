"""Phase 11 of chip_smoke.py alone on the card (execution on a mesh of
ranks): builds the kernels, runs ``chip_smoke.multicard_path`` and prints
its result and the card's name and power limit.

    python experiments/torch/multicard_phase.py

The ranks are spawned, so this runs from a file, never from stdin.
"""
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("multicard_phase: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops
    build.build_all()
    ops.set_device("cuda")
    t = time.perf_counter()
    out = chip_smoke.multicard_path(torch.device("cuda"))
    print(f"phase 11 (mesh of ranks): {time.perf_counter() - t:.1f} s")
    print("mesh of ranks: " + json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
