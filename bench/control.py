"""Run a cell's control, or a planted fault, on the card and print what the
judge reads: the check that decides ``correct`` must come out false.

    python3 bench/control.py --workload <name> --fault <fault> --seeds 1 2 3 [--seconds 5]

Each seed is one run of the cell at its own size, in this process, with a
short window.  A fault is planted once the set-up is done, from outside the
family: it wraps the program's objects the family holds.  The controls
(PERF.md §2) are ``skip_sync`` (a commit acknowledged without ``sync()``),
``unverified`` (chunks put and read without their check against their
cids), ``drop_write`` (a block that loses its last write) and
``stale_proof`` (a state proof at the block before the head); the faults
``unchanged_state``, ``half_batch`` and ``altered_answer`` apply to every
cell.  Prints one JSON line a seed and exits 1 if any run comes out
correct.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flip(b: bytes) -> bytes:
    return bytes([b[0] ^ 1]) + b[1:]


class _Blob:
    """A blob handed out by a broken engine: every second ``replace`` is
    lost (``half``), or what ``read`` returns is altered (``alter``)."""

    def __init__(self, blob, half=False, alter=False):
        self.blob, self.half, self.alter, self.n = blob, half, alter, 0

    def replace(self, *args):
        self.n += 1
        if not (self.half and self.n % 2 == 0):
            self.blob.replace(*args)

    def read(self, *args):
        got = self.blob.read(*args)
        return _flip(got) if self.alter else got

    def __getattr__(self, name):
        return getattr(self.blob, name)


class _Handle:
    def __init__(self, handle, **kw):
        self.handle, self.kw = handle, kw

    def blob(self):
        return _Blob(self.handle.blob(), **self.kw)

    def __getattr__(self, name):
        return getattr(self.handle, name)


def _wrap_blobs(db, **kw):
    """``db.get`` hands out ``_Blob``s; ``db.put`` takes them back."""
    get, put = db.get, db.put

    def broken_get(*args, **kws):
        h = get(*args, **kws)
        return None if h is None else _Handle(h, **kw)

    def broken_put(key, value, *args, **kws):
        return put(key, value.blob if isinstance(value, _Blob) else value,
                   *args, **kws)

    db.get, db.put = broken_get, broken_put


# --------------------------------------------------------------- analytics

def skip_sync(fam):
    fam.db.sync = lambda: None


def unverified(fam):
    fam.db.verify_get = False
    fam.db.store.verify = fam.db.store.cold.verify = False


def _unchanged_analytics(fam):
    db = fam.db
    get, first = db.get, []

    def put(key, value, branch=None, **kw):       # the head stays put
        return db.branches.head(key.encode(), branch or "master")

    def stale_get(*args, **kw):                   # so does the reader
        if not first:
            first.append(get(*args, **kw))
        return first[0]

    db.put = put
    if fam.mix["op"] != "commit":
        db.get = stale_get


def _half_analytics(fam):
    _wrap_blobs(fam.db, half=True)


def _altered_analytics(fam):
    _wrap_blobs(fam.db, alter=True)
    put = fam.db.put
    fam.db.put = lambda *a, **kw: _flip(put(*a, **kw))


# ------------------------------------------------------------------ ledger

def drop_write(fam):
    led = fam.led
    commit = led.commit

    def dropping():
        if led._writes:
            led._writes.pop(next(reversed(led._writes)))
        return commit()

    led.commit = dropping


def stale_proof(fam):
    led = fam.led
    prove = led.prove_state_flat
    led.prove_state_flat = lambda c, k, height=None: prove(
        c, k, max(0, led.height - 2))


def _unchanged_ledger(fam):
    fam.led.commit = lambda: fam.blocks[-1]["uid"]


def _half_ledger(fam):
    led = fam.led
    write, n = led.write, [0]

    def halving(c, k, v):
        n[0] += 1
        if n[0] % 2:
            write(c, k, v)

    led.write = halving


def _altered_ledger(fam):
    led, client = fam.led, fam.client
    read, verify = led.read, client.verify_state_flat
    led.read = lambda c, k: _flip(read(c, k))

    def altered(*args, **kw):
        d, v = verify(*args, **kw)
        return d, _flip(v)

    client.verify_state_flat = altered


FAULTS = {
    "analytics": {"skip_sync": skip_sync, "unverified": unverified,
                  "unchanged_state": _unchanged_analytics,
                  "half_batch": _half_analytics,
                  "altered_answer": _altered_analytics},
    "ledger": {"drop_write": drop_write, "stale_proof": stale_proof,
               "unchanged_state": _unchanged_ledger,
               "half_batch": _half_ledger,
               "altered_answer": _altered_ledger},
}


def fault(family: str, name: str):
    """The function that plants fault ``name`` in a family ``family``."""
    return FAULTS[family][name]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench.harness import core
    from bench.harness.runner import run_cell

    cell = core.cell_of(core.load_benchmark(), args.workload)
    plant = fault(core.load_config(cell["config"])["family"], args.fault)
    caught = True
    for seed in args.seeds:
        result, details = run_cell(args.workload, seed, args.seconds, False,
                                   plant=plant)
        caught &= not result["correct"]
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": result["correct"],
                          "completed": details["completed"],
                          "checks": result["checks"]}), flush=True)
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
