"""The ledger family's controls and faults, and the size of its CPU tests.

Each control or fault is a function ``plant(family)`` that breaks the timed
path from outside once the set-up is done, by wrapping the program's
objects the family holds (``bench/control.py``).  The controls:
``drop_write``, a block that loses its last write; ``stale_proof``, a
state proof at the block before the head; ``skip_sync``, a block of a
durable deployment acknowledged without ``sync()``; ``lost_leaves``, a
block of a durable deployment whose ``sync()`` persists the heads and the
meta chunks but not the chunks that hold accounts.
"""
from bench.control import flip

# the config key that sets a deployment's scale, and its size in the tests
TEST_SCALE = ("accounts", 1500)


def controls(config: dict, traffic: dict) -> tuple[str, ...]:
    """The cell's controls, the first of them "the control": blocks are
    held to every write they take, queries to the head they prove at, and
    a durable deployment, whose every mix commits blocks, to its
    ``sync()`` and to every chunk that sync persists."""
    out = {"block": ("drop_write",),
           "query": ("stale_proof",)}.get(traffic["op"], ())
    return out + (("skip_sync", "lost_leaves")
                  if config["deployment"].get("durable") else ())


def faults(config: dict, traffic: dict) -> tuple[str, ...]:
    """The faults that apply to the mix: all three."""
    return ("unchanged_state", "half_batch", "altered_answer")


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


def skip_sync(fam):
    fam.led.db.sync = lambda: None


def lost_leaves(fam):
    db = fam.led.db
    sync = db.sync

    def losing():                 # an account's chunk stays in memory only
        store = db.store
        store._dirty -= {c for c in store._dirty
                         if b"kv/key" in store._hot[c]}
        sync()

    db.sync = losing


def unchanged_state(fam):
    fam.led.commit = lambda: fam.blocks[-1]["uid"]


def half_batch(fam):
    led = fam.led
    write, n = led.write, [0]

    def halving(c, k, v):
        n[0] += 1
        if n[0] % 2:
            write(c, k, v)

    led.write = halving


def altered_answer(fam):
    led, client = fam.led, fam.client
    read, verify = led.read, client.verify_state_flat
    led.read = lambda c, k: flip(read(c, k))

    def altered(*args, **kw):
        d, v = verify(*args, **kw)
        return d, flip(v)

    client.verify_state_flat = altered
