"""The analytics family's controls and faults, and the size of its CPU
tests.

Each control or fault is a function ``plant(family)`` that breaks the timed
path from outside once the set-up is done, by wrapping the program's
objects the family holds (``bench/control.py``).  The controls:
``skip_sync``, a commit acknowledged without ``sync()``, and
``unverified``, chunks put and read without their check against their
cids.
"""
from bench.control import flip

# the config key that sets a deployment's scale, and its size in the tests
TEST_SCALE = ("records", 1500)


def controls(config: dict, traffic: dict) -> tuple[str, ...]:
    """The cell's controls, the first of them "the control": a mix that
    commits to a durable deployment is held to its ``sync()``; every
    deployment that verifies, to its checks."""
    dep = config["deployment"]
    out = ("skip_sync",) if dep["durable"] and traffic["op"] == "commit" \
        else ()
    return out + (("unverified",) if dep["verify_get"] else ())


def faults(config: dict, traffic: dict) -> tuple[str, ...]:
    """The faults that apply to the mix: a checkout reads whole versions
    one at a time, so it has no batch to halve."""
    return (("unchanged_state", "altered_answer")
            if traffic["op"] == "checkout"
            else ("unchanged_state", "half_batch", "altered_answer"))


class _Blob:
    """A blob handed out by a broken engine: every second ``replace`` is
    lost (``half``), what ``read`` returns is altered (``alter``), or
    ``read`` returns the buffer it held before, nothing (``held``)."""

    def __init__(self, blob, half=False, alter=False, held=False):
        self.blob, self.half, self.alter, self.n = blob, half, alter, 0
        self.held = held

    def replace(self, *args):
        self.n += 1
        if not (self.half and self.n % 2 == 0):
            self.blob.replace(*args)

    def read(self, *args):
        if self.held:
            return b""
        got = self.blob.read(*args)
        return flip(got) if self.alter else got

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


def skip_sync(fam):
    fam.db.sync = lambda: None


def unverified(fam):
    fam.db.verify_get = False
    fam.db.store.verify = fam.db.store.cold.verify = False


def unchanged_state(fam):
    db = fam.db

    def put(key, value, branch=None, **kw):       # the head stays put
        return db.branches.head(key.encode(), branch or "master")

    db.put = put
    if fam.mix["op"] != "commit":                 # so does the reader's
        _wrap_blobs(db, held=True)                # buffer: still empty


def half_batch(fam):
    _wrap_blobs(fam.db, half=True)


def altered_answer(fam):
    _wrap_blobs(fam.db, alter=True)
    put = fam.db.put
    fam.db.put = lambda *a, **kw: flip(put(*a, **kw))
