"""The cold analytics family's controls and faults, and the size of its
CPU tests: the analytics family's (``faults/analytics.py``).  Its
``unverified`` turns the checks of both tiers off, so each of the
family's three probes (a chunk put under a wrong cid, a leaf altered in
the memory tier, a leaf altered in its segment file) reads 1 under it:
``tamper_undetected`` 3."""
from bench.faults.analytics import (TEST_SCALE, altered_answer, controls,
                                    faults, half_batch, skip_sync,
                                    unchanged_state, unverified)

__all__ = ["TEST_SCALE", "altered_answer", "controls", "faults",
           "half_batch", "skip_sync", "unchanged_state", "unverified"]
