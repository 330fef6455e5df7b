"""Share of the layer bytes the round's boots assembled that they wrote
to new device memory rather than viewed in place, per round, in %:
counter ``boot.stage_copied_bytes`` over ``boot.stage_bytes``."""

from . import mean


def _share(rnd):
    copied = rnd["counters"].get("boot.stage_copied_bytes")
    total = rnd["counters"].get("boot.stage_bytes", 0)
    if copied is None or total <= 0:
        return None
    return 100.0 * copied / total


def read(run):
    return mean(_share(r) for r in run.rounds)
