"""Share of the bytes uploaded from host memory that crossed through the
card's pinned chunk ring, per round, in %: counter
``fabric.upload_staged_bytes`` over ``fabric.upload_bytes``."""

from . import mean


def _share(rnd):
    staged = rnd["counters"].get("fabric.upload_staged_bytes")
    total = rnd["counters"].get("fabric.upload_bytes", 0)
    if staged is None or total <= 0:
        return None
    return 100.0 * staged / total


def read(run):
    return mean(_share(r) for r in run.rounds)
