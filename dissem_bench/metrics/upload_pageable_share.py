"""Share of the bytes uploaded from host memory whose host tensor was not
pinned, per round, in %: counter ``fabric.upload_pageable_bytes`` over
``fabric.upload_bytes``."""

from . import mean


def _share(rnd):
    pageable = rnd["counters"].get("fabric.upload_pageable_bytes")
    total = rnd["counters"].get("fabric.upload_bytes", 0)
    if pageable is None or total <= 0:
        return None
    return 100.0 * pageable / total


def read(run):
    return mean(_share(r) for r in run.rounds)
