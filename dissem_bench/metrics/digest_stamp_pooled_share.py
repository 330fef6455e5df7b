"""Share of the holders' stamped bytes hashed on the port's digest pool
and not inline, per round, in %: counter
``integrity.digest_stamp_pooled_bytes`` over
``integrity.digest_stamp_bytes``."""

from . import mean


def _share(rnd):
    pooled = rnd["counters"].get("integrity.digest_stamp_pooled_bytes")
    total = rnd["counters"].get("integrity.digest_stamp_bytes", 0)
    if pooled is None or total <= 0:
        return None
    return 100.0 * pooled / total


def read(run):
    return mean(_share(r) for r in run.rounds)
