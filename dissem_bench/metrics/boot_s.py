"""Ready until every stage reports booted, per round (host clock)."""

from . import mean


def read(run):
    return mean(r["boot_s"] for r in run.rounds)
