"""The mode-3 leader's plan solve per round (its ``solve_ms``)."""

from . import mean


def read(run):
    return mean(r["solve_ms"] for r in run.rounds)
