"""Phase ``collective`` per round, in ms (the port's sum over threads)."""

from . import phase_ms


def read(run):
    return phase_ms(run, "collective")
