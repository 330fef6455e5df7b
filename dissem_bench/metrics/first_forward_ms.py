"""The pod's first pipelined forward per round (host clock around
``pp_serve.pod_forward``, which synchronises)."""

from . import mean


def read(run):
    v = mean(r["forward_s"] for r in run.rounds)
    return None if v is None else v * 1e3
