"""Phase ``pod_start`` per round, in ms: ``run_pod`` from the announces
sent until the leader's start queue hands out the plan."""

from . import phase_ms


def read(run):
    return phase_ms(run, "pod_start")
