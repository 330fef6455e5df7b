"""Phase ``pod_assemble`` per round, in ms: ``run_pod``'s assembly of the
booted stages into the pod's pipelined parameters."""

from . import phase_ms


def read(run):
    return phase_ms(run, "pod_assemble")
