"""Phase ``fabric_upload_busy`` per round, in ms: the time in which at
least one seeder upload from host memory ran, on any thread."""

from . import phase_ms


def read(run):
    return phase_ms(run, "fabric_upload_busy")
