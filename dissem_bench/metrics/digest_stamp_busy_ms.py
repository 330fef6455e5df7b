"""Phase ``integrity_digest_stamp_busy`` per round, in ms: the time in
which at least one holder's stamp hash ran, on any thread."""

from . import phase_ms


def read(run):
    return phase_ms(run, "integrity_digest_stamp_busy")
