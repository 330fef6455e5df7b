"""The holders' digest stamp's hash rate per round, in GB/s: counter
``integrity.digest_stamp_bytes`` over phase ``integrity_digest_stamp``
(the port's time hashing, summed over threads)."""

from . import mean, phase_total_ms


def _gbps(rnd):
    nbytes = rnd["counters"].get("integrity.digest_stamp_bytes")
    ms = phase_total_ms(rnd, "integrity_digest_stamp")
    if nbytes is None or ms <= 0:
        return None
    return nbytes / ms / 1e6


def read(run):
    return mean(_gbps(r) for r in run.rounds)
