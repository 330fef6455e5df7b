"""Bytes the seeders uploaded from host memory to the fabric per round
(counter ``fabric.upload_bytes``; 0 where the seeders' copies are already
in device memory)."""

from . import mean


def read(run):
    if not run.rounds:
        return None
    return mean(r["counters"].get("fabric.upload_bytes", 0)
                for r in run.rounds)
