"""Process-environment knobs (copy of the JAX package's ``utils/env.py``
boot-donation reader)."""

from __future__ import annotations

import os


def boot_donate_mode() -> str:
    """The donated-staging knob (``DLD_BOOT_DONATE``): ``"off"`` (0),
    ``"force"`` (1), or ``"auto"`` (unset/anything else).  Auto releases a
    blob's device copy only where a host copy survives and the blob lives
    on a CUDA device (a CPU "device" tensor may alias the host buffer)."""
    v = os.environ.get("DLD_BOOT_DONATE", "")
    if v == "0":
        return "off"
    if v == "1":
        return "force"
    return "auto"
