"""Device resolution: the port's one rule for where work runs.

``device=None`` means the CUDA card.  A machine without one raises — the
port never moves to the CPU on its own; a CPU run is asked for by name
(``device="cpu"``), which is what the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested (device=None means cuda) but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "explicitly for a CPU run")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
