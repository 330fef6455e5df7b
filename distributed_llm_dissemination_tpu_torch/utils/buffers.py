"""Receive-buffer allocation for the data plane.

``bytearray(n)`` zeroes its memory inside a single C call — for a
multi-hundred-MiB layer that is hundreds of milliseconds spent holding
the GIL, which starves every other thread in the node process (the
sender half of a relay, the control-plane loop) before the first byte is
even received.  ``np.empty`` returns unfaulted pages immediately; the
bytes are written exactly once by ``recv_into``/fragment writes, so the
zero-fill was pure waste.  The array supports the full buffer protocol
(slice assignment, ``memoryview``, ``bytes()``), so downstream LayerSrc
handling is unchanged.
"""

from __future__ import annotations

from . import hostmem


def alloc_recv_buffer(n: int):
    """An n-byte write-once receive buffer (unzeroed, instant).

    Aligned (``hostmem.ALIGN``) so a completed reassembly buffer is
    directly adoptable as a CPU device array — the shared-buffer ingest
    then stages the layer with ZERO additional copies."""
    return hostmem.aligned_empty(n)
