"""Transport abstraction: the two-plane communication backend contract.

Mirrors the reference's ``Transport`` interface
(``distributor/transport.go:18-25``): ``send``,
``broadcast``, ``deliver``, ``register_pipe``, ``get_address``, ``close``.
Concrete backends: in-process fake (tests), TCP (host/DCN data plane), and
the device plane in ``parallel/`` which moves layer bytes over ICI as XLA
collectives instead of sockets.
"""

from __future__ import annotations

import abc
import queue
from typing import Dict

from ..core.types import LayerID, NodeID
from .messages import Message

# NodeID -> dialable address (transport.go:57).
AddrRegistry = Dict[NodeID, str]


class Transport(abc.ABC):
    """Abstract send/broadcast/deliver/pipe/close."""

    @abc.abstractmethod
    def send(self, dest_id: NodeID, message: Message) -> None:
        """Deliver ``message`` to ``dest_id``; raises on failure."""

    @abc.abstractmethod
    def broadcast(self, message: Message) -> None:
        """Send to every registered peer (best-effort, errors logged)."""

    @abc.abstractmethod
    def register_pipe(self, layer_id: LayerID, dest_id: NodeID) -> None:
        """Arrange for the next incoming copy of ``layer_id`` to be relayed
        cut-through to ``dest_id`` while being received
        (transport.go:144-196, 427-436)."""

    @abc.abstractmethod
    def deliver(self) -> "queue.Queue[Message]":
        """The incoming-message queue (the Go ``Deliver()`` channel)."""

    @abc.abstractmethod
    def get_address(self) -> str: ...

    @abc.abstractmethod
    def close(self) -> None: ...
