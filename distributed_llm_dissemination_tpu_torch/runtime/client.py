"""External clients: the weight source, and the inference requester.

``Client`` is a re-design of ``distributor/client.go``: a
separate process holding layers (stand-in for S3/GCS/blob store) attached
to one node.  On a ``ClientReqMsg`` it streams the requested layer to its
node at the configured rate; the node's registered pipe relays it onward
cut-through.

``GenRequester`` is the client role's natural next step, beyond the
reference: once dissemination booted the engine, the same transport
serves inference — send prompt token ids to a booted node, get the
decoded ids back (``runtime/receiver.handle_generate_req``).
"""

from __future__ import annotations

import itertools
import queue
import threading

from ..core.types import CLIENT_ID, LayersSrc, NodeID  # noqa: F401  (CLIENT_ID re-exported)
from ..transport.base import Transport
from ..transport.messages import (
    ClientReqMsg,
    GenerateReqMsg,
    GenerateRespMsg,
    LayerMsg,
)
from ..utils.logging import log
from .node import MessageLoop


class Client:
    """Serves layers to its attached node on request (client.go:12-63)."""

    def __init__(self, node_id: NodeID, transport: Transport, layers: LayersSrc,
                 start_loop: bool = True):
        self.node_id = node_id  # the node this client is attached to
        self.transport = transport
        self.layers = layers
        self.loop = MessageLoop(transport)
        self.loop.register(ClientReqMsg, self.handle_client_req)
        if start_loop:
            self.loop.start()

    def handle_client_req(self, msg: ClientReqMsg) -> None:
        layer = self.layers.get(msg.layer_id)
        if layer is None:
            log.error("client has no such layer", layerID=msg.layer_id)
            return
        log.debug("sending layer", layerID=msg.layer_id)
        try:
            self.transport.send(
                self.node_id,
                LayerMsg(CLIENT_ID, msg.layer_id, layer, layer.data_size),
            )
        except (OSError, KeyError) as e:
            log.error("failed to send layer", dest=self.node_id, err=repr(e))

    def close(self) -> None:
        self.loop.stop()


class GenRequester:
    """Request inference from a booted node over the dissemination
    transport and block for the answer.

    ``my_id``: the id replies are addressed to — it must resolve on the
    serving node's transport (a topology node id, or the client role's
    id; defaults to ``int(transport.addr)`` when the addr is numeric,
    the in-process test convention).  Thread-safe: concurrent requests
    multiplex on ``req_id``."""

    def __init__(self, transport: Transport, my_id: NodeID = None,
                 start_loop: bool = True):
        if my_id is None:
            addr = getattr(transport, "addr", "")
            if not str(addr).isdigit():
                raise ValueError(
                    "my_id is required when the transport address is not "
                    "a bare node id")
            my_id = int(addr)
        self.my_id = my_id
        self.transport = transport
        self.loop = MessageLoop(transport)
        self.loop.register(GenerateRespMsg, self._handle_resp)
        self._lock = threading.Lock()
        self._pending: dict = {}  # req_id -> Queue[GenerateRespMsg]
        self._req_ids = itertools.count(1)
        if start_loop:
            self.loop.start()

    def _handle_resp(self, msg: GenerateRespMsg) -> None:
        with self._lock:
            q = self._pending.get(msg.req_id)
        if q is None:
            log.warn("response for unknown/expired request",
                     req=msg.req_id, server=msg.src_id)
            return
        q.put(msg)

    def request(self, dest: NodeID, prompt, max_new: int,
                timeout: float = 120.0, temperature: float = 0.0,
                seed: int = 0) -> list:
        """Decode ``max_new`` tokens after ``prompt`` on node ``dest``.
        ``temperature`` 0 = greedy; > 0 samples with ``seed`` (same seed,
        same tokens).  Returns the new token ids; raises RuntimeError on
        a served error and TimeoutError when no answer arrives (lost
        message / dead node)."""
        req_id = next(self._req_ids)
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            self._pending[req_id] = q
        try:
            self.transport.send(
                dest,
                GenerateReqMsg(self.my_id, req_id, list(prompt),
                               int(max_new), float(temperature),
                               int(seed)),
            )
            try:
                resp = q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no generation response from node {dest} within "
                    f"{timeout:g}s") from None
            if resp.error:
                raise RuntimeError(
                    f"node {dest} refused generation: {resp.error}")
            return list(resp.tokens)
        finally:
            with self._lock:
                self._pending.pop(req_id, None)

    def close(self) -> None:
        self.loop.stop()
