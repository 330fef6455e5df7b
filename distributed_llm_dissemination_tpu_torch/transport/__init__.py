from .base import AddrRegistry, Transport  # noqa: F401
from .faults import FaultRule, FaultyTransport, rules_from_spec  # noqa: F401
from .inmem import InmemTransport, reset_registry  # noqa: F401
from .messages import (  # noqa: F401
    AckMsg,
    AnnounceMsg,
    ClientReqMsg,
    FlowRetransmitMsg,
    LayerDigestsMsg,
    LayerHeader,
    LayerMsg,
    LayerNackMsg,
    Message,
    MsgType,
    RetransmitMsg,
    SimpleMsg,
    StartupMsg,
    decode_msg,
    src_of,
)
from .tcp import TcpTransport  # noqa: F401
