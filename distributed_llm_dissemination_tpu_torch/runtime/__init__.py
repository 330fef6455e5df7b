from .checkpoint import LayerCheckpointStore, map_through_gaps  # noqa: F401
from .client import Client  # noqa: F401
from .failover import (  # noqa: F401
    ControlReplicator,
    ShadowLeaderState,
    StandbyController,
)
from .failure import FailureDetector, HeartbeatSender  # noqa: F401
from .leader import (  # noqa: F401
    FlowRetransmitLeaderNode,
    HierarchicalFlowLeaderNode,
    LeaderNode,
    PullRetransmitLeaderNode,
    RetransmitLeaderNode,
    assignment_satisfied,
)
from .membership import MembershipTable, MemberRecord  # noqa: F401
from .node import MessageLoop, Node  # noqa: F401
from .receiver import (  # noqa: F401
    FlowRetransmitReceiverNode,
    ReceiverNode,
    RetransmitReceiverNode,
)
from .send import fetch_from_client, handle_flow_retransmit, send_layer  # noqa: F401
from .store import ContentIndex, ContentStore  # noqa: F401
