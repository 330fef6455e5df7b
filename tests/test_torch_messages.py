"""Wire identity of the port's control-plane messages with the JAX package.

For every message type of the JAX package's ``transport/messages._DECODERS``
(the cases of ``tests/test_messages_compat.py``, one parametrised case per
type) and for decorated instances that carry the optional fields:

- a message the JAX package encodes decodes in the port and re-encodes to
  the same bytes (the JSON payload as the transports frame it);
- a message the port encodes decodes in the JAX package and re-encodes to
  the same bytes.

So a JAX node and a port node can share one cluster over TCP.
"""

import json
import types

import pytest

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.transport import messages as jmsg
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.transport import messages as tmsg

JAX = types.SimpleNamespace(**vars(jmsg), LayerMeta=jtypes.LayerMeta)
PORT = types.SimpleNamespace(**vars(tmsg), LayerMeta=ttypes.LayerMeta)

# One minimal instance per wire message (only required constructor
# arguments), built from either package's classes: the cases of
# tests/test_messages_compat.py.
CASES = {
    "ANNOUNCE": lambda m: m.AnnounceMsg(1, {7: m.LayerMeta()}),
    "ACK": lambda m: m.AckMsg(1, 7),
    "RETRANSMIT": lambda m: m.RetransmitMsg(1, 7, 2),
    "FLOW_RETRANSMIT": lambda m: m.FlowRetransmitMsg(1, 7, 2, 64, 0, 1000),
    "CLIENT_REQ": lambda m: m.ClientReqMsg(1, 7),
    "STARTUP": lambda m: m.StartupMsg(1),
    "SIMPLE": lambda m: m.SimpleMsg("a", "b"),
    "HEARTBEAT": lambda m: m.HeartbeatMsg(1),
    "BOOT_READY": lambda m: m.BootReadyMsg(1),
    "DEVICE_PLAN": lambda m: m.DevicePlanMsg(1, "p", 7, 2, 64, [(1, 0, 64)]),
    "SERVE": lambda m: m.ServeMsg(1, [2, 3]),
    "BOOT_HINT": lambda m: m.BootHintMsg(1, [7]),
    "GENERATE_REQ": lambda m: m.GenerateReqMsg(1, 5, [1, 2], 4),
    "GENERATE_RESP": lambda m: m.GenerateRespMsg(1, 5),
    "PLAN_RESEND_REQ": lambda m: m.PlanResendReqMsg(1, [3, 4]),
    "LAYER_NACK": lambda m: m.LayerNackMsg(1, 7, 0, 64),
    "LAYER_DIGESTS": lambda m: m.LayerDigestsMsg(1, {7: "xxh3:ab"}),
    "LEADER_LEASE": lambda m: m.LeaderLeaseMsg(1, 3),
    "CONTROL_DELTA": lambda m: m.ControlDeltaMsg(1, 3, 0, "status"),
    "SOURCE_DEAD": lambda m: m.SourceDeadMsg(1, 7, 2, 3),
    "METRICS_REPORT": lambda m: m.MetricsReportMsg(1),
    "TIME_SYNC": lambda m: m.TimeSyncMsg(1, 123.0),
    "JOB_SUBMIT": lambda m: m.JobSubmitMsg(1, "j1", {2: {7: m.LayerMeta()}}),
    "JOB_STATUS": lambda m: m.JobStatusMsg(1),
    "SWAP_COMMIT": lambda m: m.SwapCommitMsg(1, "v2"),
    "JOB_REVOKE": lambda m: m.JobRevokeMsg(1, "j1"),
    "GROUP_PLAN": lambda m: m.GroupPlanMsg(1, 2),
    "GROUP_STATUS": lambda m: m.GroupStatusMsg(1, 2),
    "JOIN": lambda m: m.JoinMsg(9),
    "DRAIN": lambda m: m.DrainMsg(9),
    "ROLLOUT_CTL": lambda m: m.RolloutCtlMsg(9),
    "POLICY_CTL": lambda m: m.PolicyCtlMsg(9),
}

# Instances with their optional fields set: what a mode-3 round, a swap,
# a rollout and the telemetry plane put on the wire.
DELTA = "delta:" + "ab" * 16
DECORATED = [
    lambda m: m.AnnounceMsg(1, {7: m.LayerMeta(data_size=64, shard="1/4@1")},
                            partial={8: [[0, 32]]}, digests={7: "xxh3:ab"},
                            codecs=["int8", "delta"], nic_bw=250 * 10 ** 6),
    lambda m: m.AckMsg(2, 7, shard="1/4@1", version="v2", codec="int8",
                       span_id="2.7"),
    lambda m: m.RetransmitMsg(1, 7, 2, shard="1/2@0", codec="int4"),
    lambda m: m.FlowRetransmitMsg(1, 7, 2, 64, 0, 1000, codec=DELTA),
    lambda m: m.LayerNackMsg(1, 7, 0, 64, codec="int4e"),
    lambda m: m.LayerDigestsMsg(1, {7: "xxh3:ab", 8: "0123"},
                                shards={7: "1/4@1"},
                                range_digests={7: "xxh3:cd"},
                                versions={8: "v2"}, codecs={7: DELTA},
                                full_digests={7: "xxh3:ff"}, pods={7: 4}),
    lambda m: m.DevicePlanMsg(1, "pod.7.0", 7, 2, 64,
                              [(2, 0, 32), (3, 32, 32)], seq=5, pod=[2, 3]),
    lambda m: m.JobSubmitMsg(1, "canary-v2", {2: {7: m.LayerMeta()}},
                             kind="rollout", version="v2", swap_base=1000,
                             waves=[[2], [3, 4]],
                             slo={"P99Ms": 500.0, "MaxFailures": 0,
                                  "SoakS": 2.0}, split=0.25, auth="s"),
    lambda m: m.SwapCommitMsg(1, "v2", swap_base=1000, prepare=True),
    lambda m: m.SwapCommitMsg(1, "v2#w1", abort=True, revert=True,
                              error="boom"),
    lambda m: m.JobRevokeMsg(1, "j-lo", pairs=[[2, 7], [3, 8]], epoch=4),
    lambda m: m.MetricsReportMsg(1, hists={
        "serve.latency_ms.n1": {"buckets": [0, 1, 2], "sum_ms": 9.5,
                                "n": 3}},
        spans=[{"span": "2.7", "phase": "acked", "t_ms": 123.0, "node": 0}]),
    lambda m: m.GroupPlanMsg(1, 2, targets={3: {7: m.LayerMeta()}},
                             forward={7: [[0, 64, 4]]}, epoch=5),
    lambda m: m.GroupStatusMsg(1, 2, covered={7: [3, 4]},
                               digests={3: {7: "xxh3:ab"}},
                               codecs={3: ["int8"]}),
    lambda m: m.RolloutCtlMsg(0, rollout_id="canary-v2", table={
        "canary-v2": {"State": "running", "WaveStates": ["passed"]}},
        epoch=3),
    lambda m: m.GenerateReqMsg(3, 9, list(range(128)), 32, 0.7, 11),
    lambda m: m.GenerateRespMsg(2, 9, [5, 6, 7]),
    lambda m: m.BootReadyMsg(2, 0.25, "full"),
]


def _wire(msg) -> bytes:
    """The bytes a transport frames for ``msg``'s payload."""
    return json.dumps(msg.to_payload()).encode()


def _cross(msg, into) -> bytes:
    """Decode ``msg``'s wire payload with the ``into`` package's decoder
    and re-encode it."""
    kind = into.MsgType[msg.msg_type.name]
    back = into.decode_msg(kind, json.loads(_wire(msg)))
    assert type(back).__name__ == type(msg).__name__
    return _wire(back)


def test_port_decoders_cover_the_same_message_types():
    assert ({k.name: k.value for k in tmsg._DECODERS}
            == {k.name: k.value for k in jmsg._DECODERS})
    assert set(CASES) == {k.name for k in jmsg._DECODERS}


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_message_type_crosses_both_ways_byte_identical(name):
    jax_msg, port_msg = CASES[name](JAX), CASES[name](PORT)
    assert _wire(jax_msg) == _wire(port_msg)
    assert _cross(jax_msg, PORT) == _wire(jax_msg)
    assert _cross(port_msg, JAX) == _wire(port_msg)


@pytest.mark.parametrize("i", range(len(DECORATED)))
def test_decorated_messages_cross_both_ways_byte_identical(i):
    jax_msg, port_msg = DECORATED[i](JAX), DECORATED[i](PORT)
    assert _wire(jax_msg) == _wire(port_msg)
    assert _cross(jax_msg, PORT) == _wire(jax_msg)
    assert _cross(port_msg, JAX) == _wire(port_msg)


@pytest.mark.parametrize("fields", [
    {},
    {"stripe_idx": 1, "stripe_n": 2, "stripe_off": 16, "stripe_span": 64,
     "stripe_tid": "t1", "crc": 99, "job_id": "v2-push", "shard": "1/4@2",
     "codec": DELTA, "span_id": "2.7", "span_parent": "1.7"},
], ids=["legacy", "decorated"])
def test_layer_header_crosses_both_ways_byte_identical(fields):
    """The data-plane preamble of every layer frame."""
    jh = jmsg.LayerHeader(1, 7, 64, 128, 32, **fields)
    th = tmsg.LayerHeader(1, 7, 64, 128, 32, **fields)
    jwire = json.dumps(jh.to_payload()).encode()
    assert json.dumps(th.to_payload()).encode() == jwire
    back = tmsg.LayerHeader.from_payload(json.loads(jwire))
    assert json.dumps(back.to_payload()).encode() == jwire
    again = jmsg.LayerHeader.from_payload(json.loads(jwire))
    assert again == jh
