"""The port's transports: byte-exact delivery, striping, and the wire
shared with the JAX package.

- inmem and TCP deliver control messages and layer bytes byte-exact, and
  a LayerMsg past the 8 MiB stripe threshold rides several stripes;
- a JAX ``TcpTransport`` and a port one exchange every message type and
  a striped layer, both ways;
- with ``xxhash`` hidden on the port's side (a host without the
  extension), its frames carry crc32 checksums and its digests are
  blake2b-128, and both verify across the two packages; an xxh3 stamp
  stays unverifiable (advisory) on such a host and an xxh3 hash raises.
"""

import json
import queue

import pytest

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.transport import messages as jmsg
from distributed_llm_dissemination_tpu.transport import tcp as jtcp
from distributed_llm_dissemination_tpu.utils import integrity as jint
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.transport import inmem as tinmem
from distributed_llm_dissemination_tpu_torch.transport import messages as tmsg
from distributed_llm_dissemination_tpu_torch.transport import tcp as ttcp
from distributed_llm_dissemination_tpu_torch.utils import integrity as tint
from distributed_llm_dissemination_tpu_torch.utils import telemetry

from test_torch_messages import CASES, JAX, PORT

RECV_TIMEOUT = 10.0
STRIPED = 9 << 20  # past the transports' 8 MiB stripe threshold


@pytest.fixture(autouse=True)
def _clean():
    tinmem.reset_registry()
    telemetry.reset_run()
    yield
    tinmem.reset_registry()


def _payload(n: int, salt: int = 0) -> bytes:
    return bytes((i * 7 + salt) & 0xFF for i in range(256)) * (n // 256) \
        + bytes(n % 256)


def _layer(t, data: bytes):
    return t.LayerSrc(inmem_data=bytearray(data), data_size=len(data),
                      meta=t.LayerMeta(location=t.LayerLocation.INMEM))


def _pair(a_cls, b_cls):
    """Two TCP transports (possibly of different packages) that know each
    other as nodes 0 and 1; ephemeral ports."""
    a, b = a_cls("127.0.0.1:0"), b_cls("127.0.0.1:0")
    reg = {0: a.get_address(), 1: b.get_address()}
    a.addr_registry.update(reg)
    b.addr_registry.update(reg)
    return a, b


def _make(kind):
    if kind == "inmem":
        reg = {0: "n0", 1: "n1"}
        return (tinmem.InmemTransport("n0", addr_registry=reg),
                tinmem.InmemTransport("n1", addr_registry=reg))
    return _pair(ttcp.TcpTransport, ttcp.TcpTransport)


def _wire(msg) -> bytes:
    return json.dumps(msg.to_payload()).encode()


def _spy_stripes(transport):
    seen = []
    orig = transport._receive_stripe

    def spy(conn, envelope, header):
        seen.append((header.stripe_idx, header.stripe_n))
        return orig(conn, envelope, header)

    transport._receive_stripe = spy
    return seen


@pytest.mark.timeout(60)
@pytest.mark.parametrize("kind", ["inmem", "tcp"])
def test_port_transport_delivers_messages_and_layers_byte_exact(kind):
    a, b = _make(kind)
    try:
        for name in ("ANNOUNCE", "ACK", "LAYER_DIGESTS", "GENERATE_REQ"):
            msg = CASES[name](PORT)
            a.send(1, msg)
            assert _wire(b.deliver().get(timeout=RECV_TIMEOUT)) == _wire(msg)
        data = _payload(1 << 20, 3)
        a.send(1, tmsg.LayerMsg(0, 7, _layer(ttypes, data), len(data)))
        got = b.deliver().get(timeout=RECV_TIMEOUT)
        assert isinstance(got, tmsg.LayerMsg) and got.layer_id == 7
        assert bytes(got.layer_src.inmem_data) == data
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(60)
def test_port_tcp_stripes_a_layer_past_the_threshold():
    a, b = _pair(ttcp.TcpTransport, ttcp.TcpTransport)
    try:
        seen = _spy_stripes(b)
        data = _payload(STRIPED, 5)
        a.send(1, tmsg.LayerMsg(0, 9, _layer(ttypes, data), len(data)))
        got = b.deliver().get(timeout=RECV_TIMEOUT)
        assert bytes(got.layer_src.inmem_data) == data
        assert got.total_size == len(data) and got.layer_src.offset == 0
        assert len(seen) == ttcp.STRIPE_COUNT > 1
        assert sorted(i for i, _ in seen) == list(range(ttcp.STRIPE_COUNT))
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(120)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mixed_tcp_pair_exchanges_every_message_and_a_striped_layer(
        direction):
    if direction == "jax_to_port":
        src_cls, dst_cls, src_ns, t_src = (jtcp.TcpTransport,
                                           ttcp.TcpTransport, JAX, jtypes)
        src_layer_msg = jmsg.LayerMsg
    else:
        src_cls, dst_cls, src_ns, t_src = (ttcp.TcpTransport,
                                           jtcp.TcpTransport, PORT, ttypes)
        src_layer_msg = tmsg.LayerMsg
    a, b = _pair(src_cls, dst_cls)
    try:
        for name in sorted(CASES):
            msg = CASES[name](src_ns)
            a.send(1, msg)
            got = b.deliver().get(timeout=RECV_TIMEOUT)
            assert type(got).__name__ == type(msg).__name__, name
            assert _wire(got) == _wire(msg), name
        seen = _spy_stripes(b)
        data = _payload(STRIPED, 11)
        a.send(1, src_layer_msg(0, 3, _layer(t_src, data), len(data)))
        got = b.deliver().get(timeout=RECV_TIMEOUT)
        assert bytes(got.layer_src.inmem_data) == data
        assert len(seen) > 1
    finally:
        a.close()
        b.close()


@pytest.fixture
def port_without_xxhash(monkeypatch):
    """The port's integrity module as on a host without ``xxhash``."""
    monkeypatch.setattr(tint, "_xxhash", None)
    return tint


def _corrupt_first_frame(receiver):
    """Flip one byte of the first frame the receiver reads (below its
    checksum check) and collect the drop reports."""
    reports: "queue.Queue" = queue.Queue()
    state = {"done": False}

    def tamper(info, view):
        if not state["done"]:
            state["done"] = True
            view[0] = view[0] ^ 0xFF
        return True

    receiver.recv_tamper = tamper
    receiver.on_corrupt = lambda *args: reports.put(args)
    return reports


def test_xxhash_less_port_stamps_crc32_frames_and_blake2b_digests(
        port_without_xxhash):
    data = _payload(1 << 16, 1)
    assert tint.fragment_checksum(data)[0] == "crc32"
    assert tint.digest_algo() == "blake2b"
    with pytest.raises(ValueError, match="xxhash"):
        tint.layer_digest(data, algo="xxh3")
    # An xxh3 stamp is advisory where it cannot be computed.
    assert tint.digest_check(data, "xxh3:" + "0" * 32)[0] is None
    # blake2b digests verify across the packages, both ways.
    port_digest = tint.layer_digest(data)
    assert jint.digest_check(data, port_digest)[0] is True
    jax_blake = jint.layer_digest(data, algo="blake2b")
    assert jax_blake == port_digest
    assert tint.digest_check(data, jax_blake)[0] is True
    assert tint.digest_check(data[:-1] + b"\x00", jax_blake)[0] is False


@pytest.mark.timeout(60)
def test_xxhash_less_port_frames_verify_at_a_jax_receiver(
        port_without_xxhash):
    """A port sender without xxhash stamps crc32 frames; the JAX receiver
    verifies them: an intact frame is delivered, a corrupted one is
    dropped with reason "crc"."""
    a, b = _pair(ttcp.TcpTransport, jtcp.TcpTransport)
    try:
        data = _payload(1 << 20, 2)
        a.send(1, tmsg.LayerMsg(0, 4, _layer(ttypes, data), len(data)))
        got = b.deliver().get(timeout=RECV_TIMEOUT)
        assert bytes(got.layer_src.inmem_data) == data
        reports = _corrupt_first_frame(b)
        a.send(1, tmsg.LayerMsg(0, 5, _layer(ttypes, data), len(data)))
        src, layer, *_, reason = reports.get(timeout=RECV_TIMEOUT)
        assert (src, layer, reason) == (0, 5, "crc")
    finally:
        a.close()
        b.close()


@pytest.mark.timeout(60)
def test_crc32_frames_from_jax_verify_at_an_xxhash_less_port_receiver(
        port_without_xxhash, monkeypatch):
    """The reverse: a JAX sender that also lacks xxhash stamps crc32
    frames; the port receiver verifies them, and an xxh3-stamped frame
    (a JAX sender with xxhash) is delivered as unverifiable, not
    dropped."""
    a, b = _pair(jtcp.TcpTransport, ttcp.TcpTransport)
    try:
        data = _payload(1 << 20, 4)
        a.send(1, jmsg.LayerMsg(0, 6, _layer(jtypes, data), len(data)))
        got = b.deliver().get(timeout=RECV_TIMEOUT)
        assert bytes(got.layer_src.inmem_data) == data  # xxh3: advisory
        monkeypatch.setattr(jint, "_xxhash", None)
        a.send(1, jmsg.LayerMsg(0, 7, _layer(jtypes, data), len(data)))
        got = b.deliver().get(timeout=RECV_TIMEOUT)
        assert bytes(got.layer_src.inmem_data) == data
        reports = _corrupt_first_frame(b)
        a.send(1, jmsg.LayerMsg(0, 8, _layer(jtypes, data), len(data)))
        src, layer, *_, reason = reports.get(timeout=RECV_TIMEOUT)
        assert (src, layer, reason) == (0, 8, "crc")
    finally:
        a.close()
        b.close()


def test_idle_pool_worker_releases_its_last_task():
    """A data-plane worker that went idle holds no reference to the task
    it ran last: a finished transfer's bound method would otherwise keep
    its transport, the receiver behind the sink and the receiver's device
    tensors alive after every node closed."""
    import gc
    import time
    import weakref

    from distributed_llm_dissemination_tpu_torch.utils import threads

    class Payload:
        pass

    pool = threads.WorkerPool(1, "test-release")
    held = Payload()
    ref = weakref.ref(held)
    assert pool.submit(lambda obj: None, held).wait(RECV_TIMEOUT)
    del held
    deadline = time.monotonic() + RECV_TIMEOUT
    while ref() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert ref() is None
