"""Port parity: fragment ingest, reassembly and the host->device mover.

``ShardedLayerIngest`` must be byte-exact under forward, reverse,
shuffled, duplicated and concurrent fragment writes on both arms (the
CPU host-accumulate arm, and the device-tensor arm that CUDA uses, run
here on the CPU with ``stream=True``); ``salvage`` must return exactly
the committed ranges.  The integer tilings and the reassembly helpers
are compared with the JAX package's on the same inputs: exact.
"""

import random
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.ops import reassembly as jre
from distributed_llm_dissemination_tpu_torch.core.types import (
    LayerLocation, LayerMeta, LayerSrc)
from distributed_llm_dissemination_tpu_torch.ops import reassembly as tre
from distributed_llm_dissemination_tpu_torch.parallel import ingest as ting
from distributed_llm_dissemination_tpu_torch.parallel.mover import (
    WeightMover, array_to_bytes, bytes_to_array)
from distributed_llm_dissemination_tpu_torch.utils import hostmem

ARMS = [False, True]  # stream=False: CPU host-accumulate; True: tensor arm


def _payload(n, seed=0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _frags(n, parts, seed=0):
    return [(o, s) for o, s in tre.split_offsets(n, parts) if s]


def _orders(frags, order):
    if order == "forward":
        return list(frags)
    if order == "reverse":
        return list(reversed(frags))
    rnd = random.Random(1)
    out = list(frags)
    rnd.shuffle(out)
    if order == "duplicate":
        out += out[:3]
        # ...and overlapping ranges straddling fragment edges.
        out += [(frags[1][0] - 5, 17), (frags[-1][0] - 3, 9)]
    return out


@pytest.mark.parametrize("stream", ARMS)
@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled",
                                   "duplicate"])
def test_fragment_orders_byte_exact(stream, order):
    data = _payload(100_003)
    ing = ting.ShardedLayerIngest(len(data), ["cpu"], stream=stream)
    for off, size in _orders(_frags(len(data), 8), order):
        ing.write(off, memoryview(data)[off : off + size])
    out = ing.finalize(timeout=5)
    assert out.dtype == torch.uint8 and out.dim() == 1
    assert out.numpy().tobytes() == data


@pytest.mark.parametrize("stream", ARMS)
def test_concurrent_overlapping_writes_byte_exact(stream):
    data = _payload(1 << 20, seed=2)
    ing = ting.ShardedLayerIngest(len(data), ["cpu"], stream=stream)
    frags = _frags(len(data), 64)
    # Every fragment twice plus overlapping spans, across 8 threads.
    work = frags + frags + [(o + s // 2, s) for o, s in frags[:-1]]
    random.Random(3).shuffle(work)
    errors = []

    def writer(items):
        try:
            for off, size in items:
                ing.write(off, data[off : off + size])
        except Exception as e:  # noqa: BLE001 -- surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer, args=(work[i::8],))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert ing.finalize(timeout=5).numpy().tobytes() == data


@pytest.mark.parametrize("stream", ARMS)
def test_salvage_returns_exactly_committed_ranges(stream):
    data = _payload(10_000, seed=4)
    ing = ting.ShardedLayerIngest(len(data), ["cpu"], stream=stream)
    for off, size in [(0, 1000), (500, 1000), (4000, 10), (9990, 10)]:
        ing.write(off, data[off : off + size])
    got = ing.salvage()
    assert [(o, len(b)) for o, b in got] == [(0, 1500), (4000, 10),
                                             (9990, 10)]
    for off, b in got:
        assert b == data[off : off + len(b)]
    # salvage closes the ingest: a late write is a no-op.
    ing.write(2000, data[2000:2100])
    assert [o for o, _ in ing.salvage()] == [0, 4000, 9990]


def test_failed_write_rolls_back_its_claim(monkeypatch):
    data = _payload(4096, seed=5)
    ing = ting.ShardedLayerIngest(len(data), ["cpu"], stream=True)
    ing.write(0, data[:1024])

    def boom(dst, src):
        raise OSError("injected copy failure")

    monkeypatch.setattr(ing._mover, "copy_to", boom)
    with pytest.raises(OSError):
        ing.write(1024, data[1024:2048])
    with pytest.raises(RuntimeError, match="ingest failed"):
        ing.finalize(timeout=1)
    assert [(o, len(b)) for o, b in ing.salvage()] == [(0, 1024)]


@pytest.mark.parametrize("stream", ARMS)
def test_write_into_a_failed_ingest_is_a_no_op(stream, monkeypatch):
    """A demoted layer poisons its ingest (``fail``); a straggling
    fragment then queues no copy into buffers nobody reads and claims no
    coverage."""
    data = _payload(4096, seed=6)
    ing = ting.ShardedLayerIngest(len(data), ["cpu"], stream=stream)
    ing.write(0, data[:1024])
    ing.fail()
    copies = []
    if stream:
        monkeypatch.setattr(ing._mover, "copy_to",
                            lambda dst, src: copies.append(len(src)))
    ing.write(1024, data[1024:])
    assert copies == []
    with pytest.raises(RuntimeError, match="ingest failed"):
        ing.finalize(timeout=1)
    assert [(o, len(b)) for o, b in ing.salvage()] == [(0, 1024)]


def test_incomplete_finalize_raises():
    ing = ting.ShardedLayerIngest(100, ["cpu"])
    ing.write(0, b"x" * 50)
    with pytest.raises(RuntimeError, match="50/100"):
        ing.finalize(timeout=0.05)


def test_shared_host_buffer_adopted_zero_copy():
    data = _payload(4096, seed=6)
    buf = hostmem.aligned_empty(len(data))
    ing = ting.ShardedLayerIngest(len(data), ["cpu"])
    assert ing.share_host_buffer(buf)
    hostmem.copy_into(buf, 0, data)
    ing.mark(0, 2048)
    ing.mark(2048, 4096)
    out = ing.finalize(timeout=1)
    assert out.data_ptr() == buf.ctypes.data
    assert out.numpy().tobytes() == data
    # The tensor arm never adopts a caller's buffer.
    assert not ting.ShardedLayerIngest(4096, ["cpu"],
                                       stream=True).share_host_buffer(buf)


def test_device_fragments_land_byte_exact():
    data = _payload(5000, seed=7)
    src = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    for stream in ARMS:
        ing = ting.ShardedLayerIngest(len(data), ["cpu"], stream=stream)
        ing.write(2500, src[2500:])
        ing.write(0, src[:2600])
        assert ing.finalize(timeout=1).numpy().tobytes() == data


def test_finalize_many_and_ingest_bytes():
    blobs = [_payload(3000 + i, seed=i) for i in range(3)]
    ings = []
    for b in blobs:
        ing = ting.ShardedLayerIngest(len(b), ["cpu"], stream=True)
        ing.write(0, b)
        ings.append(ing)
    outs = ting.finalize_many(ings, timeout=1)
    assert [o.numpy().tobytes() for o in outs] == blobs
    one = ting.ingest_bytes(blobs[0], ["cpu"])
    assert one.numpy().tobytes() == blobs[0]
    assert one.data_ptr() % hostmem.ALIGN == 0


def test_multi_device_ingest_waits_for_fabric_slice():
    """A device list longer than one is a stage of slots now: the layer is
    tiled over them and gathered, held by every slot."""
    data = _payload(100, seed=9)
    for stream in ARMS:
        ing = ting.ShardedLayerIngest(100, ["cpu", "cpu"], stream=stream)
        assert ing.spans == [(0, 50), (50, 50)]
        ing.write(0, data)
        out = ing.finalize(timeout=1)
        assert out.numpy().tobytes() == data
        assert [s.index for s in sorted(out.devices(),
                                        key=lambda s: s.index)] == [0, 1]


def test_hbm_headroom_unknown_on_cpu():
    assert ting.hbm_headroom_bytes("cpu") is None


def test_hbm_headroom_counts_the_allocator_cache(monkeypatch):
    """Blocks torch's caching allocator keeps reserved after a free are
    the process's to allocate again: ``mem_get_info`` counts them as
    used, the probe does not (the JAX package's ``limit - in_use``)."""
    gb = 10 ** 9
    card = torch.device("cuda", 0)
    monkeypatch.setattr(ting, "resolve_device", lambda device=None: card)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (2 * gb, 80 * gb))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 30 * gb)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 20 * gb)
    assert ting.hbm_headroom_bytes() == 12 * gb
    # Nothing cached: the card's free bytes alone.
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: 30 * gb)
    assert ting.hbm_headroom_bytes(card) == 2 * gb


@pytest.mark.parametrize("total,parts,min_size", [
    (0, 4, 1), (1, 4, 1), (10, 3, 1), (100, 7, 1), (1 << 20, 4, 1 << 18),
    (1000, 8, 300), (436_224_000, 8, 1), (17, 17, 1), (5, 8, 1),
])
def test_split_and_stripe_offsets_match_jax(total, parts, min_size):
    assert list(tre.split_offsets(total, parts)) == list(
        jre.split_offsets(total, parts))
    assert tre.stripe_offsets(total, parts, min_size) == jre.stripe_offsets(
        total, parts, min_size)


def test_assemble_fragments_matches_jax():
    rng = np.random.default_rng(8)
    vals = rng.standard_normal(1000).astype(np.float32)
    cuts = [0, 137, 500, 501, 1000]
    frags = [(a, vals[a:b]) for a, b in zip(cuts, cuts[1:])][::-1]
    want = np.asarray(jre.assemble_fragments(
        1000, [(o, jnp.asarray(f)) for o, f in frags], dtype=jnp.float32))
    got = tre.assemble_fragments(
        1000, [(o, torch.from_numpy(f)) for o, f in frags],
        dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    buf = tre.alloc_layer_buffer(8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tre.write_fragment(buf, torch.ones(4), 6)


def test_weight_mover_stages_layers_on_cpu():
    mover = WeightMover("cpu")
    layers = {i: LayerSrc(inmem_data=bytearray(_payload(1000 + i, seed=i)),
                          data_size=1000 + i) for i in range(3)}
    results = mover.stage_layers(layers)
    assert [r.layer_id for r in results] == [0, 1, 2]
    for i, src in layers.items():
        assert src.meta.location == LayerLocation.HBM
        assert array_to_bytes(src.device_array) == bytes(src.inmem_data)
    assert mover.throughput_gbps(results) > 0
    one = LayerSrc(inmem_data=bytearray(b"abcd"), data_size=4,
                   meta=LayerMeta())
    assert array_to_bytes(mover.stage(one)) == b"abcd"
    padded = bytes_to_array(b"abc", torch.bfloat16)
    assert padded.numel() == 2 and array_to_bytes(padded) == b"abc\x00"
