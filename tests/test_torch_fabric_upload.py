"""The fabric sender's host-to-device upload (``runtime/send.py``).

``_FabricUploadCache._upload`` is the one upload seam: pageable bytes
bound for a CUDA card cross through the card's ``WeightMover`` (one
process-wide, shared by every seeder), split into runs of whole chunks on
the digest pool; a pinned source, or the CPU, is one direct copy.  Every
path returns the source's bytes exactly, and the counters say which bytes
were pageable and which went through the ring.  The ring's path runs on
the CPU here through ``_staged_copy`` itself (a CPU mover copies each run
with one memcpy); the ``cuda`` case runs ``_upload`` on the card.
"""

import threading

import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu_torch.parallel import mover as mover_mod
from distributed_llm_dissemination_tpu_torch.runtime import send as send_mod
from distributed_llm_dissemination_tpu_torch.utils import telemetry, threads, trace

CHUNK = 4096  # the ring's chunk for the CPU cases: many chunks, small bytes


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset_run()
    yield


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(mover_mod, "CHUNK_BYTES", CHUNK)
    return CHUNK


def _pattern(n: int, salt: int = 0) -> bytearray:
    rng = np.random.default_rng(n * 7919 + salt)
    return bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())


def _sizes(chunk):
    workers = threads.digest_pool().size
    return [1, chunk, chunk + 1, 3 * chunk + 5, (2 * workers + 3) * chunk + 7]


def _host(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


@pytest.mark.parametrize("kind", ["bytes", "bytearray", "memoryview"])
@pytest.mark.parametrize("n", [1, mover_mod.CHUNK_BYTES,
                               mover_mod.CHUNK_BYTES + 1,
                               3 * mover_mod.CHUNK_BYTES + 5])
def test_upload_returns_the_source_bytes_and_counts_them(kind, n):
    """On the CPU every source is one direct copy: the bytes come back
    exactly, all of them counted uploaded and pageable, none staged."""
    src = _pattern(n + 3)
    data = {"bytes": bytes(src[:n]), "bytearray": src[:n],
            "memoryview": memoryview(src)[3 : 3 + n]}[kind]
    out = send_mod._FabricUploadCache._upload(data, "cpu")
    assert out.dtype == torch.uint8 and out.dim() == 1
    assert _host(out) == bytes(memoryview(data))
    counters = trace.counter_totals()
    assert counters["fabric.upload_bytes"] == n
    assert counters["fabric.upload_pageable_bytes"] == n
    assert "fabric.upload_staged_bytes" not in counters


def test_a_pinned_source_is_counted_neither_pageable_nor_staged(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    data = _pattern(1000)
    out = send_mod._FabricUploadCache._upload(data, "cpu")
    assert _host(out) == bytes(data)
    counters = trace.counter_totals()
    assert counters["fabric.upload_bytes"] == 1000
    assert "fabric.upload_pageable_bytes" not in counters
    assert "fabric.upload_staged_bytes" not in counters


@pytest.mark.parametrize("index", range(5))
def test_staged_copy_lands_every_byte_in_runs_of_whole_chunks(
        small_chunks, monkeypatch, index):
    """The ring's path: at most one run a pool worker, each run whole
    chunks but the last, the runs tiling the source; the bytes exact."""
    n = _sizes(small_chunks)[index]
    pool = threads.digest_pool()
    runs = []
    real_submit = pool.submit

    def spy(fn, dst, src):
        runs.append(len(src))
        return real_submit(fn, dst, src)

    monkeypatch.setattr(pool, "submit", spy)
    data = _pattern(n)
    src = torch.frombuffer(data, dtype=torch.uint8)
    out = send_mod._staged_copy(src, torch.device("cpu"))
    assert _host(out) == bytes(data)
    assert sum(runs) == n
    assert 1 <= len(runs) <= pool.size
    assert all(r % small_chunks == 0 for r in runs[:-1])


def test_one_mover_per_device():
    cpu = torch.device("cpu")
    assert send_mod._card_mover(cpu) is send_mod._card_mover(cpu)
    assert send_mod._card_mover(cpu).device == cpu


def test_two_threads_staging_at_once_are_both_byte_exact(small_chunks):
    """Two seeders' uploads through one device's mover and one pool, at
    once and many times: neither sees the other's bytes."""
    n = 37 * small_chunks + 11
    data = [_pattern(n, salt) for salt in (1, 2)]
    gate = threading.Barrier(2)
    bad = []

    def seeder(i):
        src = torch.frombuffer(data[i], dtype=torch.uint8)
        gate.wait(timeout=10)
        for _ in range(20):
            if _host(send_mod._staged_copy(src, torch.device("cpu"))) \
                    != bytes(data[i]):
                bad.append(i)

    ts = [threading.Thread(target=seeder, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert bad == []


def test_a_failed_run_fails_the_copy(small_chunks, monkeypatch):
    """A run that raises on a pool worker raises in the uploading thread
    (the upload cache then marks the layer failed), after every run
    ended."""
    mover = send_mod._card_mover(torch.device("cpu"))
    real = mover.copy_to
    n = 4 * threads.digest_pool().size * small_chunks
    src = torch.frombuffer(_pattern(n), dtype=torch.uint8)
    second = src.data_ptr() + 4 * small_chunks  # the second run's start
    seen = []

    def copy_to(dst, run):
        seen.append(len(run))
        if run.ctypes.data == second:
            raise RuntimeError("copy failed")
        real(dst, run)

    monkeypatch.setattr(mover, "copy_to", copy_to)
    with pytest.raises(RuntimeError, match="copy failed"):
        send_mod._staged_copy(src, torch.device("cpu"))
    assert sum(seen) == n


@pytest.mark.cuda
def test_pageable_uploads_cross_the_ring_on_the_card():
    """On the card: pageable and ``bytes`` sources land exactly through
    the ring and every pageable byte is counted staged; a pinned source
    lands exactly and stages nothing; two threads at once are exact; all
    of it on one mover, whose ring is pinned once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned ring has no CPU mode")
    up = send_mod._FabricUploadCache._upload
    chunk = mover_mod.CHUNK_BYTES
    total = 0
    for n in [1, chunk, chunk + 1, 3 * chunk + 5,
              (threads.digest_pool().size + 3) * chunk + 7]:
        data = _pattern(n + 1)
        view = memoryview(data)[1:]  # n bytes from an unaligned start
        assert _host(up(data[:n], "cuda")) == bytes(data[:n])
        assert _host(up(bytes(data[:n]), "cuda")) == bytes(data[:n])
        assert _host(up(view, "cuda")) == bytes(view)
        total += 3 * n
    counters = trace.counter_totals()
    assert counters["fabric.upload_pageable_bytes"] == total
    assert counters["fabric.upload_staged_bytes"] == total
    mover = send_mod._card_mover(torch.device("cuda", 0))
    ring = mover.warm()

    pinned = torch.empty(chunk + 9, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(torch.frombuffer(_pattern(chunk + 9), dtype=torch.uint8))
    assert _host(up(pinned.numpy(), "cuda")) == _host(pinned)
    after = trace.counter_totals()
    assert after["fabric.upload_bytes"] == total + chunk + 9
    assert after["fabric.upload_staged_bytes"] == total
    assert after["fabric.upload_pageable_bytes"] == total

    n = 5 * chunk + 3
    data = [_pattern(n, salt) for salt in (1, 2)]
    bad = []

    def seeder(i):
        for _ in range(4):
            if _host(up(data[i], "cuda")) != bytes(data[i]):
                bad.append(i)

    ts = [threading.Thread(target=seeder, args=(i,)) for i in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert bad == []
    assert send_mod._card_mover(torch.device("cuda", 0)) is mover
    assert mover.warm() is ring
