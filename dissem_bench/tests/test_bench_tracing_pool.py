"""The readers of the digest pool's phase and counter (``metrics/``) on a
synthetic run: each gives its value from the rounds' totals, and None
where a round lacks what it reads (a program that hashes every layer on
the caller's thread records no such phase or counter)."""

import pytest

from dissem_bench.tests.test_bench_tracing import (
    BEFORE, STAMP_BYTES, _read, _round, _run)


def test_digest_stamp_busy_ms_is_the_busy_phase_per_round():
    run = _run(_round({"integrity_digest_stamp_busy": 30.0,
                       "integrity_digest_stamp": 90.0}),
               _round({"integrity_digest_stamp_busy": 10.0}))
    assert _read("digest_stamp_busy_ms", run) == pytest.approx(20.0)


def test_digest_stamp_pooled_share_is_the_pooled_bytes_in_percent():
    run = _run(
        _round(counters={"integrity.digest_stamp_bytes": STAMP_BYTES,
                         "integrity.digest_stamp_pooled_bytes": STAMP_BYTES}),
        _round(counters={"integrity.digest_stamp_bytes": 400,
                         "integrity.digest_stamp_pooled_bytes": 0}))
    assert _read("digest_stamp_pooled_share", run) == pytest.approx(50.0)


# A round as a program without the digest pool records it: the stamp's
# time and bytes and the upload spans are there, the pool's are not.
BEFORE_POOL = _round({"integrity_digest_stamp": 2500.0,
                      "fabric_upload_busy": 2600.0},
                     {"integrity.digest_stamp_bytes": STAMP_BYTES,
                      "fabric.upload_bytes": STAMP_BYTES,
                      "fabric.upload_pageable_bytes": STAMP_BYTES})


@pytest.mark.parametrize("name", [
    "digest_stamp_busy_ms", "digest_stamp_pooled_share"])
def test_pool_readers_give_none_where_the_rounds_lack_what_they_read(name):
    assert _read(name, _run(BEFORE, BEFORE)) is None
    assert _read(name, _run(BEFORE_POOL, BEFORE_POOL)) is None
    assert _read(name, _run()) is None


def test_the_stamp_readers_of_before_still_read_a_round_without_the_pool():
    run = _run(BEFORE_POOL, BEFORE_POOL)
    assert _read("digest_stamp_ms", run) == pytest.approx(2500.0)
    assert _read("digest_stamp_gbps", run) == pytest.approx(
        STAMP_BYTES / 2.5e9)


def test_pooled_share_gives_none_where_a_round_hashed_nothing():
    idle = _round({"integrity_digest_stamp": 0.0},
                  {"integrity.digest_stamp_bytes": 0,
                   "integrity.digest_stamp_pooled_bytes": 0})
    assert _read("digest_stamp_pooled_share", _run(idle)) is None
