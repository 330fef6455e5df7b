"""The reader of the fabric sender's staged share (``metrics/
upload_staged_share.py``): counter ``fabric.upload_staged_bytes`` over
``fabric.upload_bytes`` a round, in %, and None where no round has the
staged counter (a program without the pinned ring's path) or a round
uploaded nothing."""

import types

import pytest

from dissem_bench import spec

STAMP_BYTES = 14_496_047_104


def _round(counters):
    return {"phases": {}, "counters": dict(counters)}


def _read(*rounds):
    return spec.metric_reader("upload_staged_share")(
        types.SimpleNamespace(rounds=list(rounds)))


def test_the_staged_bytes_over_the_uploaded_bytes_in_percent():
    assert _read(
        _round({"fabric.upload_bytes": STAMP_BYTES,
                "fabric.upload_staged_bytes": STAMP_BYTES}),
        _round({"fabric.upload_bytes": 400,
                "fabric.upload_staged_bytes": 100})) == pytest.approx(62.5)


@pytest.mark.parametrize("rounds", [
    [],
    [_round({"fabric.upload_bytes": STAMP_BYTES,
             "fabric.upload_pageable_bytes": STAMP_BYTES})],
    [_round({"fabric.upload_bytes": 0, "fabric.upload_staged_bytes": 0})],
])
def test_none_where_no_round_staged_or_uploaded(rounds):
    assert _read(*rounds) is None
