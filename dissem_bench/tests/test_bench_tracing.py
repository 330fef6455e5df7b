"""The readers of the port's own spans and counters (``metrics/``) on a
synthetic run: each gives its value from the rounds' phase and counter
totals, and None where a round lacks what it reads (a program that
records no such phase or counter)."""

import types

import pytest

from dissem_bench import spec

STAMP_BYTES = 14_496_047_104


def _round(phases=None, counters=None):
    return {"phases": {k: {"ms": v, "n": 1}
                       for k, v in (phases or {}).items()},
            "counters": dict(counters or {})}


def _run(*rounds):
    return types.SimpleNamespace(rounds=list(rounds))


def _read(name, run):
    return spec.metric_reader(name)(run)


def test_digest_stamp_gbps_is_bytes_over_the_stamps_time_per_round():
    run = _run(
        _round({"integrity_digest_stamp": 2500.0},
               {"integrity.digest_stamp_bytes": STAMP_BYTES}),
        _round({"integrity_digest_stamp": 2000.0},
               {"integrity.digest_stamp_bytes": 10**10}))
    want = (STAMP_BYTES / 2.5e9 + 10**10 / 2e9) / 2
    assert _read("digest_stamp_gbps", run) == pytest.approx(want)


def test_upload_pageable_share_is_the_pageable_bytes_in_percent():
    run = _run(
        _round(counters={"fabric.upload_bytes": 400,
                         "fabric.upload_pageable_bytes": 400}),
        _round(counters={"fabric.upload_bytes": 400,
                         "fabric.upload_pageable_bytes": 100}))
    assert _read("upload_pageable_share", run) == pytest.approx(62.5)


@pytest.mark.parametrize("name,phase", [
    ("upload_busy_ms", "fabric_upload_busy"),
    ("pod_start_ms", "pod_start"),
    ("pod_assemble_ms", "pod_assemble"),
])
def test_phase_readers_give_the_phase_per_round(name, phase):
    run = _run(_round({phase: 30.0, "other": 5.0}), _round({phase: 10.0}))
    assert _read(name, run) == pytest.approx(20.0)


# A round as a program without the new spans and counters records it:
# the stamp's time and the upload bytes are there, nothing else is.
BEFORE = _round({"integrity_digest_stamp": 2500.0, "fabric_upload": 9e4},
                {"fabric.upload_bytes": STAMP_BYTES})


@pytest.mark.parametrize("name", [
    "digest_stamp_gbps", "upload_busy_ms", "upload_pageable_share",
    "pod_start_ms", "pod_assemble_ms",
])
def test_readers_give_none_where_the_rounds_lack_what_they_read(name):
    assert _read(name, _run(BEFORE, BEFORE)) is None
    assert _read(name, _run()) is None


def test_rates_give_none_where_a_round_moved_nothing():
    idle = _round({"integrity_digest_stamp": 0.0},
                  {"integrity.digest_stamp_bytes": 0,
                   "fabric.upload_bytes": 0,
                   "fabric.upload_pageable_bytes": 0})
    assert _read("digest_stamp_gbps", _run(idle)) is None
    assert _read("upload_pageable_share", _run(idle)) is None
