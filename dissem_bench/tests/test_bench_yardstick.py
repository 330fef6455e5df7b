"""The roofline arithmetic on known shapes, and the readers that use it."""

import types

import pytest

from dissem_bench import yardstick
from dissem_bench.metrics import k1_prefill_roofline, round_mfu
from dissem_bench.tests.conftest import DENSE, STAGED, load

MISTRAL = load(DENSE).shape
MIXTRAL = load(STAGED).shape


def test_prefill_work_at_the_forward_shape():
    flops, nbytes = yardstick.prefill_attention_work(1, 32, 8, 128, 128)
    assert flops == 4 * 32 * (128 * 129 // 2) * 128 == 135_266_304
    # q, k, v in bf16 read once; pv (f32) and m, l written once
    assert nbytes == (32 * 128 * 128 + 2 * 8 * 128 * 128) * 2 \
        + 32 * 128 * 130 * 4 == 3_702_784
    t = yardstick.least_time(flops, nbytes)
    assert t == pytest.approx(3_702_784 / 3.35e12)  # bound by bytes


def test_least_time_picks_the_larger_bound_and_scales_with_cards():
    assert yardstick.least_time(989e12, 0) == pytest.approx(1.0)
    assert yardstick.least_time(0, 3.35e12, cards=4) == pytest.approx(0.25)
    assert yardstick.least_time(989e12, 3.35e12 * 2) == pytest.approx(2.0)


def test_forward_flops_dense_and_experts():
    per_layer = (4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 14336)
    attn = 135_266_304
    head = 2 * 4096 * 32768 * 128
    assert yardstick.forward_flops(MISTRAL, 128) == \
        (2 * per_layer * 128 + attn) * 32 + head
    moe = (4096 * 4096 * 2 + 4096 * 1024 * 2 + 2 * 3 * 4096 * 14336
           + 4096 * 8)
    assert yardstick.forward_flops(MIXTRAL, 128) == \
        (2 * moe * 128 + attn) * 24 + 2 * 4096 * 32000 * 128


def test_round_least_time_is_bound_by_bytes():
    t1 = yardstick.round_least_time(MISTRAL, 128, 1, False)
    assert t1 == pytest.approx(2 * 14_496_047_104 / 3.35e12)
    t4 = yardstick.round_least_time(MIXTRAL, 128, 4, True)
    assert t4 == pytest.approx(3 * 70_185_263_104 / (3.35e12 * 4))


def _run(**kw):
    base = dict(shape=MISTRAL, tokens=128, chips=1, seeders_in_hbm=False,
                rounds=[], trace=None, window=None, cards=[0],
                probe_gbps=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_round_mfu_reader():
    rounds = [{"time_to_serve_s": 2.0}, {"time_to_serve_s": 4.0}]
    got = round_mfu.read(_run(rounds=rounds))
    assert got == pytest.approx(2 * 14_496_047_104 / 3.35e12 / 3.0 * 100)


class _Trace:
    def __init__(self, n, dur_us):
        self.n, self.dur = n, dur_us

    def span(self, name):
        return (0.0, 1e6) if name == "bench.pod_forward" else None

    def kernels(self, substr, t0, t1):
        return [{"dur": self.dur}] * self.n


def test_k1_prefill_roofline_reader():
    share = k1_prefill_roofline.read(_run(trace=_Trace(32, 10.0)))
    assert share == pytest.approx(3_702_784 / 3.35e12 / 10e-6 * 100)
    assert k1_prefill_roofline.read(_run(trace=_Trace(31, 10.0))) is None
    assert k1_prefill_roofline.read(_run()) is None
