"""Port parity: block attention (the port of the one Pallas kernel).

The port's plain version ``block_attention_ref`` is held against the JAX
package's lax oracle ``_block_attention_ref`` and against the Pallas
kernel itself, run in interpret mode on the CPU (``FORCE_PALLAS``, as
``tests/test_flash_attention.py`` does), on the same numpy-made inputs.

Tolerances: f32 inputs ``rtol=1e-5`` (both sides sum f32 products in a
different order); bf16 inputs are compared in f32 -- both upcast the bf16
values exactly, so the same ``rtol=1e-5`` holds.  The CUDA kernel itself
runs only on the card (``cuda`` marker; ``chip_smoke.py`` holds it against
the plain version at the serving shapes).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.ops import flash_attention as jfa
from distributed_llm_dissemination_tpu_torch.ops import flash_attention as tfa

OFFSETS = [(0, 0), (256, 0), (0, 256), (128, 0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; under a parallel
    test run extra threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def pallas_forced():
    prev = jfa.FORCE_PALLAS
    jfa.FORCE_PALLAS = True
    try:
        yield
    finally:
        jfa.FORCE_PALLAS = prev


def _qkv(seed, b=1, kvh=2, g=2, sq=256, t=256, hd=128, bf16=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((b, kvh, g, sq, hd), (b, kvh, t, hd), (b, kvh, t, hd))]
    if bf16:
        # Round once to bf16 in numpy-land; both sides get the same bits.
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in arrs]
    return arrs


def _jax_in(a):
    return jnp.asarray(a)


def _torch_in(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _run_port(arrs, q_off, k_off):
    return [x.numpy() for x in tfa.block_attention_ref(
        *[_torch_in(a) for a in arrs], q_off, k_off)]


def _run_jax(arrs, q_off, k_off, pallas=False):
    offs = (jnp.float32(q_off), jnp.float32(k_off))
    args = [_jax_in(a) for a in arrs]
    if pallas:
        with pallas_forced():
            out = jfa.block_attention(*args, *offs)
    else:
        out = jfa._block_attention_ref(*args, *offs)
    return [np.asarray(x) for x in out]


def _assert_close(port, ref, rtol=1e-5, atol=1e-5):
    for name, p, r in zip(("pv", "m", "l"), port, ref):
        assert p.shape == r.shape, name
        np.testing.assert_allclose(p, r, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("q_off,k_off", OFFSETS)
def test_ref_matches_jax_oracle(q_off, k_off):
    arrs = _qkv(0)
    _assert_close(_run_port(arrs, q_off, k_off),
                  _run_jax(arrs, q_off, k_off))


@pytest.mark.parametrize("q_off,k_off", OFFSETS)
def test_ref_matches_pallas_interpret(q_off, k_off):
    arrs = _qkv(1)
    _assert_close(_run_port(arrs, q_off, k_off),
                  _run_jax(arrs, q_off, k_off, pallas=True))


@pytest.mark.parametrize("q_off,k_off", [(0, 0), (128, 0)])
def test_ref_bf16_inputs_compared_in_f32(q_off, k_off):
    arrs = _qkv(2, bf16=True)
    _assert_close(_run_port(arrs, q_off, k_off),
                  _run_jax(arrs, q_off, k_off))


@pytest.mark.parametrize("sq,t,hd,q_off", [
    (1, 160, 128, 159),   # decode step against a whole cache
    (100, 77, 32, 40),    # ragged, tiny-config head_dim
    (13, 300, 64, 290),   # t not a multiple of any tile
])
def test_ref_ragged_shapes_match_jax_oracle(sq, t, hd, q_off):
    arrs = _qkv(3, sq=sq, t=t, hd=hd)
    _assert_close(_run_port(arrs, q_off, 0), _run_jax(arrs, q_off, 0))


def test_fully_masked_rows_are_zero_neginf_zero():
    # Every key is in every query's future.
    pv, m, l = _run_port(_qkv(4), 0, 256)
    assert np.all(pv == 0.0)
    assert np.all(m == np.float32(tfa.NEG_INF))
    assert np.all(l == 0.0)
    # Partially: rows before the block's first key are fully masked.
    pv, m, l = _run_port(_qkv(4, sq=8, t=8, hd=32), 0, 4)
    assert np.all(pv[..., :4, :] == 0) and np.all(l[..., :4] == 0)
    assert np.all(m[..., :4] == np.float32(tfa.NEG_INF))
    assert np.all(l[..., 4:] > 0)


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(5)
    shape = (1, 2, 2, 16)
    carry = (rng.standard_normal(shape + (32,)).astype(np.float32),
             rng.standard_normal(shape).astype(np.float32),
             rng.random(shape).astype(np.float32) + 0.5)
    part = (rng.standard_normal(shape + (32,)).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.random(shape).astype(np.float32) + 0.5)
    want = jfa.merge_partials(tuple(map(jnp.asarray, carry)),
                              tuple(map(jnp.asarray, part)))
    got = tfa.merge_partials(tuple(map(torch.from_numpy, carry)),
                             tuple(map(torch.from_numpy, part)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_merging_two_blocks_equals_one_block():
    """(pv, m, l) partials of two KV halves merge into the one-block
    result -- the contract ring attention relies on."""
    qg, k, v = (_torch_in(a) for a in _qkv(6, sq=64, t=128, hd=64))
    whole = tfa.block_attention_ref(qg, k, v, 64, 0)
    a = tfa.block_attention_ref(qg, k[:, :, :64].contiguous(),
                                v[:, :, :64].contiguous(), 64, 0)
    b = tfa.block_attention_ref(qg, k[:, :, 64:].contiguous(),
                                v[:, :, 64:].contiguous(), 64, 64)
    o, m, l = tfa.merge_partials(a, b)
    torch.testing.assert_close(o / l[..., None],
                               whole[0] / whole[2][..., None],
                               rtol=1e-5, atol=1e-5)


def test_wrapper_on_cpu_takes_plain_version_without_launching():
    before = tfa.launches
    arrs = [_torch_in(a) for a in _qkv(7, sq=32, t=32, hd=32)]
    got = tfa.block_attention(*arrs, 0, 0)
    want = tfa.block_attention_ref(*arrs, 0, 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfa.launches == before


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity", "mixed"])
def test_wrapper_rejects_bad_inputs(bad):
    qg, k, v = (_torch_in(a) for a in _qkv(8, sq=8, t=8, hd=32))
    if bad == "shape":
        k = k[:, :1].contiguous()
    elif bad == "dtype":
        qg = qg.double()
    elif bad == "contiguity":
        k = k.transpose(2, 3)
    else:
        v = v.to(torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.block_attention(qg, k, v, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # scalar kernel (f32)
    (1, 2, 2, 256, 256, 128, 128, 0, torch.float32),
    (1, 2, 2, 100, 2049, 32, 2000, 0, torch.float32),
    # split-KV decode kernel (bf16, g * sq <= 8)
    (1, 8, 4, 1, 160, 128, 159, 0, torch.bfloat16),
    (1, 8, 4, 1, 2048, 128, 2047, 0, torch.bfloat16),
    (1, 8, 4, 1, 333, 64, 200, 0, torch.bfloat16),
    (1, 2, 4, 2, 300, 32, 250, 0, torch.bfloat16),
    (1, 8, 4, 1, 160, 128, 10, 100, torch.bfloat16),   # nothing visible
    (1, 8, 4, 1, 0, 128, 0, 0, torch.bfloat16),        # empty block
    # tensor-core prefill kernel (bf16)
    (1, 8, 4, 128, 128, 128, 0, 0, torch.bfloat16),
    (1, 2, 2, 77, 300, 64, 250, 0, torch.bfloat16),
    (1, 2, 2, 100, 77, 32, 40, 0, torch.bfloat16),
    (1, 2, 2, 64, 64, 128, 0, 32, torch.bfloat16),     # masked rows
    (1, 2, 2, 64, 0, 64, 0, 0, torch.bfloat16),        # empty block
])
def test_cuda_kernel_matches_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    b, kvh, g, sq, t, hd, q_off, k_off, dtype = case
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    qg, k, v = rnd(b, kvh, g, sq, hd), rnd(b, kvh, t, hd), rnd(b, kvh, t, hd)
    name = tfa.kernel_for(sq, g, dtype)
    before = dict(tfa.launches_by_kernel)
    got = tfa.block_attention(qg, k, v, q_off, k_off)
    torch.cuda.synchronize()
    assert tfa.launches_by_kernel[name] == before[name] + 1
    want = tfa.block_attention_ref(qg, k, v, q_off, k_off)
    for g_, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g_, w, rtol=1e-4, atol=1e-4)
    # pv: the prefill kernel rounds p to bf16 (module docstring), so its
    # per-row bound is BF16_P_REL * l * max|v| on top of the f32 slack.
    slack = 1e-4 * (1 + want[0].abs())
    if name == "prefill" and t:
        slack = slack + (tfa.BF16_P_REL * want[2] * v.float().abs().max()
                         )[..., None]
    assert bool(((got[0] - want[0]).abs() <= slack).all())
