"""Port parity: the arithmetic behind the block-attention kernels.

The Hopper kernels run only on the card, so what they compute beyond the
plain version is checked here in PyTorch on the CPU, against the JAX
package's lax oracle ``_block_attention_ref``, on numpy-made inputs:

- the decode kernel's split plan (``split_plan``) and the split-and-merge
  algebra it relies on: chunk partials merged with ``merge_partials``
  equal one call over the whole block (rtol 1e-5: f32 sums in another
  order);
- the dispatch (``kernel_for``) of the main path's shapes;
- the prefill kernel's bf16 rounding of p: an emulation of its tiled
  online softmax with p rounded to bf16 before the PV product stays
  within the stated bound ``2**-9 * l * max|v|`` per row (plus f32 slack
  ``1e-5 * max(1, l)``) of the f32-p oracle, while m and l, summed from
  the f32 p, hold rtol 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.ops import flash_attention as jfa
from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
from distributed_llm_dissemination_tpu_torch.ops import flash_attention as tfa

NEG_INF = np.float32(tfa.NEG_INF)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; under a parallel
    test run extra threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b=1, kvh=2, g=2, sq=1, t=160, hd=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, kvh, g, sq, hd), (b, kvh, t, hd), (b, kvh, t, hd))]


def _jax_ref(arrs, q_off, k_off):
    out = jfa._block_attention_ref(*map(jnp.asarray, arrs),
                                   jnp.float32(q_off), jnp.float32(k_off))
    return [np.asarray(x) for x in out]


def _chunks(n_vis, n_split, chunk):
    return [(s * chunk, min((s + 1) * chunk, n_vis)) for s in range(n_split)]


# ------------------------------------------------------------ split plan

PLAN_CASES = [
    # (bh, sq, t, q_off, k_off)
    (8, 1, 160, 159, 0),       # main-path decode, 128-token prompt
    (8, 1, 2080, 2047, 0),     # long-context decode against a bigger cache
    (8, 1, 2048, 2047, 0),
    (8, 1, 160, 128, 0),       # early decode: most of the cache is future
    (1, 1, 4096, 4095, 0),     # one KV head: many splits
    (64, 1, 100, 99, 0),       # many heads: few splits
    (8, 4, 300, 250, 0),       # several query rows (g * sq <= 8)
    (8, 2, 77, 500, 0),        # every key visible, t ragged
    (8, 1, 160, 10, 100),      # query before the block: nothing visible
    (8, 1, 0, 0, 0),           # empty block
    (2, 1, 33, 40, 8),         # k_off inside the visible range
]


@pytest.mark.parametrize("bh,sq,t,q_off,k_off", PLAN_CASES)
def test_split_plan_covers_every_visible_key_once(bh, sq, t, q_off, k_off):
    n_vis, n_split, chunk = tfa.split_plan(bh, sq, t, q_off, k_off)
    visible = [j for j in range(t) if k_off + j <= q_off + sq - 1]
    assert visible == list(range(n_vis))
    assert n_split >= 1
    if n_vis == 0:
        assert (n_split, chunk) == (1, 0)
        return
    assert chunk % tfa.DECODE_CHUNK_ALIGN == 0
    seen = []
    for lo, hi in _chunks(n_vis, n_split, chunk):
        assert lo < n_vis, "a split starts past the visible keys"
        assert lo < hi
        seen.extend(range(lo, hi))
    assert seen == list(range(n_vis))
    # About DECODE_CTAS_PER_SM CTAs per SM, never a split more than needed.
    assert bh * (n_split - 1) < tfa.DECODE_CTAS_PER_SM * tfa.SMS
    assert n_split * chunk - n_vis < chunk


def test_split_plan_main_path_numbers():
    # t = 2048 at 8 KV heads: 32 splits of 64 keys, 256 CTAs on 132 SMs.
    assert tfa.split_plan(8, 1, 2048, 2047, 0) == (2048, 32, 64)
    assert tfa.split_plan(8, 1, 160, 159, 0) == (160, 5, 32)


@pytest.mark.parametrize("sq,t,q_off,k_off", [
    (1, 50, 10, 20), (3, 64, 0, 3), (1, 0, 5, 0), (2, 16, 7, 9)])
def test_no_visible_keys_before_the_block(sq, t, q_off, k_off):
    n_vis = tfa.visible_keys(sq, t, q_off, k_off)
    assert (n_vis == 0) == (q_off + sq - 1 < k_off or t == 0)
    if n_vis == 0:
        assert tfa.split_plan(8, sq, t, q_off, k_off) == (0, 1, 0)


# ------------------------------------------------ split-and-merge algebra

def _split_merge(arrs, q_off, k_off, bounds):
    """Partials of each key chunk by the plain version, merged in order
    with merge_partials from the empty state (0, -1e30, 0)."""
    qg, k, v = (torch.from_numpy(a.copy()) for a in arrs)
    carry = (torch.zeros(qg.shape), torch.full(qg.shape[:4], tfa.NEG_INF),
             torch.zeros(qg.shape[:4]))
    for lo, hi in bounds:
        part = tfa.block_attention_ref(
            qg, k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous(),
            q_off, k_off + lo)
        carry = tfa.merge_partials(carry, part)
    return [x.numpy() for x in carry]


def _assert_matches_jax(got, want):
    for name, g_, w in zip(("pv", "m", "l"), got, want):
        np.testing.assert_allclose(g_, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("n_split", [1, 2, 3, 5, 16])
@pytest.mark.parametrize("sq,t,q_off", [(1, 160, 159), (1, 160, 100),
                                        (4, 96, 60)])
def test_split_partials_merge_to_one_block(n_split, sq, t, q_off):
    arrs = _qkv(10 + n_split, sq=sq, t=t)
    n_vis = tfa.visible_keys(sq, t, q_off, 0)
    chunk = -(-n_vis // n_split)
    # Chunks past the visible keys are empty for every row: their
    # partials are (0, -1e30, 0) and must merge as no-ops.
    bounds = _chunks(n_vis, n_split, chunk) + [(n_vis, t)]
    _assert_matches_jax(_split_merge(arrs, q_off, 0, bounds),
                        _jax_ref(arrs, q_off, 0))


def test_split_plan_chunks_merge_to_one_block():
    arrs = _qkv(20, sq=1, t=2080, hd=64)
    n_vis, n_split, chunk = tfa.split_plan(2, 1, 2080, 2047, 0)
    assert n_split > 1
    _assert_matches_jax(
        _split_merge(arrs, 2047, 0, _chunks(n_vis, n_split, chunk)),
        _jax_ref(arrs, 2047, 0))


def test_split_merge_with_no_visible_key_is_zero_neginf_zero():
    arrs = _qkv(21, sq=2, t=64)
    pv, m, l = _split_merge(arrs, 3, 10, [(0, 32), (32, 64)])
    assert np.all(pv == 0) and np.all(l == 0) and np.all(m == NEG_INF)
    _assert_matches_jax([pv, m, l], _jax_ref(arrs, 3, 10))


# ---------------------------------------------------------------- dispatch

def _serving_shapes(cfg, prompt, gen):
    """(count, sq, t, q_off) of the main path's calls, as chip_smoke.py."""
    L = cfg.n_layers
    return ([(L, prompt, prompt, 0), (L, prompt, prompt + gen, 0)]
            + [(L, 1, prompt + gen, prompt + i - 1) for i in range(1, gen)])


@pytest.mark.parametrize("prompt", [128, 2048])
def test_dispatch_of_the_main_path(prompt):
    cfg = CONFIGS["llama3-8b-d4"]
    g = cfg.n_heads // cfg.n_kv_heads
    counts = {"decode": 0, "prefill": 0}
    for n, sq, _, _ in _serving_shapes(cfg, prompt, 32):
        counts[tfa.kernel_for(sq, g, torch.bfloat16)] += n
    assert counts == {"decode": 124, "prefill": 8}


@pytest.mark.parametrize("sq,g,dtype,want", [
    (1, 4, torch.bfloat16, "decode"),
    (2, 4, torch.bfloat16, "decode"),
    (1, 8, torch.bfloat16, "decode"),
    (3, 4, torch.bfloat16, "prefill"),
    (1, 16, torch.bfloat16, "prefill"),
    (128, 4, torch.bfloat16, "prefill"),
    (1, 4, torch.float32, "decode"),
    (256, 2, torch.float32, "prefill"),
])
def test_dispatch_by_rows_and_dtype(sq, g, dtype, want):
    assert tfa.kernel_for(sq, g, dtype) == want


# ------------------------------------------------------- bf16-P pv bound

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _prefill_emulation(qg, k, v, q_off, k_off, bk=128):
    """The prefill kernel's arithmetic in PyTorch: KV tiles of ``bk`` keys,
    online softmax in log2 units, l summed from the f32 p, and p rounded
    to bf16 for the PV product.  f32 throughout otherwise."""
    hd = qg.shape[-1]
    sq, t = qg.shape[3], k.shape[2]
    scale = 1.4426950408889634 / math.sqrt(hd)
    qpos = q_off + torch.arange(sq)
    m = torch.full(qg.shape[:4], tfa.NEG_INF)
    l = torch.zeros(qg.shape[:4])
    o = torch.zeros(qg.shape)
    for lo in range(0, t, bk):
        kt, vt = k[:, :, lo : lo + bk], v[:, :, lo : lo + bk]
        s = torch.einsum("bkgsh,bkth->bkgst", qg, kt) * scale
        kpos = k_off + lo + torch.arange(kt.shape[2])
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full_like(s, tfa.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        live = m_new > tfa.NEG_INF / 2
        alpha = torch.where(live, torch.exp2(m - m_new), torch.ones_like(m))
        p = torch.where(live[..., None], torch.exp2(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bkgst,bkth->bkgsh",
                                                _bf16(p), vt)
        m = m_new
    m = torch.where(m > tfa.NEG_INF / 2, m * math.log(2.0), m)
    return o, m, l


@pytest.mark.parametrize("seed,sq,t,q_off,hd", [
    (30, 64, 64, 0, 32),       # the boot's square causal block
    (31, 77, 300, 250, 64),    # ragged rows and keys
    (32, 128, 160, 0, 128),    # serving prefill against the cache
    (33, 96, 200, 150, 32),    # a tile crossing the diagonal mid-way
    (34, 40, 130, 0, 64),      # rows whose keys start past a tile
])
def test_bf16_p_pv_error_within_stated_bound(seed, sq, t, q_off, hd):
    arrs = _qkv(seed, kvh=2, g=2, sq=sq, t=t, hd=hd)
    # bf16 inputs, as the kernel gets them.
    qg, k, v = (_bf16(torch.from_numpy(a)) for a in arrs)
    pv, m, l = _prefill_emulation(qg, k, v, q_off, 0)
    want = _jax_ref([x.numpy() for x in (qg, k, v)], q_off, 0)
    np.testing.assert_allclose(m.numpy(), want[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), want[2], rtol=1e-5, atol=1e-5)
    err = np.abs(pv.numpy() - want[0]).max(-1)  # per row
    bound = (tfa.BF16_P_REL * want[2] * float(v.abs().max())
             + 1e-5 * np.maximum(1.0, want[2]))
    assert np.all(err <= bound), float((err / bound).max())
    # ... and the rounding is real: the bound is not vacuous.
    assert float(err.max()) > 0.0


def test_bf16_p_bound_is_tight_to_a_small_factor():
    """Against the f32-p oracle the bf16-p error uses a fair part of the
    bound (it is not loose by orders of magnitude)."""
    arrs = _qkv(40, kvh=1, g=1, sq=64, t=512, hd=32)
    qg, k, v = (_bf16(torch.from_numpy(a)) for a in arrs)
    pv, _, l = _prefill_emulation(qg, k, v, 511, 0)
    want = _jax_ref([x.numpy() for x in (qg, k, v)], 511, 0)
    err = np.abs(pv.numpy() - want[0]).max(-1)
    bound = tfa.BF16_P_REL * want[2] * float(v.abs().max())
    assert float((err / bound).max()) > 1e-3
