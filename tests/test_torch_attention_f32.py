"""K1's float32 path: the f32 instances of the decode and prefill kernels
(``csrc/attention_decode.cu``, ``csrc/attention_prefill.cu``).

The f32 prefill kernel forms both of its products as 3xTF32 on the tensor
cores: every f32 operand x is split into hi = tf32(x) (round to nearest,
ties away from zero) and lo = tf32(x - hi), and a product a b is taken as
a_hi b_lo + a_lo b_hi + a_hi b_hi with f32 sums.  ``tf32x3_attention`` below
is a test-only emulation of that arithmetic in plain torch (TF32 rounding
by integer round-and-mask of the f32 bits); it takes the whole row's
softmax at once where the kernel walks 32-key tiles, which moves nothing
but f32 rounding.  On the same numpy-made inputs, with q scaled so that
the largest |logit| is 30, it is held against the JAX package's Pallas
kernel (``_block_attention_pallas``, interpret mode) and its lax oracle
(``_block_attention_ref``) at ``chip_smoke.py``'s f32 tolerances: m within
1e-4, l and pv within 1e-3 x max(1, max l) (measured: m 1.3e-5, l and pv
7e-6 of that scale).  One TF32 product per f32 product (1xTF32) moves m by
6e-3 on the same inputs, which is why the kernel splits.

The kernels themselves run only on the card (``cuda`` marker; skipped
here): ``chip_smoke.py`` phase 2 holds them against the plain version at
full width and phase 9's ``hf_f32`` round serves an f32 model through
them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.ops import flash_attention as jfa
from distributed_llm_dissemination_tpu_torch.models.llama import CONFIGS
from distributed_llm_dissemination_tpu_torch.ops import flash_attention as tfa

M_TOL = 1e-4  # chip_smoke.attention_case: f32 rounding of a max
TOL = 1e-3  # l and pv, times max(1, max l)
LOGIT_MAX = 30.0
Q_OFF, K_OFF = 128, 0  # a causal block: rows 128..255 against keys 0..255


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    value with 10 mantissa bits, ties away from zero (add half of the
    dropped 13 bits' span to the magnitude, then clear them)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _product(a, b, eq, passes):
    a_hi, b_hi = tf32(a), tf32(b)
    if passes == 1:
        return torch.einsum(eq, a_hi, b_hi)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    return (torch.einsum(eq, a_hi, b_lo) + torch.einsum(eq, a_lo, b_hi)
            + torch.einsum(eq, a_hi, b_hi))


def tf32x3_attention(qg, k, v, q_off, k_off, passes=3):
    """``block_attention``'s (pv, m, l) with the f32 prefill kernel's
    products: ``passes`` = 3 is 3xTF32, 1 a single TF32 product."""
    hd = qg.shape[-1]
    sq, t = qg.shape[3], k.shape[2]
    s = _product(qg, k, "bkgsh,bkth->bkgst", passes) / np.sqrt(hd)
    causal = ((q_off + torch.arange(sq))[:, None]
              >= (k_off + torch.arange(t))[None, :])
    s = torch.where(causal, s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = torch.where((m > tfa.NEG_INF / 2)[..., None], p, torch.zeros_like(p))
    return _product(p, v, "bkgst,bkth->bkgsh", passes), m, p.sum(-1)


def _inputs(hd, seed=0):
    """q, k, v for one causal block, with q scaled so that the largest
    |logit| is ``LOGIT_MAX``."""
    rng = np.random.default_rng(seed + hd)
    q = rng.standard_normal((1, 2, 2, 128, hd)).astype(np.float32)
    k = rng.standard_normal((1, 2, 256, hd)).astype(np.float32)
    v = rng.standard_normal((1, 2, 256, hd)).astype(np.float32)
    logits = np.einsum("bkgsh,bkth->bkgst", q.astype(np.float64), k)
    q = (q * (LOGIT_MAX * np.sqrt(hd) / np.abs(logits).max())).astype(
        np.float32)
    return q, k, v


def _jax(arrs, which):
    args = [jnp.asarray(a) for a in arrs]
    offs = (jnp.float32(Q_OFF), jnp.float32(K_OFF))
    if which == "pallas":
        out = jfa._block_attention_pallas(*args, *offs, interpret=True)
    else:
        out = jfa._block_attention_ref(*args, *offs)
    return [np.asarray(x) for x in out]


def _errors(got, want):
    """(m error, l error, pv row error), l and pv over max(1, max l)."""
    scale = max(1.0, float(want[2].max()))
    return (float(np.abs(got[1] - want[1]).max()),
            float(np.abs(got[2] - want[2]).max()) / scale,
            float(np.abs(got[0] - want[0]).max()) / scale)


@pytest.mark.parametrize("which", ["pallas", "ref"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_tf32x3_within_chip_smoke_f32_tolerance_of_jax(hd, which):
    arrs = _inputs(hd)
    want = _jax(arrs, which)
    assert abs(float(want[1].max()) - LOGIT_MAX) < 1e-3
    got = [x.numpy() for x in tf32x3_attention(
        *map(torch.from_numpy, arrs), Q_OFF, K_OFF)]
    m_err, l_err, pv_err = _errors(got, want)
    assert m_err <= M_TOL and l_err <= TOL and pv_err <= TOL, (
        m_err, l_err, pv_err)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_one_tf32_product_breaks_the_m_tolerance(hd):
    arrs = _inputs(hd)
    want = _jax(arrs, "ref")
    got = [x.numpy() for x in tf32x3_attention(
        *map(torch.from_numpy, arrs), Q_OFF, K_OFF, passes=1)]
    m_err, _, _ = _errors(got, want)
    assert m_err > 10 * M_TOL, m_err


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # TF32's step at 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, one + 2.0 ** -12,
                      3.0], dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one, 3.0], dtype=torch.float32)
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1000).astype(np.float32))
    hi = tf32(y)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((y - hi).abs() <= 2.0 ** -11 * y.abs()).all())


def test_f32_routing_of_the_main_path():
    """An f32 model's serve of ``llama3-8b-d4`` (128-token prompt, 32
    tokens) launches K1 as a bf16 serve does: 124 decode, 8 prefill."""
    cfg = CONFIGS["llama3-8b-d4"]
    g = cfg.n_heads // cfg.n_kv_heads
    L, P, G = cfg.n_layers, 128, 32
    shapes = ([(L, P), (L, P)] + [(L, 1)] * (G - 1))
    counts = {name: 0 for name in tfa.SOURCES}
    for n, sq in shapes:
        counts[tfa.kernel_for(sq, g, torch.float32)] += n
    assert counts == {"decode": 124, "prefill": 8}
    assert tfa.P_REL[torch.float32] == 0.0
    assert "float32" in {str(d).split(".")[-1] for d in tfa.DTYPE_IDS}


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # decode instance (g * sq <= 8)
    (1, 8, 4, 1, 2048, 128, 2047, 0),
    (1, 2, 4, 2, 300, 64, 250, 0),
    (1, 2, 8, 1, 1000, 32, 999, 0),
    (1, 8, 4, 1, 160, 128, 10, 100),      # nothing visible
    (1, 8, 4, 1, 0, 128, 0, 0),           # empty block
    # prefill instance (3xTF32)
    (1, 8, 4, 128, 128, 128, 0, 0),
    (1, 2, 2, 256, 256, 128, 128, 0),
    (1, 2, 2, 77, 300, 64, 250, 0),
    (1, 2, 2, 100, 2049, 32, 2000, 0),
    (1, 2, 2, 64, 64, 128, 0, 32),        # masked rows
    (1, 2, 2, 64, 0, 64, 0, 0),           # empty block
])
def test_f32_instances_match_plain_version(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    b, kvh, g, sq, t, hd, q_off, k_off = case
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    qg, k, v = rnd(b, kvh, g, sq, hd), rnd(b, kvh, t, hd), rnd(b, kvh, t, hd)
    name = tfa.kernel_for(sq, g, torch.float32)
    before = tfa.launches_by_instance[f"{name}:float32"]
    got = tfa.block_attention(qg, k, v, q_off, k_off)
    torch.cuda.synchronize()
    assert tfa.launches_by_instance[f"{name}:float32"] == before + 1
    want = tfa.block_attention_ref(qg, k, v, q_off, k_off)
    scale = max(1.0, float(want[2].max()))
    assert float((got[1] - want[1]).abs().max()) <= M_TOL
    assert float((got[2] - want[2]).abs().max()) <= TOL * scale
    assert float((got[0] - want[0]).abs().max()) <= TOL * scale
