"""Port parity: the blob format and its decoders.

The same params (the JAX package's ``init_params``, carried across as
numpy arrays by ``params_from_numpy``) serialise to byte-identical blobs
in both packages, and both decode paths of the port (host, and the CPU
run of the device path) give bit-identical leaves to the JAX package's
``params_from_blobs``.  Comparisons are of raw bits: exact.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import quant as tquant
from distributed_llm_dissemination_tpu_torch.models import serde as tserde

CONFIG_NAMES = ["tiny", "tiny2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads; under a parallel
    test run extra threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_params(name, seed=0):
    cfg = jllama.CONFIGS[name]
    return cfg, jllama.init_params(cfg, jax.random.PRNGKey(seed))


def _bits(a) -> np.ndarray:
    """Raw bits of a bf16 leaf (torch tensor or ml_dtypes numpy)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _assert_same_bits(port_tree, jax_tree):
    if isinstance(jax_tree, dict):
        assert set(port_tree) == set(jax_tree)
        for k in jax_tree:
            _assert_same_bits(port_tree[k], jax_tree[k])
        return
    assert tuple(port_tree.shape) == tuple(np.shape(jax_tree))
    np.testing.assert_array_equal(_bits(port_tree), _bits(jax_tree))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_blobs_byte_identical(name):
    jcfg, params = _jax_params(name)
    tcfg = tllama.CONFIGS[name]
    np_params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    tparams = tserde.params_from_numpy(np_params, device="cpu")
    want = jserde.blobs_from_params(jcfg, params)
    got = tserde.blobs_from_params(tcfg, tparams)
    assert sorted(got) == sorted(want)
    for i in want:
        assert got[i] == want[i], f"blob {i} differs"
        assert len(got[i]) == tserde.blob_nbytes(tcfg, i)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_host_decode_matches_jax(name):
    jcfg, params = _jax_params(name, seed=1)
    blobs = jserde.blobs_from_params(jcfg, params)
    want = jserde.params_from_blobs(jcfg, blobs)
    got = tserde.params_from_blobs(tllama.CONFIGS[name], blobs)
    _assert_same_bits(got, want)


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_device_decode_on_cpu_matches_jax(name):
    jcfg, params = _jax_params(name, seed=2)
    tcfg = tllama.CONFIGS[name]
    blobs = jserde.blobs_from_params(jcfg, params)
    want = jserde.params_from_blobs(jcfg, blobs)
    head_id = tserde.head_blob_id(tcfg)
    dev_blobs = [torch.frombuffer(bytearray(blobs[i]), dtype=torch.uint8)
                 for i in range(head_id + 1)]
    stacked = tquant.stacked_from_device(tcfg, dev_blobs[:head_id], "raw")
    head = tquant.head_from_device(tcfg, dev_blobs[head_id], "raw")
    _assert_same_bits(stacked, want["layers"])
    _assert_same_bits(head, {k: want[k] for k in ("embed", "ln_f", "lm_head")})
    # One-blob decodes are views of the wire bytes: no copy.
    one = tquant.device_decode_jit("raw")((dev_blobs[0],),
                                          tuple(tserde.layer_param_specs(tcfg)),
                                          tcfg.dtype)
    assert (one["wq"].untyped_storage().data_ptr()
            == dev_blobs[0].untyped_storage().data_ptr())


def test_params_from_numpy_round_trips():
    jcfg, params = _jax_params("tiny", seed=3)
    np_params = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    tparams = tserde.params_from_numpy(np_params, device="cpu")
    assert set(tparams) == {"embed", "layers", "ln_f", "lm_head"}
    assert tparams["embed"].dtype == torch.bfloat16
    _assert_same_bits(tparams, np_params)
    # ...and back through the port's blobs.
    cfg = tllama.CONFIGS["tiny"]
    again = tserde.params_from_blobs(cfg, tserde.blobs_from_params(cfg, tparams))
    _assert_same_bits(again, np_params)


@pytest.mark.parametrize("name", sorted(jllama.CONFIGS))
def test_specs_and_sizes_match_jax(name):
    jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    assert tserde.layer_param_specs(tcfg) == jserde.layer_param_specs(jcfg)
    assert tserde.head_param_specs(tcfg) == jserde.head_param_specs(jcfg)
    assert tcfg.layer_nbytes() == jcfg.layer_nbytes()
    for b in (0, tserde.head_blob_id(tcfg)):
        assert tserde.blob_nbytes(tcfg, b) == jserde.blob_nbytes(jcfg, b)


def test_flagship_blob_sizes():
    cfg = tllama.CONFIGS["llama3-8b-d4"]
    assert tserde.blob_nbytes(cfg, 0) == 436_224_000
    assert tserde.blob_nbytes(cfg, tserde.head_blob_id(cfg)) == 2_101_354_496


def test_seeded_blob_is_deterministic_and_shaped():
    cfg = tllama.CONFIGS["tiny"]
    a = tserde.seeded_blob(cfg, 1, seed=7, device="cpu")
    assert a == tserde.seeded_blob(cfg, 1, seed=7, device="cpu")
    assert a != tserde.seeded_blob(cfg, 2, seed=7, device="cpu")
    assert a != tserde.seeded_blob(cfg, 1, seed=8, device="cpu")
    assert len(a) == tserde.blob_nbytes(cfg, 1)
    leaves = tquant.decode_blob_host(cfg, 1, a, "raw")
    assert torch.all(leaves["ln1"] == 1)
    # The JAX init's scales: d**-0.5 for wq, d_ff**-0.5 for w2.
    std_q = leaves["wq"].float().std().item()
    std_2 = leaves["w2"].float().std().item()
    assert abs(std_q - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert abs(std_2 - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    head = tserde.seeded_blob(cfg, tserde.head_blob_id(cfg), device="cpu")
    assert len(head) == tserde.blob_nbytes(cfg, tserde.head_blob_id(cfg))
    with pytest.raises(ValueError):
        tserde.seeded_blob(cfg, cfg.n_layers + 1, device="cpu")


@pytest.mark.parametrize("codec", ["int8", "int4", "int8e"])
def test_unported_codecs_raise(codec):
    """Every codec of the JAX package is ported: the quantized forms decode
    on the device path as on the host, and only what the JAX package also
    refuses raises -- a device decode of an entropy form (it unwraps on
    the host first) and an unknown codec."""
    cfg = tllama.CONFIGS["tiny"]
    enc = tquant.encode_blob(cfg, 0, tserde.seeded_blob(cfg, 0, device="cpu"),
                             codec)
    host = tquant.decode_blob_host(cfg, 0, enc, codec)
    if codec in tquant.ENTROPY_CODECS:
        with pytest.raises(ValueError, match="no device decode"):
            tquant.device_decode_jit(codec)
    else:
        dev = tquant.stacked_from_device(
            cfg, [tserde._host_u8(enc)], codec)
        for name, _ in tserde.layer_param_specs(cfg):
            assert torch.equal(dev[name][0].view(torch.int16),
                               host[name].view(torch.int16)), name
    with pytest.raises(ValueError):
        tquant.device_decode_jit("zstd")


def test_decode_rejects_wrong_size():
    cfg = tllama.CONFIGS["tiny"]
    blob = bytearray(tserde.blob_nbytes(cfg, 0) + 2)
    with pytest.raises(ValueError, match="blob size"):
        tquant.decode_blob_host(cfg, 0, blob, "raw")
