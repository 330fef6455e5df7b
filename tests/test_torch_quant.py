"""The port's quantized codecs (``models/quant.py``, ``ops/dequant.py``)
on ``tests/test_quant.py``'s cases, with the JAX package as the oracle.

Mirrored from the JAX file: wire sizes, round-trip error bounds, the
device decode against the host decode, MoE leaves, the entropy wrap,
config parsing, ``create_layers`` and the disseminate-then-boot loops
for int8 and int4 (the pod-fabric case is in
``tests/test_torch_pp_serve.py``).

Added for the port:

- ``encode_blob`` equals the JAX package's byte for byte for int8, int4,
  int8e and int4e on every blob of ``tiny`` and ``tiny2`` (seeds 0 and
  7), ``tiny-moe`` and an f32 copy of ``tiny`` -- the JAX package reads
  bf16 through ``ml_dtypes``, the port through the bits alone;
- ``blob_nbytes_codec`` equals the JAX package's for every config,
  without a blob being made;
- the plain K2/K3 (``ops.dequant`` on CPU tensors) equals the JAX
  package's ``device_decode_jit`` run on the CPU, bit for bit, in bf16,
  f16 and f32, on model blobs and on synthetic leaves that hit the kernels'
  traps (scale blocks at odd offsets, odd columns, 1-D leaves, columns
  that 128 does not divide);
- a quantized mode-3 round of the port, staged on a CPU "device" so the
  boot decodes through ``ops.dequant``, boots with logits within
  ``tests/test_torch_model.py``'s tolerance of the JAX boot of the same
  wire blobs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.core import types as jtypes
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import quant as jquant
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu.runtime import boot as jboot
from distributed_llm_dissemination_tpu_torch.core import config as cfg_mod
from distributed_llm_dissemination_tpu_torch.core import types as ttypes
from distributed_llm_dissemination_tpu_torch.models import entropy
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import quant
from distributed_llm_dissemination_tpu_torch.models import serde
from distributed_llm_dissemination_tpu_torch.ops import dequant
from distributed_llm_dissemination_tpu_torch.parallel.mesh import (
    assignment_to_placement,
)
from distributed_llm_dissemination_tpu_torch.runtime import (
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    Node,
)

from test_torch_dissemination import NIC, _close, _drive, _holdings, _transports
from test_torch_model import LOGIT_ATOL, LOGIT_MEAN_ATOL

TIMEOUT = 60.0
CFG = tllama.CONFIGS["tiny"]
JCFG = jllama.CONFIGS["tiny"]
SEED = 0
WIRE = ("int8", "int4", "int8e", "int4e")
# Synthetic leaves that hit the kernels' traps: every scale block after
# the first starts at an offset that is not a multiple of 4, cols of 5,
# 7 and 3 (odd: int4 rides them raw), 130 (128 does not divide it: one
# int4 group per row), 1-D leaves, a 3-D leaf, and a leaf of 2 columns.
TRAPS = (("a", (3, 5)), ("b", (7,)), ("c", (2, 3, 6)), ("d", (5, 130)),
         ("e", (4, 256)), ("f", (3, 7)), ("g", (1, 2)), ("h", (2, 34)))
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def all_ids(cfg=CFG):
    return list(range(cfg.n_layers)) + [serde.head_blob_id(cfg)]


def _raw(bid, cfg=JCFG, seed=SEED) -> bytes:
    return jserde.seeded_blob(cfg, bid, seed)


def _src(cfg, bid):
    return serde._split_blob(cfg, _raw(bid), serde.blob_specs(cfg, bid))


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _bits(a) -> np.ndarray:
    """Raw bits of a leaf: a torch tensor or a JAX/numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        return a.numpy().view(np.uint16 if a.dtype == torch.int16
                              else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def trap_case(codec: str, dtype_name: str, seed: int = 3):
    """One synthetic case: (specs, raw bytes, wire blob, leaf table), the
    blob and its table from the same specs and dtype."""
    dtype = DTYPES[dtype_name]
    n = sum(int(np.prod(s)) for _, s in TRAPS)
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    raw = torch.from_numpy(x).to(dtype).view(torch.uint8).numpy().tobytes()
    enc = quant.encode_specs(TRAPS, dtype, raw, codec)
    return TRAPS, raw, enc, quant.leaf_table(codec, TRAPS, dtype)


# ---------------------------------------------------------- JAX's cases


def test_int8_halves_the_wire_bytes():
    for bid in all_ids():
        raw_n = serde.blob_nbytes(CFG, bid)
        q_n = quant.blob_nbytes_codec(CFG, bid, "int8")
        assert q_n < 0.6 * raw_n, (bid, q_n, raw_n)
        enc = quant.encode_blob(CFG, bid, _raw(bid), "int8")
        assert len(enc) == q_n
        assert quant.blob_nbytes_codec(CFG, bid, "raw") == raw_n


def test_int4_quarters_the_wire_bytes():
    for bid in all_ids():
        raw_n = serde.blob_nbytes(CFG, bid)
        q_n = quant.blob_nbytes_codec(CFG, bid, "int4")
        assert q_n < 0.35 * raw_n, (bid, q_n, raw_n)
        enc = quant.encode_blob(CFG, bid, _raw(bid), "int4")
        assert len(enc) == q_n


def test_int4_roundtrip_error_bounded_by_group_scale():
    bid = 0
    enc = quant.encode_blob(CFG, bid, _raw(bid), "int4")
    dec = quant.decode_blob_host(CFG, bid, enc, "int4")
    src = _src(CFG, bid)
    for name, shape in serde.layer_param_specs(CFG):
        x = _f32(src[name])
        got = _f32(dec[name])
        layout = quant._q4_layout(shape, CFG.dtype.itemsize)
        if layout[0] == "raw":
            np.testing.assert_array_equal(got, x, err_msg=name)
            continue
        _, rows, cols, groups = layout
        g = cols // groups
        xg = x.reshape(rows, groups, g)
        scale = np.abs(xg).max(axis=2, keepdims=True) / 7.0
        scale = np.where(scale > 0, scale, 1.0)
        bound = scale * 0.5 + 0.01 * np.abs(xg) + 1e-6
        assert (np.abs(got.reshape(rows, groups, g) - xg) <= bound).all(), name


def test_int4_device_decode_matches_host():
    for bid in (1, serde.head_blob_id(CFG)):
        enc = quant.encode_blob(CFG, bid, _raw(bid), "int4")
        host = quant.decode_blob_host(CFG, bid, enc, "int4")
        dev_blob = serde._host_u8(enc)
        if bid == serde.head_blob_id(CFG):
            dev = quant.head_from_device(CFG, dev_blob, "int4")
            pick = lambda a: a  # noqa: E731
        else:
            dev = quant.stacked_from_device(CFG, [dev_blob], "int4")
            pick = lambda a: a[0]  # noqa: E731
        for name in host:
            np.testing.assert_array_equal(_bits(pick(dev[name])),
                                          _bits(host[name]),
                                          err_msg=f"blob {bid} leaf {name}")


def test_int4_moe_leaves_roundtrip():
    mcfg = tllama.CONFIGS["tiny-moe"]
    raw = _raw(0, jllama.CONFIGS["tiny-moe"])
    enc = quant.encode_blob(mcfg, 0, raw, "int4")
    assert len(enc) == quant.blob_nbytes_codec(mcfg, 0, "int4")
    dec = quant.decode_blob_host(mcfg, 0, enc, "int4")
    for name, shape in serde.layer_param_specs(mcfg):
        assert tuple(dec[name].shape) == shape, name


def test_unknown_codec_rejected():
    with pytest.raises(ValueError, match="unknown codec"):
        quant.blob_nbytes_codec(CFG, 0, "fp3")
    with pytest.raises(ValueError, match="unknown codec"):
        quant.encode_blob(CFG, 0, b"", "fp3")


def test_entropy_codecs_wrap_their_base_form():
    bid = 0
    raw = _raw(bid)
    for codec, base in quant.ENTROPY_CODECS.items():
        enc = quant.encode_blob(CFG, bid, raw, codec)
        base_enc = quant.encode_blob(CFG, bid, raw, base)
        assert entropy.decode(enc) == base_enc
        assert quant.host_unwrap(codec, enc) == (base, base_enc)
        dec = quant.decode_blob_host(CFG, bid, enc, codec)
        base_dec = quant.decode_blob_host(CFG, bid, base_enc, base)
        for name, _ in serde.layer_param_specs(CFG):
            assert torch.equal(dec[name], base_dec[name]), f"{codec}:{name}"
        assert quant.decode_to_raw(CFG, bid, enc, codec) == \
            quant.decode_to_raw(CFG, bid, base_enc, base)
        with pytest.raises(ValueError, match="data-dependent|entropy"):
            quant.blob_nbytes_codec(CFG, bid, codec)
        with pytest.raises(ValueError, match="no device decode"):
            quant.device_decode_jit(codec)
    assert quant.host_unwrap("int8", b"abc") == ("int8", b"abc")


def test_config_rejects_entropy_model_codec(tmp_path):
    p = tmp_path / "e.json"
    p.write_text('{"Nodes": [], "Model": "tiny", "ModelCodec": "int8e"}')
    with pytest.raises(ValueError, match="wire-only"):
        cfg_mod.read_json(str(p))
    p.write_text('{"Nodes": [], "Model": "tiny", "WireCodec": "int4e"}')
    assert cfg_mod.read_json(str(p)).wire_codec == "int4e"


def test_roundtrip_error_bounded_by_scale():
    bid = 0
    enc = quant.encode_blob(CFG, bid, _raw(bid), "int8")
    dec = quant.decode_blob_host(CFG, bid, enc, "int8")
    src = _src(CFG, bid)
    for name, shape in serde.layer_param_specs(CFG):
        x = _f32(src[name]).reshape(-1, shape[-1])
        got = _f32(dec[name]).reshape(-1, shape[-1])
        scale = np.abs(x).max(axis=1, keepdims=True) / 127.0
        scale = np.where(scale > 0, scale, 1.0)
        bound = scale * 0.5 + 0.01 * np.abs(x) + 1e-6
        assert (np.abs(got - x) <= bound).all(), name


def test_device_decode_matches_host():
    bid = 1
    enc = quant.encode_blob(CFG, bid, _raw(bid), "int8")
    host = quant.decode_blob_host(CFG, bid, enc, "int8")
    dev = quant.stacked_from_device(CFG, [serde._host_u8(enc)], "int8")
    for name, _ in serde.layer_param_specs(CFG):
        np.testing.assert_array_equal(_bits(dev[name][0]), _bits(host[name]),
                                      err_msg=name)


def test_config_rejects_unknown_codec(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"Nodes": [], "Model": "tiny", "ModelCodec": "INT8"}')
    with pytest.raises(ValueError, match="unknown ModelCodec"):
        cfg_mod.read_json(str(p))


def test_config_parses_model_codec(tmp_path):
    p = tmp_path / "c.json"
    p.write_text(
        '{"Nodes": [{"ID": 0, "Addr": "a", "IsLeader": true}], '
        '"Model": "tiny", "ModelCodec": "int8"}')
    conf = cfg_mod.read_json(str(p))
    assert conf.model == "tiny" and conf.model_codec == "int8"
    p.write_text('{"Nodes": [], "Model": "tiny"}')
    assert cfg_mod.read_json(str(p)).model_codec == "raw"


def test_create_layers_encodes_with_codec():
    nc = cfg_mod.NodeConf(
        id=1, addr="x",
        initial_layers={ttypes.SourceType.MEM: {0: 0}},
        sources={ttypes.SourceType.MEM: 0})
    layers = cfg_mod.create_layers(nc, save_disk=False, model="tiny",
                                   model_seed=SEED, model_codec="int8",
                                   device="cpu")
    want = jquant.encode_blob(JCFG, 0, _raw(0), "int8")
    assert bytes(layers[0].inmem_data) == want
    assert layers[0].data_size == quant.blob_nbytes_codec(CFG, 0, "int8")


def _quantized_round(codec: str):
    """A port mode-3 round of ``codec`` wire blobs: seeder 1 holds them,
    cold dest 2 stages them on a CPU "device" and boots under ``codec``.
    Returns (the dest's boot result, the wire blobs)."""
    enc = {bid: jquant.encode_blob(JCFG, bid, _raw(bid), codec)
           for bid in all_ids()}
    assignment = {2: {bid: ttypes.LayerMeta() for bid in enc}}
    placement = assignment_to_placement(assignment, ["cpu"])
    ts = _transports({0: "inmem", 1: "inmem", 2: "inmem"})
    leader = FlowRetransmitLeaderNode(Node(0, 0, ts[0]), {}, assignment, NIC,
                                      expected_nodes={1, 2})
    seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]),
                                        _holdings(ttypes, enc))
    dest = FlowRetransmitReceiverNode(
        Node(2, 0, ts[2]), {}, stage_hbm=True, placement=placement,
        boot_cfg=CFG, boot_codec=codec)
    before = dict(dequant.plain_calls)
    try:
        _drive(leader, [seeder, dest])
        booted = leader.boot_ready().get(timeout=TIMEOUT)
        assert set(booted) == {2}
        for bid in enc:
            assert dest.layers[bid].data_size == \
                quant.blob_nbytes_codec(CFG, bid, codec)
        res = dest.boot_result
        assert res is not None and res.kind == "full"
        # Decoded through ops.dequant: the warm-up's blob and one call per
        # wire blob at least (each took the plain version on the CPU).
        assert dequant.plain_calls[codec] - before[codec] >= len(enc) + 1
        return res, enc
    finally:
        _close([leader, seeder, dest], ts)


def _jax_unquantized_logits():
    tokens = jnp.zeros((1, 16), jnp.int32)
    return np.asarray(jax.device_get(jllama.forward_jit(
        jllama.init_params(JCFG, jax.random.key(SEED)), tokens, JCFG)),
        np.float32)


@pytest.mark.timeout(120)
def test_disseminate_int4_then_boot_close_logits():
    res, _ = _quantized_round("int4")
    want = _jax_unquantized_logits()
    got = res.logits.float().numpy()
    assert got.shape == want.shape
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.9, corr
    np.testing.assert_array_equal(got.argmax(axis=-1), want.argmax(axis=-1))


@pytest.mark.timeout(120)
def test_disseminate_int8_then_boot_close_logits():
    res, _ = _quantized_round("int8")
    want = _jax_unquantized_logits()
    got = res.logits.float().numpy()
    assert got.shape == want.shape
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.99, corr
    np.testing.assert_array_equal(got.argmax(axis=-1), want.argmax(axis=-1))


# ------------------------------------------------------- port vs JAX


ENCODE_CASES = ([("tiny", 0), ("tiny", 7), ("tiny2", 0), ("tiny2", 7),
                 ("tiny-moe", 0)])


@pytest.mark.parametrize("codec", WIRE)
@pytest.mark.parametrize("name,seed", ENCODE_CASES)
def test_encode_equals_jax_on_every_blob(name, seed, codec):
    jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    for bid in all_ids(tcfg):
        raw = _raw(bid, jcfg, seed)
        assert quant.encode_blob(tcfg, bid, raw, codec) == \
            jquant.encode_blob(jcfg, bid, raw, codec), (name, seed, bid)


@pytest.mark.parametrize("codec", WIRE)
def test_encode_equals_jax_on_an_f32_model(codec):
    jcfg = dataclasses.replace(JCFG, dtype=jnp.float32)
    tcfg = dataclasses.replace(CFG, dtype=torch.float32)
    rng = np.random.default_rng(11)
    for bid in all_ids(tcfg):
        n = serde.blob_nbytes(tcfg, bid) // 4
        raw = (rng.standard_normal(n) * 0.05).astype(np.float32).tobytes()
        assert quant.encode_blob(tcfg, bid, raw, codec) == \
            jquant.encode_blob(jcfg, bid, raw, codec), bid


@pytest.mark.parametrize("name", sorted(tllama.CONFIGS))
def test_blob_nbytes_codec_equals_jax_for_every_config(name):
    jcfg, tcfg = jllama.CONFIGS[name], tllama.CONFIGS[name]
    for bid in (0, serde.head_blob_id(tcfg)):
        for codec in ("raw", "int8", "int4"):
            assert quant.blob_nbytes_codec(tcfg, bid, codec) == \
                jquant.blob_nbytes_codec(jcfg, bid, codec), (bid, codec)


def _jax_device_decode(codec, enc, specs, dtype_name):
    out = jquant.device_decode_jit(codec)(
        (jnp.asarray(np.frombuffer(enc, np.uint8)),), tuple(specs),
        dtype_name)
    return {name: np.asarray(jax.device_get(a))[0] for name, a in out.items()}


def _plain_decode(codec, enc, table, dtype):
    outs = [torch.empty(leaf.shape, dtype=dtype) for leaf in table]
    dequant.dequant(codec, serde._host_u8(enc), table, outs)
    return {leaf.name: o for leaf, o in zip(table, outs)}


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_plain_dequant_equals_jax_device_decode_on_traps(codec, dtype_name):
    specs, _, enc, table = trap_case(codec, dtype_name)
    assert sum(leaf.nbytes for leaf in table) == len(enc)
    offs = [leaf.offset for leaf in table]
    assert any(o % 4 for o in offs), offs  # the alignment trap is hit
    if codec == "int4":
        assert {leaf.layout for leaf in table} == {"q4", "raw"}
        assert any(leaf.cols % 128 and leaf.layout == "q4" for leaf in table)
    got = _plain_decode(codec, enc, table, DTYPES[dtype_name])
    want = _jax_device_decode(codec, enc, specs, dtype_name)
    for name, _ in specs:
        np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                      err_msg=name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_plain_dequant_equals_jax_device_decode_on_model_blobs(codec,
                                                               dtype_name):
    dtype = DTYPES[dtype_name]
    tcfg = dataclasses.replace(CFG, dtype=dtype)
    jcfg = dataclasses.replace(JCFG, dtype=jnp.dtype(dtype_name))
    for bid in all_ids(tcfg):
        raw = _raw(bid)
        if dtype != torch.bfloat16:  # the same values in f32 (exact) or
            raw = _src(CFG, bid)     # rounded to f16
            raw = b"".join(raw[name].to(dtype).numpy().tobytes()
                           for name, _ in serde.blob_specs(CFG, bid))
        enc = quant.encode_blob(tcfg, bid, raw, codec)
        assert enc == jquant.encode_blob(jcfg, bid, raw, codec)
        specs = serde.blob_specs(tcfg, bid)
        got = _plain_decode(codec, enc, quant.leaf_table(codec, specs, dtype),
                            dtype)
        want = _jax_device_decode(codec, enc, specs, dtype_name)
        host = jquant.decode_blob_host(jcfg, bid, enc, codec)
        for name, _ in specs:
            np.testing.assert_array_equal(_bits(got[name]), _bits(want[name]),
                                          err_msg=f"{bid}:{name}")
            np.testing.assert_array_equal(_bits(got[name]), _bits(host[name]),
                                          err_msg=f"{bid}:{name} host")


@pytest.mark.cuda
@pytest.mark.parametrize("shift", [0, 1, 2, 4])
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_cuda_dequant_matches_plain_version_on_traps(codec, dtype_name,
                                                     shift):
    """K2/K3 on the card, with the blob ``shift`` bytes into its buffer,
    against the plain version on the CPU: bit for bit, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dtype = DTYPES[dtype_name]
    _, _, enc, table = trap_case(codec, dtype_name)
    want = _plain_decode(codec, enc, table, dtype)
    buf = torch.zeros(len(enc) + shift, dtype=torch.uint8, device="cuda")
    buf[shift:].copy_(serde._host_u8(enc))
    outs = [torch.empty(leaf.shape, dtype=dtype, device="cuda")
            for leaf in table]
    assert dequant.dequant(codec, buf[shift:], table, outs) == 1
    for leaf, out in zip(table, outs):
        np.testing.assert_array_equal(_bits(out.cpu()), _bits(want[leaf.name]),
                                      err_msg=leaf.name)


def test_plain_dequant_launches_nothing():
    _, _, enc, table = trap_case("int4", "bfloat16")
    outs = [torch.empty(leaf.shape, dtype=torch.bfloat16) for leaf in table]
    launches = dequant.launches
    assert dequant.dequant("int4", serde._host_u8(enc), table, outs) == 0
    assert dequant.launches == launches


def test_dequant_refuses_a_blob_of_the_wrong_size():
    _, _, enc, table = trap_case("int8", "bfloat16")
    outs = [torch.empty(leaf.shape, dtype=torch.bfloat16) for leaf in table]
    with pytest.raises(ValueError, match="wire blob size"):
        dequant.dequant("int8", serde._host_u8(enc + b"\0"), table, outs)
    with pytest.raises(ValueError, match="layout"):
        dequant.dequant("int4", serde._host_u8(enc), table, outs)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_quantized_round_boots_like_jax_from_the_same_wire_blobs(codec):
    res, enc = _quantized_round(codec)
    assert res.via == "streamed per-layer"
    jres = jboot.boot_from_layers(JCFG, _holdings(jtypes, enc), codec=codec)
    err = np.abs(res.logits.float().numpy() - np.asarray(jres.logits))
    assert err.max() < LOGIT_ATOL, err.max()
    assert err.mean() < LOGIT_MEAN_ATOL, err.mean()
    # The booted weights are the JAX boot's, bit for bit.
    for name, _ in serde.layer_param_specs(CFG):
        np.testing.assert_array_equal(
            _bits(torch.stack(res.params["layers"][name])),
            _bits(jres.params["layers"][name]), err_msg=name)
