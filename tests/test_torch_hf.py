"""The port's Hugging Face checkpoint import (``models/hf.py``,
``models/safetensors_io.py``), held against the JAX package's
``models/hf.py`` and against ``transformers``.

Mirrored from ``tests/test_hf.py`` on its fixture (a seeded
``transformers`` tiny Llama, f32): config mapping, logits parity with
``transformers`` (``rtol = atol = 2e-3``, that test's tolerance), the
serde round trip, disseminate then boot, the ``rope_scaling`` rejection,
greedy ids equal to ``transformers.generate``, and the int4
disseminate-boot-decode loop with that test's bars (a prefix of 4 equal
ids, agreement at least 0.5).  Its slow two-stage pod test is mirrored
in ``tests/test_torch_pp_serve.py``.

Added for the port:

- the reader equals ``safetensors.safe_open`` on F32, F16 and BF16
  tensors of two-shard checkpoints, tied and untied;
- under ``ModelCodec`` int8 the seeder's wire blobs and the booted
  weights equal the JAX package's, bit for bit;
- the port's blobs equal the JAX package's byte for byte for every blob
  of f32, bf16 and f16 checkpoints, untied and tied, of an f32-stored
  checkpoint whose config names bf16 (a conversion on read), and of a
  bf16 checkpoint whose config names ``"dtype"`` and no ``torch_dtype``
  (read as f32 by both), which also boots in f32 like the JAX package;
- every rejection raises the JAX package's error type and message;
- ``models/hf.py`` imports and reads with ``jax``, ``safetensors``,
  ``transformers`` and ``ml_dtypes`` blocked;
- a float16 model fabricates (raw, int8 and int4, as JAX does) and boots
  in f16, its logits and greedy ids held against the JAX package's;
- a mixed cluster over TCP: a JAX leader fabricating from the checkpoint
  with a port seeder fabricating from the same checkpoint, delivered
  byte-exact to a port dest with every digest verified.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("safetensors")

from distributed_llm_dissemination_tpu.core import config as jcfg_mod  # noqa: E402
from distributed_llm_dissemination_tpu.core import types as jtypes  # noqa: E402
from distributed_llm_dissemination_tpu.models import hf as jhf  # noqa: E402
from distributed_llm_dissemination_tpu.models import quant as jquant  # noqa: E402
from distributed_llm_dissemination_tpu.runtime import (  # noqa: E402
    FlowRetransmitLeaderNode as JLeader,
    Node as JNode,
)
from distributed_llm_dissemination_tpu_torch.core import config as cfg_mod  # noqa: E402
from distributed_llm_dissemination_tpu_torch.core.types import (  # noqa: E402
    LayerLocation,
    LayerMeta,
    SourceType,
)
from distributed_llm_dissemination_tpu_torch.models import hf  # noqa: E402
from distributed_llm_dissemination_tpu_torch.models import quant, serde  # noqa: E402
from distributed_llm_dissemination_tpu_torch.models import safetensors_io  # noqa: E402
from distributed_llm_dissemination_tpu_torch.models.generate import (  # noqa: E402
    generate,
)
from distributed_llm_dissemination_tpu_torch.models.llama import forward  # noqa: E402
from distributed_llm_dissemination_tpu_torch.runtime import (  # noqa: E402
    FlowRetransmitLeaderNode,
    FlowRetransmitReceiverNode,
    Node,
)
from distributed_llm_dissemination_tpu_torch.runtime import boot as tboot  # noqa: E402
from distributed_llm_dissemination_tpu_torch.transport import (  # noqa: E402
    InmemTransport,
    reset_registry,
)

from test_torch_dissemination import NIC, _close, _drive, _transports  # noqa: E402

TIMEOUT = 30.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": torch.float32, "float16": torch.float16,
          "bfloat16": torch.bfloat16}
BASE_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "vocab_size": 256,
    "hidden_size": 128, "intermediate_size": 256,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
    "rope_theta": 500000.0,
}


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(
        vocab_size=256, hidden_size=128, intermediate_size=256,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=500000.0, rms_norm_eps=1e-5, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    path = str(tmp_path_factory.mktemp("hf") / "tiny-llama")
    model.save_pretrained(path)
    return path


@pytest.fixture(autouse=True)
def _clean():
    reset_registry()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    reset_registry()


def _state(seed=0, tied=False):
    """A seeded Llama state dict in HF's layout (f32 CPU tensors)."""
    g = torch.Generator().manual_seed(seed)
    d, f, v, kv = 128, 256, 256, 64
    state = {"model.embed_tokens.weight": torch.randn(v, d, generator=g),
             "model.norm.weight": 1 + 0.1 * torch.randn(d, generator=g)}
    if not tied:
        state["lm_head.weight"] = torch.randn(v, d, generator=g)
    for i in range(2):
        p = f"model.layers.{i}."
        for key, shape in (("self_attn.q_proj.weight", (d, d)),
                           ("self_attn.k_proj.weight", (kv, d)),
                           ("self_attn.v_proj.weight", (kv, d)),
                           ("self_attn.o_proj.weight", (d, d)),
                           ("input_layernorm.weight", (d,)),
                           ("post_attention_layernorm.weight", (d,)),
                           ("mlp.gate_proj.weight", (f, d)),
                           ("mlp.up_proj.weight", (f, d)),
                           ("mlp.down_proj.weight", (d, f))):
            state[p + key] = 0.05 * torch.randn(*shape, generator=g)
    return state


def _write_checkpoint(path, stored, torch_dtype, tied=False, shards=2,
                      **config):
    """A checkpoint directory: ``config.json`` (``torch_dtype`` named, as
    older ``transformers`` wrote it) and the state in ``stored`` dtype,
    split round-robin over ``shards`` safetensors files."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    state = {k: t.to(DTYPES[stored]) for k, t in _state(tied=tied).items()}
    keys = sorted(state)
    for s in range(shards):
        part = {k: state[k] for k in keys[s::shards]}
        save_file(part, os.path.join(
            path, f"model-{s + 1:05d}-of-{shards:05d}.safetensors"))
    conf = dict(BASE_CONFIG, torch_dtype=torch_dtype,
                tie_word_embeddings=tied, **config)
    with open(os.path.join(path, "config.json"), "w") as fh:
        json.dump({k: v for k, v in conf.items() if v is not None}, fh)
    return path


def _hf_logits(path, tokens):
    from transformers import LlamaForCausalLM

    model = LlamaForCausalLM.from_pretrained(path).eval()
    with torch.no_grad():
        out = model(torch.tensor(tokens)).logits
    return out.numpy()


def _hf_generate(path, prompt, max_new):
    from transformers import LlamaForCausalLM

    model = LlamaForCausalLM.from_pretrained(path).eval()
    with torch.no_grad():
        out = model.generate(torch.tensor(prompt, dtype=torch.long),
                             max_new_tokens=max_new, do_sample=False,
                             pad_token_id=0)
    return out[:, prompt.shape[1]:].numpy()


# ------------------------------------------------- mirrored from test_hf.py

def test_config_from_dir_maps_fields(hf_dir):
    cfg = hf.config_from_dir(hf_dir)
    assert cfg.vocab == 256 and cfg.d_model == 128
    assert cfg.n_layers == 2 and cfg.n_heads == 4 and cfg.n_kv_heads == 2
    assert cfg.d_ff == 256 and cfg.rope_theta == 500000.0
    assert cfg.dtype == torch.float32
    jcfg = jhf.config_from_dir(hf_dir)
    for field in ("name", "vocab", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "rope_theta", "norm_eps",
                  "n_experts", "top_k"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_logits_parity_with_transformers(hf_dir):
    cfg = hf.config_from_dir(hf_dir)
    params = hf.params_from_dir(hf_dir, device="cpu")
    tokens = np.arange(32, dtype=np.int64).reshape(2, 16) % cfg.vocab
    ours = forward(params, torch.from_numpy(tokens), cfg).numpy()
    theirs = _hf_logits(hf_dir, tokens)
    np.testing.assert_allclose(ours, theirs, rtol=2e-3, atol=2e-3)


def test_blobs_roundtrip_through_serde(hf_dir):
    cfg = hf.config_from_dir(hf_dir)
    name = "hf:" + hf_dir
    head_id = serde.head_blob_id(cfg)
    blobs = {b: hf.blob_from_name(name, b) for b in range(head_id + 1)}
    params = serde.params_from_blobs(cfg, blobs)
    src = hf.params_from_dir(hf_dir, device="cpu")
    assert torch.equal(params["embed"], src["embed"])
    for k in src["layers"]:
        assert torch.equal(params["layers"][k], src["layers"][k]), k
    assert torch.equal(params["lm_head"], src["lm_head"])


def _round(cfg, blob_ids, seed_layers, codec="raw"):
    """A mode-3 round on the CPU: seeder 1 holds ``seed_layers``, dest 2
    boots ``cfg`` under ``codec``.  Returns the dest's boot result."""
    assignment = {2: {b: LayerMeta() for b in blob_ids}}
    ts = {i: InmemTransport(str(i)) for i in range(3)}
    leader = FlowRetransmitLeaderNode(
        Node(0, 0, ts[0]), {}, assignment,
        {i: 10**9 for i in range(3)}, expected_nodes={1, 2},
    )
    seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), seed_layers)
    dest = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {}, boot_cfg=cfg,
                                      boot_codec=codec, device="cpu")
    try:
        for r in (seeder, dest):
            r.announce()
        assert leader.start_distribution().get(timeout=TIMEOUT) == assignment
        assert leader.ready().get(timeout=TIMEOUT) == assignment
        dest.ready().get(timeout=TIMEOUT)
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {2}
        assert dest.layers[0].meta.location == LayerLocation.INMEM
        res = dest.boot_result
        assert res is not None and res.kind == "full"
        return res
    finally:
        leader.close()
        for r in (seeder, dest):
            r.close()
        for t in ts.values():
            t.close()


def _seed_layers(name, cfg, codec="raw"):
    blob_ids = list(range(serde.head_blob_id(cfg) + 1))
    nc = cfg_mod.NodeConf(
        id=1, addr="1",
        initial_layers={SourceType.MEM: {b: 0 for b in blob_ids}},
        sources={SourceType.MEM: 0},
    )
    return blob_ids, cfg_mod.create_layers(nc, save_disk=False, model=name,
                                           model_codec=codec)


def test_disseminate_hf_checkpoint_then_boot(hf_dir):
    """create_layers fabricates blobs from the checkpoint, mode 3
    disseminates, the dest boots, and the booted logits equal the
    transformers implementation's."""
    name = "hf:" + hf_dir
    cfg = hf.config_from_dir(hf_dir)
    blob_ids, seed_layers = _seed_layers(name, cfg)
    assert seed_layers[0].data_size == serde.blob_nbytes(cfg, 0)
    res = _round(cfg, blob_ids, seed_layers)
    theirs = _hf_logits(hf_dir, np.zeros((1, 16), np.int64))
    np.testing.assert_allclose(res.logits.numpy(), theirs,
                               rtol=2e-3, atol=2e-3)


def test_rope_scaling_checkpoint_rejected(tmp_path):
    d = dict(BASE_CONFIG,
             rope_scaling={"rope_type": "llama3", "factor": 8.0})
    (tmp_path / "config.json").write_text(json.dumps(d))
    with pytest.raises(ValueError, match="rope_scaling"):
        hf.config_from_dir(str(tmp_path))


def test_greedy_generate_matches_transformers(hf_dir):
    cfg = hf.config_from_dir(hf_dir)
    params = hf.params_from_dir(hf_dir, device="cpu")
    prompt = np.array([[11, 42, 7, 199]], np.int64)
    ours = generate(params, torch.from_numpy(prompt), cfg, max_new=12)
    np.testing.assert_array_equal(ours.numpy(),
                                  _hf_generate(hf_dir, prompt, 12))


def test_hf_checkpoint_through_int4_disseminate_boot_decode(hf_dir):
    """The checkpoint rides the int4 codec end to end; the booted
    engine's greedy ids against ``transformers.generate`` with
    ``tests/test_hf.py``'s bars (prefix >= 4, agreement >= 0.5)."""
    name = "hf:" + hf_dir
    cfg = hf.config_from_dir(hf_dir)
    blob_ids, seed_layers = _seed_layers(name, cfg, codec="int4")
    for b in blob_ids:
        assert seed_layers[b].data_size == quant.blob_nbytes_codec(
            cfg, b, "int4")
    res = _round(cfg, blob_ids, seed_layers, codec="int4")
    prompt = np.array([[11, 42, 7, 199]], np.int64)
    ours = generate(res.params, torch.from_numpy(prompt), cfg,
                    max_new=16)[0].numpy()
    theirs = _hf_generate(hf_dir, prompt, 16)[0]
    agreement = float((ours == theirs).mean())
    prefix = 0
    for a, b in zip(ours, theirs):
        if a != b:
            break
        prefix += 1
    assert prefix >= 4, (prefix, ours.tolist(), theirs.tolist())
    assert agreement >= 0.5, (agreement, ours.tolist(), theirs.tolist())


# --------------------------------------------------------- added for the port

def test_hf_checkpoint_int8_round_boots_like_jax(hf_dir):
    """The checkpoint under ``ModelCodec`` int8: the seeder's wire blobs
    equal the JAX package's, and the booted weights equal the JAX boot's
    of the same wire blobs, bit for bit."""
    from distributed_llm_dissemination_tpu.runtime import boot as jboot

    from test_torch_dissemination import _holdings

    name = "hf:" + hf_dir
    cfg = hf.config_from_dir(hf_dir)
    blob_ids, seed_layers = _seed_layers(name, cfg, codec="int8")
    wire = {b: bytes(seed_layers[b].inmem_data) for b in blob_ids}
    for b in blob_ids:
        assert wire[b] == jquant.encode_blob(
            jhf.config_from_dir(hf_dir), b, jhf.blob_from_name(name, b),
            "int8"), b
    res = _round(cfg, blob_ids, seed_layers, codec="int8")
    jres = jboot.boot_from_layers(jhf.config_from_dir(hf_dir),
                                  _holdings(jtypes, wire), codec="int8")
    for k in serde.layer_param_specs(cfg):
        np.testing.assert_array_equal(
            torch.stack(res.params["layers"][k[0]]).numpy(),
            np.asarray(jres.params["layers"][k[0]]), err_msg=k[0])
    np.testing.assert_array_equal(res.params["lm_head"].numpy(),
                                  np.asarray(jres.params["lm_head"]))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("stored", sorted(DTYPES))
def test_reader_equals_safe_open(tmp_path, stored, tied):
    from safetensors import safe_open

    names = {"float32": "F32", "float16": "F16", "bfloat16": "BF16"}
    path = _write_checkpoint(str(tmp_path / "ck"), stored, stored, tied=tied)
    index = safetensors_io.index(path)
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    assert len(files) == 2 and len({e.file for e in index.values()}) == 2
    seen = set()
    for fname in files:
        with safe_open(os.path.join(path, fname), framework="pt") as f:
            for key in f.keys():
                want = f.get_tensor(key)
                got = safetensors_io.read_tensor(path, key)
                assert index[key].dtype == names[stored]
                assert got.dtype == want.dtype and got.shape == want.shape
                assert torch.equal(got.view(torch.uint8),
                                   want.view(torch.uint8)), key
                seen.add(key)
    assert seen == set(index)
    assert ("lm_head.weight" in seen) is not tied
    if stored == "bfloat16":  # numpy has no bf16: the bits come back
        assert safetensors_io.read(path, sorted(seen)[0]).dtype == np.uint16


def test_reader_is_lazy_and_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "ck")
    os.makedirs(path)
    save_file({"a": torch.arange(6, dtype=torch.int64).reshape(2, 3),
               "b": torch.ones(4)}, os.path.join(path, "x.safetensors"))
    assert safetensors_io.index(path)["a"].shape == (2, 3)
    np.testing.assert_array_equal(safetensors_io.read(path, "b"),
                                  np.ones(4, np.float32))
    with pytest.raises(ValueError, match="I64"):
        safetensors_io.read(path, "a")
    with pytest.raises(KeyError):
        safetensors_io.read(path, "c")


def _blob_cases():
    """(stored, named, tied).  ``named`` None: the config names no
    ``torch_dtype`` but ``"dtype": "bfloat16"``, as ``transformers`` 4.56
    and later write it; both packages read only ``torch_dtype`` and serve
    such a checkpoint in f32."""
    cases = [(s, s, tied) for s in sorted(DTYPES) for tied in (False, True)]
    return cases + [("float32", "bfloat16", False), ("bfloat16", None, False)]


def _write_current_config_checkpoint(path, stored="bfloat16"):
    """A checkpoint whose config.json has ``"dtype"`` and no
    ``torch_dtype``."""
    return _write_checkpoint(path, stored, None, dtype="bfloat16")


@pytest.mark.parametrize("stored,named,tied", _blob_cases())
def test_blobs_equal_jax_byte_for_byte(tmp_path, stored, named, tied):
    if named is None:
        path = _write_current_config_checkpoint(str(tmp_path / "ck"), stored)
    else:
        path = _write_checkpoint(str(tmp_path / "ck"), stored, named,
                                 tied=tied)
    cfg, jcfg = hf.config_from_dir(path), jhf.config_from_dir(path)
    assert cfg.dtype == DTYPES[named or "float32"]
    assert np.dtype(jcfg.dtype).name == (named or "float32")
    name = "hf:" + path
    for b in range(serde.head_blob_id(cfg) + 1):
        got = hf.blob_from_name(name, b)
        assert got == jhf.blob_from_name(name, b), b
        assert len(got) == serde.blob_nbytes(cfg, b)
    if tied:
        head = hf.params_from_dir(path, device="cpu")
        assert torch.equal(head["lm_head"], head["embed"].T)


def _rejections(tmp_path):
    """(label, path or name, call) cases each package must refuse alike."""
    def conf(label, **changes):
        d = dict(BASE_CONFIG, **changes)
        p = tmp_path / label
        p.mkdir()
        (p / "config.json").write_text(json.dumps(d))
        return str(p)

    good = _write_checkpoint(str(tmp_path / "good"), "float32", "float32")
    partial = _write_checkpoint(str(tmp_path / "partial"), "float32",
                                "float32", shards=2)
    os.remove(os.path.join(partial, "model-00002-of-00002.safetensors"))
    return [
        ("rope_scaling", "config", conf(
            "rope", rope_scaling={"rope_type": "llama3", "factor": 8.0})),
        ("arch", "config", conf("arch", architectures=["MistralForCausalLM"])),
        ("attention_bias", "config", conf("abias", attention_bias=True)),
        ("mlp_bias", "config", conf("mbias", mlp_bias=True)),
        ("head_dim", "config", conf("hd", head_dim=64)),
        ("torch_dtype", "config", conf("fp8", torch_dtype="float8_e4m3fn")),
        ("no config", "config", str(tmp_path / "missing")),
        ("not hf", "name", "tiny"),
        ("no weights", "blob", "hf:" + conf("empty")),
        ("missing tensor", "blob", "hf:" + partial),
        ("blob range", "blob", "hf:" + good),
    ]


def _outcome(mod, kind, arg):
    try:
        if kind == "config":
            mod.config_from_dir(arg)
        elif kind == "name":
            mod.config_from_name(arg)
        else:
            for b in range(4 if arg.endswith("good") else 3):
                mod.blob_from_name(arg, b)
    except Exception as e:  # noqa: BLE001 -- compared below
        return type(e), str(e)
    return None


def test_every_rejection_raises_like_jax(tmp_path):
    for label, kind, arg in _rejections(tmp_path):
        got, want = _outcome(hf, kind, arg), _outcome(jhf, kind, arg)
        assert want is not None, label
        assert got == want, label


def test_imports_and_reads_with_jax_safetensors_transformers_blocked(hf_dir):
    code = (
        "import sys\n"
        "for m in ('jax', 'safetensors', 'transformers', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "from distributed_llm_dissemination_tpu_torch.models import hf\n"
        "from distributed_llm_dissemination_tpu_torch.models import "
        "safetensors_io\n"
        f"name = 'hf:' + {hf_dir!r}\n"
        "cfg = hf.config_from_name(name)\n"
        "blob = hf.blob_from_name(name, cfg.n_layers)\n"
        "print(len(blob))\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "k.split('.')[0] in ('jax', 'safetensors', 'transformers', "
        "'ml_dtypes')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    cfg = hf.config_from_dir(hf_dir)
    assert int(out.stdout.split()[-1]) == serde.blob_nbytes(
        cfg, cfg.n_layers)


def test_float16_fabricates_like_jax_and_boots(tmp_path):
    """A float16 checkpoint fabricates like JAX (raw, int8 and int4 blobs)
    and boots in f16, with no cast to bf16: the booted logits agree with
    the JAX package's forward of the same checkpoint within
    ``tests/test_torch_model.py``'s bound (max 0.1, mean 0.02), and the
    greedy ids equal JAX's."""
    import jax.numpy as jnp

    from distributed_llm_dissemination_tpu.models import generate as jgen
    from distributed_llm_dissemination_tpu.models import llama as jllama

    path = _write_checkpoint(str(tmp_path / "ck"), "float16", "float16")
    name = "hf:" + path
    cfg, jcfg = hf.config_from_dir(path), jhf.config_from_dir(path)
    assert cfg.dtype == torch.float16
    blob_ids, seed_layers = _seed_layers(name, cfg)
    for codec in ("int8", "int4"):
        for b in blob_ids:
            raw = hf.blob_from_name(name, b)
            assert quant.encode_blob(cfg, b, raw, codec) == \
                jquant.encode_blob(jcfg, b, raw, codec), (codec, b)
    warm = tboot.precompile_boot(cfg, blob_ids, device="cpu")
    assert warm["compiled"], warm
    res = tboot.boot_from_layers(cfg, seed_layers, device="cpu")
    assert res.kind == "full"
    assert all(t.dtype == torch.float16
               for per_layer in res.params["layers"].values()
               for t in per_layer)
    assert res.params["embed"].dtype == torch.float16
    jparams = jhf.params_from_dir(path)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 16))
    got = forward(res.params, torch.from_numpy(tokens), cfg).numpy()
    want = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg))
    err = np.abs(got - want)
    assert err.max() < 0.1 and err.mean() < 0.02, (err.max(), err.mean())
    prompt = tokens[:1, :6]
    ids = generate(res.params, torch.from_numpy(prompt), cfg, max_new=12)
    jids = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg, 12))
    np.testing.assert_array_equal(ids.numpy(), jids)


def test_config_without_torch_dtype_boots_f32_like_jax(tmp_path):
    """A bf16 checkpoint whose config.json names ``"dtype"`` and no
    ``torch_dtype`` (a current ``transformers``'s): both packages read it
    as f32, so it fabricates into f32 blobs equal byte for byte and boots
    in f32.  The booted logits agree with the JAX package's forward of the
    same checkpoint within ``tests/test_torch_model.py``'s bound (max 0.1,
    mean 0.02; in f32 they agree far closer) and the greedy ids equal
    JAX's."""
    import jax.numpy as jnp

    from distributed_llm_dissemination_tpu.models import generate as jgen
    from distributed_llm_dissemination_tpu.models import llama as jllama

    path = _write_current_config_checkpoint(str(tmp_path / "ck"))
    with open(os.path.join(path, "config.json")) as fh:
        conf = json.load(fh)
    assert "torch_dtype" not in conf and conf["dtype"] == "bfloat16"
    name = "hf:" + path
    cfg, jcfg = hf.config_from_dir(path), jhf.config_from_dir(path)
    assert cfg.dtype == torch.float32
    assert np.dtype(jcfg.dtype).name == "float32"
    blob_ids, seed_layers = _seed_layers(name, cfg)
    warm = tboot.precompile_boot(cfg, blob_ids, device="cpu")
    assert warm["compiled"], warm
    res = tboot.boot_from_layers(cfg, seed_layers, device="cpu")
    assert res.kind == "full"
    assert all(t.dtype == torch.float32
               for per_layer in res.params["layers"].values()
               for t in per_layer)
    assert res.params["embed"].dtype == torch.float32
    jparams = jhf.params_from_dir(path)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 16))
    got = forward(res.params, torch.from_numpy(tokens), cfg).numpy()
    want = np.asarray(jllama.forward(jparams, jnp.asarray(tokens), jcfg))
    err = np.abs(got - want)
    assert err.max() < 0.1 and err.mean() < 0.02, (err.max(), err.mean())
    prompt = tokens[:1, :6]
    ids = generate(res.params, torch.from_numpy(prompt), cfg, max_new=12)
    jids = np.asarray(jgen.generate(jparams, jnp.asarray(prompt), jcfg, 12))
    np.testing.assert_array_equal(ids.numpy(), jids)


@pytest.mark.timeout(120)
def test_jax_leader_and_port_seeder_fabricate_the_same_checkpoint(hf_dir):
    """A JAX leader and a port seeder each fabricate every blob from the
    checkpoint; a port dest receives from both over TCP and verifies every
    blob against the JAX leader's digests."""
    from distributed_llm_dissemination_tpu_torch.core import types as ttypes

    from distributed_llm_dissemination_tpu_torch.utils import telemetry

    telemetry.reset_run()
    name = "hf:" + hf_dir
    cfg = hf.config_from_dir(hf_dir)
    blob_ids = list(range(serde.head_blob_id(cfg) + 1))
    jnc = jcfg_mod.NodeConf(
        id=0, addr="0",
        initial_layers={jtypes.SourceType.MEM: {b: 0 for b in blob_ids}},
        sources={jtypes.SourceType.MEM: 0})
    jlayers = jcfg_mod.create_layers(jnc, save_disk=False, model=name)
    _, tlayers = _seed_layers(name, cfg)
    assignment = {2: {b: jtypes.LayerMeta() for b in blob_ids}}
    ts = _transports({0: "jax", 1: "port", 2: "port"})
    # The leader's NIC a thousandth of the seeder's: the max-flow plan
    # sends nearly every byte from the port seeder.
    nic = {**NIC, 0: NIC[1] >> 10}
    leader = JLeader(JNode(0, 0, ts[0]), jlayers, assignment, nic,
                     expected_nodes={1, 2})
    seeder = FlowRetransmitReceiverNode(Node(1, 0, ts[1]), tlayers)
    dest = FlowRetransmitReceiverNode(Node(2, 0, ts[2]), {})
    try:
        _drive(leader, [seeder, dest])
        for b in blob_ids:
            src = dest.layers[b]
            assert src.meta.location == ttypes.LayerLocation.INMEM
            assert bytes(src.inmem_data[:src.data_size]) == \
                jhf.blob_from_name(name, b)
        assert dest._digest_ok >= set(blob_ids)
        sent = telemetry.snapshot().get("links", {}).get("1->2", {})
        assert sent.get("tx_bytes", 0) > 0, "the port seeder sent nothing"
    finally:
        _close([leader, seeder, dest], ts)
