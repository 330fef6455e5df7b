"""Port parity: serving over the dissemination transport, on
``tests/test_generate_serving.py``'s cases (``:67-310``).

A booted node answers a ``GenerateReqMsg`` from its resident params
(``runtime/receiver.py::handle_generate_req``, ``_serve_generate_req``).
Each twin runs the JAX scenario on the port, at ``tiny`` on the CPU, and
holds against the JAX package what does not depend on thread timing: the
encoded message bytes, the greedy ids a node serves (a JAX receiver
booted from the same blobs, or the JAX test's own oracle), the int4-booted
ids, and the text of every refusal.  Sampled ids come from a
``torch.Generator`` (``ROADMAP.md``, "Known, stated differences"), so the
sampling twin holds seed-determinism within the port only.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models.generate import (
    generate as jgenerate)
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde

from torch_parity import (
    JAX, PKGS, TORCH, clean, close_all, mod, tcp_transports)

TIMEOUT = 60.0
CFG = tllama.CONFIGS["tiny"]
JCFG = jllama.CONFIGS["tiny"]
SEED = 0


@pytest.fixture(autouse=True)
def _clean():
    for pkg in PKGS:
        clean(pkg)
    yield
    for pkg in PKGS:
        mod(pkg, "transport").reset_registry()


@functools.lru_cache(maxsize=None)
def _raw_blobs():
    """The seeded ``tiny`` model's blobs: the port's ``init_params`` and
    the JAX package's give the same bytes."""
    blobs = tserde.blobs_from_params(CFG, tllama.init_params(CFG, SEED, "cpu"))
    assert blobs == jserde.blobs_from_params(
        JCFG, jllama.init_params(JCFG, jax.random.key(SEED)))
    return blobs


def all_ids():
    return list(range(CFG.n_layers)) + [tserde.head_blob_id(CFG)]


def blob_layer(pkg, data: bytes):
    t = mod(pkg, "core.types")
    return t.LayerSrc(inmem_data=bytearray(data), data_size=len(data),
                      meta=t.LayerMeta(location=t.LayerLocation.INMEM,
                                       source_type=t.SourceType.MEM))


def _requester(pkg, transport, my_id=None):
    return mod(pkg, "runtime.client").GenRequester(transport, my_id=my_id)


def _booted_pair(pkg, kind="inmem", codec="raw"):
    """Leader 0 seeds the whole ``tiny`` model (``codec`` wire blobs);
    node 1 receives and boots it.  Returns (leader, dest, transports)."""
    rt = mod(pkg, "runtime")
    blobs = _raw_blobs()
    if codec != "raw":
        quant = mod(pkg, "models.quant")
        cfg = CFG if pkg == TORCH else JCFG
        blobs = {bid: quant.encode_blob(cfg, bid, blobs[bid], codec)
                 for bid in blobs}
    assignment = {1: {bid: mod(pkg, "core.types").LayerMeta()
                      for bid in blobs}}
    if kind == "tcp":
        ts = tcp_transports(pkg, range(3))
    else:
        tr = mod(pkg, "transport")
        ts = {i: tr.InmemTransport(str(i)) for i in range(3)}
    leader = rt.LeaderNode(rt.Node(0, 0, ts[0]),
                           {bid: blob_layer(pkg, b) for bid, b in blobs.items()},
                           assignment)
    kw = {"boot_codec": codec} if codec != "raw" else {}
    if pkg == TORCH:
        dest = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {}, boot_cfg=CFG,
                               device="cpu", **kw)
    else:
        dest = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {}, boot_cfg=JCFG, **kw)
    return leader, dest, ts


def _serve(pkg, requests, kind="inmem", codec="raw", start=False,
           requester_id=None):
    """Boot node 1 and send it ``requests`` (prompt, max_new[, request
    keywords]) in order; returns each answer's ids, or the
    ``RuntimeError`` text it raised."""
    leader, dest, ts = _booted_pair(pkg, kind, codec)
    requester = None
    try:
        dest.announce()
        if start:
            assert leader.start_distribution().get(timeout=TIMEOUT)
        assert leader.ready().get(timeout=TIMEOUT)
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        requester = _requester(pkg, ts[2], requester_id)
        out = []
        for prompt, max_new, *kw in requests:
            try:
                out.append(requester.request(1, prompt, max_new=max_new,
                                             timeout=TIMEOUT,
                                             **(kw[0] if kw else {})))
            except RuntimeError as e:
                out.append(str(e))
        return out
    finally:
        close_all(*([requester] if requester else []), leader, dest, ts)


def _jax_generate(params, prompt, max_new):
    want = jgenerate(params, jnp.asarray([prompt], jnp.int32), JCFG,
                     max_new=max_new)
    return np.asarray(jax.device_get(want))[0].tolist()


def test_generate_messages_roundtrip_json():
    """``test_generate_serving.py:67``: both messages round-trip, and the
    port's encoded payloads equal the JAX package's byte for byte (each
    package decodes the other's)."""
    payloads = {}
    for pkg in PKGS:
        msgs = mod(pkg, "transport.messages")
        req = msgs.GenerateReqMsg(3, req_id=7, prompt=[1, 2, 3], max_new=4)
        resp = msgs.GenerateRespMsg(1, req_id=7, tokens=[9, 8], error="")
        payloads[pkg] = (req.to_payload(), resp.to_payload())
    assert payloads[TORCH] == payloads[JAX]
    for pkg in PKGS:
        msgs = mod(pkg, "transport.messages")
        other = payloads[JAX if pkg == TORCH else TORCH]
        back = msgs.decode_msg(msgs.MsgType.GENERATE_REQ, other[0])
        assert (back.src_id, back.req_id, back.prompt, back.max_new) == (
            3, 7, [1, 2, 3], 4)
        back = msgs.decode_msg(msgs.MsgType.GENERATE_RESP, other[1])
        assert (back.src_id, back.req_id, back.tokens, back.error) == (
            1, 7, [9, 8], "")


def test_booted_node_serves_generation_requests():
    """``test_generate_serving.py:92``: the booted port node's greedy ids
    equal a JAX receiver's booted from the same blobs, and a repeated
    request answers the same ids."""
    prompt = [5, 7, 11, 13]
    got = {pkg: _serve(pkg, [(prompt, 6), (prompt, 6)], start=True)
           for pkg in PKGS}
    assert got[TORCH][0] == got[TORCH][1]
    assert got[TORCH] == got[JAX]
    want = _jax_generate(jllama.init_params(JCFG, jax.random.key(SEED)),
                         prompt, 6)
    assert got[JAX][0] == want


def test_sampled_generation_is_seed_deterministic():
    """``test_generate_serving.py:123``, within the port: the same seed
    samples the same ids, every id is in the vocab, and a negative
    temperature is refused with the JAX package's text."""
    leader, dest, ts = _booted_pair(TORCH)
    try:
        dest.announce()
        assert leader.ready().get(timeout=TIMEOUT)
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        requester = _requester(TORCH, ts[2], 2)
        try:
            a = requester.request(1, [3, 5], max_new=8, timeout=TIMEOUT,
                                  temperature=0.8, seed=42)
            b = requester.request(1, [3, 5], max_new=8, timeout=TIMEOUT,
                                  temperature=0.8, seed=42)
            assert a == b  # same seed, same sampled tokens
            assert all(0 <= t < CFG.vocab for t in a)
            with pytest.raises(RuntimeError, match="temperature") as err:
                requester.request(1, [3], max_new=2, timeout=TIMEOUT,
                                  temperature=-1.0)
        finally:
            requester.close()
    finally:
        close_all(leader, dest, ts)
    assert [str(err.value)] == _serve(JAX, [([3], 2, {"temperature": -1.0})])


def test_generation_request_over_real_tcp():
    """``test_generate_serving.py:149``: request and answer over real
    sockets, the requester a topology node of its own; the ids equal the
    JAX package's ``generate`` on the same params."""
    prompt = [3, 1, 4, 1, 5]
    (got,) = _serve(TORCH, [(prompt, 4)], kind="tcp", requester_id=2)
    want = _jax_generate(jllama.init_params(JCFG, jax.random.key(SEED)),
                         prompt, 4)
    assert got == want


def _unbooted_refusal(pkg):
    rt, tr = mod(pkg, "runtime"), mod(pkg, "transport")
    ts = {i: tr.InmemTransport(str(i)) for i in range(2)}
    r = rt.ReceiverNode(rt.Node(1, 0, ts[1]), {})
    requester = _requester(pkg, ts[0])
    try:
        with pytest.raises(RuntimeError, match="no booted model") as err:
            requester.request(1, [1, 2], max_new=2, timeout=TIMEOUT)
        return str(err.value)
    finally:
        close_all(requester, r, ts)


def test_generation_request_to_unbooted_node_errors():
    """``test_generate_serving.py:185``: a node with no boot config
    answers with an error, the JAX package's text."""
    assert _unbooted_refusal(TORCH) == _unbooted_refusal(JAX)


def test_serving_from_int4_booted_model():
    """``test_generate_serving.py:201``: a node booted from int4 wire
    blobs serves; its greedy ids equal the port's ``generate`` on the same
    dequantized params and the JAX package's int4-booted node's ids."""
    from distributed_llm_dissemination_tpu_torch.models import quant
    from distributed_llm_dissemination_tpu_torch.models.generate import (
        generate)

    got = {pkg: _serve(pkg, [([9, 4], 5)], codec="int4", requester_id=2)[0]
           for pkg in PKGS}
    raw = _raw_blobs()
    enc = {bid: quant.encode_blob(CFG, bid, raw[bid], "int4")
           for bid in all_ids()}
    stacked = quant.stacked_from_blobs_host(CFG, enc,
                                            list(range(CFG.n_layers)), "int4")
    head = quant.head_from_blob_host(CFG, enc[tserde.head_blob_id(CFG)],
                                     "int4")
    params = {"embed": head["embed"], "layers": dict(stacked),
              "ln_f": head["ln_f"], "lm_head": head["lm_head"]}
    want = generate(params, torch.tensor([[9, 4]], dtype=torch.long), CFG,
                    max_new=5)[0].tolist()
    assert got[TORCH] == want
    assert got[TORCH] == got[JAX]


def _leader_refusal(pkg):
    rt, tr = mod(pkg, "runtime"), mod(pkg, "transport")
    ts = {i: tr.InmemTransport(str(i)) for i in range(2)}
    leader = rt.LeaderNode(rt.Node(0, 0, ts[0]), {},
                           {1: {0: mod(pkg, "core.types").LayerMeta()}})
    requester = _requester(pkg, ts[1], 1)
    try:
        with pytest.raises(RuntimeError, match="leader seat serves no") as err:
            requester.request(0, [1, 2], max_new=2, timeout=TIMEOUT)
        return str(err.value)
    finally:
        close_all(requester, leader, ts)


def test_generation_request_to_leader_is_refused_not_dropped():
    """``test_generate_serving.py:246``: the leader seat refuses a
    misdirected request at once, with the JAX package's text."""
    assert _leader_refusal(TORCH) == _leader_refusal(JAX)


BAD = [([], 2, "prompt"), ([CFG.vocab + 5], 2, "vocab"), ([1], 0, "max_new"),
       # Upper bounds: one peer must not allocate an arbitrarily large KV
       # cache or force a decode per giant shape.
       ([1], 10 ** 6, "serve limit"), ([1] * 10 ** 5, 2, "serve limit")]


def _bad_prompt_refusals(pkg):
    leader, dest, ts = _booted_pair(pkg)
    texts = []
    try:
        dest.announce()
        assert leader.ready().get(timeout=TIMEOUT)
        assert set(leader.boot_ready().get(timeout=TIMEOUT)) == {1}
        requester = _requester(pkg, ts[2])
        try:
            for prompt, max_new, match in BAD:
                with pytest.raises(RuntimeError, match=match) as err:
                    requester.request(1, prompt, max_new=max_new,
                                      timeout=TIMEOUT)
                texts.append(str(err.value))
            # Concurrency gate: with the budget spent a request gets an
            # immediate busy refusal; restoring it restores service.
            dest.SERVE_MAX_CONCURRENT = 0
            try:
                with pytest.raises(RuntimeError, match="busy") as err:
                    requester.request(1, [1], max_new=2, timeout=TIMEOUT)
                texts.append(str(err.value))
            finally:
                del dest.SERVE_MAX_CONCURRENT  # back to the class attr
            assert requester.request(1, [1], max_new=2,
                                     timeout=TIMEOUT) is not None
            # The budget returns after the decode thread's finally (the
            # reply races it by design: poll briefly).
            import time as _t
            deadline = _t.monotonic() + 5.0
            while dest._serve_active and _t.monotonic() < deadline:
                _t.sleep(0.01)
            assert dest._serve_active == 0
        finally:
            requester.close()
    finally:
        close_all(leader, dest, ts)
    return texts


def test_generation_request_rejects_bad_prompts():
    """``test_generate_serving.py:262``: empty, out-of-vocab, zero and
    oversized requests and a spent concurrency budget are refused, each
    with the JAX package's text."""
    assert _bad_prompt_refusals(TORCH) == _bad_prompt_refusals(JAX)
