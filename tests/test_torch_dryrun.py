"""Port parity: the multi-device dry run (``cli/dryrun.py``) against the
JAX package's ``__graft_entry__`` (not edited), on the CPU.

- ``entry(device="cpu", config="tiny")``'s logits against the JAX
  ``entry()``'s forward with ``_flagship_cfg`` patched to ``tiny``, within
  ``tests/test_torch_model.py``'s tolerance (``LOGIT_ATOL`` on the max,
  ``LOGIT_MEAN_ATOL`` on the mean).
- ``dryrun_dissemination`` and ``dryrun_fabric`` in this process at n = 1
  and 2 on ``tiny``, beside the JAX ``_dryrun_dissemination`` and
  ``_dryrun_fabric`` run in the test (their printed lines parsed): the
  port is handed the JAX package's own blobs, so its byte-exact landing
  check holds it to the bytes the JAX round lands; the loss from the
  landed tensors within ``LOSS_TOL`` (0.02, ``tests/test_torch_sharded.py``'s
  bf16 loss bound) of the JAX line's; the decode's ids equal to the JAX
  ``generate`` that the JAX round holds its pod decode to; no
  ``LayerMsg`` on the fabric's transport and a full boot in both.
- The whole ``dryrun_multichip(n, device="cpu")`` at n = 2 and 4: the
  training step in a gloo world of n processes (a ``FileStore`` in the
  test's ``tmp_path``, every child joined or killed by the launcher, a
  per-test timeout), its loss within ``LOSS_TOL`` of the JAX step on
  ``make_train_mesh(n)`` in this process and ``opt["step"] == 1``.
- The module imports with ``jax`` blocked, and without a card a run not
  given ``device="cpu"`` raises.
"""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from distributed_llm_dissemination_tpu.models import generate as jgen
from distributed_llm_dissemination_tpu.models import llama as jllama
from distributed_llm_dissemination_tpu.models import quant as jquant
from distributed_llm_dissemination_tpu.models import serde as jserde
from distributed_llm_dissemination_tpu_torch.cli import dryrun
from distributed_llm_dissemination_tpu_torch.transport import inmem

from test_torch_model import LOGIT_ATOL, LOGIT_MEAN_ATOL

LOSS_TOL = 0.02
TRAIN_TIMEOUT_S = 240.0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
    inmem.reset_registry()


@pytest.fixture(scope="module")
def tiny():
    """(cfg, raw blobs, int8 wire blobs, JAX greedy ids of 16 zero
    tokens), all made by the JAX package."""
    cfg = jllama.CONFIGS["tiny"]
    ids = range(jserde.head_blob_id(cfg) + 1)
    blobs = {b: jserde.seeded_blob(cfg, b, 0) for b in ids}
    wire = {b: jquant.encode_blob(cfg, b, blobs[b], "int8") for b in ids}
    params = jllama.init_params(cfg, jax.random.key(0))
    want = jgen.generate(params, jnp.zeros((1, 16), jnp.int32), cfg,
                         max_new=dryrun.DECODE_NEW)
    return cfg, blobs, wire, [int(t) for t in np.asarray(want)[0]]


def _jax_line(fn, n, capsys):
    capsys.readouterr()
    fn(n)
    return capsys.readouterr().out


def test_entry_matches_jax_forward(monkeypatch):
    monkeypatch.setattr(graft, "_flagship_cfg",
                        lambda: jllama.CONFIGS["tiny"])
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn)(*jargs), np.float32)
    fn, args = dryrun.entry(device="cpu", config="tiny")
    assert args[1].shape == (1, 128) and not args[1].any()
    got = fn(*args).float().numpy()
    assert got.shape == want.shape == (1, 128, 256)
    diff = np.abs(got - want)
    assert diff.max() < LOGIT_ATOL, diff.max()
    assert diff.mean() < LOGIT_MEAN_ATOL, diff.mean()


@pytest.mark.timeout(180)
@pytest.mark.parametrize("n", [1, 2])
def test_dissemination_matches_jax(n, tiny, capsys):
    cfg, blobs, _, ids_want = tiny
    line = _jax_line(graft._dryrun_dissemination, n, capsys)
    jax_loss = float(re.search(r"loss_from_landed_arrays=([-0-9.]+)",
                               line).group(1))
    jax_stages = int(re.search(r"stages=(\d+)", line).group(1))
    rec = dryrun.dryrun_dissemination(n, "cpu", "tiny", blobs=blobs)
    assert rec["stages"] == jax_stages == (2 if n == 2 else 1)
    assert rec["landed_exact"] == len(blobs)
    kinds = set(rec["boots"].values())
    assert kinds == ({"stage"} if n == 2 else {"full"})
    assert abs(rec["loss_from_landed"] - jax_loss) < LOSS_TOL, (
        rec["loss_from_landed"], jax_loss)
    assert rec["tokens"] == ids_want
    if n == 2:
        assert rec["pod_forward_s"] > 0 and "pod_decode_s=" in line


@pytest.mark.timeout(180)
@pytest.mark.parametrize("n", [1, 2])
def test_fabric_matches_jax(n, tiny, capsys):
    _, _, wire, _ = tiny
    line = _jax_line(graft._dryrun_fabric, n, capsys)
    assert "layer_bytes_on_transport=0" in line and "kind=full" in line
    jax_stages = int(re.search(r"stages=(\d+)", line).group(1))
    rec = dryrun.dryrun_fabric(n, "cpu", "tiny", wire=wire)
    assert rec["stages"] == jax_stages
    assert rec["layer_msgs_on_transport"] == 0
    assert rec["landed_exact"] == len(wire)
    assert rec["kind"] == "full" and rec["codec"] == "int8"
    assert rec["wire_bytes"] == sum(len(b) for b in wire.values())


def _jax_train_step(n):
    """The JAX ``dryrun_multichip``'s training step: (loss, opt step)."""
    from distributed_llm_dissemination_tpu.models import sharded as jsh

    cfg = jllama.CONFIGS[dryrun.TRAIN_CONFIG]
    mesh = jsh.make_train_mesh(n, cfg)
    params = jsh.shard_params(jllama.init_params(cfg, jax.random.key(0)),
                              mesh, cfg)
    opt = jsh.init_adamw_state(params)
    step = jsh.build_adamw_train_step(cfg, mesh, lr=dryrun.TRAIN_LR,
                                      remat=True)
    inputs, targets = jsh.example_batch(cfg, mesh)
    _, opt, loss = step(params, opt, inputs, targets)
    return float(loss), int(opt["step"]), jsh.factor_mesh_axes(n, cfg)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_in_a_gloo_world_matches_jax(n, tiny, tmp_path):
    cfg, blobs, wire, ids_want = tiny
    jax_loss, jax_step, jax_axes = _jax_train_step(n)
    out = dryrun.dryrun_multichip(n, device="cpu", blobs=blobs, wire=wire,
                                  workdir=tmp_path)
    train = out["train"]
    assert train["mesh"] == jax_axes
    assert train["step"] == jax_step == 1
    assert train["devices"] == ["cpu"] * n
    assert abs(train["loss"] - jax_loss) < LOSS_TOL, (train["loss"],
                                                       jax_loss)
    # Every rank wrote its result; the plain attention served each.
    assert sorted(p.name for p in tmp_path.glob("rank*.json")) == [
        f"rank{r}.json" for r in range(n)]
    assert train["attention_plain"] > 0
    assert out["dissemination"]["stages"] == 2
    assert out["dissemination"]["landed_exact"] == len(blobs)
    assert out["dissemination"]["tokens"] == ids_want
    assert out["fabric"]["layer_msgs_on_transport"] == 0
    assert out["fabric"]["landed_exact"] == len(wire)


def test_imports_without_jax_and_refuses_the_cpu_unless_asked():
    code = ("import sys; sys.modules['jax'] = None; "
            "import distributed_llm_dissemination_tpu_torch.cli.dryrun")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-card refusal is moot")
    for call in (lambda: dryrun.dryrun_multichip(1),
                 lambda: dryrun.dryrun_train(2),
                 lambda: dryrun.dryrun_dissemination(1),
                 lambda: dryrun.dryrun_fabric(1),
                 lambda: dryrun.entry(config="tiny"),
                 lambda: dryrun.main(["-n", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
