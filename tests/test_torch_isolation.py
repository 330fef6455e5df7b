"""The port stands alone: no JAX, no JAX package, no quiet CPU fallback.

- Every port module imports in a fresh interpreter where ``jax`` is
  blocked (``sys.modules["jax"] = None``).
- No port source imports the JAX package
  (``distributed_llm_dissemination_tpu`` followed by ``.``, whitespace or
  the end of the line -- the port's own name shares the prefix).
- On a machine with no GPU, every entry point given no ``device`` raises
  instead of running on the CPU.
"""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import distributed_llm_dissemination_tpu_torch as port
from distributed_llm_dissemination_tpu_torch.models import generate as tgen
from distributed_llm_dissemination_tpu_torch.models import llama as tllama
from distributed_llm_dissemination_tpu_torch.models import serde as tserde
from distributed_llm_dissemination_tpu_torch.ops import reassembly as tre
from distributed_llm_dissemination_tpu_torch.parallel import ingest as ting
from distributed_llm_dissemination_tpu_torch.parallel import mover as tmover
from distributed_llm_dissemination_tpu_torch.runtime import boot as tboot
from distributed_llm_dissemination_tpu_torch.runtime import stream_boot
from distributed_llm_dissemination_tpu_torch.utils import device as tdevice

PORT_DIR = pathlib.Path(port.__file__).parent
REPO = PORT_DIR.parent
JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from|import)\s+distributed_llm_dissemination_tpu(\.|\s|$)",
    re.MULTILINE)
JAX_IMPORT = re.compile(r"^\s*(from|import)\s+jax(\.|\s|$)", re.MULTILINE)


def _port_sources():
    return sorted(PORT_DIR.rglob("*.py"))


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import distributed_llm_dissemination_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in "
        "sys.modules.items() if v is not None)\n"
        "assert 'distributed_llm_dissemination_tpu' not in sys.modules\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert int(proc.stdout.split()[-1]) >= 15


def test_no_port_source_imports_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) >= 15
    for path in sources:
        text = path.read_text()
        assert not JAX_PACKAGE_IMPORT.search(text), path
        assert not JAX_IMPORT.search(text), path


def test_import_pattern_tells_the_two_package_names_apart():
    assert JAX_PACKAGE_IMPORT.search(
        "from distributed_llm_dissemination_tpu.models import llama")
    assert JAX_PACKAGE_IMPORT.search("import distributed_llm_dissemination_tpu")
    assert JAX_PACKAGE_IMPORT.search(
        "import distributed_llm_dissemination_tpu as ref")
    assert not JAX_PACKAGE_IMPORT.search(
        "from distributed_llm_dissemination_tpu_torch.models import llama")
    assert not JAX_PACKAGE_IMPORT.search(
        "import distributed_llm_dissemination_tpu_torch")


def _entry_points():
    cfg = tllama.CONFIGS["tiny"]
    blob = bytes(tserde.blob_nbytes(cfg, 0))
    layers = {0: tboot.LayerSrc(inmem_data=bytearray(blob),
                                data_size=len(blob))}
    return {
        "resolve_device": lambda: tdevice.resolve_device(),
        "init_cache": lambda: tgen.init_cache(cfg, 1, 8),
        "seeded_blob": lambda: tserde.seeded_blob(cfg, 0),
        "params_from_numpy": lambda: tserde.params_from_numpy({}),
        "alloc_layer_buffer": lambda: tre.alloc_layer_buffer(8),
        "ShardedLayerIngest": lambda: ting.ShardedLayerIngest(8),
        "ingest_bytes": lambda: ting.ingest_bytes(b"12345678"),
        "hbm_headroom_bytes": lambda: ting.hbm_headroom_bytes(),
        "WeightMover": lambda: tmover.WeightMover(),
        "StreamingBootStager": lambda: stream_boot.StreamingBootStager(cfg),
        "boot_from_layers": lambda: tboot.boot_from_layers(cfg, layers),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_device_raises_when_no_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None legitimately means it")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


def test_cuda_kernel_wrapper_never_falls_back():
    """No try/except around the build or the launch, and no environment
    switch in the kernel modules."""
    for rel in ("ops/flash_attention.py", "ops/cuda_build.py"):
        text = (PORT_DIR / rel).read_text()
        assert "except" not in text, rel
        assert "os.environ" not in text, rel
