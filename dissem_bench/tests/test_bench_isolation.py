"""Nothing the benchmark runs loads JAX or the JAX package.  The port's
name begins with the JAX package's, so names are compared whole, by
their top-level part."""

import subprocess
import sys

from dissem_bench import run, spec

BLOCK = r"""
import importlib.abc, sys
BANNED = {"jax", "jaxlib", "flax", "distributed_llm_dissemination_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in BANNED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import pkgutil, importlib
import dissem_bench
for m in pkgutil.walk_packages(dissem_bench.__path__, "dissem_bench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
from dissem_bench import spec
for f in sorted((spec.PKG_DIR / "configs").glob("*.json")):
    spec.port_config(spec.shape_from_config(f.stem, spec.read_json(f)))
for w in spec.read_json(spec.ROOT / "BENCHMARK.json")["workloads"]:
    spec.path_module(spec.load_cell(w["name"]).traffic["path"])
import distributed_llm_dissemination_tpu_torch.cli.podrun
from dissem_bench.run import forbidden_modules
assert forbidden_modules() == [], forbidden_modules()
print("clean")
"""


def test_benchmark_modules_import_without_jax():
    p = subprocess.run([sys.executable, "-c", BLOCK], cwd=str(spec.ROOT),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "clean" in p.stdout, p.stderr[-3000:]


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(
        ["distributed_llm_dissemination_tpu_torch.cli", "jaxtyping",
         "numpy"]) == []
    assert run.forbidden_modules(
        ["jax.numpy", "distributed_llm_dissemination_tpu.models",
         "flax"]) == ["distributed_llm_dissemination_tpu", "flax", "jax"]
