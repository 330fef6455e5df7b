"""The kernel build helper (``ops/cuda_build.py``) without a compiler.

``nvcc`` exists only on the machine with the card, so these tests stand a
fake compiler in for it.  They check what ``chip_smoke.py`` relies on: one
build per source, builds of different sources running at the same time,
a reused library when the source is unchanged, a new one when it changes,
and a raise (no fallback) when the compiler fails.
"""

import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from distributed_llm_dissemination_tpu_torch.ops import cuda_build


class FakeNvcc:
    """Stands in for ``subprocess.run``: writes the ``-o`` file after
    ``seconds`` and records when each call ran."""

    def __init__(self, seconds=0.3, fail=False):
        self.seconds, self.fail = seconds, fail
        self.spans, self.lock = [], threading.Lock()

    def __call__(self, cmd, **kwargs):
        t0 = time.monotonic()
        time.sleep(self.seconds)
        if not self.fail:
            with open(cmd[cmd.index("-o") + 1], "wb") as f:
                f.write(b"lib")
        with self.lock:
            self.spans.append((t0, time.monotonic(), cmd[-1]))
        return subprocess.CompletedProcess(
            cmd, 1 if self.fail else 0, "",
            "error: fake" if self.fail else "ptxas info    : Used 1 registers")


@pytest.fixture
def fake(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text(f"// {name}\n")
    nvcc = FakeNvcc()
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    monkeypatch.setattr(cuda_build, "_built", {})
    monkeypatch.setattr(cuda_build, "_locks", {})
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", nvcc)
    return nvcc, csrc


def test_builds_of_different_sources_overlap(fake):
    nvcc, _ = fake
    sources = ["a.cu", "b.cu", "c.cu"]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(cuda_build.build, sources))
    assert len(nvcc.spans) == 3
    # All started before any finished: the builds ran together.
    assert max(s for s, _, _ in nvcc.spans) < min(e for _, e, _ in nvcc.spans)
    for (path, seconds, report), src in zip(built, sources):
        assert path.exists() and path.name.startswith(src[:-3] + "-")
        assert seconds > 0 and "registers" in report


def test_one_source_builds_once_across_threads(fake):
    nvcc, _ = fake
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(cuda_build.build, ["a.cu"] * 4))
    assert len(nvcc.spans) == 1
    assert len({p for p, _, _ in built}) == 1


def test_unchanged_source_reuses_library_and_edit_rebuilds(fake, monkeypatch):
    nvcc, csrc = fake
    first = cuda_build.build("a.cu")[0]
    monkeypatch.setattr(cuda_build, "_built", {})  # a new process
    path, seconds, report = cuda_build.build("a.cu")
    assert (path, seconds, report) == (first, 0.0, "")
    assert len(nvcc.spans) == 1
    (csrc / "a.cu").write_text("// edited\n")
    monkeypatch.setattr(cuda_build, "_built", {})
    assert cuda_build.build("a.cu")[0] != first
    assert len(nvcc.spans) == 2


def test_failed_compile_raises_and_leaves_no_library(fake):
    nvcc, _ = fake
    nvcc.fail = True
    with pytest.raises(RuntimeError, match="nvcc failed for a.cu"):
        cuda_build.build("a.cu")
    assert not cuda_build.library_path("a.cu").exists()
    assert not list(cuda_build.BUILD_DIR.glob("*.tmp"))
