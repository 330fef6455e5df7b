"""PyTorch/CUDA port of ``distributed_llm_dissemination_tpu``.

Same subpackage layout as the JAX package (``core/ utils/ ops/ parallel/
models/ runtime/``), so each port module maps to one module there.  The
port imports ``torch`` and never ``jax``, and nothing of the JAX package:
what it needs from the jax-free modules there is copied here.

Device rule: every entry point takes ``device=None``, which means
``torch.device("cuda")``; with no GPU it raises (``utils.device``).  CPU
runs happen only when the caller passes ``device="cpu"`` — the tests do.
"""
