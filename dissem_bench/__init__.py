"""The benchmark of the PyTorch/CUDA port: model delivery onto H100s.

One command runs one cell (``python3 -m dissem_bench.run --workload
<name> --seed <n> --seconds <s> --trace <0|1>``).  Everything a cell
needs is found by name from ``BENCHMARK.json``:

- ``configs/<config>.json``: the model's published sizes and any cut;
- ``traffic/<traffic>.json``: who holds what where, the stages, the
  mesh, the mode, the codec and the prompt;
- ``paths/<path>.py``: the runner of one round of the traffic's path;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``.

The yardstick (frozen blob layout, seeded weights, the plain reference,
the peaks and the roofline arithmetic, the trace reduction) lives here
too.  Nothing in this package imports JAX or the JAX package.
"""
