"""The benchmark's frozen blob layout against the port's blobs, at a tiny
shape on the CPU."""

import torch

from dissem_bench import layout, spec, weights
from dissem_bench.tests.conftest import tiny_cell


def test_layout_matches_the_port(cell):
    from distributed_llm_dissemination_tpu_torch.models import serde

    s = cell.shape
    mcfg = spec.port_config(s)
    assert layout.layer_specs(s) == serde.layer_param_specs(mcfg)
    assert layout.head_specs(s) == serde.head_param_specs(mcfg)
    for b in s.blob_ids:
        assert layout.blob_nbytes(s, b) == serde.blob_nbytes(mcfg, b)


def test_port_decodes_the_benchmarks_blobs_to_the_same_leaves(cell):
    from distributed_llm_dissemination_tpu_torch.models import serde

    s = cell.shape
    mcfg = spec.port_config(s)
    blobs = weights.make_blobs(s, s.blob_ids, seed=2**31 + 3, salt=1,
                               device="cpu")
    host = {b: bytearray(t.numpy().tobytes()) for b, t in blobs.items()}
    params = serde.params_from_blobs(mcfg, host)
    for b in range(s.n_layers):
        for name, leaf in layout.leaves(s, b, blobs[b]).items():
            assert torch.equal(params["layers"][name][b], leaf), (b, name)
    for name, leaf in layout.leaves(s, s.head_id, blobs[s.head_id]).items():
        assert torch.equal(params[name], leaf), name


def test_weights_follow_the_seed():
    s = tiny_cell("mistral7b.fabric1.host_seeded").shape
    a = weights.make_blobs(s, [0, 1, s.head_id], 2**31 + 11, 1, "cpu")
    b = weights.make_blobs(s, [0, 1, s.head_id], 2**31 + 11, 1, "cpu")
    c = weights.make_blobs(s, [0, 1, s.head_id], 2**31 + 12, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[0], c[0])
    assert torch.equal(weights.prompt(s, 5, 0, 16), weights.prompt(s, 5, 0, 16))
    assert not torch.equal(weights.prompt(s, 5, 0, 16),
                           weights.prompt(s, 5, 1, 16))
