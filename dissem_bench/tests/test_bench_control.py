"""The control (the reference in fp8 put in the program's place) comes
out not correct through the run's own checks, at a tiny shape on the
CPU; at the cell's own size it runs on the card."""

import pytest
import torch

from dissem_bench import control, run, spec
from dissem_bench.reference import model as ref
from dissem_bench.tests.conftest import DENSE, STAGED, WORKLOADS, tiny_cell

SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)
TOKEN_CHECKS = {"logit_gap", "routing_margin"}


def test_reference_against_itself_reads_zero():
    cell = tiny_cell(STAGED)
    drv = spec.path_module("fabric").Runner(cell, 3, "cpu")
    drv.setup()
    layer_leaves, head, dev = drv.reference_inputs()
    tok = torch.randint(0, cell.shape.vocab, (2, 16))
    out = ref.forward(cell.shape, layer_leaves, head, tok, dev,
                      variants=("f32", "fp8"))["logits"]
    assert float(ref.served_gap(out["f32"], out["f32"].argmax(-1)).max()) == 0
    assert float((out["f32"] - out["fp8"]).abs().max()) > 0
    drv.close()


def test_judge_following_its_own_routes_reads_no_margin():
    cell = tiny_cell(STAGED)
    drv = spec.path_module("fabric").Runner(cell, 4, "cpu")
    drv.setup()
    layer_leaves, head, dev = drv.reference_inputs()
    tok = torch.randint(0, cell.shape.vocab, (1, 16))
    own = ref.forward(cell.shape, layer_leaves, head, tok, dev,
                      variants=("fp8", "f32"), routes="fp8")
    assert own["routing_margin"] >= 0
    free = ref.forward(cell.shape, layer_leaves, head, tok, dev)
    assert free["routing_margin"] is None
    drv.close()


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_the_programs_place_is_not_correct(workload):
    """Each seed's program run is correct and its control run is not, and
    only the token checks tell them apart; with experts the routing
    margin fails the control as well as the logit gap."""
    cell = tiny_cell(workload, tokens=64)
    for s in SEEDS:
        program = run.run_cell(cell, s, 0.2, False, device="cpu")
        ctl = control.control_run(cell, s, 0.2, device="cpu")
        assert program["correct"], program["checks"]
        assert not ctl["correct"], ctl["checks"]
        failed = {k for k, v in ctl["checks"].items()
                  if not v["value"] <= v["limit"]
                  and k in TOKEN_CHECKS}
        assert failed == TOKEN_CHECKS & set(ctl["checks"])
        for k in set(ctl["checks"]) - TOKEN_CHECKS:
            assert ctl["checks"][k] == program["checks"][k] or \
                k == "rounds_done"


@pytest.mark.cuda
def test_control_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's own size)")
    cell = spec.load_cell(DENSE)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip("needs the cell's cards")
    for s in SEEDS:
        assert not control.control_run(cell, s, 12.0)["correct"]
