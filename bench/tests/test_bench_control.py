"""The control: the plain reference in float8 put in the program's place
fails the comparison the program passes. On the CPU at the reduced size
(the program in fp32 there); on the card at the cell's own size
(``cuda``-marked, one seed; `bench.readings` reads a dozen)."""
import pytest
import torch

from bench import serve
from bench.run import judge
from bench.tests._cells import mix, reduced_conf


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own size runs there")
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["qwen-chat-poisson", "minitron-chat-poisson"])
def test_control_fails_where_the_program_passes(workload):
    conf = reduced_conf(workload)
    c = serve.Cell(conf, mix(False), 99, 3.0, "cpu")
    c.setup()
    run = c.serve(drain_s=20.0)
    g = judge(c, run, 99, torch.device("cpu"), conf, control=True)
    limit = conf["correct"]["mean_gap_limit"]
    assert g["mean_gap"] <= limit < g["control_mean_gap"]
    assert g["control_mean_gap"] >= 3 * max(g["mean_gap"], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["qwen-chat-poisson", "minitron-chat-poisson"])
def test_control_fails_at_the_cells_size(card, workload):
    from bench import spec
    s = spec.load_spec()
    cell = spec.cell(s, workload)
    conf = spec.load_config(s, cell["config"])
    c = serve.Cell(conf, spec.load_traffic(cell["traffic"]), 2**31 + 99, 12.0, card)
    c.setup()
    run = c.serve()
    g = judge(c, run, 2**31 + 99, card, conf, control=True)
    assert g["mean_gap"] <= conf["correct"]["mean_gap_limit"] < g["control_mean_gap"]
