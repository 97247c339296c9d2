"""On the card (marker ``gpu``): the TF32 control, cuBLAS's own, is not
correct and the port is, at each cell's own size (its readings on many
seeds: PERF.md section 2)."""
import pytest
import torch

from perfbench import check, harness, inputs, spec
from perfbench.phase_cell import ProgramRun
from perfbench.reference import phase_svi

from . import _tiny


@pytest.mark.gpu
@pytest.mark.parametrize("name", _tiny.CELLS)
def test_control_and_port_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = spec.cell(name)
    cfg = c.config
    dev = torch.device("cuda", 0)
    seed = 3000000041
    prog = ProgramRun(cfg, c.mix, seed, dev, harness.Spans())
    mine = prog.first_steps(3)
    del prog
    torch.cuda.empty_cache()
    made = inputs.make(cfg["data"], seed, dev, unspliced=False)
    follow = lambda **kw: phase_svi.follow(  # noqa: E731
        made, cfg["model"], c.mix["optimizer"], seed, **kw)
    ref = follow()
    ok, shown = check.verdict(check.gaps(mine, ref), c.limits)
    assert ok, shown
    ok, shown = check.verdict(check.gaps(follow(precision="tf32"), ref),
                              c.limits)
    assert not ok, shown
