"""The plain reference agrees with the port at a tiny size on the CPU, and
follows the program's seeding rule."""
import pytest
import torch

from perfbench import check, inputs
from perfbench.phase_cell import ProgramRun
from perfbench.reference import keys, phase_svi

from . import _tiny


@pytest.mark.parametrize("name", _tiny.CELLS)
@pytest.mark.parametrize("seed", [3000000023, 7])
def test_a_sound_run_is_correct(name, seed):
    r = _tiny.run(name, seed)
    assert r["correct"] and r["failed"] == 0, r["checked"]
    assert list(r["checked"]) == ["loss_gap", "grad_gap_median",
                                  "grad_gap_worst", "change_gap",
                                  "change_gap_steps", "nonfinite_losses"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_the_port_reads_like_the_float64_reference(name):
    c = _tiny.cell(name)
    seed = 3000000027
    dev = torch.device("cpu")
    prog = ProgramRun(c.config, c.mix, seed, dev, _tiny.harness.Spans())
    mine = prog.first_steps(3)
    made = inputs.make(c.config["data"], seed, dev, unspliced=False)
    ref = phase_svi.follow(made, c.config["model"], c.mix["optimizer"], seed)
    gaps = check.gaps(mine, ref)
    assert all(v < 2e-6 for v in gaps.values()), gaps
    # every leaf moves and has a gradient, on both sides
    assert set(mine.grad_norms) == set(ref.grad_norms)
    assert min(ref.change_norms.values()) > 0.01


def test_the_traced_run_reports_its_per_layer_metrics_on_the_cpu():
    r = _tiny.run("stereoseq_102k.phase_default", 3000000029, traced=True)
    assert r["correct"]
    assert set(r["metrics"]) >= {"preprocess_s", "launches_per_step"}
    assert r["device"]["window_s"] > 0


def test_the_seeding_rule_is_the_programs():
    from velocycle_tpu_torch.core import handlers

    root = 3000000031
    key = handlers.fold_in(root, 1)
    want = []
    for _ in range(3):
        want.append(handlers.fold_in(handlers.fold_in(key, 1), 0))
        key = handlers.fold_in(key, 0)
    assert keys.step_keys(root, 3) == want
    assert keys.fold_in(want[0], keys.site_hash("nu")) == handlers.site_seed(
        want[0], "nu")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, 3.0])
    assert phase_svi._tf32(x).tolist() == [1.0, 1.0 + 2**-9, 1.0 + 2**-10, 3.0]


@pytest.mark.parametrize("fused", [False, True])
def test_sections_and_the_trivial_prior_read_like_the_reference(fused):
    """The data law's sections (an obs column through make_design_matrix,
    a delta_nu leaf per section) and the trivial nu prior, which a later
    configuration may state, agree with the reference too."""
    import copy

    c = _tiny.cell(_tiny.CELLS[0])
    cfg = copy.deepcopy(c.config)
    cfg["data"]["batches"] = 4
    model = cfg["model"]
    for k in ("nu_prior", "condition_on", "with_delta_nu"):
        model.pop(k, None)
    model.update(nu_means=0.0, nu_stds=[0.1, 0.2, 0.2])
    mix = dict(c.mix, use_fused_nb=fused)
    seed, dev = 3000000043, torch.device("cpu")
    mine = ProgramRun(cfg, mix, seed, dev, _tiny.harness.Spans()).first_steps(3)
    made = inputs.make(cfg["data"], seed, dev, unspliced=False)
    ref = phase_svi.follow(made, model, mix["optimizer"], seed)
    assert "delta_nu_locs" in ref.grad_norms
    gaps = check.gaps(mine, ref)
    assert all(v < 2e-6 for v in gaps.values()), gaps
