"""A run whose timed path is broken underneath comes out not correct: the
harness past its look for a card, at a tiny size on the CPU, with each
fault the cells can have planted in the program (a step that returns its
state unchanged; half of the cells left out, the rest doubled; the
dispersion's gradient doubled where it is produced), and the control,
the reference in TF32 put in the program's place."""
import pytest
import torch

from perfbench import check, inputs
from perfbench.reference import phase_svi

from . import _tiny


@pytest.fixture
def frozen(monkeypatch):
    from velocycle_tpu_torch.infer import optim

    monkeypatch.setattr(optim.ClippedAdam, "update",
                        lambda self, grads, state, params: None)


@pytest.fixture
def half(monkeypatch):
    from velocycle_tpu_torch.core import distributions as dist
    from velocycle_tpu_torch.core import handlers
    from velocycle_tpu_torch.models import phase

    fused = phase.nb_loglik_fused

    def fused_half(S, nu, zeta, cf, r, dnu=None, Db=None, lgamma_k_sum=None,
                   disp_grad=True):
        n = S.shape[1] // 2
        return 2.0 * fused(S[:, :n], nu, zeta[:n], cf[:n], r, dnu,
                           None if Db is None else Db[:, :n], None, disp_grad)

    def observe_half(mp, ElogS):
        n = mp.Nc // 2
        r = phase._sample_shape_inv(mp)[:, None]
        lp = dist.NegativeBinomial(mean=torch.exp(ElogS[:, :n]),
                                   dispersion=r).log_prob(mp.S[:, :n])
        handlers.factor("S_half", 2.0 * lp.sum())

    monkeypatch.setattr(phase, "nb_loglik_fused", fused_half)
    monkeypatch.setattr(phase, "_observe_spliced", observe_half)


@pytest.fixture
def disp(monkeypatch):
    from velocycle_tpu_torch.models import phase

    class Doubled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return 2.0 * g

    sample = phase._sample_shape_inv
    monkeypatch.setattr(phase, "_sample_shape_inv",
                        lambda mp: Doubled.apply(sample(mp)))


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name, frozen):
    r = _tiny.run(name, 3000000033)
    assert not r["correct"], r["checked"]
    assert r["checked"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_half_the_cells_left_out_is_not_correct(name, half):
    r = _tiny.run(name, 3000000035)
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_a_doubled_dispersion_gradient_is_not_correct(name, disp):
    r = _tiny.run(name, 3000000039)
    assert not r["correct"], r["checked"]
    c = r["checked"]
    assert c["grad_gap_worst"]["value"] > c["grad_gap_worst"]["limit"]


@pytest.mark.parametrize("name", _tiny.CELLS)
@pytest.mark.parametrize("seed", [3000000037, 11, 12])
def test_the_tf32_control_is_not_correct(name, seed):
    c = _tiny.cell(name)
    dev = torch.device("cpu")
    made = inputs.make(c.config["data"], seed, dev, unspliced=False)
    follow = lambda **kw: phase_svi.follow(  # noqa: E731
        made, c.config["model"], c.mix["optimizer"], seed, **kw)
    ref = follow()
    ok, shown = check.verdict(check.gaps(follow(precision="tf32"), ref),
                              c.limits)
    assert not ok, shown
    # float32 alone, with TF32 off, passes: the control fails by TF32
    ok32, shown32 = check.verdict(
        check.gaps(follow(precision="float32"), ref), c.limits)
    assert ok32, shown32
