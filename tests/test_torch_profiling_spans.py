"""The program's spans (`velocycle_tpu_torch.profiling.span` and
`recording`) on a tiny phase fit: on the CPU, and on the card (marker
``gpu``, which skips inside the test without one).

  * Off (no recording open, no profiler active), a step and a front door
    enter no `record_function`, and every span is one shared no-op.
  * Under `recording()`, N updates give ``svi.step``, ``svi.elbo``,
    ``svi.backward`` and ``svi.optim`` N calls each, the three children's
    seconds within the parent's; each front door records ``preprocess``
    and each of its passes once (``compact`` and ``lgamma`` on the fused
    path only), the passes' seconds within the door's.
  * Under `profiling.trace`, the exported Chrome trace holds the four step
    spans as ``user_annotation`` events, each child inside its step.
  * The losses and parameters after N steps are bit-identical with tracing
    off, with `recording()` open and under the profiler.
  * On the card, every kernel, copy and set of one traced step was
    launched inside a program span (its launching runtime call joined by
    the trace's correlation id, on whatever thread it ran, by the
    benchmark's `perfbench.attribution.correlation_join`), and the
    synchronizing runtime calls inside ``svi.step`` are as many as the
    warnings `torch.cuda.set_sync_debug_mode("warn")` raises over that
    step.

This file imports no JAX.
"""
import glob
import json
import os
import warnings

import numpy as np
import pytest
import torch

import velocycle_tpu_torch as T
from perfbench.attribution import correlation_join
from velocycle_tpu_torch import profiling
from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam

STEP = ("svi.step", "svi.elbo", "svi.backward", "svi.optim")
PASSES = ("preprocess.dense", "preprocess.logs", "preprocess.upload")
FUSED_PASSES = ("preprocess.compact", "preprocess.lgamma")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _front_door(stage, fused, device="cpu", Nc=120, Ng=12):
    adata = T.simulate_data(Nc=Nc, Ng=Ng, seed=3)
    genes, cells = list(adata.var.index), list(adata.obs.index)
    cycle = T.Cycle.trivial_prior(genes, harmonics=1)
    phases = T.Phases.from_angles(np.asarray(adata.obs["simulated_phis"]),
                                  cell_names=cells)
    if stage == "phase":
        return T.preprocess_for_phase_estimation(
            adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
            use_fused_nb=fused, device=device)
    return T.preprocess_for_velocity_estimation(
        adata, cycle, phases,
        T.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                     stds=0.5),
        n_harmonics=1, omega_n_harmonics=1, with_delta_nu=False,
        model_type="fourier", use_fused_nb=fused, device=device)


def _svi(mp):
    fit = T.PhaseFitModel(mp, get_posterior=False)
    return SVI(fit.model, fit.guide, clipped_adam(lrd=0.1 ** 0.1),
               Trace_ELBO())


def _steps(mp, n, seed=5):
    """(the losses, the parameters) after ``n`` `SVI.update` calls."""
    svi = _svi(mp)
    state = svi.init(seed, mp.data)
    losses = []
    for _ in range(n):
        state, loss = svi.update(state, mp.data)
        losses.append(loss)
    return (torch.stack(losses),
            {k: v.detach().clone() for k, v in state.params.items()})


def _annotations(logdir):
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_off_a_front_door_and_a_step_enter_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("svi.step") is profiling.span("preprocess")
    mp = _front_door("phase", False)
    losses, _ = _steps(mp, 2)
    assert torch.isfinite(losses).all()


def test_recording_counts_each_step_span_once_per_update():
    mp = _front_door("phase", False)
    n = 3
    with profiling.recording() as rec:
        _steps(mp, n)
    assert set(rec) == set(STEP)
    assert all(rec[name][0] == n for name in STEP)
    assert sum(rec[name][1] for name in STEP[1:]) <= rec["svi.step"][1]
    seen = {k: list(v) for k, v in rec.items()}
    _steps(mp, 1)                     # closed: nothing more is added
    assert rec == seen


@pytest.mark.parametrize("stage", ["phase", "velocity"])
@pytest.mark.parametrize("fused", [False, True])
def test_a_front_door_records_each_pass_once(stage, fused):
    with profiling.recording() as rec:
        _front_door(stage, fused)
    want = {"preprocess", *PASSES, *(FUSED_PASSES if fused else ())}
    assert set(rec) == want
    assert all(rec[name][0] == 1 for name in want)
    assert sum(rec[name][1] for name in want - {"preprocess"}) <= \
        rec["preprocess"][1]


def test_the_profiler_trace_holds_the_step_spans_nested(tmp_path):
    mp = _front_door("phase", False)
    n = 2
    with profiling.trace(str(tmp_path)):
        _steps(mp, n)
    spans = [e for e in _annotations(str(tmp_path))
             if e.get("cat") == "user_annotation" and e["name"] in STEP]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e["name"] == "svi.step")
    assert len(steps) == n
    for a, b in steps:
        inside = sorted((e["ts"], e["name"]) for e in spans
                        if e["name"] != "svi.step"
                        and a <= e["ts"] and e["ts"] + e["dur"] <= b)
        assert [name for _, name in inside] == list(STEP[1:])


@pytest.mark.parametrize("fused", [False, True])
def test_tracing_leaves_the_fit_bit_identical(fused, tmp_path):
    mp = _front_door("phase", fused)
    losses, params = _steps(mp, 4)
    with profiling.recording():
        recorded = _steps(mp, 4)
    with profiling.trace(str(tmp_path)):
        profiled = _steps(mp, 4)
    for got_losses, got_params in (recorded, profiled):
        assert torch.equal(got_losses, losses)
        assert all(torch.equal(got_params[k], v) for k, v in params.items())


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_on_the_card_every_operation_of_a_step_has_a_program_span(
        fused, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    mp = _front_door("phase", fused, dev, Nc=300, Ng=40)
    svi = _svi(mp)
    state, _ = svi.update(svi.init(5, mp.data), mp.data)   # builds, loads
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state, loss = svi.update(state, mp.data)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert torch.isfinite(loss)
    ops, syncs = correlation_join(_annotations(str(tmp_path)))
    assert ops and all(span is not None for _, _, span in ops), [
        (op["name"], call["name"]) for op, call, span in ops if span is None]
    # the backward's operations launch from autograd's device thread
    assert any(span["name"] == "svi.backward" and call["tid"] != span["tid"]
               for _, call, span in ops)
    warned = [w for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == len(warned) > 0, (
        [c["name"] for c in syncs], [str(w.message) for w in warned])
