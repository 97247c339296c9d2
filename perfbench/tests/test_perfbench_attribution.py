"""The readers of the program's spans (`attribution`): a synthetic Kineto
event list with hand-computed answers (a kernel launched from a second
thread inside ``svi.backward``, one launched in ``svi.elbo`` that runs
while the backward's span is open, nested spans, a sync and a copy outside
``svi.step``; the first kernels' records lost, as CUPTI loses them on the
card; a kernel with no call; a record lost in the middle, which the join
refuses), the cases with nothing to read, and the order join against the
exact correlation join: on those events, and on the card (marker
``gpu``) on a traced run of the cell."""
import json
import types

import pytest
import torch

from perfbench import attribution, harness, spec
from perfbench import trace as tracing
from perfbench.phase_cell import ProgramRun

from . import _tiny

READERS = ("elbo_device_ms", "backward_device_ms", "optim_device_ms",
           "host_syncs_per_step")


def _span(name, a, b, tid=1):
    return {"cat": "user_annotation", "name": name, "ts": a, "dur": b - a,
            "tid": tid}


def _events(lost_kernels=0, lost_calls=0, lost_at=0):
    """Two steps 200 us apart and one chunk read; correlation ids count the
    runtime calls in the order they start.  The records of ``lost_kernels``
    kernels or of ``lost_calls`` launch calls from the ``lost_at``-th
    left out."""
    events, corr = [], iter(range(100, 1000))

    def call(name, t, tid=1):
        c = next(corr)
        events.append({"cat": "cuda_runtime", "name": name, "ts": t,
                       "dur": 0.5, "tid": tid, "args": {"correlation": c}})
        return c

    def kernel(c, t, dur, name="k", cat="kernel"):
        events.append({"cat": cat, "name": name, "ts": t, "dur": dur,
                       "args": {"correlation": c}})

    for o in (0, 200):
        events += [_span("svi.update", o, o + 100),
                   _span("svi.step", o + 1, o + 99),
                   _span("svi.elbo", o + 2, o + 30),
                   _span("svi.backward", o + 31, o + 80),
                   _span("svi.optim", o + 81, o + 98)]
        kernel(call("cudaLaunchKernel", o + 5), o + 10, 6)
        # launched in the ELBO, run while the backward's span is open
        kernel(call("cudaLaunchKernel", o + 29), o + 35, 8)
        # from autograd's device thread
        kernel(call("cudaLaunchKernel", o + 40, tid=2), o + 45, 20)
        kernel(call("cudaMemsetAsync", o + 50, tid=2), o + 66, 2,
               "Memset (Device)", "gpu_memset")
        kernel(call("cudaMemcpyAsync", o + 82), o + 83, 1,
               "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy")
        call("cudaStreamSynchronize", o + 83.5)
        kernel(call("cuLaunchKernel", o + 90), o + 91, 3)
    events.append(_span("chunk.read", 400, 420))
    kernel(call("cudaLaunchKernel", 405), 406, 2, "stack")
    kernel(call("cudaMemcpyAsync", 407), 409, 1,
           "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy")
    call("cudaStreamSynchronize", 408)
    events.append({"cat": "cpu_op", "name": "aten::mul", "ts": 6, "dur": 1})
    for cat, n in (("kernel", lost_kernels), ("cuda_runtime", lost_calls)):
        first = [e for e in events if e["cat"] == cat
                 and e["name"] in ("k", "cudaLaunchKernel")][
                     lost_at:lost_at + n]
        events = [e for e in events if all(e is not f for f in first)]
    return events[::-1]


def _run(events, steps=2):
    return types.SimpleNamespace(trace=tracing.Trace(events, 1.0),
                                 traced_steps=steps)


def test_each_operation_goes_to_the_span_its_launch_started_in():
    by = attribution.device_seconds(tracing.Trace(_events(), 1.0))
    assert by == pytest.approx({"svi.step": 0.0, "svi.elbo": 28e-6,
                                "svi.backward": 44e-6, "svi.optim": 8e-6,
                                None: 3e-6})
    assert _correlation_join(_events()) == (pytest.approx(by), 2)
    run = _run(_events())
    got = {m: spec.reader(m)(run) for m in READERS}
    assert got == pytest.approx({"elbo_device_ms": 0.014,
                                 "backward_device_ms": 0.022,
                                 "optim_device_ms": 0.004,
                                 "host_syncs_per_step": 1.0})


def test_lost_records_at_the_start_leave_the_rest_paired():
    # the first step's two ELBO kernels (6 + 8 us) left out, their calls kept
    by = attribution.device_seconds(tracing.Trace(_events(lost_kernels=2),
                                                  1.0))
    assert by == pytest.approx({"svi.step": 0.0, "svi.elbo": 14e-6,
                                "svi.backward": 44e-6, "svi.optim": 8e-6,
                                None: 3e-6})
    # the first call left out: its kernel (6 us) is in no span
    by = attribution.device_seconds(tracing.Trace(_events(lost_calls=1),
                                                  1.0))
    assert by == pytest.approx({"svi.step": 0.0, "svi.elbo": 22e-6,
                                "svi.backward": 44e-6, "svi.optim": 8e-6,
                                None: 9e-6})
    assert spec.reader("host_syncs_per_step")(_run(_events(2, 1))) == 1.0


def test_a_slip_in_the_middle_gives_nothing_to_read():
    # the second step's first kernel record lost: the four kernels before
    # it each pair with the call after theirs, the first of them with a
    # call that starts after it
    run = _run(_events(lost_kernels=1, lost_at=4))
    assert attribution.launched(run.trace) is None
    assert attribution.device_seconds(run.trace) is None
    assert all(spec.reader(m)(run) is None for m in READERS[:3])
    assert spec.reader("host_syncs_per_step")(run) == 1.0


def test_a_program_without_the_spans_gives_nothing_to_read():
    events = [e for e in _events() if e["name"] not in attribution.PROGRAM]
    run = _run(events)
    assert all(spec.reader(m)(run) is None for m in READERS)
    cpu = _run([e for e in _events() if e.get("cat") == "user_annotation"])
    assert all(spec.reader(m)(cpu) is None for m in READERS)
    assert all(spec.reader(m)(types.SimpleNamespace(
        trace=None, traced_steps=0)) is None for m in READERS)


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_a_traced_run_on_the_cpu_leaves_the_device_metrics_out(name):
    result = _tiny.run(name, 3000000101, traced=True)
    assert not set(READERS) & set(result["metrics"])


def _correlation_join(events):
    """{program span (None: none): device seconds} and the number of syncs
    inside svi.step, by `attribution.correlation_join`."""
    ops, syncs = attribution.correlation_join(events)
    out = dict.fromkeys(attribution.PROGRAM + (None,), 0.0)
    for op, _, span in ops:
        out[span and span["name"]] += op["dur"] / 1e6
    return out, len(syncs)


@pytest.mark.gpu
@pytest.mark.parametrize("name", _tiny.CELLS)
def test_the_order_join_is_the_correlation_join_on_the_card(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = _tiny.cell(name)
    dev = torch.device("cuda", 0)
    prog = ProgramRun(c.config, c.mix, 3000000107, dev, harness.Spans())
    prog.chunks(1)
    torch.cuda.synchronize()
    spans = harness.Spans()
    spans.annotate = True
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        steps, _ = prog.chunks(2, span=spans)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    exact, syncs = _correlation_join(events)
    run = _run(events, steps)
    # Trace.ops keeps a copy's end, not its duration: ~1e-10 s of rounding
    assert attribution.device_seconds(run.trace) == pytest.approx(exact,
                                                                  abs=1e-8)
    assert exact["svi.elbo"] and exact["svi.backward"] and exact["svi.optim"]
    assert exact[None] <= 0.02 * sum(exact.values())
    assert attribution.syncs_per_step(run) == syncs / steps > 0
