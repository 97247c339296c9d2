"""The port's examples 01-06 (`velocycle_tpu_torch/examples/`), each run as
a user runs it, in a subprocess at its smoke size (``VCT_SMOKE=1``) on the
CPU (``--device cpu``; example 05 with ``--world 2``, two ranks over gloo):
exit code 0 and its key line printed, as tests/test_examples.py runs the
JAX package's.  Examples 07 and 08 are run by tests/test_torch_minibatch.py
and tests/test_torch_twodim.py."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "01_phase_and_velocity_one_sample.py": ("phase fit: ELBO",
                                            "period (trapz of 1/omega):"),
    "02_two_sample_condition_contrast.py": ("phase fit ELBO", "omega d0 "),
    "03_mcmc_and_smc_posteriors.py": ("NUTS accept", "SMC: "),
    "04_pancreas_1d_spline.py": ("stage 1: ElogS corr vs truth",
                                 "transit time over the manifold"),
    "05_sharded_fit.py": ("2-rank mesh: ELBO", "sharded NUTS: 2 chains",
                          "sharded SMC: "),
    "06_stereoseq_spatial.py": ("LDA prior: UMI max-corr",
                                "phase fit (all 24 genes, delta_nu=0 pinned, "
                                "fused NB)"),
}
# arguments past ``--device cpu``
ARGS = {"05_sharded_fit.py": ["--world", "2"]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_smoke_on_the_cpu(name):
    env = dict(os.environ, VCT_SMOKE="1", PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("VCT_FIGDIR", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "velocycle_tpu_torch", "examples",
                                      name), "--device", "cpu",
         *ARGS.get(name, [])],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in CASES[name]:
        assert line in out.stdout, out.stdout[-2000:]
