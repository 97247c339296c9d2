"""The sharded samplers of the port against one process: chain-sharded
MCMC (`MCMC.run(mesh=)`, a ("chains",) mesh and a ("cells", "chains")
one), particle-sharded SMC (`SMC.run(mesh=)`) and the weak-scaling harness
(`parallel.phase_weak_scaling`).

The ranks are spawned processes on the CPU over gloo, as in
tests/test_torch_parallel.py.  Gates: the bands of
tests/test_distributed.py:78-96 (the Gaussian's moments, sharded against
unsharded), its 2-axis mesh's shapes at 64 x 8, and the cells group's
potential and gradient bit-identical on every member; SMC: the conjugate
posterior mean within 0.2 (tests/test_distributed.py:137-157), log Z
bit-identical on every rank, the phase and the fused velocity models' log
Z within 2 nats of the unsharded run's (ROADMAP section 3); the harness'
rows as
tests/test_distributed.py:160-178.
"""
import numpy as np
import pytest

import velocycle_tpu as V
from velocycle_tpu_torch.convert import (
    phase_data_from_jax, velocity_data_from_jax,
)

from _torch_parallel_ranks import TIMEOUT, spawn


@pytest.fixture(scope="module")
def phase8():
    """tests/test_distributed.py's 64 x 8 phase draw (seed 4), fused."""
    adata = V.simulate.simulate_data(Nc=64, Ng=8, omegas_to_test=(0.4,),
                                     seed=4)
    cycle = V.Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = V.Phases.from_angles(np.asarray(adata.obs["simulated_phis"].values),
                                  cell_names=list(adata.obs.index))
    mp = V.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=True)
    return phase_data_from_jax(mp.data, device="cpu")


@pytest.fixture(scope="module")
def velo5():
    """tests/test_torch_smc.py's fused velocity draw (20 x 5, seed 3)."""
    sim = V.simulate.simulate_data(Nc=20, Ng=5, seed=3)
    mp = V.preprocess_for_velocity_estimation(
        sim, V.Cycle.trivial_prior(list(sim.var.index), harmonics=1),
        V.Phases.from_angles(sim.obs["simulated_phis"].values,
                             cell_names=list(sim.obs.index)),
        V.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                     stds=0.5),
        n_harmonics=1, omega_n_harmonics=1, with_delta_nu=False,
        model_type="fourier", use_fused_nb=True)
    return velocity_data_from_jax(mp.data, device="cpu")


@pytest.fixture(scope="module")
def world2(phase8, velo5):
    return spawn(2, [
        ("gauss", "gauss_chains", ("hmc", 300, 600, 8, 1)),
        ("smc_conjugate", "smc_conjugate", (256, 0)),
        ("smc_phase", "smc_phase", (phase8, 64, 2)),
        ("smc_velocity", "smc_velocity", (velo5, 16, 3)),
        ("refusal", "unconditioned_cells_refusal", (phase8,)),
    ])


@pytest.fixture(scope="module")
def world4(phase8):
    return spawn(4, [
        ("gauss", "gauss_chains", ("hmc", 300, 600, 8, 1)),
        ("two_axis", "two_axis_nuts", (phase8,)),
    ])


def _worlds(request, world):
    return request.getfixturevalue(f"world{world}")


@pytest.fixture(scope="module")
def gauss_unsharded():
    import _torch_parallel_ranks as R
    from velocycle_tpu_torch.infer import mcmc as TM

    m = TM.MCMC(R.gauss, kernel="hmc", num_warmup=300, num_samples=600,
                num_chains=8)
    m.run(1)
    return m.get_samples(group_by_chain=True)["x"]


@pytest.mark.parametrize("world", [2, 4])
def test_mcmc_chains_sharded_match_unsharded_moments(request, world,
                                                     gauss_unsharded):
    results = _worlds(request, world)
    s, rhat, acc = results[0]["gauss"]
    assert s.shape == (8, 600)
    for r in results[1:]:
        np.testing.assert_array_equal(r["gauss"][0], s)
    assert abs(s.mean() - 2.0) < 0.35 and abs(s.std() - 3.0) < 0.45
    assert rhat < 1.1 and 0.3 < acc <= 1.0
    u = gauss_unsharded
    assert abs(s.mean() - u.mean()) < 0.3 and abs(s.std() - u.std()) < 0.4


def test_nuts_on_a_cells_by_chains_mesh(world4, phase8):
    """tests/test_distributed.py:99-135 on a 2 x 2 mesh: finite nu of shape
    (samples * chains, Ng, Nh); every member of a cells group holds the same
    potential and gradient bits (the chains' trees stay in lockstep), and
    every rank the same draws.  The cell-summed potential (less its summed
    log_offset: the absolute -log density) and its gradient at two points
    against the unsharded potential of the same conditioned model on all
    64 cells (value rtol 1e-5, gradient rtol 1e-4)."""
    import torch

    from velocycle_tpu_torch.core import handlers as th
    from velocycle_tpu_torch.infer import mcmc as TM
    from velocycle_tpu_torch.models.phase import phase_model

    by_chain = {}
    for r in world4:
        t = r["two_axis"]
        assert t["nu"].shape == (120, 8, 3) and np.isfinite(t["nu"]).all()
        by_chain.setdefault(t["chains_rank"], []).append(t)
    assert sorted(by_chain) == [0, 1]
    for members in by_chain.values():
        assert sorted(m["cells_rank"] for m in members) == [0, 1]
        a, b = members
        np.testing.assert_array_equal(a["value"], b["value"])
        np.testing.assert_array_equal(a["grad"], b["grad"])
    for r in world4[1:]:
        np.testing.assert_array_equal(r["two_axis"]["nu"],
                                      world4[0]["two_axis"]["nu"])
    model = th.condition(phase_model, data={"phi_xy": phase8.phixy_prior})
    info = TM.init_model(model, phase8, seed=0)
    for r in world4:
        t = r["two_axis"]
        value, grad = TM._batched_value_and_grad(info.potential_fn)(
            torch.as_tensor(t["q"]))
        want = value.double().numpy() - info.log_offset
        got = t["value"].astype(np.float64) - t["log_offset"]
        np.testing.assert_allclose(got, want, rtol=1e-5)
        g = grad.numpy()
        np.testing.assert_allclose(t["grad"], g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max())


def test_mcmc_refuses_latent_cell_sites_on_a_cells_mesh(world2):
    """64 cells split evenly over two ranks, phi_xy left latent: each rank's
    chain state has one size, but its phi_xy block holds other cells.  The
    sharded potential refuses it by structure, on every rank."""
    for r in world2:
        assert r["refusal"] is not None and "phi_xy" in r["refusal"]


def test_smc_conjugate_particles_sharded(world2):
    post_var = 1.0 / (1.0 / 9.0 + 4.0)
    post_mean = post_var * (4 * 1.975)
    mu, log_z = world2[0]["smc_conjugate"]
    assert mu.shape == (256,) and abs(mu.mean() - post_mean) < 0.2
    assert np.isfinite(log_z)
    for r in world2[1:]:
        assert r["smc_conjugate"][1] == log_z          # bit-identical
        np.testing.assert_array_equal(r["smc_conjugate"][0], mu)


def test_smc_phase_model_sharded_against_unsharded(world2, phase8):
    from velocycle_tpu_torch.core import handlers as th
    from velocycle_tpu_torch.infer import smc as TS
    from velocycle_tpu_torch.models.phase import phase_model

    log_z, nu, sched = world2[0]["smc_phase"]
    assert all(r["smc_phase"][0] == log_z for r in world2)
    assert sched[-1] == 1.0 and nu.shape == (64, 8, 3)
    assert np.isfinite(nu).all()
    model = th.condition(phase_model, data={"phi_xy": phase8.phixy_prior})
    smc = TS.SMC(model, num_particles=64, num_moves=2, max_stages=100)
    smc.run(2, phase8)
    assert abs(smc.log_evidence() - log_z) < 2.0, (smc.log_evidence(), log_z)


def test_smc_velocity_model_sharded_against_unsharded(world2, velo5):
    """The fused velocity model (velo_fwd per stage, velo_fwdgrad per
    leapfrog) with its particles split: log Z equal on both ranks, within
    2 nats of the unsharded run's."""
    import torch

    from velocycle_tpu_torch.core import handlers as th
    from velocycle_tpu_torch.infer import smc as TS
    from velocycle_tpu_torch.models.velocity import velocity_model

    log_z, nu = world2[0]["smc_velocity"]
    assert all(r["smc_velocity"][0] == log_z for r in world2)
    assert nu.shape == (16, 5, 3) and np.isfinite(nu).all()
    model = th.condition(velocity_model,
                         data={"phi_xy": torch.as_tensor(velo5.phixy_prior)})
    smc = TS.SMC(model, num_particles=16, num_moves=1, max_stages=60)
    smc.run(3, velo5)
    assert abs(smc.log_evidence() - log_z) < 2.0, (smc.log_evidence(), log_z)


def test_phase_weak_scaling_harness():
    from velocycle_tpu_torch.parallel import format_report, phase_weak_scaling

    rows = phase_weak_scaling(per_device_cells=32, Ng=8, steps=5,
                              device_counts=[1, 2], repeats=1, device="cpu",
                              timeout=TIMEOUT)
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["Nc"] == 32 and rows[1]["Nc"] == 64
    for r in rows:
        assert np.isfinite(r["steps_per_s"]) and r["steps_per_s"] > 0
        assert r["efficiency"] > 0
    report = format_report(rows)
    assert "efficiency" in report and "devices" in report
