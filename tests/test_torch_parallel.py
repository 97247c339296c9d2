"""Multi-process runs of the port (`velocycle_tpu_torch/parallel/`,
`SVI.init_sharded`) against the JAX package and against one process; the
sharded samplers are tests/test_torch_parallel_samplers.py.

The ranks are spawned processes on the CPU over gloo
(`parallel.run_ranks`, a ``timeout`` that kills them and fails); each world
size is spawned once per fixture and runs many checks
(tests/_torch_parallel_ranks.py), since a spawn costs seconds.  Sizes are
the JAX package's own (tests/test_sharding.py 64 x 12).

Tolerances: the sharded loss against the JAX package's unsharded
`value_and_grad` at fixed params and substituted guide noise, rel 1e-5,
every gradient max|a-b|/max|a| 1e-4 (the port's fused path against the
JAX package's plain one, as tests/test_torch_mcmc.py explains); world 2
and 4 trajectories against world 1 over 20 steps rtol 2e-4
(tests/test_distributed.py:255), the per-cell params too; world 1 against
`SVI.update` bit for bit; replicated params and Adam moments bit-identical
across the ranks.
"""
import numpy as np
import pytest
import jax

import velocycle_tpu as V
from velocycle_tpu.models import phase as jphase
from velocycle_tpu.models import velocity as jvel
from velocycle_tpu.parallel import distributed as jdist
from velocycle_tpu.parallel import sharding as jsharding
from velocycle_tpu_torch.convert import phase_data_from_jax, velocity_data_from_jax
from velocycle_tpu_torch.parallel import distributed, sharding

from _torch_parallel_ranks import spawn
from _torch_parity import jax_elbo

LOSS_RTOL, GRAD_RTOL, TRAJ_RTOL = 1e-5, 1e-4, 2e-4
STEPS = 20


# ---------------------------------------------------------------------------
# the data and the JAX references
# ---------------------------------------------------------------------------

def _phase_jmp(fused, Nc=64, Ng=12, seed=3):
    adata = V.simulate.simulate_data(Nc=Nc, Ng=Ng, omegas_to_test=(0.4,),
                                     seed=seed)
    cycle = V.Cycle.trivial_prior(list(adata.var.index), harmonics=1)
    phases = V.Phases.from_angles(np.asarray(adata.obs["simulated_phis"].values),
                                  cell_names=list(adata.obs.index))
    return V.preprocess_for_phase_estimation(
        adata, cycle, phases, n_harmonics=1, with_delta_nu=False,
        use_fused_nb=fused)


def _lrmn_jmp(Nc=64, Ng=12, seed=17):
    adata = V.simulate.simulate_data(Nc=Nc, Ng=Ng, seed=seed)
    cycle = V.Cycle.trivial_prior(list(adata.var.index), harmonics=2)
    phases = V.Phases.from_angles(adata.obs["simulated_phis"].values, 2.0,
                                  list(adata.obs.index))
    speed = V.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                         stds=0.5)
    return V.preprocess_for_velocity_estimation(
        adata, cycle, phases, speed, n_harmonics=2, omega_n_harmonics=1,
        with_delta_nu=False, model_type="lrmn", use_fused_nb=True)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_f32(x) for x in tree)
    return np.asarray(tree, np.float32)


@pytest.fixture(scope="module")
def cases():
    """{name: (kind, port data, fixed params, noise, conditioned values,
    JAX loss, JAX grads)}: the phase model plain and fused (64 x 12), the
    LRMN velocity model fused and conditioned on phi_xy, nu, shape_inv."""
    out = {}
    rng = np.random.default_rng(2)
    for fused in (False, True):
        jmp = _phase_jmp(fused)
        jdata = jmp.data.replace(use_fused_nb=False)
        eps = {"nu": rng.normal(size=jdata.mu_nu.shape),
               "phi_xy": rng.normal(size=jdata.phixy_prior.shape)}
        params, jl, jg = jax_elbo(jphase.phase_model, jphase.phase_guide,
                                   jdata, eps)
        out["phase_fused" if fused else "phase"] = (
            "phase", phase_data_from_jax(jmp.data, device="cpu"), params,
            _f32(eps), None, jl, jg)
    jmp = _lrmn_jmp()
    jdata = jmp.data.replace(use_fused_nb=False)
    Ng, Nx, Nhw = jdata.Ng, jdata.Nx, jdata.Nhw
    cond = {"phi_xy": np.asarray(jdata.phixy_prior),
            "nu": np.asarray(jdata.mu_nu),
            "shape_inv": np.full((Ng,), 0.3, np.float32)}
    eps = {"log_beta": rng.normal(size=Ng),
           "_lrmn_draw": (rng.normal(size=jdata.rho_rank),
                          rng.normal(size=Ng + Nx * Nhw))}
    params, jl, jg = jax_elbo(jvel.velocity_model, jvel.velocity_guide_lrmn,
                               jdata, eps, cond)
    tdata = velocity_data_from_jax(jmp.data, device="cpu").replace(
        disp_grad=False)
    out["lrmn"] = ("lrmn", tdata, params, _f32(eps), cond, jl, jg)
    return out


def _tasks(cases):
    tasks = []
    for name, (kind, tdata, params, eps, cond, _, _) in cases.items():
        tasks.append((f"elbo:{name}", "elbo_grads",
                      (kind, tdata, params, eps, cond)))
        tasks.append((f"traj:{name}", "trajectory",
                      (kind, tdata, STEPS, cond)))
    return tasks


@pytest.fixture(scope="module")
def world1(cases):
    return spawn(1, _tasks(cases))


@pytest.fixture(scope="module")
def world2(cases):
    return spawn(2, _tasks(cases) + [
        ("loading:phase", "per_rank_loading", (cases["phase_fused"][1],)),
        ("loading:lrmn", "per_rank_loading", (cases["lrmn"][1],)),
        ("refusal", "mesh_refusal", ()),
        ("unlisted", "unlisted_cell_site_refusal", (cases["phase"][1],)),
        ("replicate", "replicated", (5.0,)),
    ])


@pytest.fixture(scope="module")
def world4(cases):
    return spawn(4, _tasks(cases))


def _worlds(request, world):
    return request.getfixturevalue(f"world{world}")


# ---------------------------------------------------------------------------
# pure functions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,count", [(100, 4), (101, 4), (7, 4), (8, 4),
                                     (102_400, 2), (3, 5), (64, 1)])
def test_process_cell_slice_matches_jax(n, count):
    ours = [distributed.process_cell_slice(n, i, count) for i in range(count)]
    assert ours == [jdist.process_cell_slice(n, i, count) for i in range(count)]
    assert ours[0][0] == 0 and ours[-1][1] == n
    assert distributed.split_counts(n, count) == [hi - lo for lo, hi in ours]


@pytest.mark.parametrize("axis,index,count", [(1, 1, 3), (0, 0, 2), (-1, 2, 3)])
def test_local_data_slice_matches_jax(axis, index, count):
    x = np.arange(30).reshape(3, 10)
    np.testing.assert_array_equal(
        distributed.local_data_slice(x, axis=axis, index=index, count=count),
        jdist.local_data_slice(x, axis=axis, index=index, count=count))


def test_cell_axis_tables_match_jax():
    assert sharding.PHASE_CELL_AXES == jsharding._PHASE_CELL_AXES
    assert sharding.VELOCITY_CELL_AXES == jsharding._VELOCITY_CELL_AXES
    assert sharding.PARAM_CELL_AXES == jsharding._PARAM_CELL_AXES
    from velocycle_tpu_torch.infer import minibatch

    assert minibatch._PHASE_CELL_AXES is sharding.PHASE_CELL_AXES
    assert minibatch._PARAM_CELL_AXES is sharding.PARAM_CELL_AXES


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for v in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert not distributed.is_initialized()
    assert distributed.process_count() == 1 and distributed.process_index() == 0


# ---------------------------------------------------------------------------
# the sharded ELBO and SVI trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["phase", "phase_fused", "lrmn"])
def test_sharded_elbo_and_grads_match_jax(request, cases, world, name):
    *_, jl, jg = cases[name]
    results = _worlds(request, world)
    for r in results:
        tl, tg, _ = r[f"elbo:{name}"]
        assert abs(tl - jl) / abs(jl) < LOSS_RTOL, (tl, jl)
        assert sorted(tg) == sorted(jg)
        for k in jg:
            err = np.abs(tg[k] - jg[k]).max() / (np.abs(jg[k]).max() + 1e-9)
            assert np.isfinite(tg[k]).all() and err < GRAD_RTOL, (k, err)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", ["phase_fused", "lrmn"])
def test_lgamma_k_sum_is_added_once(request, cases, world, name):
    """One rank adds the dataset constant, the others pass 0.0 (never None,
    which would turn the kernels' skip of lgamma(k + 1) off); the sharded
    loss equals the world-1 loss."""
    tdata = cases[name][1]
    results = _worlds(request, world)
    lgks = [r[f"elbo:{name}"][2] for r in results]
    assert all(v is not None for v in lgks)
    assert lgks[0] == pytest.approx(float(tdata.lgamma_k_sum), rel=0)
    assert all(v == 0.0 for v in lgks[1:])
    one = request.getfixturevalue("world1")[0][f"elbo:{name}"][0]
    assert results[0][f"elbo:{name}"][0] == pytest.approx(one, rel=1e-6)


@pytest.mark.parametrize("name", ["phase", "phase_fused", "lrmn"])
def test_world_one_is_svi_update_bit_for_bit(world1, name):
    r = world1[0][f"traj:{name}"]
    np.testing.assert_array_equal(r["losses"], r["unsharded_losses"])
    for k, v in r["unsharded_params"].items():
        np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["phase", "phase_fused", "lrmn"])
def test_sharded_trajectory_matches_world_one(request, world1, world, name):
    one = world1[0][f"traj:{name}"]
    results = _worlds(request, world)
    r0 = results[0][f"traj:{name}"]
    assert r0["losses"].shape == (STEPS,) and np.isfinite(r0["losses"]).all()
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=TRAJ_RTOL)
    for k, v in one["cells"].items():
        np.testing.assert_allclose(r0["cells"][k], v, rtol=TRAJ_RTOL,
                                   atol=TRAJ_RTOL * np.abs(v).max())
    # replicated params and their Adam moments: the same bits on every rank
    for r in results[1:]:
        t = r[f"traj:{name}"]
        np.testing.assert_array_equal(t["losses"], r0["losses"])
        assert t["replicated"] == r0["replicated"]
        assert t["moments"] == r0["moments"]


def test_per_rank_loading_matches_the_jax_slices(world2, cases):
    """`globalize_data` on a rank's own cells equals `shard_phase_data`'s
    shard (and `globalize_params` `shard_params`), and rank r's shard of
    the container carried over from JAX is the JAX container's arrays cut
    at `process_cell_slice`."""
    for key, case in (("loading:phase", "phase_fused"), ("loading:lrmn", "lrmn")):
        tdata = cases[case][1]
        for r, res in enumerate(world2):
            fields, same, same_params, (lo, hi) = res[key]
            assert same and same_params
            assert (lo, hi) == jdist.process_cell_slice(tdata.Nc, r, 2)
            axes = (sharding.VELOCITY_CELL_AXES if case == "lrmn"
                    else sharding.PHASE_CELL_AXES)
            for k, v in fields.items():
                full = getattr(tdata, k).numpy()
                want = (jdist.local_data_slice(full, axis=axes[k], index=r,
                                               count=2)
                        if k in axes and full.ndim > axes[k] else full)
                if k == "lgamma_k_sum" and r:
                    want = np.zeros_like(want)
                np.testing.assert_array_equal(v, want, err_msg=k)


def test_make_mesh_refuses_a_shape_off_the_world(world2):
    for r in world2:
        assert r["refusal"] == "mesh shape (3,) != 2 devices"


def test_sharded_step_refuses_a_cell_site_off_local_sites(world2):
    """A site in the "cells" plate that LOCAL_SITES does not name would be
    scaled by 0 off rank 0: every rank refuses it."""
    for r in world2:
        assert r["unlisted"] is not None and "'extra'" in r["unlisted"]


def test_replicate_and_the_param_spec(world2):
    """`replicate` gives every rank rank 0's bits (other leaves as they
    are); `param_sharding_spec` splits the per-cell params only."""
    for r in world2:
        assert r["replicate"] == (5.0, "label", {"phixy_locs": 0,
                                                  "nu_locs": None})
