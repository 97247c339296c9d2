"""The batch-corrected model (``with_delta_nu=True``, per-batch offsets
``delta_nu`` over a batch design ``Db``) on every inference path of the port,
against the JAX package on the same numpy arrays.

Each case runs at Nb = 2 and Nb = 16 batches.  On the card Nb = 2 with Nh =
3 or 5 is the narrow bodies' ``HAS_DNU`` route, and Nb = 16 folds into Nh +
16 = 19 (phase, one harmonic) or 21 (velocity, two) basis columns on the
wide body; on the CPU the fused likelihoods take their plain versions, which
take ``delta_nu`` and ``Db`` as they are (tests/test_torch_wide.py holds the
wide twins' fold against them).  The batches are a seeded shuffle of Nc / Nb
cells each, so that every minibatch block and every rank holds cells of
most batches.

  * The front door: `preprocess_for_phase_estimation(design_mtx=)` and
    `preprocess_for_velocity_estimation(batch_design_mtx=)` give containers
    bit-equal to the JAX package's, every field (Db, Nb, sd_dnu, mu_dnu, the
    counts, lgamma_k_sum), fused and plain.
  * NUTS: `init_model`'s potential and gradient over a chain batch, nu and
    delta_nu sampled (phi_xy conditioned), both stages, against the JAX
    package's at `tests/test_torch_mcmc.py`'s tolerances (the minus log
    joint rel 1e-5, the gradient max|a-b|/max|a| 1e-4, ``log_offset`` rel
    1e-6 plain and 5e-6 fused; the fused path against the JAX package's
    PLAIN path, as there); batched chains equal single-chain runs (states
    and accept probabilities within 1e-6 fused, 5e-4 / 1e-3 plain, as
    there).
  * The sampled posterior: `MCMCFitModel`'s ``ElogS`` and ``ElogS2`` from
    draws with ``delta_nu`` equal the JAX package's extraction on the same
    draws (max|a-b|/max|a| 1e-6).
  * SMC: the tempered model's prior and likelihood parts and their
    gradients at fixed particles against the JAX package's (values 1e-5 of
    the part's magnitude plus 1e-6, gradients 1e-4, as
    tests/test_torch_smc.py); a short phase SMC reaches beta = 1 with a
    finite log Z, and its log Z summed again over its recorded stages
    equals the run's (rel 1e-9) and, with the plain path's likelihood at
    the same particles and betas, is within LOSS_RTOL x |log Z| of it
    (chip_smoke.py [wide] (e)'s gate).
  * MinibatchSVI: the mean of the scaled block losses, ``Db`` cut per
    block, equals the JAX package's full-batch loss at its guide's draws
    (rel 1e-5); `iter_host_blocks(Db=)` and `init_template(Db=)` build the
    JAX package's blocks (exact, but each block's lgamma_k_sum: the port's
    float64 sum against the JAX package's float32 one, rel 1e-6); the
    streamed fit equals the resident one
    (rtol 1e-6, as tests/test_torch_minibatch.py).
  * The sharded step: two ranks over gloo, ``Db`` split by cells with the
    shards, the loss and every gradient against the JAX package's
    unsharded ``value_and_grad`` (rel 1e-5, gradients 1e-4, as
    tests/test_torch_parallel.py), and 20 steps' losses against `SVI.update`
    in one process within rel 2e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.special import gammaln

import velocycle_tpu as V
from velocycle_tpu.core import handlers as jh
from velocycle_tpu.infer import Trace_ELBO as JTrace_ELBO
from velocycle_tpu.infer import mcmc as JM
from velocycle_tpu.infer import smc as JS
from velocycle_tpu.infer import minibatch as JMB
import velocycle_tpu_torch as T
from velocycle_tpu_torch.core import handlers as th
from velocycle_tpu_torch.infer import SVI, Trace_ELBO, clipped_adam
from velocycle_tpu_torch.infer import mcmc as TM
from velocycle_tpu_torch.infer import smc as TS
from velocycle_tpu_torch.infer.minibatch import (
    LOCAL_SITES, MinibatchSVI, init_template, iter_host_blocks, split_cells,
)
from velocycle_tpu_torch.models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS,
)

from _torch_parallel_ranks import spawn
from _torch_parity import first_trace_at, jax_elbo

NG, NC = 10, 160
NBS = (2, 16)
H = {"phase": 1, "velocity": 2}      # Nh 3 and 5: 19 and 21 columns at 16
NBLK = 4                             # minibatch blocks of 40 cells
POT_RTOL, GRAD_RTOL = 1e-5, 1e-4
VAL_RTOL, VAL_ATOL = 1e-5, 1e-6
SHARD_LOSS_RTOL, SHARD_STEPS, SHARD_TRAJ_RTOL = 1e-5, 20, 2e-6
STAGES = ("phase", "velocity")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


# ---------------------------------------------------------------------------
# the data: either package's front door on the same simulated counts
# ---------------------------------------------------------------------------

def _labels(nb):
    """Nc / nb cells of each of nb batches, in a seeded shuffle."""
    return np.random.default_rng(nb).permutation(
        np.repeat([f"batch{b:02d}" for b in range(nb)], NC // nb))


@functools.lru_cache(maxsize=None)
def _mp(pkg_name, stage, nb, fused, model_type="fourier"):
    """Either package's metaparams of ``stage`` from its own front door:
    the simulated counts, an obs column of ``nb`` batches and its design
    through the package's `make_design_matrix`, ``delta_nu`` on."""
    pkg = T if pkg_name == "torch" else V
    sim = (T.simulate_data if pkg is T else V.simulate.simulate_data)(
        Nc=NC, Ng=NG, omegas_to_test=(0.4,), seed=3)
    sim.obs["batch"] = _labels(nb)
    design = pkg.make_design_matrix(sim, "batch")
    cycle = pkg.Cycle.trivial_prior(list(sim.var.index), harmonics=H[stage])
    phases = pkg.Phases.from_angles(sim.obs["simulated_phis"].values, 2.0,
                                    list(sim.obs.index))
    kw = dict(n_harmonics=H[stage], with_delta_nu=True, use_fused_nb=fused)
    if pkg is T:
        kw["device"] = "cpu"
    if stage == "phase":
        return pkg.preprocess_for_phase_estimation(
            sim, cycle, phases, design_mtx=design, **kw)
    speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1, means=0.2,
                                           stds=0.5)
    return pkg.preprocess_for_velocity_estimation(
        sim, cycle, phases, speed, batch_design_mtx=design,
        omega_n_harmonics=1, model_type=model_type, **kw)


def _assert_data_equal(ours, theirs):
    fields = VELOCITY_TENSOR_FIELDS if hasattr(ours, "U") else \
        PHASE_TENSOR_FIELDS
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name not in fields:
            assert a == b, f.name
        elif b is None:
            assert a is None, f.name
        else:
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)


CASES = [(stage, nb, fused) for stage in STAGES for nb in NBS
         for fused in (False, True)]
# the velocity stage's front door for both of its models: LRMN (the main
# path, the minibatch and sharded cases) and the mean-field Fourier model
# (NUTS and SMC)
FRONT_CASES = [case + (mt,) for case in CASES
               for mt in (("fourier",) if case[0] == "phase"
                          else ("lrmn", "fourier"))]


@pytest.mark.parametrize("stage,nb,fused,model_type", FRONT_CASES)
def test_front_door_matches_jax(stage, nb, fused, model_type):
    ours = _mp("torch", stage, nb, fused, model_type).data
    theirs = _mp("jax", stage, nb, fused, model_type).data
    _assert_data_equal(ours, theirs)
    assert ours.with_delta_nu and ours.Nb == nb
    assert tuple(ours.Db.shape) == (nb, NC) and ours.sd_dnu.shape == (nb, 1)
    assert (ours.Db.sum(0) == 1).all() and (ours.Db.sum(1) == NC // nb).all()
    if fused:
        assert ours.S.dtype == torch.int16 and ours.lgamma_k_sum is not None


# ---------------------------------------------------------------------------
# NUTS: the potential over a chain batch, batched chains against single ones
# ---------------------------------------------------------------------------

def _models(stage, nb, fused):
    """(JAX model and data on the JAX package's PLAIN path, the port's
    model and data on ``fused``, the JAX package's prior draw of the latent
    sites): phi_xy conditioned on its prior in both."""
    jmp = _mp("jax", stage, nb, False)
    tmp = _mp("torch", stage, nb, fused)
    cond = np.asarray(jmp.data.phixy_prior)
    jmodel = jh.condition(jmp.model_fn, data={"phi_xy": jnp.asarray(cond)})
    tmodel = th.condition(tmp.model_fn, data={"phi_xy": torch.as_tensor(cond)})
    info0 = JM.init_model(jmodel, jmp.data, key=jax.random.PRNGKey(0))
    init = {k: np.asarray(v) for k, v in info0.unflatten(info0.init_u).items()}
    assert "delta_nu" in init and init["delta_nu"].shape == (nb, NG)
    return jmodel, jmp.data, tmodel, tmp.data, init


@pytest.mark.parametrize("stage,nb,fused", CASES)
def test_nuts_potential_over_a_chain_batch_matches_jax(stage, nb, fused):
    jmodel, jd, tmodel, td, init = _models(stage, nb, fused)
    jinfo = JM.init_model(jmodel, jd, init_values=init)
    tinfo = TM.init_model(tmodel, td, init_values=init)
    assert list(tinfo.site_meta) == list(jinfo.site_meta)
    np.testing.assert_allclose(tinfo.init_u.numpy(), np.asarray(jinfo.init_u),
                               rtol=1e-6, atol=1e-6)
    off_rtol = 5e-6 if fused else 1e-6
    assert abs(tinfo.log_offset - jinfo.log_offset) < off_rtol * abs(
        jinfo.log_offset), (tinfo.log_offset, jinfo.log_offset)
    u = (np.asarray(jinfo.init_u)[None] + np.random.default_rng(nb).normal(
        0, 0.05, (3, jinfo.init_u.shape[0]))).astype(np.float32)
    tv, tg = TM._batched_value_and_grad(tinfo.potential_fn)(torch.as_tensor(u))
    for k in range(3):
        jv, jg = jax.value_and_grad(jinfo.potential_fn)(jnp.asarray(u[k]))
        t_joint = float(tv[k]) - tinfo.log_offset
        j_joint = float(jv) - jinfo.log_offset
        assert abs(t_joint - j_joint) < POT_RTOL * abs(j_joint), (k, t_joint,
                                                                  j_joint)
        assert _rel(tg[k].numpy(), np.asarray(jg)) < GRAD_RTOL, k


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("fused", [False, True])
def test_batched_chains_equal_single_chain_runs(nb, fused):
    """Three chains in one batch against the three single-chain runs of the
    same seeds, NUTS on the phase model with delta_nu, 8 iterations:
    `tests/test_torch_mcmc.py`'s phase-model tolerances (fused: the
    chain-batched call rounds each chain as a single one; plain: batched
    matmuls round otherwise)."""
    _, _, tmodel, td, init = _models("phase", nb, fused)
    info = TM.init_model(tmodel, td, init_values=init)
    jit = torch.as_tensor(np.random.default_rng(10).normal(
        0, 0.05, (3, info.init_u.shape[0])).astype(np.float32))
    seeds = [11, 12, 13]
    kw = dict(num_warmup=4, num_samples=4, step_size=0.05, max_depth=4)
    batched = TM.nuts(info._replace(init_u=info.init_u + jit), seeds,
                      q_safe=info.init_u, **kw)
    q_tol, acc_tol = (1e-6, 1e-6) if fused else (5e-4, 1e-3)
    for c, s in enumerate(seeds):
        single = TM.nuts(info._replace(init_u=info.init_u + jit[c]), s,
                         q_safe=info.init_u, **kw)
        np.testing.assert_allclose(batched[0][c].numpy(), single[0].numpy(),
                                   rtol=0, atol=q_tol)
        np.testing.assert_allclose(batched[1][c].numpy(), single[1].numpy(),
                                   rtol=0, atol=acc_tol)


# ---------------------------------------------------------------------------
# the sampled posterior
# ---------------------------------------------------------------------------

def _draws(stage, nb, D=12):
    rng = np.random.default_rng(5 + nb)
    nh = 2 * H[stage] + 1
    out = {"nu": rng.normal(0.3, 0.5, (D, NG, nh)),
           "delta_nu": rng.normal(0.0, 0.3, (D, nb, NG)),
           "shape_inv": rng.gamma(2.0, 0.3, (D, NG))}
    if stage == "velocity":
        out.update(log_gamma=rng.normal(0, 0.5, (D, NG)),
                   log_beta=rng.normal(2, 0.5, (D, NG)),
                   nu_omega=rng.normal(0.2, 0.1, (D, 1, 3)))
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("nb", NBS)
def test_posterior_elogs_with_delta_nu_matches_jax(stage, nb):
    """`MCMCFitModel`'s extraction from draws with delta_nu: ElogS = mean nu
    @ zeta^T + mean delta_nu^T Db + count_factor (and ElogS2 with the mean
    count factor), the JAX package's formula on the same draws."""
    draws = _draws(stage, nb)
    tmp, jmp = _mp("torch", stage, nb, True), _mp("jax", stage, nb, True)
    tf = T.MCMCFitModel(tmp, condition_on={"phi_xy": tmp.data.phixy_prior})
    jf = V.MCMCFitModel(jmp, condition_on={
        "phi_xy": np.asarray(jmp.data.phixy_prior)})
    tf._extract(dict(draws))
    jf._extract(dict(draws))
    for key in ("ElogS", "ElogS2"):
        assert tf.posterior[key].shape == (NG, NC)
        assert _rel(tf.posterior[key], jf.posterior[key]) < 1e-6, key
    # the offsets reach it: without them ElogS moves
    tf._extract({k: v for k, v in draws.items() if k != "delta_nu"})
    assert _rel(tf.posterior["ElogS"], jf.posterior["ElogS"]) > 1e-3
    np.testing.assert_allclose(tf.cycle_fit.means_array,
                               jf.cycle_fit.means_array, rtol=1e-6)


# ---------------------------------------------------------------------------
# SMC: the tempered model's parts at fixed particles; a short run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage,nb,fused", CASES)
def test_tempered_model_parts_match_jax(stage, nb, fused):
    """The prior (with the bijections' log-dets) and likelihood parts of
    `init_tempered_model` and their gradients at particles around the
    reference draw, and the tempered log-density lp + beta ll at beta =
    0.37 over the particles as one chain batch."""
    jmodel, jd, tmodel, td, ref = _models(stage, nb, fused)
    jtm = JS.init_tempered_model(
        first_trace_at(jh, jmodel, {k: jnp.asarray(v) for k, v in ref.items()}),
        jd, key=jax.random.PRNGKey(1))
    ttm = TS.init_tempered_model(
        first_trace_at(th, tmodel, {k: torch.as_tensor(v)
                                     for k, v in ref.items()}), td, seed=1)
    assert ttm.dim == jtm.dim
    off_rtol = 5e-6 if fused else 1e-6
    assert abs(ttm.log_lik_offset - jtm.log_lik_offset) < off_rtol * abs(
        jtm.log_lik_offset)
    order = list(jtm.unflatten(jnp.zeros(jtm.dim)))
    assert order == list(ttm.unflatten(torch.zeros(ttm.dim)))
    jtr = jh.trace(jh.substitute(jmodel, data=ref)).get_trace(jd)
    mags = {"log_prior_fn": abs(sum(float(jtr[k]["fn"].log_prob(
                jtr[k]["value"]).sum()) for k in ref)),
            "log_lik_fn": abs(jtm.log_lik_offset)}
    u_ref = np.concatenate([
        np.log(np.expm1(ref[k].astype(np.float64))).ravel()
        if k == "shape_inv" else ref[k].ravel() for k in order
    ]).astype(np.float32)
    u = (u_ref[None] + np.random.default_rng(nb).normal(
        0, 0.05, (2, u_ref.size))).astype(np.float32)
    beta = 0.37

    def tempered(q):
        lp, ll = ttm.log_parts(q)
        return lp + beta * ll

    tv, tg = TM._batched_value_and_grad(tempered)(torch.as_tensor(u))
    for k in range(2):
        want = {}
        for part, mag in mags.items():
            jv, jg = jax.value_and_grad(getattr(jtm, part))(jnp.asarray(u[k]))
            q = torch.as_tensor(u[k]).requires_grad_(True)
            v = getattr(ttm, part)(q)
            (g,) = torch.autograd.grad(v, q)
            v = float(v.detach())
            assert abs(v - float(jv)) < VAL_RTOL * mag + VAL_ATOL, (
                part, v, float(jv))
            assert _rel(g.numpy(), np.asarray(jg)) < GRAD_RTOL, part
            want[part] = (float(jv), np.asarray(jg))
        jt = want["log_prior_fn"][0] + beta * want["log_lik_fn"][0]
        jtg = want["log_prior_fn"][1] + beta * want["log_lik_fn"][1]
        assert abs(float(tv[k]) - jt) < VAL_RTOL * sum(mags.values()) + \
            VAL_ATOL
        assert _rel(tg[k].numpy(), jtg) < GRAD_RTOL


@pytest.mark.parametrize("nb", NBS)
def test_short_phase_smc_reaches_beta_one(nb):
    """SMCFitModel's prior tempering on the fused phase data with 16
    batches or 2: beta reaches 1 on an increasing schedule, log Z and the
    posterior finite, the delta_nu particles of their shape."""
    mp = _mp("torch", "phase", nb, True)
    fm = T.SMCFitModel(mp, condition_on={"phi_xy": mp.data.phixy_prior},
                       num_particles=32, num_moves=1, target_ess=0.5,
                       max_stages=200)
    fm.run(0)
    sched = np.asarray(fm.temperature_schedule)
    assert sched[-1] == 1.0 and (np.diff(sched) > 0).all()
    assert np.isfinite(fm.log_evidence)
    assert fm.posterior["delta_nu"].shape == (32, nb, NG)
    assert all(np.isfinite(v).all() for v in fm.posterior.values())


@pytest.mark.parametrize("nb", NBS)
def test_smc_log_z_along_its_stages_matches_the_plain_path(nb):
    """chip_smoke.py [wide] (e)'s gate at a small size: a fused phase SMC
    run's stages recorded (their particles before the reweighting and
    their betas), the increments summed again with the fused likelihood
    give the run's log Z to rel 1e-9, and with the plain path's likelihood
    at the same particles and betas within LOSS_RTOL x |log Z| (the loss
    gate of the kernels carried to the sum)."""
    import chip_smoke as C

    cfg = dict(chains=32, num_moves=1, target_ess=0.5, max_stages=200,
               svi_steps=0)
    mp, plain = _mp("torch", "phase", nb, True), _mp("torch", "phase", nb,
                                                      False)
    with C._StagesRecorded(TS) as rec:
        fm = C._smc_fit(mp, cfg)
        fm.run(0)
    assert len(rec.stages) == len(fm.temperature_schedule)
    z = fm.log_evidence
    again = C._log_z_along(torch, fm.smc.tempered, rec.stages)
    assert abs(again - z) <= 1e-9 * abs(z), (again, z)
    pmodel = C._smc_fit(plain, cfg).smc.model
    ptm = TS.init_tempered_model(pmodel, plain.data, seed=th.fold_in(0, 0))
    zp = C._log_z_along(torch, ptm, rec.stages)
    assert abs(zp - z) < C.LOSS_RTOL * abs(z), (zp, z)


# ---------------------------------------------------------------------------
# MinibatchSVI: Db cut per block
# ---------------------------------------------------------------------------

def _jax_draws(mp, key):
    tr = jh.trace(jh.seed(mp.guide_fn, key)).get_trace(mp.data)
    return {n: np.asarray(s["value"]) for n, s in tr.items()
            if s["type"] == "sample"}


@pytest.mark.parametrize("stage,nb,fused", CASES)
def test_block_objective_with_db_cut_per_block_matches_jax(stage, nb, fused):
    """At the JAX guide's draws (phi_xy cut per block), the mean of the
    port's NBLK scaled block losses, each block with its columns of Db,
    equals the JAX package's full-batch loss on its plain path."""
    jplain = _mp("jax", stage, nb, False)
    key = jax.random.PRNGKey(nb)
    vals = _jax_draws(jplain, key)
    jv = {k: jnp.asarray(x) for k, x in vals.items()}
    full = float(JTrace_ELBO().loss(
        key, jh.substitute(jplain.model_fn, data=jv),
        jh.substitute(jplain.guide_fn, data=jv), jplain.data))
    tmp = _mp("torch", stage, nb, fused)
    blocks = split_cells(tmp.data, NBLK)
    B = NC // NBLK
    for i, blk in enumerate(blocks):
        np.testing.assert_array_equal(blk.Db.numpy(),
                                      tmp.data.Db[:, i * B:(i + 1) * B].numpy())
    total = 0.0
    for i, blk in enumerate(blocks):
        v = {k: torch.as_tensor(x) for k, x in vals.items()}
        v["phi_xy"] = v["phi_xy"][i * B:(i + 1) * B]

        def scaled(fn):
            return th.scale(th.substitute(fn, data=v), scale_factor=float(NBLK),
                            site_filter=LOCAL_SITES.__contains__)

        total += float(Trace_ELBO().loss(0, scaled(tmp.model_fn),
                                         scaled(tmp.guide_fn), blk))
    got = total / NBLK
    assert abs(got - full) < 1e-5 * abs(full), (got, full)


def _host_arrays(data):
    out = {k: np.asarray(getattr(data, k)) for k in
           ("S", "count_factor", "phixy_prior", "Db")}
    if hasattr(data, "U"):
        out.update(U=np.asarray(data.U), D=np.asarray(data.D))
    return out


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("nb", NBS)
def test_host_blocks_and_template_with_db_match_jax(stage, nb):
    """`iter_host_blocks(..., Db=)` yields the JAX package's blocks (every
    cell-axis field, Db's columns, the block's lgamma_k_sum) and
    `init_template(..., Db=)` its full-Nc template, on the fused data."""
    tdata, jdata = (_mp("torch", stage, nb, True).data,
                    _mp("jax", stage, nb, True).data)
    a = _host_arrays(jdata)
    extra = {k: a[k] for k in ("U", "D") if k in a}
    ours = list(iter_host_blocks(a["S"], a["count_factor"], a["phixy_prior"],
                                 tdata, NBLK, Db=a["Db"], **extra))
    theirs = list(JMB.iter_host_blocks(a["S"], a["count_factor"],
                                       a["phixy_prior"], jdata, NBLK,
                                       Db=a["Db"], **extra))
    assert [i for i, _ in ours] == [i for i, _ in theirs] == list(range(NBLK))
    for (_, b), (_, jb) in zip(ours, theirs):
        assert b.Nc == jb.Nc == NC // NBLK and b.Nb == nb
        for f in ("S", "count_factor", "phixy_prior", "Db") + tuple(extra):
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(jb, f)),
                                          err_msg=f)
        # the port sums each block's lgamma(k + 1) in float64 (as both
        # packages' preprocessing sums the container's), exact to float32;
        # the JAX package's streamed blocks take jax.scipy's float32 gammaln
        lg = sum(float(np.sum(gammaln(np.asarray(getattr(b, f), np.float64)
                                      + 1.0)))
                 for f in ("S", "U") if f == "S" or f in extra)
        assert float(b.lgamma_k_sum) == float(np.float32(lg))
        assert abs(float(b.lgamma_k_sum) - float(jb.lgamma_k_sum)) < 1e-6 * lg
    tmpl = init_template(ours[0][1], NC, a["phixy_prior"],
                         count_factor=a["count_factor"], Db=a["Db"],
                         **({"D": a["D"]} if "D" in a else {}))
    jtmpl = JMB.init_template(theirs[0][1], NC, a["phixy_prior"],
                              count_factor=a["count_factor"], Db=a["Db"],
                              **({"D": a["D"]} if "D" in a else {}))
    assert tmpl.Nc == jtmpl.Nc == NC and tmpl.S.shape == (NG, NC)
    for f in ("count_factor", "phixy_prior", "Db"):
        np.testing.assert_array_equal(np.asarray(getattr(tmpl, f)),
                                      np.asarray(getattr(jtmpl, f)), err_msg=f)


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("fused", [False, True])
def test_streamed_fit_with_db_matches_resident(nb, fused):
    """`fit_streamed` from host blocks with Db cut per block, initialised
    from `init_template`, equals `fit(shuffle=False)` on the resident data
    over two epochs (losses and params rtol 1e-6)."""
    mp = _mp("torch", "phase", nb, fused)
    data = mp.data
    mb1 = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=NBLK)
    s1, l1 = mb1.fit(4, data, num_epochs=2, shuffle=False)
    a = _host_arrays(data)

    def factory():
        return iter_host_blocks(a["S"], a["count_factor"], a["phixy_prior"],
                                data, NBLK, logS=np.asarray(data.logS),
                                Db=a["Db"])

    first = next(iter(factory()))[1]
    assert isinstance(first.Db, np.ndarray) and first.Db.shape == (nb, NC // NBLK)
    tmpl = init_template(first, NC, a["phixy_prior"],
                         count_factor=a["count_factor"], Db=a["Db"])
    mb2 = MinibatchSVI(mp.model_fn, mp.guide_fn, num_blocks=NBLK)
    s2, l2 = mb2.fit_streamed(4, tmpl, factory, num_epochs=2)
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    p2 = mb2.get_params(s2)
    for name, p in mb1.get_params(s1).items():
        np.testing.assert_allclose(p.numpy(), p2[name].numpy(), rtol=1e-6,
                                   err_msg=name)
    assert np.abs(p2["delta_nu_locs"].numpy()).max() > 0.0


# ---------------------------------------------------------------------------
# the sharded step: two ranks over gloo, Db split by cells
# ---------------------------------------------------------------------------

def _f32(tree):
    if isinstance(tree, tuple):
        return tuple(np.asarray(x, np.float32) for x in tree)
    return np.asarray(tree, np.float32)


# (name, kind of _torch_parallel_ranks.MODELS, stage, nb, fused)
SHARD_CASES = [("phase", "phase", "phase", nb, fused) for nb in NBS
               for fused in (False, True)] + \
              [("lrmn", "lrmn", "velocity", nb, True) for nb in NBS]


def _shard_name(case):
    name, _, _, nb, fused = case
    return f"{name}-{nb}-{'fused' if fused else 'plain'}"


@pytest.fixture(scope="module")
def sharded():
    """{case: (port data, cond, JAX loss, JAX grads)} and the two ranks'
    results of every case's sharded ELBO at fixed params and its
    SHARD_STEPS-step trajectory."""
    from velocycle_tpu.models import phase as jphase
    from velocycle_tpu.models import velocity as jvel

    rng = np.random.default_rng(2)
    cases, tasks = {}, []
    for case in SHARD_CASES:
        key = _shard_name(case)
        _, kind, stage, nb, fused = case
        mt = "lrmn" if kind == "lrmn" else "fourier"
        jdata = _mp("jax", stage, nb, False, mt).data
        tdata = _mp("torch", stage, nb, fused, mt).data
        if kind == "phase":
            eps = {"nu": rng.normal(size=jdata.mu_nu.shape),
                   "phi_xy": rng.normal(size=jdata.phixy_prior.shape)}
            cond = None
            params, jl, jg = jax_elbo(jphase.phase_model, jphase.phase_guide,
                                       jdata, eps)
        else:
            cond = {"phi_xy": np.asarray(jdata.phixy_prior),
                    "nu": np.asarray(jdata.mu_nu),
                    "shape_inv": np.full((NG,), 0.3, np.float32)}
            eps = {"log_beta": rng.normal(size=NG),
                   "_lrmn_draw": (rng.normal(size=jdata.rho_rank),
                                  rng.normal(size=NG + jdata.Nx * jdata.Nhw))}
            params, jl, jg = jax_elbo(jvel.velocity_model,
                                       jvel.velocity_guide_lrmn, jdata, eps,
                                       cond)
            tdata = tdata.replace(disp_grad=False)
        eps = {k: _f32(v) for k, v in eps.items()}
        cases[key] = (kind, tdata, cond, jl, jg)
        tasks += [(f"elbo:{key}", "elbo_grads", (kind, tdata, params, eps,
                                                 cond)),
                  (f"traj:{key}", "trajectory", (kind, tdata, SHARD_STEPS,
                                                 cond))]
    return cases, spawn(2, tasks)


@pytest.mark.parametrize("case", SHARD_CASES, ids=_shard_name)
def test_sharded_elbo_and_grads_with_db_match_jax(sharded, case):
    """Each rank's loss (summed over the ranks' cells and their Db columns)
    and every gradient at fixed params against the JAX package's unsharded
    value_and_grad (its plain path)."""
    cases, ranks = sharded
    key = _shard_name(case)
    *_, jl, jg = cases[key]
    for r in ranks:
        tl, tg, _ = r[f"elbo:{key}"]
        assert abs(tl - jl) < SHARD_LOSS_RTOL * abs(jl), (tl, jl)
        assert sorted(tg) == sorted(jg) and "delta_nu_locs" in tg
        for k in jg:
            assert np.isfinite(tg[k]).all() and _rel(tg[k], jg[k]) < GRAD_RTOL, k


@pytest.mark.parametrize("case", SHARD_CASES, ids=_shard_name)
def test_sharded_trajectory_with_db_matches_svi_update(sharded, case):
    """SHARD_STEPS sharded steps over two ranks, each with its cells' Db
    columns, against `SVI.update` in one process from the same seed: the
    losses within rel 2e-6 (as the card's two ranks against one), the ranks'
    losses, replicated params and Adam moments the same bits."""
    from _torch_parallel_ranks import MODELS

    cases, ranks = sharded
    key = _shard_name(case)
    kind, tdata, cond = cases[key][:3]
    model, guide = MODELS[kind]
    if cond:
        model = th.condition(model, data={k: torch.as_tensor(v)
                                          for k, v in cond.items()})
        guide = th.block(guide, hide=list(cond))
    svi = SVI(model, guide, clipped_adam(), Trace_ELBO())
    state, losses = svi.update_chunk(svi.init(0, tdata), SHARD_STEPS, tdata)
    ref = losses.numpy()
    r0 = ranks[0][f"traj:{key}"]
    assert r0["losses"].shape == (SHARD_STEPS,) and np.isfinite(ref).all()
    rel = np.abs(r0["losses"] - ref) / np.abs(ref)
    assert rel.max() < SHARD_TRAJ_RTOL, rel.max()
    for r in ranks[1:]:
        t = r[f"traj:{key}"]
        np.testing.assert_array_equal(t["losses"], r0["losses"])
        assert (t["replicated"], t["moments"]) == (r0["replicated"],
                                                   r0["moments"])
