"""The port's prior builders, gene sets, container gauge operations, joint
alignment and circular helpers against the JAX package, on the same numpy
inputs made from a seed (CPU, ``device="cpu"``).

Tolerances, stated per test: angles from the PCA and LDA priors <= 1e-6 rad
(the JAX package calls sklearn, exact at these sizes; the port computes the
same components in float64 with torch / scipy); the grid MLE the same bin
per cell, but for cells whose two best JAX totals tie within float32
rounding of the sum over genes; container operations and CSV files
bit-equal (the same numpy arithmetic); the circular helpers and the Poisson
log-pmf to float32 rounding."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import velocycle_tpu as V
import velocycle_tpu.genes as jgenes
from velocycle_tpu.ops import circular as jcirc
from velocycle_tpu.ops.fourier import fourier_basis as j_fourier
from velocycle_tpu.ops.likelihoods import nb_logpmf as j_nb
from velocycle_tpu.ops.likelihoods import poisson_logpmf as j_poisson
from velocycle_tpu.simulate import simulate_data as j_simulate
import velocycle_tpu_torch as T
import velocycle_tpu_torch.genes as tgenes
from velocycle_tpu_torch.containers import phases as tphases
from velocycle_tpu_torch.ops import circular as tcirc
from velocycle_tpu_torch.ops.likelihoods import poisson_logpmf as t_poisson


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arc(a, b):
    """Largest circular distance between two angle arrays."""
    return float(np.abs(np.angle(np.exp(1j * (np.asarray(a) - np.asarray(b))))).max())


# ---------------------------------------------------------------------------
# gene sets
# ---------------------------------------------------------------------------

GENE_LISTS = ["SMALL_CYCLING_GENE_SET", "MEDIUM_CYCLING_GENE_SET",
              "LARGE_CYCLING_GENE_SET", "S_GENES_MOUSE", "G2M_GENES_MOUSE",
              "S_GENES_HUMAN", "G2M_GENES_HUMAN", "S_genes_mouse",
              "G2M_genes_mouse", "S_genes_human", "G2M_genes_human"]


@pytest.mark.parametrize("name", GENE_LISTS)
def test_gene_lists_equal_jax(name):
    ours, theirs = getattr(tgenes, name), getattr(jgenes, name)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert list(ours) == list(theirs)


@pytest.mark.parametrize("size,n", [("Small", 98), ("Medium", 218), ("Large", 1918)])
@pytest.mark.parametrize("species", ["Human", "Mouse"])
def test_get_cycling_gene_set_equals_jax(size, n, species):
    ours = tgenes.get_cycling_gene_set(size, species=species)
    assert list(ours) == list(jgenes.get_cycling_gene_set(size, species=species))
    assert len(ours) == len(set(ours)) == n
    assert T.genes.get_cycling_gene_set is tgenes.get_cycling_gene_set


@pytest.mark.parametrize("kw", [{"size": "Huge"}, {"species": "Fly"}])
def test_get_cycling_gene_set_refuses_unknown_names(kw):
    with pytest.raises(ValueError):
        tgenes.get_cycling_gene_set(**kw)


# ---------------------------------------------------------------------------
# PCA / LDA priors
# ---------------------------------------------------------------------------

def _normalized(Nc, Ng, seed):
    """The same simulated counts for both packages, normalize_total'ed by
    each (bit-equal layers, tests/test_torch_ingest.py)."""
    ours = T.simulate_data(Nc=Nc, Ng=Ng, seed=seed)
    theirs = j_simulate(Nc=Nc, Ng=Ng, seed=seed)
    T.normalize_total(ours)
    V.normalize_total(theirs)
    phi = np.asarray(ours.obs["simulated_phis"].values)
    for a in (ours, theirs):
        a.obs["phase"] = np.select([phi < 2.0, phi < 4.0], ["G1", "S"], "G2M")
    return ours, theirs


@pytest.mark.parametrize("Nc,Ng", [(300, 40), (2000, 120)])
@pytest.mark.parametrize("variant", ["default", "genes_to_use", "zero_at_gap",
                                     "raw_pcs", "csr_layer"])
def test_pca_heuristic_matches_jax(Nc, Ng, variant):
    """<= 1e-6 rad on every cell; sklearn is exact at these sizes (full SVD
    at 300 x 40, the covariance eigh at 2000 x 120), as the port is."""
    ours, theirs = _normalized(Nc, Ng, seed=3)
    kw = {"default": {}, "raw_pcs": {"normalize_pcs": False}, "csr_layer": {},
          "zero_at_gap": {"zero_at_min_density": True, "concentration": 2.5},
          "genes_to_use": {"genes_to_use": list(ours.var.index[::2])}}[variant]
    if variant == "csr_layer":
        for a in (ours, theirs):
            a.layers["S_sz"] = sp.csr_matrix(a.layers["S_sz"])
        kw["genes_to_use"] = list(ours.var.index[1::2])
    a = T.Phases.from_pca_heuristic(ours, device="cpu", **kw)
    b = V.Phases.from_pca_heuristic(theirs, **kw)
    assert _arc(a.phis, b.phis) <= 1e-6
    np.testing.assert_allclose(a.concentrations, b.concentrations, rtol=1e-12)
    assert a.cells == b.cells
    # sklearn's sign rule: the same components, not mirrored ones
    scale = np.abs(b.pcs).max()
    assert np.abs(a.pcs - b.pcs).max() <= 1e-9 * scale
    np.testing.assert_allclose(a.pca.components_, b.pca.components_, atol=1e-9)
    np.testing.assert_allclose(a.pca.explained_variance_,
                               b.pca.explained_variance_, rtol=1e-9)
    np.testing.assert_allclose(a.pca.mean_, b.pca.mean_, rtol=1e-12)


def test_pca_scores_flip_to_a_positive_leading_loading():
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(60, 7)) * np.arange(1, 8), dtype=torch.float64)
    for sign in (1.0, -1.0):
        scores, fit = tphases.pca_scores(sign * X, 3)
        lead = np.abs(fit.components_).argmax(1)
        assert (fit.components_[np.arange(3), lead] > 0).all()
        assert np.all(np.diff(fit.explained_variance_) <= 0)
    np.testing.assert_allclose(scores.numpy(),
                               (-X - (-X).mean(0)).numpy() @ fit.components_.T)


@pytest.mark.parametrize("Nc,Ng", [(300, 60), (900, 30)])
@pytest.mark.parametrize("normalize", [True, False])
def test_lda_heuristic_matches_jax(Nc, Ng, normalize):
    """<= 1e-6 rad: the same sklearn SVD steps in the same order."""
    ours, theirs = _normalized(Nc, Ng, seed=11)
    a = T.Phases.from_lda_heuristic(ours, labels="phase", normalize=normalize)
    b = V.Phases.from_lda_heuristic(theirs, labels="phase", normalize=normalize)
    assert _arc(a.phis, b.phis) <= 1e-6
    np.testing.assert_allclose(a.pcs, b.pcs, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(a.pca, b.pca.scalings_, rtol=1e-9, atol=1e-12)


def test_lda_heuristic_refuses_two_classes():
    ours, _ = _normalized(100, 12, seed=1)
    labels = np.where(np.arange(100) % 2 == 0, "G1", "S")
    with pytest.raises(ValueError, match=">= 3 label classes"):
        T.Phases.from_lda_heuristic(ours, labels=labels)


def test_prior_builders_need_the_layer():
    adata = T.simulate_data(Nc=20, Ng=5, seed=0)
    with pytest.raises(ValueError, match="S_sz"):
        T.Phases.from_pca_heuristic(adata, device="cpu")
    with pytest.raises(ValueError, match="S_sz"):
        T.Phases.from_lda_heuristic(adata, labels=np.arange(20) % 3)


def test_flat_prior_matches_jax():
    ours, theirs = _normalized(25, 6, seed=2)
    a, b = T.Phases.flat_prior(ours), V.Phases.flat_prior(theirs)
    assert a.phi_xy.equals(b.phi_xy)


# ---------------------------------------------------------------------------
# grid MLE
# ---------------------------------------------------------------------------

def _jax_totals(cycle, adata, noisemodel, bins=100):
    """The (bins, Nc) totals the JAX package's from_cycle_mle takes the
    argmax of, formed the same way."""
    grid = jnp.arange(bins, dtype=jnp.float32) / bins * 2 * jnp.pi
    elog_grid = j_fourier(grid, cycle.harmonics) @ jnp.asarray(cycle.means_tensor)
    lc = jnp.log(jnp.asarray(adata.obs["n_scounts"].values, jnp.float32))
    k = jnp.asarray(np.asarray(adata.layers["spliced"], np.float32))[None]
    elog = elog_grid[:, None, :] + lc[None, :, None]
    lp = j_poisson(k, elog) if noisemodel == "Poisson" else j_nb(k, elog, 0.3)
    return np.asarray(lp.sum(-1))


@pytest.mark.parametrize("noisemodel", ["Poisson", "NegativeBinomial"])
def test_cycle_mle_matches_jax_bin_per_cell(noisemodel, monkeypatch):
    """The same bin for every cell; a cell whose two best JAX totals tie
    within float32 rounding of the sum over genes (2e-6 relative, about 16
    ulp of the total) may take either.  Chunked cells give the one-chunk
    result bit for bit."""
    ours, theirs = _normalized(300, 40, seed=5)
    nu = np.asarray(ours.uns["simulated_nu"]).T
    bins = 100
    res = {}
    for pkg, adata in ((T, ours), (V, theirs)):
        cycle = pkg.Cycle.from_array(nu, np.full(nu.shape, 0.3), list(adata.var.index))
        ph = pkg.Phases.flat_prior(adata)
        kw = {"device": "cpu"} if pkg is T else {}
        ph.from_cycle_mle(cycle, adata, noisemodel=noisemodel, bins=bins, **kw)
        res[pkg] = ph
    step = 2 * np.pi / bins
    b_ours = np.round(res[T].phis / step).astype(int) % bins
    b_theirs = np.round(res[V].phis / step).astype(int) % bins
    totals = _jax_totals(cycle, theirs, noisemodel, bins)
    differ = np.where(b_ours != b_theirs)[0]
    for c in differ:
        t_j, t_o = totals[b_theirs[c], c], totals[b_ours[c], c]
        assert abs(t_j - t_o) <= 2e-6 * abs(t_j), (c, t_j, t_o)
    assert len(differ) <= 2, differ
    same = b_ours == b_theirs
    np.testing.assert_array_equal(res[T].phi_xy.values[:, same],
                                  res[V].phi_xy.values[:, same])
    assert res[T].phi_xy.values.dtype == res[V].phi_xy.values.dtype
    # the chunk walk changes nothing
    monkeypatch.setattr(tphases, "MLE_CHUNK_BYTES", bins * 40 * 4 * 7)
    cycle = T.Cycle.from_array(nu, np.full(nu.shape, 0.3), list(ours.var.index))
    chunked = T.Phases.flat_prior(ours)
    chunked.from_cycle_mle(cycle, ours, noisemodel=noisemodel, bins=bins, device="cpu")
    np.testing.assert_array_equal(chunked.phi_xy.values, res[T].phi_xy.values)


def test_cycle_mle_refuses_other_noise_models():
    ours, _ = _normalized(20, 5, seed=0)
    cycle = T.Cycle.trivial_prior(list(ours.var.index), harmonics=1)
    with pytest.raises(NotImplementedError):
        T.Phases.flat_prior(ours).from_cycle_mle(cycle, ours, noisemodel="Lognormal",
                                                 device="cpu")


# ---------------------------------------------------------------------------
# container operations, joint alignment, CSV files
# ---------------------------------------------------------------------------

def _pair(pkg, Ng=12, Nc=50, H=2, seed=0):
    rng = np.random.default_rng(seed)
    genes = [f"g{i}" for i in range(Ng)]
    cycle = pkg.Cycle.from_array(rng.normal(0, 0.7, (2 * H + 1, Ng)),
                                 np.full((2 * H + 1, Ng), 0.3), genes)
    phases = pkg.Phases.from_angles(rng.uniform(0, 2 * np.pi, Nc),
                                    cell_names=[f"c{i}" for i in range(Nc)])
    return cycle, phases


def _assert_pair_equal(a, b):
    np.testing.assert_array_equal(a[0].means.values, b[0].means.values)
    np.testing.assert_array_equal(a[0].stds.values, b[0].stds.values)
    assert list(a[0].means.index) == list(b[0].means.index)
    np.testing.assert_array_equal(a[1].phi_xy.values, b[1].phi_xy.values)


@pytest.mark.parametrize("op", [
    ("shift_zero", {"gene": "g3"}), ("shift_zero", {"phase": 1.234}),
    ("invert_direction", {}),
])
@pytest.mark.parametrize("H", [1, 2, 3])
def test_cycle_and_phases_operations_match_jax(op, H):
    name, kw = op
    ours, theirs = _pair(T, H=H, seed=H), _pair(V, H=H, seed=H)
    for pkg_pair in (ours, theirs):
        getattr(pkg_pair[0], name)(**kw)
        if name == "shift_zero":
            pkg_pair[1].shift_zero(phase=kw.get("phase", 0.7))
        else:
            pkg_pair[1].invert_direction()
    _assert_pair_equal(ours, theirs)
    for attr in ("peak_phases", "amplitudes"):
        np.testing.assert_array_equal(getattr(ours[0], attr)(), getattr(theirs[0], attr)())
    assert (ours[0].check_orientation(("g1", "g5"))
            == theirs[0].check_orientation(("g1", "g5")))
    ours[1].rotate(angle=-0.4)
    theirs[1].rotate(angle=-0.4)
    _assert_pair_equal(ours, theirs)
    counts = np.random.default_rng(7).poisson(30, 50)
    a, b = ours[1].max_corr(counts), theirs[1].max_corr(counts)
    assert a[0] == b[0] and a[1] == b[1] and a[2] == b[2]


def test_gauge_operations_refuse_missing_arguments():
    cycle, phases = _pair(T)
    with pytest.raises(KeyError):
        cycle.shift_zero(gene="nope")
    with pytest.raises(ValueError):
        cycle.shift_zero()
    with pytest.raises(ValueError):
        phases.shift_zero()
    with pytest.raises(ValueError):
        phases.rotate()
    with pytest.raises(KeyError):
        cycle.check_orientation(("TOP2A", "E2F1"))
    with pytest.raises(ValueError):
        T.shift_zero(cycle, phases)


@pytest.mark.parametrize("extra,means,stds", [(1, None, None), (2, 0.5, 2.0)])
def test_add_and_remove_harmonics_match_jax(extra, means, stds):
    ours, theirs = _pair(T, H=1)[0], _pair(V, H=1)[0]
    for c in (ours, theirs):
        c.add_harmonics(extra, means=means, stds=stds)
    assert ours.harmonics == theirs.harmonics == 1 + extra
    _assert_pair_equal((ours, T.Phases.from_angles([0.0])),
                       (theirs, V.Phases.from_angles([0.0])))
    for c in (ours, theirs):
        c.remove_harmonics(2 * extra)
    assert ours.harmonics == 1
    np.testing.assert_array_equal(ours.means_array, theirs.means_array)
    np.testing.assert_array_equal(ours.stds_array, theirs.stds_array)


def _elogs(cycle, phases):
    zeta = j_fourier(np.asarray(phases.phis, np.float32), cycle.harmonics)
    return cycle.means_array @ np.asarray(zeta).T


@pytest.mark.parametrize("how", ["phase", "gene", "invert", "invert_twice"])
def test_joint_alignment_keeps_elogs_and_matches_jax(how):
    """Mirrors tests/test_alignment.py: ElogS(phi_c) unchanged (atol 1e-4,
    as there), and the pair transformed exactly as the JAX package does."""
    ours, theirs = _pair(T, seed=2), _pair(V, seed=2)
    before = _elogs(*ours)
    for pkg, (cycle, phases) in ((T, ours), (V, theirs)):
        if how == "phase":
            pkg.shift_zero(cycle, phases, phase=1.234)
        elif how == "gene":
            pkg.shift_zero(cycle, phases, gene="g3")
        else:
            for _ in range(1 if how == "invert" else 2):
                pkg.invert_direction(cycle, phases)
    _assert_pair_equal(ours, theirs)
    if how != "gene":
        np.testing.assert_allclose(_elogs(*ours), before, atol=1e-4)
    if how == "invert_twice":
        np.testing.assert_array_equal(ours[1].phi_xy.values, _pair(T, seed=2)[1].phi_xy.values)
    if how == "gene":
        c1, s1 = ours[0].means["g3"].iloc[1:3].values
        assert abs(np.arctan2(s1, c1)) < 1e-5
    assert T.preprocessing.invert_direction is T.invert_direction
    assert T.preprocessing.shift_zero is T.shift_zero


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["cycle", "phases", "speed"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_csv_files_cross_load(kind, writer, dtype, tmp_path):
    """A Cycle / Phases / AngularSpeed saved by either package loads in the
    other with the values the saving package's own load gives, bit for bit;
    both packages write the same bytes.  Against the saved values: exact in
    float32 (what a fit stores), and to rtol 1e-14 in float64, where
    pandas' default (not round-trip) CSV parser may move the last bits."""
    def make(pkg):
        rng = np.random.default_rng(3)
        if kind == "cycle":
            return pkg.Cycle.from_array(rng.normal(size=(5, 9)).astype(dtype),
                                        np.abs(rng.normal(size=(5, 9))).astype(dtype),
                                        [f"g{i}" for i in range(9)])
        if kind == "phases":
            return pkg.Phases.from_array(rng.normal(size=(2, 13)).astype(dtype),
                                         [f"c{i}" for i in range(13)])
        return pkg.AngularSpeed.from_array(rng.normal(size=(3, 2)).astype(dtype),
                                           np.abs(rng.normal(size=(3, 2))).astype(dtype),
                                           condition_names=["x", "y"])

    W, R = (T, V) if writer == "port" else (V, T)
    obj = make(W)
    obj.save(tmp_path / "w.csv")
    make(R).save(tmp_path / "r.csv")
    assert (tmp_path / "w.csv").read_bytes() == (tmp_path / "r.csv").read_bytes()
    cls = {"cycle": "Cycle", "phases": "Phases", "speed": "AngularSpeed"}[kind]
    back = getattr(R, cls).load(tmp_path / "w.csv")
    own = getattr(W, cls).load(tmp_path / "w.csv")
    parts = ("phi_xy",) if kind == "phases" else ("means", "stds")
    for part in parts:
        got, want = getattr(back, part), getattr(obj, part)
        np.testing.assert_array_equal(got.values, getattr(own, part).values)
        assert list(got.columns) == list(want.columns)
        if dtype is np.float32:
            np.testing.assert_array_equal(got.values.astype(dtype), want.values)
        else:
            np.testing.assert_allclose(got.values, want.values, rtol=1e-14)


# ---------------------------------------------------------------------------
# circular helpers and the Poisson log-pmf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,args", [
    ("unpack_direction", (1.7,)), ("wrap_angle", ()),
    ("circular_std_from_concentration", ()), ("circular_mean", ()),
    ("circular_distance", ("b",)), ("circular_corrcoef", ("b",)),
    ("pack_direction", ("xy",)),
])
def test_circular_helpers_match_jax(fn, args):
    """float32 inputs; agreement to float32 rounding (atol 2e-6 on values
    of order 1-10)."""
    rng = np.random.default_rng(9)
    a = rng.uniform(-9, 9, 64).astype(np.float32)
    b = rng.uniform(-9, 9, 64).astype(np.float32)
    if fn == "circular_std_from_concentration":
        a = np.abs(a)
    call = {"b": b, "xy": None}
    if fn == "pack_direction":
        x = np.stack([a, b], -1)
        ours, theirs = tcirc.pack_direction(torch.as_tensor(x)), jcirc.pack_direction(x)
    else:
        extra = [call.get(v, v) for v in args]
        ours = getattr(tcirc, fn)(torch.as_tensor(a), *[
            torch.as_tensor(e) if isinstance(e, np.ndarray) else e for e in extra])
        theirs = getattr(jcirc, fn)(jnp.asarray(a), *extra)
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), atol=2e-6)
    if fn == "circular_mean":
        x = np.stack([a, b])
        np.testing.assert_allclose(tcirc.circular_mean(torch.as_tensor(x), axis=1).numpy(),
                                   np.asarray(jcirc.circular_mean(x, axis=1)), atol=2e-6)


def test_poisson_logpmf_matches_jax():
    """float32, rtol 1e-6."""
    rng = np.random.default_rng(4)
    k = rng.poisson(4.0, (7, 30)).astype(np.float32)
    elog = rng.normal(1.0, 0.7, (7, 30)).astype(np.float32)
    ours = t_poisson(torch.as_tensor(k), torch.as_tensor(elog)).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_poisson(k, elog)), rtol=1e-6, atol=1e-5)
