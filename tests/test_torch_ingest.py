"""The port's ingest against the JAX package: the native C++ library
(`velocycle_tpu_torch.native`, the port's own build of its own copy of
ingest.cpp), the .h5ad reader and writer, `normalize_total`, and
read-then-preprocess, on the same numpy inputs made from a seed.

Tolerances: the native functions and every preprocessed field are held
bit-equal (the same C++ and numpy arithmetic on the same inputs); the
fallbacks against scipy at float32 equality as well."""
import dataclasses

import numpy as np
import pandas as pd
import pytest
import scipy.io as sio
import scipy.sparse as sp
import torch

import velocycle_tpu as V
from velocycle_tpu import native as jnative
from velocycle_tpu.simulate import simulate_data as j_simulate
import velocycle_tpu_torch as T
from velocycle_tpu_torch import native
from velocycle_tpu_torch.anndata_lite import as_dense
from velocycle_tpu_torch.models.metapars import (
    PHASE_TENSOR_FIELDS, VELOCITY_TENSOR_FIELDS,
)

h5py = pytest.importorskip("h5py")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def csr():
    return sp.random(500, 200, density=0.07, format="csr", random_state=0,
                     dtype=np.float32)


# ---------------------------------------------------------------------------
# native ingest
# ---------------------------------------------------------------------------

def test_native_library_compiled_into_the_build_dir():
    """g++ builds the port's library at first use, under build/, named by a
    hash of its source, and never next to the source."""
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native.build_seconds() >= 0.0
    built = sorted(native.BUILD_DIR.glob("libvct_ingest_*.so"))
    assert built, native.BUILD_DIR
    assert not list(native.SRC.parent.glob("*.so"))
    assert not (native.SRC.parent / "_build").exists()


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("fmt", ["csr", "csc", "coo", "dense"])
def test_csr_to_dense_matches_scipy_and_jax(csr, fmt, transpose):
    m = np.asarray(csr.todense()) if fmt == "dense" else csr.asformat(fmt)
    out = native.csr_to_dense(m, transpose=transpose)
    want = np.asarray(csr.todense())
    assert out.dtype == np.float32 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, want.T if transpose else want)
    np.testing.assert_array_equal(out, jnative.csr_to_dense(m, transpose=transpose))


def test_size_factors_and_one_hot_match_jax(csr):
    dense = native.csr_to_dense(csr) + 0.5
    totals, cf = native.size_factors(dense)
    jt, jcf = jnative.size_factors(dense)
    np.testing.assert_array_equal(totals, jt)
    np.testing.assert_array_equal(cf, jcf)
    np.testing.assert_allclose(totals, dense.sum(1), rtol=1e-5)
    codes = np.random.default_rng(0).integers(0, 5, 400).astype(np.int32)
    oh = native.one_hot(codes, 5)
    np.testing.assert_array_equal(oh, jnative.one_hot(codes, 5))
    assert oh.dtype == np.int8 and (oh.argmax(1) == codes).all()


def test_read_mtx_matches_scipy_and_jax(tmp_path, csr):
    path = tmp_path / "counts.mtx"
    sio.mmwrite(str(path), csr.tocoo())
    back = native.read_mtx(str(path))
    assert back.shape == csr.shape
    np.testing.assert_array_equal(back.toarray(), csr.toarray())
    np.testing.assert_array_equal(back.toarray(), jnative.read_mtx(str(path)).toarray())


def test_fallbacks_match_the_native_library(csr, tmp_path, monkeypatch):
    """Without a C++ compiler every entry point computes the same values
    with numpy/scipy; the size factors' sums run in another order and
    precision (f64 natively, f32 pairwise in numpy), and scipy reads a
    .mtx in float64 where the library rounds to float32, so those agree to
    float32 rounding (rtol 1e-6, 2**-23) rather than bit for bit."""
    dense = native.csr_to_dense(csr) + 1.0
    codes = np.array([0, 2, 1, 2], np.int32)
    path = tmp_path / "m.mtx"
    sio.mmwrite(str(path), csr.tocoo())
    fast = (native.csr_to_dense(csr, transpose=True), native.size_factors(dense),
            native.one_hot(codes, 3), native.read_mtx(str(path)).toarray())
    monkeypatch.setitem(native._STATE, "lib", None)
    monkeypatch.setitem(native._STATE, "tried", True)
    assert not native.available()
    slow = (native.csr_to_dense(csr, transpose=True), native.size_factors(dense),
            native.one_hot(codes, 3), native.read_mtx(str(path)).toarray())
    np.testing.assert_array_equal(fast[0], slow[0])
    np.testing.assert_allclose(fast[1][0], slow[1][0], rtol=1e-6)
    np.testing.assert_allclose(fast[1][1], slow[1][1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(fast[2], slow[2])
    np.testing.assert_allclose(fast[3], slow[3], rtol=2.0 ** -23)


# ---------------------------------------------------------------------------
# .h5ad
# ---------------------------------------------------------------------------

def _simulated(pkg, Nc=40, Ng=12, seed=3):
    sim = T.simulate_data if pkg is T else j_simulate
    adata = sim(Nc=Nc, Ng=Ng, seed=seed)
    adata.layers["spliced"] = sp.csr_matrix(np.asarray(adata.layers["spliced"]))
    adata.obs["phase_class"] = pd.Categorical(
        np.where(np.arange(Nc) % 2 == 0, "S", "G2M"))
    adata.obs["label"] = np.where(np.arange(Nc) % 3 == 0, "a", "bb")
    adata.obs["flag"] = np.arange(Nc) % 2 == 0
    adata.uns["meta"] = {"note": "hello", "scale": 1.5,
                         "names": np.array(["x", "yy"])}
    return adata


def _assert_adata_equal(a, b):
    assert a.shape == b.shape
    assert list(a.obs.index) == list(b.obs.index)
    assert list(a.var.index) == list(b.var.index)
    assert list(a.obs.columns) == list(b.obs.columns)
    for col in a.obs.columns:
        assert list(a.obs[col]) == list(b.obs[col]), col
    assert sorted(a.layers) == sorted(b.layers)
    for k in a.layers:
        assert sp.issparse(a.layers[k]) == sp.issparse(b.layers[k]), k
        np.testing.assert_array_equal(as_dense(a.layers[k]), as_dense(b.layers[k]))
    np.testing.assert_array_equal(np.asarray(a.uns["simulated_nu"]),
                                  np.asarray(b.uns["simulated_nu"]))
    assert a.uns["meta"]["note"] == b.uns["meta"]["note"] == "hello"
    assert float(a.uns["meta"]["scale"]) == float(b.uns["meta"]["scale"]) == 1.5


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_h5ad_round_trips_and_cross_reads(tmp_path, writer, reader):
    """Files written by either package read back equal in the other."""
    W = T if writer == "port" else V
    R = T if reader == "port" else V
    adata = _simulated(W)
    if writer == "jax":     # the JAX writer stores no string arrays in uns
        adata.uns["meta"].pop("names")
    path = tmp_path / "sim.h5ad"
    W.write_h5ad(adata, str(path))
    back = R.read_h5ad(str(path))
    _assert_adata_equal(back, adata)
    assert back.obs["flag"].dtype == bool
    if writer == reader == "port":
        assert list(back.uns["meta"]["names"]) == ["x", "yy"]
    # the JAX reader's reading of the same file is the port's
    other = (V if R is T else T).read_h5ad(str(path))
    _assert_adata_equal(back, other)


def test_h5ad_writer_sets_the_encoding_attributes(tmp_path):
    adata = _simulated(T)
    path = tmp_path / "enc.h5ad"
    T.write_h5ad(adata, str(path))

    def enc(node):
        return (node.attrs["encoding-type"], node.attrs["encoding-version"])

    with h5py.File(path, "r") as f:
        assert enc(f) == ("anndata", "0.1.0")
        assert enc(f["layers"]) == ("dict", "0.1.0")
        assert enc(f["layers/spliced"]) == ("csr_matrix", "0.1.0")
        assert enc(f["layers/unspliced"]) == ("array", "0.2.0")
        assert enc(f["obs"]) == ("dataframe", "0.2.0")
        assert enc(f["obs/_index"]) == ("string-array", "0.2.0")
        assert enc(f["obs/phase_class"]) == ("categorical", "0.2.0")
        assert f["obs/phase_class"].attrs["ordered"] == np.False_
        assert enc(f["obs/phase_class/categories"]) == ("string-array", "0.2.0")
        assert enc(f["obs/label"]) == ("string-array", "0.2.0")
        assert enc(f["obs/flag"]) == ("array", "0.2.0")
        assert enc(f["uns"]) == ("dict", "0.1.0")
        assert enc(f["uns/meta"]) == ("dict", "0.1.0")
        assert enc(f["uns/meta/note"]) == ("string", "0.2.0")
        assert enc(f["uns/meta/scale"]) == ("numeric-scalar", "0.2.0")
        assert enc(f["uns/simulated_nu"]) == ("array", "0.2.0")
        for empty in ("obsm", "varm", "obsp", "varp"):
            assert enc(f[empty]) == ("dict", "0.1.0")
        assert h5py.check_string_dtype(f["obs/_index"].dtype).encoding == "utf-8"


def test_h5ad_nullable_columns_round_trip(tmp_path):
    adata = T.AnnDataLite(X=np.eye(4, 3, dtype=np.float32))
    adata.obs["n"] = pd.array([1, None, 3, 4], dtype="Int64")
    adata.obs["ok"] = pd.array([True, False, None, True], dtype="boolean")
    path = tmp_path / "nullable.h5ad"
    T.write_h5ad(adata, str(path))
    with h5py.File(path, "r") as f:
        assert f["obs/n"].attrs["encoding-type"] == "nullable-integer"
        assert f["obs/ok"].attrs["encoding-type"] == "nullable-boolean"
    for pkg in (T, V):
        back = pkg.read_h5ad(str(path))
        assert list(back.obs["n"]) == [1, None, 3, 4]
        assert list(back.obs["ok"]) == [True, False, None, True]
        np.testing.assert_array_equal(back.X, adata.X)


@pytest.mark.parametrize("vlen", [False, True])
def test_read_spec_file_csc_categorical_nullable(tmp_path, vlen):
    """A file written with raw h5py per the anndata spec: CSC X, an ordered
    categorical and a nullable-integer obs column, nested uns; strings fixed
    width (bytes) or variable-length UTF-8 as anndata writes them."""
    path = tmp_path / "spec.h5ad"
    X = sp.random(6, 4, density=0.5, random_state=0, format="csc")

    def strings(group, name, values):
        if vlen:
            group.create_dataset(name, data=np.asarray(values, dtype=object),
                                 dtype=h5py.string_dtype("utf-8"))
        else:
            group.create_dataset(name, data=np.asarray(values, dtype="S"))

    with h5py.File(path, "w") as f:
        g = f.create_group("X")
        g.attrs["encoding-type"] = "csc_matrix"
        g.attrs["encoding-version"] = "0.1.0"
        g.attrs["shape"] = np.array([6, 4], np.int64)
        g.create_dataset("data", data=X.data)
        g.create_dataset("indices", data=X.indices)
        g.create_dataset("indptr", data=X.indptr)
        obs = f.create_group("obs")
        obs.attrs["encoding-type"] = "dataframe"
        obs.attrs["_index"] = "cell_id"
        obs.attrs["column-order"] = np.asarray(["batch", "n_counts"], dtype=object)
        strings(obs, "cell_id", [f"c{i}" for i in range(6)])
        cat = obs.create_group("batch")
        cat.attrs["encoding-type"] = "categorical"
        cat.attrs["ordered"] = True
        strings(cat, "categories", ["a", "b"])
        cat.create_dataset("codes", data=np.array([0, 0, 1, 1, 0, 1], np.int8))
        nullable = obs.create_group("n_counts")
        nullable.attrs["encoding-type"] = "nullable-integer"
        nullable.create_dataset("values", data=np.arange(6))
        nullable.create_dataset("mask", data=np.array([0, 0, 0, 1, 0, 0], bool))
        var = f.create_group("var")
        var.attrs["_index"] = "_index"
        strings(var, "_index", [f"G{i}" for i in range(4)])
        uns = f.create_group("uns")
        uns.create_group("meta").create_dataset("note", data="hello")
        uns.create_dataset("scale", data=1.5)

    adata = T.read_h5ad(str(path))
    theirs = V.read_h5ad(str(path))
    assert adata.shape == (6, 4) and sp.issparse(adata.X)
    np.testing.assert_array_equal(as_dense(adata.X), X.toarray())
    np.testing.assert_array_equal(as_dense(adata.X), as_dense(theirs.X))
    assert list(adata.obs.index) == list(theirs.obs.index) == [f"c{i}" for i in range(6)]
    assert list(adata.var.index) == [f"G{i}" for i in range(4)]
    assert list(adata.obs["batch"]) == list(theirs.obs["batch"]) == ["a", "a", "b", "b", "a", "b"]
    assert adata.obs["batch"].cat.ordered
    assert adata.obs["n_counts"].iloc[3] is None
    assert adata.obs["n_counts"].iloc[2] == 2
    assert adata.uns["meta"]["note"] == "hello"
    assert float(adata.uns["scale"]) == 1.5


# ---------------------------------------------------------------------------
# normalize_total and read-then-preprocess
# ---------------------------------------------------------------------------

def _csr_layers(pkg, Nc, Ng, seed):
    adata = (T.simulate_data if pkg is T else j_simulate)(Nc=Nc, Ng=Ng, seed=seed)
    for k in ("spliced", "unspliced"):
        adata.layers[k] = sp.csr_matrix(np.asarray(adata.layers[k]))
    return adata


@pytest.mark.parametrize("layout", ["csr", "dense"])
def test_normalize_total_matches_jax(layout):
    ours, theirs = _csr_layers(T, 37, 11, 4), _csr_layers(V, 37, 11, 4)
    if layout == "dense":
        for a in (ours, theirs):
            for k in ("spliced", "unspliced"):
                a.layers[k] = a.layers[k].toarray()
    T.normalize_total(ours)
    V.normalize_total(theirs)
    for k in ("S_sz", "U_sz"):
        assert ours.layers[k].dtype == theirs.layers[k].dtype
        np.testing.assert_array_equal(ours.layers[k], theirs.layers[k])
    for k in ("n_scounts", "n_ucounts"):
        np.testing.assert_array_equal(ours.obs[k].values, theirs.obs[k].values)
    assert T.preprocessing.normalize_total is T.normalize_total


def _assert_fields_equal(ours, theirs, fields):
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


@pytest.mark.parametrize("use_fused_nb", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_read_then_preprocess_matches_jax(tmp_path, normalize, use_fused_nb):
    """The workflow entry: write CSR layers to .h5ad, read them back with
    each package, preprocess both stages; every PhaseData and VelocityData
    field is bit-equal to the JAX package's."""
    path = tmp_path / "wf.h5ad"
    T.write_h5ad(_csr_layers(T, 30, 10, 5), str(path))
    out = {}
    for pkg in (T, V):
        adata = pkg.read_h5ad(str(path))
        assert sp.issparse(adata.layers["spliced"])
        genes, cells = list(adata.var.index), list(adata.obs.index)
        cycle = pkg.Cycle.trivial_prior(genes, harmonics=1)
        phases = pkg.Phases.from_angles(adata.obs["simulated_phis"].values,
                                        cell_names=cells)
        speed = pkg.AngularSpeed.trivial_prior(["c0"], harmonics=1)
        kw = dict(n_harmonics=1, normalize=normalize, use_fused_nb=use_fused_nb)
        if pkg is T:
            kw["device"] = "cpu"
        mp = pkg.preprocess_for_phase_estimation(adata, cycle, phases,
                                                 with_delta_nu=False, **kw)
        vmp = pkg.preprocess_for_velocity_estimation(adata, cycle, phases, speed,
                                                     omega_n_harmonics=1, **kw)
        out[pkg] = (mp.data, vmp.data)
    _assert_fields_equal(out[T][0], out[V][0], PHASE_TENSOR_FIELDS)
    _assert_fields_equal(out[T][1], out[V][1], VELOCITY_TENSOR_FIELDS)
    sim = T.simulate_data(Nc=30, Ng=10, seed=5)
    if not normalize:
        np.testing.assert_array_equal(out[T][0].S.numpy(), sim.layers["spliced"].T)
