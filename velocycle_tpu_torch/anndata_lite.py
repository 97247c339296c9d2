"""Minimal AnnData-compatible container and its .h5ad reader and writer.

Port of `velocycle_tpu/anndata_lite.py`.  `AnnDataLite` is the surface
preprocessing touches (`.layers`, `.obs`, `.var`, `.shape`, row and column
subsetting); a real AnnData object duck-types wherever one is available.

`read_h5ad` / `write_h5ad` cover the on-disk format the reference datasets
ship in, with h5py only (imported inside the functions): X and layers
(dense, CSR or CSC), obs/var dataframes (string, numeric, bool,
categorical and nullable columns, ``column-order``) and nested uns.  Unlike
the JAX package's writer, this one marks every element with anndata's
``encoding-type`` / ``encoding-version`` attributes (``array``,
``string-array``, ``string``, ``numeric-scalar``, ``dict``, ...), so anndata
itself can read what it writes; files written by either package read back
equal in the other.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import scipy.sparse as sp

__all__ = ["AnnDataLite", "as_dense", "read_h5ad", "write_h5ad"]


def as_dense(x):
    """Dense numpy view of a layer that may be scipy-sparse."""
    if sp.issparse(x):
        return np.asarray(x.todense())
    return np.asarray(x)


def _is_full(idx):
    return isinstance(idx, slice) and idx == slice(None)


class AnnDataLite:
    """cells x genes data matrix with obs/var annotations and layers."""

    def __init__(self, X=None, obs=None, var=None, layers=None, uns=None):
        if X is not None:
            X = X if sp.issparse(X) else np.asarray(X)
        self.X = X
        n_obs = n_var = None
        if X is not None:
            n_obs, n_var = X.shape
        if obs is None:
            obs = pd.DataFrame(index=pd.RangeIndex(n_obs or 0).astype(str))
        if var is None:
            var = pd.DataFrame(index=pd.RangeIndex(n_var or 0).astype(str))
        self.obs = obs if isinstance(obs, pd.DataFrame) else pd.DataFrame(obs)
        self.var = var if isinstance(var, pd.DataFrame) else pd.DataFrame(var)
        self.layers = dict(layers or {})
        self.uns = dict(uns or {})

    @property
    def shape(self):
        return (self.obs.shape[0], self.var.shape[0])

    @property
    def n_obs(self):
        return self.shape[0]

    @property
    def n_vars(self):
        return self.shape[1]

    def copy(self):
        return AnnDataLite(
            X=None if self.X is None else (
                self.X.copy() if sp.issparse(self.X) else np.array(self.X)
            ),
            obs=self.obs.copy(),
            var=self.var.copy(),
            layers={k: (v.copy() if sp.issparse(v) else np.array(v))
                    for k, v in self.layers.items()},
            uns=dict(self.uns),
        )

    def _indexer(self, key, index):
        if isinstance(key, (list, np.ndarray, pd.Index)):
            arr = np.asarray(key)
            if arr.dtype.kind in "UO":   # names
                idx = index.get_indexer(arr)
                if (idx < 0).any():
                    raise KeyError(f"names not found: {arr[idx < 0][:5]}")
                return idx
            return arr
        return key

    def __getitem__(self, key):
        """Supports adata[:, genes] and adata[cells, :]."""
        okey, vkey = key if isinstance(key, tuple) else (key, slice(None))
        oidx = self._indexer(okey, self.obs.index)
        vidx = self._indexer(vkey, self.var.index)

        def _sub(m):
            if m is None:
                return None
            m2 = m if _is_full(oidx) else m[oidx]
            if _is_full(vidx):
                return m2
            return m2[:, vidx]     # CSR stays CSR: scipy indexes its columns

        return AnnDataLite(
            X=_sub(self.X),
            obs=self.obs if _is_full(oidx) else self.obs.iloc[oidx],
            var=self.var if _is_full(vidx) else self.var.iloc[vidx],
            layers={k: _sub(v) for k, v in self.layers.items()},
            uns=dict(self.uns),
        )

    def __repr__(self):
        return (
            f"AnnDataLite(n_obs={self.n_obs}, n_vars={self.n_vars}, "
            f"layers={list(self.layers)})"
        )


# ---------------------------------------------------------------------------
# .h5ad IO (anndata 0.8+ element encodings, h5py only)
# ---------------------------------------------------------------------------

def _attr_str(node, key, default=""):
    v = node.attrs.get(key, default)
    return v.decode() if isinstance(v, bytes) else v


def _decode(x):
    """bytes -> str, recursively for arrays."""
    if isinstance(x, bytes):
        return x.decode()
    if isinstance(x, np.ndarray) and x.dtype.kind in ("S", "O"):
        return np.array([v.decode() if isinstance(v, bytes) else v
                         for v in x.ravel()]).reshape(x.shape)
    return x


def _read_matrix(node):
    """Dense dataset, or a csr/csc group {data, indices, indptr} + shape
    (CSC comes back as CSR)."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return np.asarray(node)
    enc = _attr_str(node, "encoding-type")
    shape = tuple(int(s) for s in node.attrs["shape"])
    parts = (np.asarray(node["data"]), np.asarray(node["indices"]),
             np.asarray(node["indptr"]))
    if enc.startswith("csc") or (not enc and len(parts[2]) == shape[1] + 1):
        return sp.csc_matrix(parts, shape=shape).tocsr()
    return sp.csr_matrix(parts, shape=shape)


def _read_series(node):
    """One obs/var column: a dataset, or a categorical / nullable group."""
    import h5py

    if isinstance(node, h5py.Dataset):
        return _decode(np.asarray(node))
    if "categories" in node:
        cats = _decode(np.asarray(node["categories"]))
        codes = np.asarray(node["codes"])
        return pd.Categorical.from_codes(
            codes, categories=cats, ordered=bool(node.attrs.get("ordered", False))
        )
    if "values" in node:                         # nullable int / bool
        values = np.asarray(node["values"])
        if "mask" in node:
            mask = np.asarray(node["mask"], bool)
            out = values.astype(object)
            out[mask] = None
            return out
        return values
    raise ValueError(
        f"unsupported column encoding {_attr_str(node, 'encoding-type')!r}"
    )


def _read_dataframe(group):
    """An obs/var group; its ``_index`` attribute names the index column."""
    idx_col = _attr_str(group, "_index", "_index")
    order = group.attrs.get("column-order", None)
    if order is not None:
        order = [c.decode() if isinstance(c, bytes) else c for c in order]
    else:
        order = [k for k in group.keys() if k != idx_col]
    df = pd.DataFrame(index=pd.Index(_decode(np.asarray(group[idx_col]))))
    for col in order:
        if col in group:
            df[col] = _read_series(group[col])
    return df


def _read_uns(group):
    import h5py

    return {k: (_decode(v[()]) if isinstance(v, h5py.Dataset) else _read_uns(v))
            for k, v in group.items()}


def read_h5ad(path):
    """Load an `.h5ad` file into an `AnnDataLite`.

    Reads `X` and `layers/*` as dense arrays or CSR/CSC groups (CSC comes
    back as CSR), `obs`/`var` with string (fixed or variable-length UTF-8),
    numeric, boolean, categorical (``ordered`` kept) and nullable columns in
    ``column-order``, and `uns` scalars and arrays, nested dicts kept.
    `obsm`/`varm`/`obsp` are not read: nothing downstream reads them.
    """
    import h5py

    with h5py.File(path, "r") as f:
        X = _read_matrix(f["X"]) if "X" in f else None
        layers = {name: _read_matrix(node)
                  for name, node in f["layers"].items()} if "layers" in f else {}
        obs = _read_dataframe(f["obs"]) if "obs" in f else None
        var = _read_dataframe(f["var"]) if "var" in f else None
        uns = _read_uns(f["uns"]) if "uns" in f else {}
    return AnnDataLite(X=X, obs=obs, var=var, layers=layers, uns=uns)


def _encode(node, kind, version):
    node.attrs["encoding-type"] = kind
    node.attrs["encoding-version"] = version
    return node


def _write_strings(parent, name, values):
    import h5py

    ds = parent.create_dataset(name, data=np.asarray(values, dtype=object),
                               dtype=h5py.string_dtype())
    return _encode(ds, "string-array", "0.2.0")


def _write_array(parent, name, value):
    """A dense array, a string array, a string or a numeric scalar."""
    if isinstance(value, str):
        return _encode(parent.create_dataset(name, data=value), "string", "0.2.0")
    arr = np.asarray(value)
    if arr.dtype.kind in ("U", "S", "O"):
        return _write_strings(parent, name, arr.astype(str))
    ds = parent.create_dataset(name, data=arr)
    if arr.ndim == 0:
        return _encode(ds, "numeric-scalar", "0.2.0")
    return _encode(ds, "array", "0.2.0")


def _write_matrix(parent, name, m):
    if not sp.issparse(m):
        return _write_array(parent, name, m)
    m = m.tocsr()
    g = _encode(parent.create_group(name), "csr_matrix", "0.1.0")
    g.attrs["shape"] = np.asarray(m.shape, np.int64)
    g.create_dataset("data", data=m.data)
    g.create_dataset("indices", data=m.indices)
    g.create_dataset("indptr", data=m.indptr)
    return g


def _write_dataframe(parent, name, df):
    import h5py

    g = _encode(parent.create_group(name), "dataframe", "0.2.0")
    g.attrs["_index"] = "_index"
    g.attrs.create("column-order", np.asarray(list(df.columns), dtype=object),
                   dtype=h5py.string_dtype())
    _write_strings(g, "_index", df.index.astype(str))
    for col in df.columns:
        s = df[col]
        if isinstance(s.dtype, pd.CategoricalDtype):
            cg = _encode(g.create_group(col), "categorical", "0.2.0")
            cg.attrs["ordered"] = bool(s.cat.ordered)
            _write_strings(cg, "categories", s.cat.categories.astype(str))
            _write_array(cg, "codes", np.asarray(s.cat.codes, np.int32))
        elif pd.api.types.is_extension_array_dtype(s.dtype) and s.dtype.kind in "iub":
            kind = "nullable-boolean" if s.dtype.kind == "b" else "nullable-integer"
            ng = _encode(g.create_group(col), kind, "0.1.0")
            mask = np.asarray(s.isna())
            fill = False if s.dtype.kind == "b" else 0
            _write_array(ng, "values", s.fillna(fill).to_numpy(s.dtype.numpy_dtype))
            _write_array(ng, "mask", mask)
        elif s.dtype.kind in ("U", "O") or isinstance(s.dtype, pd.StringDtype):
            _write_strings(g, col, s.astype(str))
        else:
            _write_array(g, col, np.asarray(s))


def _write_dict(group, d):
    _encode(group, "dict", "0.1.0")
    for k, v in d.items():
        if isinstance(v, dict):
            _write_dict(group.create_group(k), v)
        else:
            _write_array(group, k, v)


def write_h5ad(adata, path):
    """Write an AnnData(-Lite) to `.h5ad`: dense or CSR X and layers,
    obs/var dataframes, nested uns; every element carries anndata's
    encoding attributes.  Round-trips through `read_h5ad`."""
    import h5py

    with h5py.File(path, "w") as f:
        _encode(f, "anndata", "0.1.0")
        if adata.X is not None:
            _write_matrix(f, "X", adata.X)
        layers = _encode(f.create_group("layers"), "dict", "0.1.0")
        for name, m in adata.layers.items():
            _write_matrix(layers, name, m)
        _write_dataframe(f, "obs", adata.obs)
        _write_dataframe(f, "var", adata.var)
        for empty in ("obsm", "varm", "obsp", "varp"):
            _encode(f.create_group(empty), "dict", "0.1.0")
        _write_dict(f.create_group("uns"), adata.uns)
