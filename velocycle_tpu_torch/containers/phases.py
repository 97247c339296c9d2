"""Phases: per-cell position on the cell-cycle circle, with uncertainty.

Capability parity with reference `velocycle/phases.py:103-509`.  The
phase of cell ``c`` is stored as a 2-vector ``phi_xy`` (rows ``phi_x``,
``phi_y``; columns cells): its angle is the phase, its norm the
concentration of the projected-Normal prior/posterior.  Circular std uses
exact `scipy.special` Bessel ratios instead of the reference's
Abramowitz-Stegun polynomial tables (`phases.py:17-100`).

Port of `velocycle_tpu/containers/phases.py`, sklearn-free:

  * `from_pca_heuristic` runs on ``device`` in float64: the exact top
    components from the covariance's `eigh` (the covariance on ``device``,
    its small eigendecomposition on the host), with sklearn's sign rule
    (the largest-magnitude loading of each component positive).  sklearn, which
    the JAX package calls, switches to a randomized solver for large
    inputs; the port is exact at every size.
  * `from_lda_heuristic` is sklearn's ``LinearDiscriminantAnalysis``
    ``solver="svd"`` path, written out on the host with the same
    `scipy.linalg.svd` calls, so the axes' signs agree.
  * `from_cycle_mle` evaluates the grid likelihood on ``device`` in float32,
    walking the cells in chunks so the (bins, cells, genes) temporary stays
    near `MLE_CHUNK_BYTES`.

The percentile normalisation and the angles are numpy on the host, as in
the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pandas as pd
import scipy.special as ssp

from ..anndata_lite import as_dense
from ..device import resolve_device

__all__ = ["Phases", "PCAFit", "MLE_CHUNK_BYTES"]

# the bound on from_cycle_mle's (bins, cells, genes) float32 temporary
MLE_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass
class PCAFit:
    """What `Phases.from_pca_heuristic` stores in ``Phases.pca``: the
    attributes of sklearn's PCA that describe the fit, as numpy arrays."""
    components_: np.ndarray          # (n_components, genes)
    explained_variance_: np.ndarray  # (n_components,)
    mean_: np.ndarray                # (genes,)


def _layer_matrix(adata, layer, genes_to_use):
    """Dense (cells, genes) host array of ``layer``, restricted to the genes
    of ``genes_to_use`` in the AnnData's own gene order."""
    if layer not in adata.layers:
        raise ValueError(f"layer={layer!r} not in adata.layers")
    mat = adata.layers[layer]
    if genes_to_use is not None:
        keep = set(genes_to_use)
        mat = mat[:, np.where([g in keep for g in adata.var.index])[0]]
    return as_dense(mat)


def _percentile_normalize(x):
    pcts = np.percentile(x, [0.5, 99.5, 50], 0)
    return (x - pcts[2, :]) / (pcts[1, :] - pcts[0, :])


def _unit_phases(angle, concentration, cells):
    return Phases(pd.DataFrame(
        np.stack([np.cos(angle), np.sin(angle)]) * concentration,
        index=["phi_x", "phi_y"], columns=cells,
    ))


def pca_scores(X, n_components):
    """(scores (Nc, k), PCAFit) of a (cells, features) float64 tensor: the
    top ``n_components`` eigenvectors of the covariance, each flipped so its
    largest-magnitude loading is positive (sklearn's ``svd_flip`` with
    ``u_based_decision=False``).

    The centring, the covariance and the scores run on X's device; the
    small (features, features) eigendecomposition runs on the host
    (LAPACK), so the card's and the CPU's priors share it.  The angles are
    sensitive to the components: where the leading eigenvalues lie close,
    as for counts with no cycle in them, they move by far more than the
    relative error of the covariance."""
    import torch

    n = X.shape[0]
    mean = X.mean(0)
    Xc = X - mean
    cov = (Xc.T @ Xc / (n - 1)).cpu()
    evals, evecs = torch.linalg.eigh(cov)
    comps = evecs.flip(1)[:, :n_components].T.contiguous()     # (k, F)
    lead = comps.abs().argmax(1)
    comps = comps * torch.sign(comps.gather(1, lead[:, None]))
    scores = Xc @ comps.to(X.device).T
    fit = PCAFit(comps.numpy(),
                 evals.flip(0)[:n_components].clamp(min=0.0).numpy(),
                 mean.cpu().numpy())
    return scores, fit


def lda_scores(X, labels, tol=1.0e-4):
    """(scores (Nc, min(classes - 1, features)), scalings) of sklearn's
    ``LinearDiscriminantAnalysis(solver="svd").fit_transform(X, labels)``,
    computed with the same numpy and `scipy.linalg.svd` steps (float32 or
    float64 input keeps its type, anything else becomes float64)."""
    import scipy.linalg as sl

    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    classes, y, counts = np.unique(np.asarray(labels), return_inverse=True,
                                   return_counts=True)
    n, n_features = X.shape
    n_classes = classes.shape[0]
    if n == n_classes:
        raise ValueError(
            "The number of samples must be more than the number of classes."
        )
    priors = counts.astype(X.dtype) / float(n)
    means = np.zeros((n_classes, n_features), dtype=X.dtype)
    np.add.at(means, y, X)
    means /= np.bincount(y)[:, None]
    Xc = np.concatenate([X[y == i] - means[i, :] for i in range(n_classes)])
    xbar = priors @ means
    # within-class scaling by each feature's std, then the within SVD
    std = np.std(Xc, axis=0)
    std[std == 0] = 1.0
    fac = np.asarray(1.0 / (n - n_classes), dtype=X.dtype)
    _, S, Vt = sl.svd(np.sqrt(fac) * (Xc / std), full_matrices=False)
    rank = np.sum((S > tol).astype(np.int32))
    scalings = (Vt[:rank, :] / std).T / S[:rank]
    # between-class SVD of the scaled, prior-weighted centres
    fac = 1.0 if n_classes == 1 else 1.0 / (n_classes - 1)
    centres = (np.sqrt((n * priors) * fac) * (means - xbar).T).T @ scalings
    _, S, Vt = sl.svd(centres, full_matrices=False)
    rank = np.sum((S > tol * S[0]).astype(np.int32))
    scalings = scalings @ Vt.T[:, :rank]
    return ((X - xbar) @ scalings)[:, :min(n_classes - 1, n_features)], scalings


class Phases:
    def __init__(self, phi_xy=None):
        self.phi_xy: pd.DataFrame = phi_xy
        self.pcs = None
        self.pca = None
        self.omegas = None

    def __len__(self):
        return self.shape[-1]

    @property
    def shape(self):
        return self.phi_xy.shape

    def copy(self):
        import copy as _copy

        return _copy.deepcopy(self)

    # -- setters / views ---------------------------------------------------
    def set_phixy(self, new_phixy):
        if isinstance(new_phixy, pd.DataFrame):
            self.phi_xy = new_phixy
            return
        arr = np.asarray(new_phixy)
        df = pd.DataFrame(arr)
        df.index = self.phi_xy.index
        df.columns = self.phi_xy.columns
        self.phi_xy = df

    def set_omegas(self, new_omegas):
        self.omegas = new_omegas

    @property
    def cells(self):
        return list(self.phi_xy.columns)

    @property
    def phi_xy_array(self):
        """(Nc, 2) f32 array: model layout."""
        return self.phi_xy.values.astype(np.float32).T

    @property
    def phi_xy_tensor(self):
        """(2, Nc) f32 array — reference orientation (`phases.py:276-283`)."""
        return self.phi_xy.values.astype(np.float32)

    @property
    def phis(self):
        """Per-cell phase angle in [0, 2*pi)."""
        v = self.phi_xy.values
        return np.mod(np.arctan2(v[1, :], v[0, :]), 2 * np.pi)

    directions = phis

    @property
    def concentrations(self):
        return np.sqrt((self.phi_xy.values ** 2).sum(0))

    @property
    def stds(self):
        """Circular std sqrt(1 - I1(k)/I0(k)) of the projected-Normal
        posterior (`phases.py:219-234`)."""
        k = self.concentrations
        return np.sqrt(1.0 - ssp.i1e(k) / ssp.i0e(k))

    # -- persistence (reference CSV format) --------------------------------
    def save(self, pathname):
        self.phi_xy.to_csv(pathname)

    @classmethod
    def load(cls, filepath):
        return cls(pd.read_csv(filepath, index_col=0))

    @classmethod
    def from_file(cls, filepath):
        return cls.load(filepath)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_array(cls, phi_xy_array, cell_names=None):
        arr = np.asarray(phi_xy_array)
        if arr.ndim != 2 or arr.shape[0] != 2:
            raise ValueError(f"phi_xy array must be (2, Nc), got {arr.shape}")
        if cell_names is not None and len(cell_names) != arr.shape[1]:
            raise ValueError(
                f"{len(cell_names)} cell names for {arr.shape[1]} cells"
            )
        return cls(
            pd.DataFrame(arr, index=["phi_x", "phi_y"], columns=cell_names)
        )

    @classmethod
    def from_angles(cls, angles, concentration=1.0, cell_names=None):
        """Phases at given angles with uniform concentration."""
        a = np.asarray(angles)
        return cls.from_array(
            np.stack([np.cos(a), np.sin(a)]) * concentration, cell_names
        )

    @classmethod
    def flat_prior(cls, adata):
        """Zero-concentration (uninformative) prior for every cell."""
        return cls(
            pd.DataFrame(
                np.zeros((2, adata.shape[0])),
                index=["phi_x", "phi_y"],
                columns=adata.obs.index,
            )
        )

    @classmethod
    def from_pca_heuristic(
        cls,
        adata,
        genes_to_use=None,
        concentration=1.0,
        layer="S_sz",
        small_count=1e-1,
        normalize_pcs=True,
        zero_at_min_density=False,
        random_state=0,
        n_components=2,
        device=None,
    ):
        """PCA initialisation: the angle of (PC1, PC2) of log counts,
        optionally percentile-normalized, optionally zeroed at the largest
        angular density gap.

        The log counts and the PCA run on ``device`` (the card unless
        ``device="cpu"``) in float64 (`pca_scores`: exact, sklearn's signs);
        ``random_state`` is taken for the JAX package's signature and draws
        nothing, as no solver here is randomized.  Stores the scores in
        ``pcs`` and a `PCAFit` in ``pca``."""
        import torch

        dev = resolve_device(device)
        mat = _layer_matrix(adata, layer, genes_to_use)
        if mat.dtype.kind != "f":
            mat = mat.astype(np.float64)
        # log(mat + small_count) in the layer's own float type, as numpy does
        X = torch.log(torch.as_tensor(mat, device=dev) + small_count)
        scores, fit = pca_scores(X.double(), n_components)
        del X
        pcs = scores.cpu().numpy()
        if normalize_pcs:
            pcs = _percentile_normalize(pcs)
        angle = np.mod(np.arctan2(pcs[:, 1], pcs[:, 0]), 2 * np.pi)
        if zero_at_min_density:
            order = np.argsort(angle)
            gap_start = order[np.diff(angle[order]).argmax() + 1]
            angle = np.mod(angle - angle[gap_start], 2 * np.pi)
        out = _unit_phases(angle, concentration, adata.obs.index)
        out.pcs = pcs
        out.pca = fit
        return out

    @classmethod
    def from_lda_heuristic(
        cls,
        adata,
        labels="phase",
        concentration=1.0,
        layer="S_sz",
        normalize=True,
        genes_to_use=None,
    ):
        """Supervised LDA initialisation (the Stereo-seq workflow's prior):
        the two leading discriminant axes of the count layer against
        categorical cell-cycle labels (`lda_scores`, on the host),
        percentile-normalized (0.5/99.5 percentiles around the median), and
        their angle.  Stores the axes in ``pcs`` and the scalings in ``pca``.

        Args:
          labels: `adata.obs` column name, or an array of per-cell labels
            with >= 3 classes (LDA yields ``n_classes - 1 >= 2`` axes).
        """
        if isinstance(labels, str):
            labels = np.asarray(adata.obs[labels])
        mat = _layer_matrix(adata, layer, genes_to_use)
        X, scalings = lda_scores(mat, labels)
        if X.shape[1] < 2:
            raise ValueError(
                f"LDA produced {X.shape[1]} axis; need >= 3 label classes"
            )
        X = X[:, :2]
        if normalize:
            X = _percentile_normalize(X)
        angle = np.mod(np.arctan2(X[:, 1], X[:, 0]), 2 * np.pi)
        out = _unit_phases(angle, concentration, adata.obs.index)
        out.pcs = X
        out.pca = scalings
        return out

    def from_cycle_mle(
        self,
        cycle,
        data,
        a=1.0,
        bins=100,
        concentration=10.0,
        noisemodel="Poisson",
        dispersion=0.3,
        device=None,
    ):
        """Grid MLE of each cell's phase against a fixed Cycle: evaluate
        ElogS on a ``bins``-point phase grid and take the per-cell argmax of
        the summed count log-likelihood.  In place.

        Runs on ``device`` (the card unless ``device="cpu"``) in float32,
        over chunks of cells sized so the (bins, cells, genes) temporary
        stays near `MLE_CHUNK_BYTES`."""
        import torch

        from .. import native
        from ..ops.fourier import fourier_basis
        from ..ops.likelihoods import nb_logpmf, poisson_logpmf

        if noisemodel not in ("Poisson", "NegativeBinomial"):
            raise NotImplementedError(f"{noisemodel=} not supported")
        dev = resolve_device(device)
        coeffs = torch.as_tensor(cycle.means_tensor, device=dev)   # (Nh, Ng)
        counts = np.array(data.obs["n_scounts"].values, np.float32)
        log_counts = torch.log(torch.as_tensor(counts, device=dev)) * a  # (Nc,)
        grid = torch.arange(bins, dtype=torch.float32, device=dev) / bins * 2 * math.pi
        elog_grid = fourier_basis(grid, cycle.harmonics) @ coeffs  # (bins, Ng)
        k_all = torch.as_tensor(native.csr_to_dense(data.layers["spliced"]),
                                device=dev)                         # (Nc, Ng)
        r = torch.tensor(dispersion, dtype=torch.float32, device=dev)
        n_cells, n_genes = k_all.shape
        step = max(1, MLE_CHUNK_BYTES // (bins * n_genes * 4))
        total = torch.empty((bins, n_cells), dtype=torch.float32, device=dev)
        for c0 in range(0, n_cells, step):
            k = k_all[None, c0:c0 + step, :]
            # ElogS[b, c, g] = elog_grid[b, g] + log_counts[c]
            elog = elog_grid[:, None, :] + log_counts[None, c0:c0 + step, None]
            lp = (poisson_logpmf(k, elog) if noisemodel == "Poisson"
                  else nb_logpmf(k, elog, r))
            total[:, c0:c0 + step] = lp.sum(-1)
            del elog, lp
        mle = grid[torch.argmax(total, dim=0)].cpu().numpy()     # (Nc,)
        self.set_phixy(np.stack([np.cos(mle), np.sin(mle)]) * concentration)

    # -- alignment operations ---------------------------------------------
    def shift_zero(self, phase=None):
        """Subtract ``phase`` from every cell's angle.  In place."""
        if phase is None:
            raise ValueError("specify phase= for the desired shift")
        self.rotate(-float(phase))

    def rotate(self, angle=None):
        """Rotate all phi_xy vectors by ``angle``.  In place."""
        if angle is None:
            raise ValueError("specify angle= for the desired rotation")
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s], [s, c]])
        self.set_phixy(rot @ self.phi_xy.values)

    def invert_direction(self):
        """Mirror phases across the x axis.  In place."""
        v = self.phi_xy.values.copy()
        v[1, :] = -v[1, :]
        self.set_phixy(v)

    def max_corr(self, counts, npoints=100):
        """Grid-search the rotation maximizing the linear correlation of the
        (wrapped) phase with a per-cell covariate, e.g. UMI counts.  Returns
        (best_shift, best_corr, corrs)."""
        shifts = np.arange(npoints) / npoints * 2 * np.pi
        phis = self.phis
        corrs = []
        for s in shifts:
            x = np.mod(phis - s, 2 * np.pi)
            corrs.append(np.corrcoef(x, counts)[0, 1])
        best = int(np.argmax(corrs))
        return shifts[best], corrs[best], corrs
