"""velocycle_tpu_torch: the PyTorch + CUDA port of velocycle_tpu.

Same two-stage workflow as the JAX package, module for module: host
containers and preprocessing build a `PhaseData` or `VelocityData` of
device tensors, the phase and velocity models and guides run under the
effect-handler DSL, and `PhaseFitModel` then `VelocityFitModel` (conditioned
on the phase fit) fit them with SVI, `MCMCFitModel` samples their
posteriors with NUTS or HMC (`infer.mcmc`), the chains as one batch, and
`SMCFitModel` with tempered SMC (`infer.smc`), the particles as one batch,
with the model evidence.  The fused Negative-Binomial
likelihoods of both stages run as hand-written CUDA kernels for Hopper
(`ops/nb_kernels.py`, `csrc/`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card and no explicit CPU request they raise (`device.py`).

The 2-D extension (a spline velocity field on a branching 2-D manifold,
its simulator and two-stage driver) is `velocycle_tpu_torch.twodim`.

Real data enters as in the JAX package: `read_h5ad` (or `native.read_mtx`),
`normalize_total`, `genes.get_cycling_gene_set`, the `Phases` prior builders
and the joint gauge fixes `invert_direction` / `shift_zero`.

Support: `checkpoint` (save and resume an SVI state), `profiling` (traces,
step timers, device memory), `plots` (matplotlib, imported lazily) and
`warmup` / `enable_compile_cache` (build the CUDA kernels ahead of a fit).

This package imports torch, numpy, scipy and pandas (h5py only inside the
.h5ad functions) — never jax or the JAX package, which stays in the
repository as the reference.
"""
from . import alignment, checkpoint, genes, native, plots, profiling  # noqa: F401
from .alignment import invert_direction, shift_zero  # noqa: F401
from .anndata_lite import AnnDataLite, read_h5ad, write_h5ad  # noqa: F401
from .containers import AngularSpeed, Cycle, FourierTable, Phases  # noqa: F401
from .device import resolve_device  # noqa: F401
from .fit import PhaseFitModel, VelocityFitModel  # noqa: F401
from .fit_mcmc import MCMCFitModel, SMCFitModel  # noqa: F401
from .models.metapars import Metapars, PhaseData, VelocityData  # noqa: F401
from .preprocessing import (  # noqa: F401
    filter_shared_genes,
    make_design_matrix,
    normalize_total,
    preprocess_for_phase_estimation,
    preprocess_for_velocity_estimation,
)
from .simulate import simulate_data  # noqa: F401
from .warmup import enable_compile_cache, warmup  # noqa: F401

__all__ = [
    "AngularSpeed",
    "AnnDataLite",
    "Cycle",
    "FourierTable",
    "MCMCFitModel",
    "Metapars",
    "PhaseData",
    "PhaseFitModel",
    "Phases",
    "SMCFitModel",
    "VelocityData",
    "VelocityFitModel",
    "enable_compile_cache",
    "filter_shared_genes",
    "genes",
    "invert_direction",
    "make_design_matrix",
    "normalize_total",
    "preprocess_for_phase_estimation",
    "preprocess_for_velocity_estimation",
    "read_h5ad",
    "resolve_device",
    "shift_zero",
    "simulate_data",
    "warmup",
    "write_h5ad",
]
