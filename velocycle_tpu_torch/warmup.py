"""First-run cost: building the CUDA kernels before the fit that needs them
(port of `velocycle_tpu/warmup.py`).

The JAX package warms XLA's persistent compilation cache.  This package
compiles no program per fit: its one first-use cost is ``nvcc``, which
builds `csrc/nb_phase.cu` and `csrc/nb_velo.cu` into shared libraries
(100-140 s on an H100 host, both at once) kept on disk by a hash of the
sources, so every later process starts with them built.  Warming up here
is that build, then one SVI step and one posterior draw, which launch the
configuration's kernel and run its plain replay path.

Typical use, once per machine (or after the kernel sources change)::

    import velocycle_tpu_torch as vc
    vc.enable_compile_cache()            # build/velocycle_tpu_torch/
    mp = vc.preprocess_for_phase_estimation(...)
    vc.warmup(mp, num_steps=5000)        # builds, one step, one draw
    ...                                  # every later fit starts hot
"""
from __future__ import annotations

import os
import time
from pathlib import Path

import torch

__all__ = ["enable_compile_cache", "warmup"]


def enable_compile_cache(cache_dir=None, min_compile_seconds=1.0):
    """Point the kernels' build directory (`ops.cuda_build.BUILD_DIR`) at
    ``cache_dir``.

    Args:
      cache_dir: where the built libraries live; defaults to
        ``$VELOCYCLE_TPU_CACHE``, else ``build/velocycle_tpu_torch/`` beside
        the package.
      min_compile_seconds: accepted for the JAX package's callers and
        without effect: every ``nvcc`` output is kept.

    Returns the directory's path.  Raises RuntimeError if a library is
    already loaded from another directory.
    """
    from .ops import cuda_build

    if cache_dir is None:
        cache_dir = os.environ.get("VELOCYCLE_TPU_CACHE",
                                   str(cuda_build.DEFAULT_BUILD_DIR))
    path = Path(cache_dir).resolve()
    if cuda_build.loaded() and path != Path(cuda_build.BUILD_DIR).resolve():
        raise RuntimeError(
            f"kernels {cuda_build.loaded()} are already loaded from "
            f"{cuda_build.BUILD_DIR}; set the build directory before the "
            "first fit")
    path.mkdir(parents=True, exist_ok=True)
    cuda_build.BUILD_DIR = path
    return str(cache_dir)


def _chunk_lengths(num_steps, chunk_size=None):
    """The distinct chunk lengths `SVI.run` takes for a ``num_steps`` fit
    (``min(num_steps, 1000)``, then a remainder chunk), as the JAX package
    derives them for its scanned programs; this package compiles nothing
    per chunk length."""
    if chunk_size is None:
        chunk_size = min(num_steps, 1000)
    lengths = {min(chunk_size, num_steps)}
    rem = num_steps % chunk_size
    if num_steps > chunk_size and rem:
        lengths.add(rem)
    return sorted(lengths)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warmup(metaparams, condition_on=None, num_steps=1000, predictive=True,
           num_posterior_samples=None, seed=0, cache_dir=None, verbose=True):
    """Build and run once what a fit of this configuration runs.

    Builds the exact model/guide pair the fit drivers build (``condition_on``
    conditions the model and blocks the guide; conditioning ``shape_inv``
    turns the fused kernels' dispersion gradient off, as in the drivers),
    then:

      * ``"build"``: builds the kernel library this configuration loads
        (fused data on the card: `csrc/nb_phase.cu` for the phase stage,
        `csrc/nb_velo.cu` for the velocity stage; nothing otherwise);
      * ``"svi_step"``: one `SVI.update` with the drivers' ClippedAdam,
        which launches the configuration's kernel instantiation;
      * ``"predictive"`` (if ``predictive``): one `Predictive` call through
        the plain path, as the drivers replay posterior draws.

    Args:
      metaparams: a `Metapars` from either ``preprocess_for_*`` call.
      condition_on: the same dict you will pass to the fit driver.
      num_steps: the real fit's step count (>= 1; sets the decay of the
        learning rate as the drivers do).
      num_posterior_samples: draws of the predictive call (default 500).
      seed: integer seed of the step's and the draws' noise.
      cache_dir: forwarded to `enable_compile_cache`; ``False`` leaves the
        build directory as it is.

    Returns {"build", "svi_step"[, "predictive"]: seconds}.  The JAX
    package's keys are ``svi_chunk_<n>``, one per scanned program it
    compiles; this package compiles no program per chunk length.
    """
    from .core import handlers
    from .fit import _FitModel
    from .infer import SVI, Trace_ELBO, clipped_adam
    from .infer.predictive import Predictive
    from .models.metapars import VelocityData
    from .ops import cuda_build

    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if cache_dir is not False:
        enable_compile_cache(cache_dir)
    driver = _FitModel(metaparams, condition_on=condition_on,
                       get_posterior=False)
    data = driver.metaparams.data
    dev = data.device
    timings = {}

    t0 = time.perf_counter()
    if data.use_fused_nb and dev.type == "cuda":
        cuda_build.build_all(
            ["nb_velo" if isinstance(data, VelocityData) else "nb_phase"])
    timings["build"] = time.perf_counter() - t0

    svi = SVI(driver.model, driver.guide, clipped_adam(
        lr=0.05, betas=(0.80, 0.99), lrd=0.1 ** (1.0 / num_steps),
    ), Trace_ELBO())
    state = svi.init(seed, data)
    t0 = time.perf_counter()
    state, loss = svi.update(state, data)
    float(loss)
    _sync(dev)
    timings["svi_step"] = time.perf_counter() - t0

    if predictive:
        n_samples = num_posterior_samples or 500
        pred = Predictive(driver.model, guide=driver.guide,
                          params=svi.get_params(state), num_samples=n_samples)
        t0 = time.perf_counter()
        pred(handlers.fold_in(seed, 1), data.replace(use_fused_nb=False))
        _sync(dev)
        timings["predictive"] = time.perf_counter() - t0
    if verbose:
        print("warmup: " + ", ".join(f"{k} {v:.2f}s"
                                     for k, v in timings.items()))
    return timings
