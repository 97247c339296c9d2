"""The benchmark's inputs, made on the device from ``--seed``.

One configuration file states the data law (`configs/*.json`, key
``data``): genes and cells, the spliced and unspliced counts as
``floor(exp(N(mean, sd^2)))`` (the law of the repository's Stereo-seq-class
runs), cell phases uniform on the circle, and ``batches`` contiguous
sections of equal size.  ``nu_prior`` is the phase stage's prior on the
genes' harmonic coefficients worked out from the counts as a user's script
does (the Stereo-seq notebook's cell 63).  The same seed gives the same inputs, and both the
program and the plain reference are handed them: the program through its
front door as an AnnData, the reference as device tensors.

Counts are drawn in blocks of cells, so that the draw never holds more than
one block's float32 normals beside the int16 counts on the device.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BLOCK_ELEMENTS = 1 << 26


@dataclasses.dataclass
class Inputs:
    spliced: torch.Tensor           # (Nc, Ng) int16, cells x genes
    angles: torch.Tensor            # (Nc,) float32 cell phases
    batch: torch.Tensor | None      # (Nc,) int64 section of each cell
    unspliced: torch.Tensor | None  # (Nc, Ng) int16, drawn last


def _counts(g, law, Nc, Ng, device):
    mean, sd = law
    out = torch.empty((Nc, Ng), dtype=torch.int16, device=device)
    rows = max(1, BLOCK_ELEMENTS // Ng)
    for lo in range(0, Nc, rows):
        n = min(rows, Nc - lo)
        x = torch.randn((n, Ng), generator=g, device=device)
        out[lo:lo + n] = x.mul_(sd).add_(mean).exp_().floor_().to(torch.int16)
    return out


def make(data, seed, device, unspliced=True):
    """The inputs of a configuration's ``data`` law at ``seed``: spliced
    counts, then phases, then (unless ``unspliced=False``) unspliced
    counts, from one generator on ``device``."""
    Ng, Nc, Nb = data["genes"], data["cells"], data.get("batches", 0)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    spliced = _counts(g, data["spliced"], Nc, Ng, device)
    angles = torch.rand(Nc, generator=g, device=device) * (2 * math.pi)
    U = _counts(g, data["unspliced"], Nc, Ng, device) if unspliced else None
    batch = None
    if Nb:
        if Nc % Nb:
            raise ValueError(f"{Nc} cells do not split into {Nb} sections")
        batch = torch.arange(Nc, device=device) // (Nc // Nb)
    return Inputs(spliced, angles, batch, U)


def to_adata(inputs):
    """The inputs as the AnnData a user hands the front door: counts
    layers (cells x genes, int16) and, with sections, an obs ``batch``
    column of section labels."""
    import pandas as pd

    from velocycle_tpu_torch import AnnDataLite

    Nc, Ng = inputs.spliced.shape
    obs = pd.DataFrame(index=[f"C{i:06d}" for i in range(Nc)])
    if inputs.batch is not None:
        obs["batch"] = np.char.add(
            "section", inputs.batch.cpu().numpy().astype(str))
    layers = {"spliced": inputs.spliced.cpu().numpy()}
    if inputs.unspliced is not None:
        layers["unspliced"] = inputs.unspliced.cpu().numpy()
    var = pd.DataFrame(index=[f"G{i:05d}" for i in range(Ng)])
    return AnnDataLite(obs=obs, var=var, layers=layers)


def nu_prior(inputs, harmonics):
    """(means, stds), each (2 harmonics + 1, Ng) float32 on the counts'
    device: the per-gene log mean count (+1e-9) and zeros, and the per-gene
    std of log(S + 1) over cells, halved, and half of that again for each
    harmonic's pair.  Summed in float64, block by block of cells."""
    S = inputs.spliced
    Nc, Ng = S.shape
    rows = max(1, BLOCK_ELEMENTS // Ng)
    s1 = torch.zeros(Ng, dtype=torch.float64, device=S.device)
    s2 = torch.zeros_like(s1)
    for lo in range(0, Nc, rows):
        x = torch.log1p(S[lo:lo + rows].to(torch.float64))
        s1 += x.sum(0)
        s2 += (x * x).sum(0)
    mean_log = s1 / Nc
    std = torch.sqrt(torch.clamp(s2 / Nc - mean_log ** 2, min=0.0)) / 2
    nu0 = torch.log(S.sum(0, dtype=torch.int64).to(torch.float64) / Nc
                    + 1e-9)
    k = 2 * int(harmonics)
    means = torch.cat([nu0[None], torch.zeros((k, Ng), dtype=torch.float64,
                                              device=S.device)])
    stds = torch.cat([std[None], (0.5 * std)[None].expand(k, Ng)])
    return means.float(), stds.float()
