"""The benchmark's cells at a size a CPU test run holds: the cell's own
files, limits and traffic, with fewer genes and cells and shorter chunks."""
import copy
import time

import torch

from perfbench import harness, spec

SIZES = {"stereoseq_102k.phase_default": dict(genes=48, cells=1200)}
CELLS = sorted(SIZES)


def cell(name):
    c = spec.cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["data"].update(SIZES[name])
    c.mix = dict(c.mix, chunk=4)
    return c


def run(name, seed, traced=False):
    """One run of the tiny cell on the CPU, past the look for a card."""
    result = harness.run_cell(cell(name), seed, 0.2, traced,
                              torch.device("cpu"), time.perf_counter())
    result.pop("spans")
    return result
