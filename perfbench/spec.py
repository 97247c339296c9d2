"""Everything the harness runs, found by name.

`BENCHMARK.json` (at the checkout's root) names each cell's configuration
and traffic mix; each is a file of its own: ``configs/<config>.json``
(the data law, the model's priors and pinned sites, its precision),
``traffic/<mix>.json`` (stage, path, chunk, optimizer, steps checked and
traced, the kernels a roofline reads through `metrics.roofline`) and
``cells/<cell>.json`` (the limits of the comparison that decides
``correct``).  A per-layer metric is read by
``metrics/<base>.py``, ``<base>`` its name up to the first ``.`` (a
quantity split by path, such as ``launches_per_step.fused``, has one
reader), whose ``read(run)`` returns the number or None.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "velocycle_tpu"})


def _load(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root=ROOT):
    return _load(Path(root) / "BENCHMARK.json")


def cell(name, root=ROOT):
    """The cell ``name`` of BENCHMARK.json with its files and the metrics
    it reports."""
    spec = benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfgs = {c["name"]: c for c in spec["configs"]}
    cfg = _load(Path(root) / cfgs[w["config"]]["file"])
    return Cell(
        name=name, chips=int(w["chips"]), config=cfg,
        mix=_load(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_load(HERE / "cells" / f"{name}.json")["limits"],
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def base(metric_name):
    """A metric's name up to its first ``.``: what it measures, whichever
    path it is split by."""
    return metric_name.split(".")[0]


def reader(metric_name):
    """The ``read`` function of ``metrics/<base>.py``."""
    return importlib.import_module(
        f"perfbench.metrics.{base(metric_name)}").read


def forbidden_modules(modules):
    """The top-level names among ``modules`` that a run may not hold: JAX,
    its libraries and the JAX package (compared whole, so
    ``velocycle_tpu_torch`` is not one)."""
    return sorted({m.split(".")[0] for m in modules} & FORBIDDEN)
