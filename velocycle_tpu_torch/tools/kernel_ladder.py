"""Layout ladder of the fused Negative-Binomial kernels on the card.

    python -m velocycle_tpu_torch.tools.kernel_ladder [phase|velo] [layouts...]

The port of tools/kernel_ladder.py.  For each layout it gives the ms per
step of the loss and every gradient through `nb_loglik_fused` (``phase``,
2048 genes x 102,400 cells, Nh = 5) or `nbsu_loglik_fused` (``velo``, 1024
x 51,200): CUDA events around a loop of ``n_it`` = 25 steps chained through
nu (``nu - 1e-12 * dnu``), after one untimed loop.  The inputs are the TPU
tool's draws, made on the card from ``seed``.

A layout is named ``<gene_chunk>x<cells_per_tile>x<dtype>``, as in the TPU
tool: genes staged per step of the sweep (``kGeneChunk``), cells per tile
(``kCellsPerTile``, with ``kCellsPerThread = cells_per_tile / kThreads``
beside it) of csrc/phase_kernel.cuh or csrc/velo_kernel.cuh, and the count
type, ``i16`` or ``f32`` (the two the kernels take).  The package's own
layout (``16x256`` for phase, ``8x256`` for velo) runs in this process.
Any other runs in a copy of the package under
``build/kernel_ladder/<kind>_<gene_chunk>x<cells_per_tile>/`` whose header
has those constants: the copy builds its library into its own ``build/``
and is measured in a subprocess that imports it.  ``csrc/`` itself is never
changed.  Each layout's loss is held against the package layout's at the
same dtype and inputs (relative 1e-5: a layout changes only the order of
the partial sums); one that disagrees raises.  It runs on the card and
raises without one.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops import cuda_build
from ..ops import nb_kernels as K

KINDS = {"phase": ("phase_kernel.cuh", "nb_phase"),
         "velo": ("velo_kernel.cuh", "nb_velo")}
SHAPES = {"phase": (2048, 102_400), "velo": (1024, 51_200)}
NH = 5
DTYPES = {"i16": torch.int16, "f32": torch.float32}
LOSS_RTOL = 1e-5          # the kernels against their plain versions
PACKAGE = Path(__file__).resolve().parents[1]
LADDER_DIR = cuda_build.DEFAULT_BUILD_DIR.parent / "kernel_ladder"
BUILD_TIMEOUT_S = 900


class Layout(NamedTuple):
    gene_chunk: int
    cells_per_tile: int
    dtype: str

    @property
    def name(self):
        return f"{self.gene_chunk}x{self.cells_per_tile}x{self.dtype}"


def _package_layout(kind):
    return K.phase_layout() if kind == "phase" else K.velo_layout()


def parse_layout(kind, name):
    """``"<gene_chunk>x<cells_per_tile>x<dtype>"`` -> `Layout`; raises
    ValueError for a layout the kernel headers' static_asserts refuse or a
    count type the kernels do not take."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: phase or velo")
    parts = name.split("x")
    if len(parts) != 3 or not all(p.isdigit() for p in parts[:2]):
        raise ValueError(f"layout {name!r}: <gene_chunk>x<cells_per_tile>x"
                         "<dtype>, e.g. 16x256xi16")
    gene_chunk, cells_per_tile, dtype = int(parts[0]), int(parts[1]), parts[2]
    if dtype not in DTYPES:
        raise ValueError(
            f"layout {name!r}: count type {dtype!r}; the kernels take i16 and "
            "f32 counts (the TPU tool's i8 and bf16 have no instantiation)")
    threads = _package_layout(kind).threads
    if gene_chunk < 1 or cells_per_tile < threads or cells_per_tile % threads:
        raise ValueError(
            f"layout {name!r}: cells_per_tile must be a positive multiple of "
            f"kThreads = {threads} (kCellsPerTile == kThreads * "
            "kCellsPerThread) and gene_chunk >= 1")
    if kind == "velo" and gene_chunk > threads:
        raise ValueError(f"layout {name!r}: the velocity body stages each "
                         f"gene's columns with one thread (kGeneChunk <= "
                         f"kThreads = {threads})")
    return Layout(gene_chunk, cells_per_tile, dtype)


def package_layout(kind, dtype="i16"):
    """The layout the package's headers define, at count type ``dtype``."""
    lay = _package_layout(kind)
    return Layout(lay.gene_chunk, lay.cells_per_tile, dtype)


def _is_package(kind, layout):
    return layout._replace(dtype="i16") == package_layout(kind)


def copy_root(kind, layout):
    return LADDER_DIR / f"{kind}_{layout.gene_chunk}x{layout.cells_per_tile}"


def layout_copy(kind, layout):
    """Copy the package under `copy_root` with ``layout``'s constants in
    its kind's header; returns the root (the directory holding the copy).
    The copy's build directory is kept: its libraries are named by a hash
    of the sources."""
    root = copy_root(kind, layout)
    dest = root / PACKAGE.name
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(PACKAGE, dest,
                    ignore=shutil.ignore_patterns("__pycache__"))
    header = dest / "csrc" / KINDS[kind][0]
    text = header.read_text()
    threads = _package_layout(kind).threads
    for const, value in (("kGeneChunk", layout.gene_chunk),
                         ("kCellsPerTile", layout.cells_per_tile),
                         ("kCellsPerThread", layout.cells_per_tile // threads)):
        text, n = re.subn(rf"constexpr int {const} = \d+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise RuntimeError(f"csrc/{KINDS[kind][0]} defines {const} "
                               f"{n} times")
    header.write_text(text)
    return root


def _child(root, *args, nice=0):
    """Start this tool in the copy at ``root`` (it imports the copy's
    package: the copy comes first on its path), in a session of its own so
    that `stop` ends its compilers too; ``nice`` lowers its priority."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE.name}.tools.kernel_ladder",
         "--child", *args], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        preexec_fn=(lambda: os.nice(nice)) if nice else None)


def stop(pending):
    """End every process of `start_builds`' builds that is still running."""
    for _, proc in pending.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _child_result(proc, root, what, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    finally:
        stop({None: (root, proc)})
    if proc.returncode != 0:
        raise RuntimeError(f"{what} in {root} failed:\n{err[-3000:]}")
    result = json.loads(out.strip().splitlines()[-1])
    if not Path(result["package"]).is_relative_to(root):
        raise RuntimeError(f"{what} imported {result['package']}, not the "
                           f"copy under {root}")
    return result


def start_builds(pairs, nice=0):
    """Copy the package for each (kind, layout) that is not the package's
    own, and start building each copy's library, all at once (at niceness
    ``nice``); returns the pending builds for `finish_builds` (or
    `stop`)."""
    pending = {}
    for kind, layout in pairs:
        if _is_package(kind, layout):
            continue
        key = (kind, layout.gene_chunk, layout.cells_per_tile)
        if key not in pending:
            root = layout_copy(kind, layout)
            pending[key] = (root, _child(root, "build", kind, nice=nice))
    return pending


def finish_builds(pending):
    """Wait for `start_builds`' builds; {(kind, gene_chunk, cells_per_tile):
    seconds}.  Raises if a build failed or its copy reports another
    layout."""
    out = {}
    for (kind, gc, cpt), (root, proc) in pending.items():
        r = _child_result(proc, root, f"the {kind} build", BUILD_TIMEOUT_S)
        if r["layout"] != [gc, cpt]:
            raise RuntimeError(f"the copy under {root} reads back layout "
                               f"{r['layout']}, not {[gc, cpt]}")
        out[(kind, gc, cpt)] = r["build_s"]
    return out


def make_inputs(kind, seed, device):
    """The TPU tool's draws (tools/kernel_ladder.py), on ``device`` from
    ``seed``, counts as float32: (counts, the other arguments of the fused
    call, lgamma_k_sum)."""
    Ng, Nc = SHAPES[kind]
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    counts = [torch.floor(torch.exp(normal(Ng, Nc) * 0.8 + 1.0))]
    if kind == "velo":
        counts.append(torch.floor(torch.exp(normal(Ng, Nc) * 0.8 + 0.4)))
    lgk = sum(torch.lgamma(c.double() + 1.0).sum() for c in counts).float()
    nu0 = normal(Ng, NH) * 0.5
    ang = torch.rand(Nc, generator=g, device=device) * 6.28
    zeta = torch.stack([torch.ones_like(ang), torch.cos(ang), torch.sin(ang),
                        torch.cos(2 * ang), torch.sin(2 * ang)], -1)
    cf = normal(Nc) * 0.2
    disp = torch.exp(normal(Ng) * 0.3)
    if kind == "phase":
        return counts, [nu0, zeta, cf, disp], lgk
    zdphi = torch.stack([torch.zeros_like(ang), -torch.sin(ang), torch.cos(ang),
                         -2 * torch.sin(2 * ang), 2 * torch.cos(2 * ang)], -1)
    om = torch.exp(normal(Nc) * 0.2 - 1.0)
    lb = normal(Ng) * 0.2
    lg = normal(Ng) * 0.2
    return counts, [nu0, zeta, zdphi, cf, om, lb, lg, disp], lgk


def _measure_here(kind, dtype, n_it=25, seed=0):
    """(ms per step, the last step's loss) in this process's package."""
    dev = resolve_device(None)
    counts, args, lgk = make_inputs(kind, seed, dev)
    counts = [c.to(DTYPES[dtype]) for c in counts]
    nu0, rest = args[0], [a.requires_grad_(True) for a in args[1:]]
    fused = K.nb_loglik_fused if kind == "phase" else K.nbsu_loglik_fused

    def loop():
        nu = nu0
        for _ in range(n_it):
            nu = nu.detach().requires_grad_(True)
            loss = fused(*counts, nu, *rest, lgamma_k_sum=lgk)
            grads = torch.autograd.grad(loss, [nu, *rest])
            nu = nu - 1e-12 * grads[0]
        return loss

    loop()
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    loss = loop()
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / n_it, float(loss.detach())


def measure(kind, layout, n_it=25, seed=0):
    """{"ms", "loss", "copy"} of a `Layout`: in this process for the
    package's own layout, else in its copy (whose library is built at its
    first use unless `start_builds` built it)."""
    resolve_device(None)
    if _is_package(kind, layout):
        ms, loss = _measure_here(kind, layout.dtype, n_it, seed)
        return {"ms": ms, "loss": loss, "copy": None}
    root = layout_copy(kind, layout)
    r = _child_result(_child(root, "measure", kind, layout.dtype, str(n_it),
                             str(seed)), root, f"{layout.name}", 1200)
    if r["layout"] != [layout.gene_chunk, layout.cells_per_tile]:
        raise RuntimeError(f"{root} measured layout {r['layout']}")
    return {"ms": r["ms"], "loss": r["loss"], "copy": str(root)}


def measure_phase(gene_chunk, cells_per_tile, dtype="i16", n_it=25, seed=0):
    """(ms per step, loss) of the phase stage's fused call at this layout."""
    r = measure("phase", parse_layout(
        "phase", f"{gene_chunk}x{cells_per_tile}x{dtype}"), n_it, seed)
    return r["ms"], r["loss"]


def measure_velo(gene_chunk, cells_per_tile, dtype="i16", n_it=25, seed=0):
    """(ms per step, loss) of the velocity stage's fused call."""
    r = measure("velo", parse_layout(
        "velo", f"{gene_chunk}x{cells_per_tile}x{dtype}"), n_it, seed)
    return r["ms"], r["loss"]


def run_sweep(kind, names, n_it=25, seed=0, pending=None):
    """One row per layout of ``names``, the package's layout first at each
    count type (measured for the comparison if not asked for): {"kind",
    "layout", "ms", "loss", "rel_to_package", "copy", "build_s"}.  Builds
    the copies concurrently (or finishes ``pending``, from
    `start_builds`); raises if a layout's loss disagrees with the package
    layout's at LOSS_RTOL."""
    layouts = [parse_layout(kind, n) for n in names]
    resolve_device(None)
    refs = [package_layout(kind, d)
            for d in dict.fromkeys(lay.dtype for lay in layouts)]
    order = refs + [lay for lay in layouts if lay not in refs]
    pending = dict(pending or {})
    pending.update(start_builds(
        [(kind, lay) for lay in order
         if (kind, lay.gene_chunk, lay.cells_per_tile) not in pending]))
    built = finish_builds(pending)
    rows, ref_loss = [], {}
    for lay in order:
        r = measure(kind, lay, n_it, seed)
        if lay in refs:
            ref_loss[lay.dtype] = r["loss"]
        ref = ref_loss[lay.dtype]
        rel = abs(r["loss"] - ref) / max(abs(ref), 1e-30)
        rows.append({"kind": kind, "layout": lay.name, "ms": r["ms"],
                     "loss": r["loss"], "rel_to_package": rel,
                     "copy": r["copy"],
                     "build_s": built.get((kind, lay.gene_chunk,
                                           lay.cells_per_tile))})
        if not rel < LOSS_RTOL:
            raise RuntimeError(
                f"{kind} {lay.name}: loss {r['loss']!r} against the package "
                f"layout's {ref!r}, rel {rel:.3g} >= {LOSS_RTOL}")
    return rows


def format_row(row):
    where = "this process" if row["copy"] is None else (
        f"copy, built in {row['build_s']:.1f} s" if row["build_s"] is not None
        else "copy")
    return (f"{row['kind']} {row['layout']}: {row['ms']:.4f} ms/step "
            f"(loss {row['loss']:.9g}, rel to the package layout "
            f"{row['rel_to_package']:.2e}; {where})")


def _run_child(argv):
    """``--child build <kind>`` or ``--child measure <kind> <dtype> <n_it>
    <seed>``, in a copy: one JSON line."""
    mode, kind = argv[0], argv[1]
    lay = _package_layout(kind)
    out = {"package": str(PACKAGE), "layout": [lay.gene_chunk,
                                               lay.cells_per_tile]}
    if mode == "build":
        t0 = time.perf_counter()
        cuda_build.build_all([KINDS[kind][1]])
        out["build_s"] = time.perf_counter() - t0
    else:
        out["ms"], out["loss"] = _measure_here(kind, argv[2], int(argv[3]),
                                               int(argv[4]))
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--child":
        return _run_child(argv[1:])
    kind = argv[0] if argv else "phase"
    names = argv[1:] or [package_layout(kind, "i16").name,
                         package_layout(kind, "f32").name]
    dev = resolve_device(None)
    shape = "x".join(str(n) for n in SHAPES[kind])
    print(f"# {torch.cuda.get_device_name(dev)}: {kind}, {shape}, Nh {NH}, "
          "25 chained steps per layout", flush=True)
    for row in run_sweep(kind, names):
        print(format_row(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
