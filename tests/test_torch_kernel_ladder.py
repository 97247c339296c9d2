"""The layout ladder tool (`velocycle_tpu_torch/tools/kernel_ladder.py`, the
port of tools/kernel_ladder.py) on the CPU, where it builds nothing:

  * layout names parse as the TPU tool's ``<gene_chunk>x<cells_per_tile>x
    <dtype>``; the layouts the kernel headers' static_asserts refuse, and
    the count types no kernel takes (i8, bf16), raise before any copy;
  * a copy's rewritten header reads back through the copy's own
    `phase_layout()` / `velo_layout()` in a process that imports the copy,
    and csrc/ stays as it was;
  * in a copy at another layout, the plain version of `nb_loglik_fused`
    gives the JAX package's fused loss and nu gradient at 16 x 512
    (interpret mode, as tests/test_nb_kernels.py runs it), rtol 5e-4;
  * the tool raises without a card.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from velocycle_tpu.ops.nb_kernels import nb_loglik_fused as j_fused
from velocycle_tpu_torch.ops import cuda_build
from velocycle_tpu_torch.tools import kernel_ladder as KL


@pytest.fixture
def ladder_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(KL, "LADDER_DIR", tmp_path / "kernel_ladder")
    return tmp_path / "kernel_ladder"


def _in_copy(root, code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind,name,want", [
    ("phase", "16x256xi16", (16, 256, "i16")),
    ("phase", "32x512xf32", (32, 512, "f32")),
    ("phase", "200x128xi16", (200, 128, "i16")),
    ("velo", "8x256xi16", (8, 256, "i16")),
    ("velo", "128x384xf32", (128, 384, "f32")),
])
def test_layouts_parse_as_the_tpu_tool_names_them(kind, name, want):
    lay = KL.parse_layout(kind, name)
    assert tuple(lay) == want and lay.name == name


@pytest.mark.parametrize("kind,name,match", [
    ("phase", "16x256xi8", "i8 and bf16"),
    ("velo", "8x256xbf16", "i8 and bf16"),
    ("phase", "16x100xi16", "multiple of kThreads"),
    ("phase", "16x64xi16", "multiple of kThreads"),
    ("velo", "0x256xi16", "gene_chunk >= 1"),
    ("velo", "129x256xi16", "kGeneChunk <= kThreads"),
    ("phase", "16x256", "<gene_chunk>x<cells_per_tile>x<dtype>"),
    ("tiles", "16x256xi16", "phase or velo"),
])
def test_refused_layouts_raise_before_any_copy(kind, name, match, ladder_dir):
    with pytest.raises(ValueError, match=match):
        KL.parse_layout(kind, name)
    assert not ladder_dir.exists()


def test_package_layouts_are_the_headers():
    assert KL.package_layout("phase").name == "16x256xi16"
    assert KL.package_layout("velo", "f32").name == "8x256xf32"
    assert KL.start_builds([("phase", KL.package_layout("phase", "f32"))]) == {}


@pytest.mark.parametrize("kind,name", [("phase", "32x512xi16"),
                                       ("velo", "4x128xf32")])
def test_copy_reads_back_its_layout(kind, name, ladder_dir):
    header = cuda_build.CSRC / KL.KINDS[kind][0]
    before = header.read_text()
    lay = KL.parse_layout(kind, name)
    root = KL.layout_copy(kind, lay)
    assert root == ladder_dir / f"{kind}_{lay.gene_chunk}x{lay.cells_per_tile}"
    got = _in_copy(root, (
        "import json, velocycle_tpu_torch as P\n"
        "from velocycle_tpu_torch.ops import nb_kernels as K, cuda_build\n"
        f"lay = K.{kind}_layout()\n"
        "print(json.dumps({'package': P.__file__, 'layout': list(lay), "
        "'build': str(cuda_build.BUILD_DIR)}))"))
    assert got["package"].startswith(str(root))
    assert got["build"] == str(root / "build" / "velocycle_tpu_torch")
    threads, cells, chunk = got["layout"][:3]
    assert (chunk, cells) == (lay.gene_chunk, lay.cells_per_tile)
    text = (root / "velocycle_tpu_torch" / "csrc" / KL.KINDS[kind][0]).read_text()
    assert f"constexpr int kCellsPerThread = {cells // threads};" in text
    assert header.read_text() == before


def test_copy_plain_version_matches_jax_fused_kernel(ladder_dir, tmp_path):
    rng = np.random.default_rng(0)
    Ng, Nc = 16, 512
    args = [rng.poisson(3, (Ng, Nc)).astype(np.float32),
            rng.normal(0.5, 0.5, (Ng, 5)).astype(np.float32),
            rng.normal(0, 0.7, (Nc, 5)).astype(np.float32),
            rng.normal(0, 0.2, Nc).astype(np.float32),
            (np.abs(rng.normal(0.5, 0.2, Ng)) + 0.05).astype(np.float32)]
    np.savez(tmp_path / "inputs.npz", *args)
    root = KL.layout_copy("phase", KL.parse_layout("phase", "8x384xi16"))
    got = _in_copy(root, (
        "import json, numpy as np, torch\n"
        "from velocycle_tpu_torch.ops import nb_kernels as K\n"
        f"d = np.load({str(tmp_path / 'inputs.npz')!r})\n"
        "S, nu, zeta, cf, r = (torch.as_tensor(d[f'arr_{i}']) for i in range(5))\n"
        "S = S.to(torch.int16)\n"
        "nu.requires_grad_(True)\n"
        "loss = K.nb_loglik_fused(S, nu, zeta, cf, r)\n"
        "(g,) = torch.autograd.grad(loss, nu)\n"
        "print(json.dumps({'layout': list(K.phase_layout()), "
        "'loss': float(loss), 'dnu': g.tolist()}))"))
    assert got["layout"][1:3] == [384, 8]
    jl, jg = jax.value_and_grad(j_fused, argnums=1)(
        *(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(got["loss"], float(jl), rtol=5e-4)
    np.testing.assert_allclose(np.asarray(got["dnu"]), np.asarray(jg),
                               rtol=5e-4, atol=5e-4 * float(jnp.abs(jg).max()))


def test_the_tool_raises_without_a_card(monkeypatch, ladder_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KL.measure_phase(16, 256, "i16")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KL.measure_velo(4, 256, "f32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KL.main(["phase", "16x256xi16", "32x256xi16"])
    assert not ladder_dir.exists()
