"""BENCHMARK.json against the rules of its format, and every piece it
names found by name."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = spec.benchmark()


def test_top_level_keys_and_command():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"]
    assert B["command"][1].startswith("perfbench/")
    assert 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024


@pytest.mark.parametrize("w", B["workloads"], ids=lambda w: w["name"])
def test_each_cell_names_files_that_exist(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    cell = spec.cell(w["name"])
    assert cell.config["name"] == w["config"]
    assert cell.mix["stage"] == "phase"
    assert set(cell.limits) == set(check.NUMBERS)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("c", B["configs"], ids=lambda c: c["name"])
def test_each_configuration(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("perfbench/configs/")
    with open(os.path.join(spec.ROOT, c["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert c["source"].startswith("https://")
    assert cfg["precision"] == "float32"
    assert any(w["config"] == c["name"] for w in B["workloads"])


@pytest.mark.parametrize("m", B["end_to_end"] + B["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        assert callable(spec.reader(m["name"]))
    if "bound" in m:
        assert spec.base(m["name"]) in ("svi_steps_per_s", "peak_device_gib",
                                        "setup_s")
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"
    for w in m.get("workloads", []):
        assert w in {x["name"] for x in B["workloads"]}


def test_every_name_and_file_uses_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for dirpath, dirs, files in os.walk(os.path.join(spec.ROOT, "perfbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), spec.ROOT)
            assert all(NAME.match(p) for p in rel.split("/")), rel


def test_the_command_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, *B["command"][1:], "--workload",
                          B["workloads"][0]["name"], "--seed", "3000000019",
                          "--seconds", "1", "--trace", "0"], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_command_fails_in_a_directory_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(spec.ROOT, "perfbench"),
                    tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *B["command"][1:], "--workload",
                          B["workloads"][0]["name"], "--seed", "3000000021",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_import_check_compares_whole_top_level_names():
    held = ["velocycle_tpu_torch", "velocycle_tpu_torch.fit", "numpy",
            "jaxtyping", "flaxen"]
    assert spec.forbidden_modules(held) == []
    assert spec.forbidden_modules(held + ["velocycle_tpu.ops.nb_kernels",
                                          "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "velocycle_tpu"]


def test_the_benchmark_imports_no_jax_and_the_reference_no_program():
    code = ("import sys, perfbench.harness, perfbench.calibrate, "
            "perfbench.run; from perfbench import spec; "
            "print(spec.forbidden_modules(sys.modules)); "
            "import perfbench.reference.phase_svi as r; "
            "print(sorted({m.split('.')[0] for m in sys.modules "
            "if m.startswith('velocycle')}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "[]"]
