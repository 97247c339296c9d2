"""Smoke-mode switch for the port's example scripts.

``VCT_SMOKE=1 python velocycle_tpu_torch/examples/01_... .py`` shrinks data
sizes and step counts so that every workflow finishes in seconds;
tests/test_torch_examples.py runs each example this way on the CPU, so API
drift breaks the tests instead of the workflows.
"""
import os

SMOKE = os.environ.get("VCT_SMOKE") == "1"


def sz(full, tiny):
    """Pick the full-size value, or the tiny one under VCT_SMOKE=1."""
    return tiny if SMOKE else full
