"""Run one cell of the benchmark and print its result as the last line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (`harness`).  The numbers the
check compared are printed beside their limits as the last lines on
standard error and under the result's last key, ``checked``.  Exits
non-zero, printing no result, without enough cards, or where the process
holds JAX or the JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _power_line():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi not read: {e}"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)   # starts the allocator whose peak is read
    torch.cuda.reset_peak_memory_stats(device)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device, T_START)
    print(f"card (name, power limit): {_power_line()}; peaks of "
          f"{result['device']['kind']}: "
          f"{harness.counts.PEAKS.get(result['device']['kind'])}",
          file=sys.stderr)
    found = spec.forbidden_modules(sys.modules)
    if found:
        print(f"the run holds {', '.join(found)}: no result", file=sys.stderr)
        return 3
    import resource

    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    spans = {k: round(v, 3) for k, v in result.pop("spans").items()}
    print(f"host peak RSS {rss:.2f} GiB; spans (host s): {spans}",
          file=sys.stderr)
    for k, v in result["checked"].items():
        print(f"checked {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
