"""The readings that a cell's limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] \
        [--out <file.jsonl>]

For each seed, in one process: the program's first steps as a run's
set-up takes them (`phase_cell.ProgramRun`), then the float64 reference,
and against it the comparison's numbers (`check.gaps`) of

  program   the port;
  control   the reference put in the program's place in the nearest
            precision below the configuration's float32: TF32 matrix
            products (`reference.phase_svi`, ``precision="tf32"``);
  float32   the reference in float32 with TF32 off, beside the control,
            to show that TF32 and not float32 arithmetic is what fails;
  half      the fault "half of the batch left out": the likelihood of the
            first half of the cells, doubled, planted in the reference;
  frozen    the fault "a step that returns its state unchanged";
  disp      the fault "an answer altered where it is produced": the
            dispersion leaf's gradient doubled, to which Adam's first
            steps are all but blind.

One JSON line per seed, the gaps and every case's readings (printed, and
appended to ``--out``; the lines a cell's limits were set from are kept in
``calibration/<cell>.jsonl``).  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {"control": dict(precision="tf32"), "float32": dict(precision="float32"),
         "half": dict(fault="half"), "frozen": dict(fault="frozen"),
         "disp": dict(fault="disp")}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import gc

    import torch

    from perfbench import check, harness, inputs, spec
    from perfbench.phase_cell import ProgramRun
    from perfbench.reference.phase_svi import follow

    if not torch.cuda.is_available():
        print("calibrate.py runs on the card", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    cfg, mix = cell.config, cell.mix
    device = torch.device("cuda", 0)
    steps = int(mix["checked_steps"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog = ProgramRun(cfg, mix, seed, device, harness.Spans())
        mine = prog.first_steps(steps)
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        made = inputs.make(cfg["data"], seed, device, unspliced=False)
        ref = follow(made, cfg["model"], mix["optimizer"], seed, steps=steps)
        line = {"workload": args.workload, "seed": seed,
                "program": check.gaps(mine, ref)}
        readings = {"program": mine, "reference": ref}
        for name, kw in CASES.items():
            readings[name] = follow(made, cfg["model"], mix["optimizer"],
                                    seed, steps=steps, **kw)
            line[name] = check.gaps(readings[name], ref)
        line["seconds"] = {"program": t1 - t0,
                           "references": time.perf_counter() - t1}
        line["readings"] = {k: vars(r) for k, r in readings.items()}
        text = json.dumps(line, default=str)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del made, ref, readings
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
