"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \\
        [--candidate control:7,8,9] [--candidate g_half_batch:7,8,9] \\
        [--out FILE]

For each of ``--seeds``: the program through the cell's own path at the
cell's sizes (frames: one cycle of the mix, then the same sample a run
checks; training: the checked steps), judged by the reference.  For
each ``--candidate NAME:SEEDS``: that candidate in the program's place,
judged the same way: ``control`` (the reference in fp8), or for
training a planted fault of ``drivers/gan_train.CANDIDATES``.  One JSON
line per reading on stdout (and appended to ``--out``).  Needs a CUDA
card.
"""

import argparse
import json
import os
import sys
import time

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != BENCH]


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--candidate", action="append", default=[],
                    help="NAME:SEEDS, e.g. control:7,8,9")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import harness, program, traffic

    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA card", file=sys.stderr)
            return 2
        program.use_build_cache()
    kind = cell.traffic["kind"]
    driver_cls = harness.driver(kind)
    jobs = [("program", s) for s in args.seeds]
    for c in args.candidate:
        name, seeds = c.split(":", 1)
        jobs += [(name, s) for s in _seeds(seeds)]
    for what, seed in jobs:
        t0 = time.perf_counter()
        drv = driver_cls(cell.config, cell.traffic, seed, device,
                         build_program=what == "program")
        if what == "program" and kind == "frames":
            drv.run(None, count=len(traffic.frame_cycle(cell.traffic)))
        drv.free_program()
        numbers = drv.check() if what == "program" else drv.candidate(what)
        line = json.dumps({"workload": cell.name, "reading": what,
                           "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del drv
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
