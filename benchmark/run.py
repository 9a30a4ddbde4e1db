"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Run from the root of a checkout.  The last line on stdout is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit); the last lines on stderr are the same checks.
A cell on several cards runs one process per card: this one is rank 0,
starts the others (``--rank`` and ``--port``, for them alone), and
waits for them.  Without a CUDA card, or with fewer cards than the cell
asks for, the run exits with code 2 and prints no result.  It also
exits non-zero, with no result, if a rank fails or if JAX or the JAX
package has been loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# this folder's own names must not shadow modules: import the harness as
# the package ``benchmark`` from the checkout's root
sys.path[:] = [ROOT] + [p for p in sys.path
                        if os.path.abspath(p or ".") != BENCH]
# libraries that could load JAX by themselves are kept from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import harness, program, ranks

    cell = harness.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {have}: no run", file=sys.stderr)
        return 2
    program.use_build_cache()
    others = []
    port = args.port
    if cell.chips > 1 and args.rank == 0:
        own = sys.argv[1:] if argv is None else list(argv)
        port = ranks.free_port()
        others = ranks.start(os.path.abspath(__file__), own, cell.chips,
                             port)
    device = torch.device("cuda", args.rank)
    out = sys.stdout
    try:
        if cell.chips > 1:
            ranks.join(args.rank, cell.chips, port, device)
        with contextlib.redirect_stdout(sys.stderr):
            result = harness.run(cell, args.seed, args.seconds,
                                 bool(args.trace), device, PROCESS_START)
    finally:
        ranks.leave()
        failed = [r for r, rc in enumerate(ranks.wait(others), 1) if rc]
    if failed:
        print(f"[bench] rank(s) {failed} failed: no result", file=sys.stderr)
        return 4
    if args.rank:
        return 0
    found = harness.forbidden_modules()
    if found:
        print(f"[bench] forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
