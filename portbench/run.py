"""Run one cell of ``BENCHMARK.json`` on the card and print its result:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It measures ``ndzip_tpu_torch`` through its
public entry points (see ``harness``). The last line on stdout is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with the plain reference beside its limit, which also end stderr.

It exits nonzero and prints no result without as many CUDA devices as the
cell asks for, without the program, or when JAX or the JAX package was
loaded; there is no CPU fallback.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout: the program and the benchmark as packages


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; the workloads are {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.set_num_threads(2)

    import ndzip_tpu_torch

    from portbench import harness

    result = harness.run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), ndzip_tpu_torch)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules that the run may not load were loaded: {loaded}", file=sys.stderr)
        return 4
    for note in result.notes:
        print(f"note: {note}", file=sys.stderr)
    print(f"compression ratio (stream bytes / field bytes, mean over the window's compress calls): {result.ratio}")
    line = {"correct": result.correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": result.metrics, "device": result.device}
    if result.breakdown is not None:
        line["breakdown"] = result.breakdown
    line["checks"] = result.checks
    sys.stdout.flush()
    for name, c in result.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
