"""The control of the benchmark's comparison: the plain reference put in the
program's place, on each field rounded to the nearest lower precision
(bfloat16 for float32, float32 for float64), so that it breaks the lossless
guarantee the configurations state. Every run of it has to come out not
correct; the numbers it reads are the upper readings of the limits.

    python3 portbench/control.py --workload <name> --seeds <n> ... --seconds <s> [--sound]

runs a short window of the cell per seed on the card with the control in the
program's place and prints each run's checks as a JSON line; with
``--sound`` the program's own runs of the same seeds follow in the same
process (the lower readings). The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import codec as reference  # noqa: E402

LOWER = {torch.float32: torch.bfloat16, torch.float64: torch.float32}


class ControlEntry:
    """The reference in the program's place, a precision below the
    configuration's; it takes and gives what the mix's own entry does
    (device tensors, or host arrays for ``offload``)."""

    def __init__(self, cfg, device, host: bool):
        self.device, self.host = device, host
        self.dtype = getattr(torch, cfg["dtype"])

    def prepare(self, x):
        return x.cpu().numpy() if self.host else x

    def compress(self, x):
        x = torch.from_numpy(x).to(self.device) if self.host else x
        low = x.to(LOWER[self.dtype]).to(self.dtype)
        stream, length = reference.encode(harness.as_words(low, self.device).reshape(x.shape))
        n = int(length)
        return (stream[:n].cpu().numpy().view(np.uint32), n) if self.host else (stream[:n], n)

    def decompress(self, stream, like):
        s = harness.as_words(stream, self.device)
        out = reference.decode(s, like.shape, like.element_size() * 8).view(like.dtype)
        return out.cpu().numpy() if self.host else out


def control_factory(mix: dict):
    return lambda program, cfg, device: ControlEntry(cfg, device, host=mix["entry"] == "offload")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sound", action="store_true", help="run the program on the same seeds after the control")
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    if not torch.cuda.is_available():
        print("the control runs on the card: no CUDA device", file=sys.stderr)
        return 3
    import ndzip_tpu_torch

    device = torch.device("cuda", 0)
    factory = control_factory(harness.load_mix(cell["traffic"]))
    sides = [("control", factory)] + ([("program", None)] if args.sound else [])
    for side, entry_factory in sides:
        for seed in args.seeds:
            r = harness.run_cell(bench, cell, seed, args.seconds, False, device, ndzip_tpu_torch,
                                 entry_factory=entry_factory)
            print(json.dumps({"side": side, "workload": args.workload, "seed": seed, "correct": r.correct,
                              "attempted": r.attempted, "ratio": r.ratio,
                              "checks": {k: v["value"] for k, v in r.checks.items()}}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
