"""Tabulate and plot the benchmark's CSV: the port's own copy of
``ndzip_tpu/plot_benchmark.py``, after the reference's
``src/benchmark/plot_benchmark.py``.

Reads the CSV of ``python -m ndzip_tpu_torch.benchmark`` (or of the JAX
package's harness, or of the reference's) from a file or stdin and gives:

* a table with the arithmetic-mean throughput over datasets and its 95%
  interval, for compression and decompression (plot_benchmark.py:40-54);
* with ``--plot PREFIX``, a throughput-against-ratio scatter per algorithm
  (plot_benchmark.py:69-133) and, where an algorithm ran at several thread
  counts, a thread-scaling plot (plot_benchmark.py:134+). matplotlib is
  imported only then, so the table needs nothing beyond the standard
  library.

Throughput = uncompressed bytes / mean rep time (plot_benchmark.py:40-47);
compression ratio = compressed bytes / uncompressed bytes (lower better).
"""

from __future__ import annotations

import argparse
import math
import sys
from collections import defaultdict
from dataclasses import dataclass


@dataclass
class Row:
    dataset: str
    dtype: str
    dims: int
    algorithm: str
    tunable: str
    threads: int
    comp_times: list[float]    # seconds
    decomp_times: list[float]  # seconds
    uncompressed: int
    compressed: int

    @property
    def key(self):
        return f"{self.algorithm}[{self.tunable}]x{self.threads}"

    @property
    def ratio(self):
        return self.compressed / self.uncompressed

    def throughput(self, times):
        return self.uncompressed / (sum(times) / len(times))


def _parse_times(cell: str) -> list[float]:
    """Rep-time lists are comma-joined (benchmark.cc:1335); also accept the
    legacy quoted semicolon-joined form emitted before round 2."""
    cell = cell.strip().strip('"')
    sep = "," if "," in cell else ";"
    return [int(x) / 1e6 for x in cell.split(sep) if x]


def read_rows(fh) -> list[Row]:
    rows = []
    header = fh.readline()
    assert header.startswith("dataset"), "not a benchmark CSV"
    for line in fh:
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # quoted time lists contain ';' — split carefully
        parts, cur, inq = [], [], False
        for ch in line:
            if ch == '"':
                inq = not inq
            elif ch == ";" and not inq:
                parts.append("".join(cur))
                cur = []
            else:
                cur.append(ch)
        parts.append("".join(cur))
        rows.append(Row(parts[0], parts[1], int(parts[2]), parts[3], parts[4],
                        int(parts[5]), _parse_times(parts[6]),
                        _parse_times(parts[7]), int(parts[8]), int(parts[9])))
    return rows


def mean_ci95(values: list[float]) -> tuple[float, float]:
    n = len(values)
    m = sum(values) / n
    if n < 2:
        return m, 0.0
    var = sum((v - m) ** 2 for v in values) / (n - 1)
    return m, 1.96 * math.sqrt(var / n)


def summarize(rows: list[Row]):
    """Group rows by algorithm config; average over datasets."""
    groups: dict[str, list[Row]] = defaultdict(list)
    for r in rows:
        groups[r.key].append(r)
    table = []
    for key, rs in sorted(groups.items()):
        comp_tp = [r.throughput(r.comp_times) for r in rs]
        dec_tp = [r.throughput(r.decomp_times) for r in rs]
        ratios = [r.ratio for r in rs]
        cm, cci = mean_ci95(comp_tp)
        dm, dci = mean_ci95(dec_tp)
        table.append((key, len(rs), sum(ratios) / len(ratios), cm, cci, dm, dci))
    return table


def print_table(table, out=sys.stdout):
    print(f"{'algorithm':<28} {'n':>3} {'ratio':>7} "
          f"{'comp GB/s':>12} {'±95%':>8} {'decomp GB/s':>12} {'±95%':>8}", file=out)
    for key, n, ratio, cm, cci, dm, dci in table:
        print(f"{key:<28} {n:>3} {ratio:>7.4f} "
              f"{cm / 1e9:>12.3f} {cci / 1e9:>8.3f} "
              f"{dm / 1e9:>12.3f} {dci / 1e9:>8.3f}", file=out)


def plot(rows: list[Row], out_prefix: str):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    table = summarize(rows)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    for ax, (label, idx) in zip(axes, [("compression", 3), ("decompression", 5)]):
        for entry in table:
            key, _, ratio = entry[0], entry[1], entry[2]
            tp = entry[idx] / 1e9
            ax.scatter(ratio, tp, label=key)
            ax.annotate(key, (ratio, tp), fontsize=7,
                        xytext=(3, 3), textcoords="offset points")
        ax.set_xlabel("compressed/uncompressed ratio (lower = better)")
        ax.set_ylabel(f"{label} throughput (GB/s)")
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3)
        ax.set_title(label)
    fig.tight_layout()
    path = f"{out_prefix}_throughput_ratio.png"
    fig.savefig(path, dpi=150)
    print(f"wrote {path}", file=sys.stderr)

    # thread scaling (if multiple thread counts exist for an algorithm)
    by_algo_threads = defaultdict(dict)
    for r in rows:
        by_algo_threads[f"{r.algorithm}[{r.tunable}]"].setdefault(
            r.threads, []).append(r)
    multi = {k: v for k, v in by_algo_threads.items() if len(v) > 1}
    if multi:
        fig, ax = plt.subplots(figsize=(7, 5))
        for algo, per_t in sorted(multi.items()):
            ts = sorted(per_t)
            tps = [sum(r.throughput(r.comp_times) for r in per_t[t]) /
                   len(per_t[t]) / 1e9 for t in ts]
            ax.plot(ts, tps, marker="o", label=algo)
        ax.set_xlabel("threads")
        ax.set_ylabel("compression throughput (GB/s)")
        ax.legend()
        ax.grid(True, alpha=0.3)
        path = f"{out_prefix}_thread_scaling.png"
        fig.savefig(path, dpi=150)
        print(f"wrote {path}", file=sys.stderr)


def main(argv=None):
    p = argparse.ArgumentParser(description="plot/tabulate benchmark CSV")
    p.add_argument("csv", nargs="?", help="benchmark CSV (default: stdin)")
    p.add_argument("--plot", metavar="PREFIX", default=None,
                   help="write PNG plots with this path prefix")
    args = p.parse_args(argv)
    fh = open(args.csv) if args.csv else sys.stdin
    rows = read_rows(fh)
    if not rows:
        print("no rows", file=sys.stderr)
        return 1
    print_table(summarize(rows))
    if args.plot:
        plot(rows, args.plot)
    return 0


if __name__ == "__main__":
    sys.exit(main())
