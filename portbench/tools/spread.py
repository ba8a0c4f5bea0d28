"""The spread of sets of runs: for each metric of the result lines given
(one JSON object per line, as run.py prints last), the median and the
distance between the first and the third quartile as a share of the median
(statistics.quantiles(values, n=4)), the spread the benchmark's bounds are
set from; then, over all the sets, the mean of the sets' spreads with each
set's run farthest from its median left out (how tight a bound may be), and
the largest compared number of each check. Lines that are not results are
skipped.

    python3 portbench/tools/spread.py set_a.jsonl [set_b.jsonl ...]
"""

import json
import statistics
import sys


def spread(values):
    """(median, (q3 - q1) / median) of `values`."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, (q3 - q1) / med


def trimmed(values):
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def read(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"metrics"' in line:
                out.append(json.loads(line))
    return out


def main(paths):
    sets = []
    for path in paths:
        runs = read(path)
        sets.append(runs)
        print(f"{path}: {len(runs)} runs, correct {sum(bool(r['correct']) for r in runs)}")
        for name in runs[0]["metrics"] if runs else ():
            vals = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if len(vals) >= 2:
                med, s = spread(vals)
                print(f"  {name}: median {med!r}, spread {s!r}, values {vals}")
    names = {n for runs in sets for r in runs for n in r["metrics"]}
    for name in sorted(names):
        per = [[r["metrics"][name]["value"] for r in runs if name in r["metrics"]] for runs in sets]
        per = [v for v in per if len(v) >= 4]
        if per:
            s = [spread(trimmed(v))[1] for v in per]
            print(f"{name}: trimmed spreads {s}, mean {statistics.mean(s)!r}")
    checks = {}
    for runs in sets:
        for r in runs:
            for k, c in r.get("checks", {}).items():
                checks.setdefault(k, []).append(c["value"])
    for k, v in checks.items():
        print(f"check {k}: max {max(v)!r} over {len(v)} runs")


if __name__ == "__main__":
    main(sys.argv[1:])
