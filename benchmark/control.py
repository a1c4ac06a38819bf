"""The control of the comparison that decides `correct`, and the
reference's readings that its limit is set from.

    python benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it writes the cell's lake as a run does, computes every
query of the mix with the plain reference in float64 and again in
float32 (the control: the nearest precision below the configuration's),
and compares the control's results with the reference's by the
benchmark's own comparison. It prints one JSON line per seed with the
numbers compared; the control must fail at least one of them. It needs
no card and uses none.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_control(root: str, cell, seed: int) -> dict:
    from benchmark import harness, spec
    from benchmark.reference.compare import compare, lower_precision, normalize

    config = cell.config
    fam = spec.load_family(config, with_builders=False)
    work = os.path.join(root, "benchmark", "_work", f"control-{cell.name}")
    shutil.rmtree(work, ignore_errors=True)
    try:
        paths = fam.generate(os.path.join(work, "lake"),
                             scale=config["generator_scale"],
                             seed=harness.data_seed(seed))
        tables = harness.lake_tables(paths)
        low = lower_precision(tables)
        wrong, gap, per_query = 0, 0.0, {}
        for q in cell.traffic["queries"]:
            want = fam.oracles[q](tables)
            v = compare(fam.oracles[q](low), want, normalize(want))
            wrong += not v.exact
            gap = max(gap, v.gap)
            per_query[q] = [v.exact, v.gap, v.reason]
        return {"seed": seed, "wrong_results": wrong, "max_rel_gap": gap,
                "per_query": per_query}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import spec

    cell = spec.find_cell(ROOT, args.workload)
    for seed in map(int, args.seeds.split(",")):
        t0 = time.perf_counter()
        out = read_control(ROOT, cell, seed)
        out["seconds"] = time.perf_counter() - t0
        out["limit"] = cell.config["limits"]["max_rel_gap"]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
