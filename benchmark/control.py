"""The control of a training cell's correctness check: the plain reference
put in the program's place and computed one precision below the
configuration's (``control`` in ``configs/<config>.json``: fp8 operands
for a bf16 configuration), read against the float32 reference exactly as
a run reads the program.  The control has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

prints one JSON line a seed: its numbers, and whether the cell's limits
pass them (they must not).  It runs at the cell's own sizes on the card,
and never in the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

import core  # noqa: E402


def readings(cell: str, seed: int, device, spec_root: str = core.ROOT,
             here: str = core.HERE, precision=None) -> dict:
    """The control's numbers of ``cell`` at ``seed``."""
    import compare

    sp = core.spec(spec_root)
    w = core.workload(sp, cell)
    cfg = core.config(w["config"], here)
    tr = core.traffic(w["traffic"], here)
    out = _trained(cfg, tr, seed, device, precision or cfg["control"])
    ok, _ = compare.checks(out, core.limits(cell, here))
    return {"seed": seed, "passes_limits": ok, "readings": {
        k: v for k, v in out.items() if not k.startswith("_")},
        "at": out.get("_at")}


def _trained(cfg, tr, seed, device, precision) -> dict:
    """A training cell's control: the reference one precision down in
    the program's place, the float32 reference following its verbs and
    its gt-branch nouns."""
    import torch

    import compare
    import seeded
    from reference import nets
    from reference import train as ref_train

    h = cfg["head"]
    big, checked = tr["batch"], tr["checked_steps"]
    rows, window = cfg["store"]["rows"], cfg["image"]["window"]
    nets.strict_f32()
    ts = seeded.train_set(seed, h)
    counts = seeded.role_counts(ts)
    tables = tuple(t.to(device)
                   for t in nets.role_tables(ts, h["max_roles"])[3:])
    first = seeded.first_rows(seed, checked, big, rows)
    batches = [{k: torch.as_tensor(v).to(device) for k, v in seeded.batch(
        seed, s, big, rows, counts, h["num_labels"], h["max_roles"],
        distinct=first[s]).items()} for s in range(checked)]
    st = seeded.store(seed, rows, window, device)
    bb, head = seeded.weights(cfg, seed, device)
    tseed = seed % (1 << 31)
    low = ref_train.steps(cfg, tables, bb, head, batches, lambda i: st[i],
                          tseed, nets.Precision(precision))
    ref = ref_train.steps(cfg, tables, bb, head, batches, lambda i: st[i],
                          tseed, nets.Precision("f32"),
                          choices=low["choices"],
                          gt_choices=low["gt_choices"])
    return compare.training(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(args.workload, seed, dev, precision=args.precision)
        got["seconds"] = time.perf_counter() - t0
        print(json.dumps(got), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
