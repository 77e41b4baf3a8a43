"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration
(``benchmark/configs/<config>.json``), whose ``backbone.kind`` is the
plain reference's backbone (``benchmark/reference/backbones/<kind>.py``),
and a traffic mix (``benchmark/traffic/<traffic>.json``), whose ``kind``
is the driver that runs it (``benchmark/drivers/<kind>.py``).  The driver
builds the program's system under test from the seed, warms every shape
the cell uses, measures for ``--seconds``, then checks what the timed
path produced against the plain reference (``benchmark/reference/``)
within the cell's limits (``benchmark/limits/<cell>.json``).

With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each read by its own reader
(``benchmark/metrics/<metric>.py``) from a profiler trace of a sub-window,
the program's counters and the benchmark's own counts of work.  The last
line of standard output is the result:

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}

The run needs a CUDA card (it exits 2 without one, printing no result),
and it exits 3, printing no result, if JAX, flax or the JAX package was
loaded, or if the reference holds anything of the program.  A
configuration whose backbone kind has no file ends the run before it
starts (exit 1, the fault on standard error, no result).  ``--fault``
breaks the timed path on purpose (the fault checks of
``benchmark/tests/`` and the faults' readings on the card); ``--device
cpu`` runs a cell on the CPU, for those tests only.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import core  # noqa: E402


def _cache_dirs() -> None:
    """Every compiler cache the program might write at a fixed path inside
    the checkout (the kernels it builds go to its own ``build/``)."""
    base = os.path.join(ROOT, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(base, sub)
    # a library the program may pull in must not load JAX by itself
    os.environ["USE_FLAX"] = "0"


class Context:
    """What a driver is handed: the cell's files, the run's arguments and
    the device, and the hooks that mark the window."""

    def __init__(self, args, cell, config, traffic, limits, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.limits, self.device = limits, device
        self.seed, self.seconds = args.seed, args.seconds
        self.trace, self.fault = bool(args.trace), args.fault
        self.t_window = None

    def phase(self, what: str) -> None:
        print(f"[bench] t={time.perf_counter() - T_START:.1f}s {what}",
              file=sys.stderr, flush=True)

    def window_started(self, t: float) -> None:
        self.t_window = t
        self.phase("window opens")

    def window_closed(self) -> None:
        self.phase("window closed")


class ReaderContext:
    """What a per-layer metric's reader is handed."""

    def __init__(self, cell, config, traffic, counters, red, card):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.counters, self.trace, self.card = counters, red, card
        self.peaks = core.peaks(card["kind"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    _cache_dirs()
    sp = core.spec()
    cell = core.workload(sp, args.workload)
    cfg = core.config(cell["config"])
    fault = core.backbone_fault(cell["config"], cfg)
    if fault:
        raise SystemExit(fault)
    tr = core.traffic(cell["traffic"])
    lim = core.limits(cell["name"])

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"[bench] {cell['name']} needs {cell['chips']} CUDA "
                  f"card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        card = core.card()
    else:
        dev = torch.device("cpu")
        card = {"platform": "cpu", "kind": "cpu", "count": 1,
                "power_limit_w": None}
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    ctx = Context(args, cell, cfg, tr, lim, dev)
    ctx.phase(f"{cell['name']} seed {args.seed} on {card['kind']} "
              f"({card.get('power_limit_w')} W)")
    driver = core.driver(tr["kind"])
    result, e2e, counters, red, peak, checks = driver.run(ctx)

    names = core.cell_metrics(sp, cell["name"], "per_layer" if args.trace
                              else "end_to_end")
    metrics = {}
    if args.trace:
        rctx = ReaderContext(cell, cfg, tr, counters, red, card)
        for m in names:
            value = core.metric_reader(m["name"]).read(rctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e["setup_s"] = (ctx.t_window - T_START, "s")
        for m in names:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]][0],
                                      "unit": m["unit"]}
    device = {**card, "memory_peak_bytes": int(peak)}
    out = {**result, "metrics": metrics, "device": device}
    if args.trace and red is not None:
        device["busy_s"], device["window_s"] = red["busy_s"], red["window_s"]
        out["breakdown"] = red["breakdown"]
    found = core.forbidden_loaded() + core.reference_borrowed()
    if found:
        print(f"[bench] forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    core.emit(out, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
