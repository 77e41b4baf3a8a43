"""The harness's common parts: the spec (``BENCHMARK.json``) and the files
it names, the checks of names and units, the result line, the card's
description, the peaks, and the look for JAX among the loaded modules.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by its name:

* ``configs/<config>.json`` — the configuration, its source and cuts;
* ``traffic/<traffic>.json`` — a traffic mix: its ``kind`` (the driver in
  ``drivers/<kind>.py`` that runs it) and its parameters;
* ``limits/<workload>.json`` — the limits of a cell's correctness check;
* ``metrics/<metric>.py`` — a per-layer metric's reader, ``read(ctx)``,
  which returns a number or None (nothing to read).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC_FILE = "BENCHMARK.json"

#: top-level module names no run may load (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "situation_recognition_tpu")
#: the measured program's package
PROGRAM = "situation_recognition_tpu_torch"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")

#: dense bf16 tensor-core peak (FLOP/s) and HBM bandwidth (B/s) by a
#: substring of the card's name (NVIDIA's data sheets, no sparsity)
PEAKS = (("H100 80GB HBM3", 989e12, 3.35e12), ("H100 SXM", 989e12, 3.35e12),
         ("H100 PCIe", 756e12, 2.0e12))


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(root, SPEC_FILE)


def workload(sp: dict, name: str) -> dict:
    for w in sp["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in {SPEC_FILE}; one of "
                     f"{[w['name'] for w in sp['workloads']]}")


def config(name: str, here: str = HERE) -> dict:
    return load_json(here, "configs", name + ".json")


def traffic(name: str, here: str = HERE) -> dict:
    return load_json(here, "traffic", name + ".json")


def limits(cell: str, here: str = HERE) -> dict:
    return load_json(here, "limits", cell + ".json")


def load_file(path: str, name: str):
    """A module from a file whose name need not be an identifier."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(kind: str, here: str = HERE):
    return load_file(os.path.join(here, "drivers", kind + ".py"),
                     "bench_driver_" + kind.replace("-", "_"))


def metric_reader(name: str, here: str = HERE):
    return load_file(os.path.join(here, "metrics", name + ".py"),
                     "bench_metric_" + re.sub(r"\W", "_", name))


def cell_metrics(sp: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``cell`` reports."""
    return [m for m in sp[section]
            if "workloads" not in m or cell in m["workloads"]]


def validate(sp: dict, here: str = HERE) -> list:
    """The faults of a spec against the contract's shape and the files it
    names (empty when there are none)."""
    bad = []

    def name_ok(x, what):
        if not isinstance(x, str) or not NAME.match(x):
            bad.append(f"{what} {x!r} is not a name")

    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(sp) != keys:
        bad.append(f"keys {sorted(set(sp) ^ keys)} differ")
    configs = {c["name"] for c in sp.get("configs", [])}
    for c in sp.get("configs", []):
        name_ok(c["name"], "config")
        for k in c.get("reduced", []):
            name_ok(k, "reduced key")
        if not os.path.exists(os.path.join(os.path.dirname(here), c["file"])):
            bad.append(f"config file {c['file']} is missing")
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c['name']} has keys {sorted(c)}")
    used = set()
    for w in sp.get("workloads", []):
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        name_ok(w["config"], "config")
        if w["config"] not in configs:
            bad.append(f"workload {w['name']}: no config {w['config']}")
        if (w["config"], w["traffic"]) in used:
            bad.append(f"workload {w['name']} repeats a pair")
        used.add((w["config"], w["traffic"]))
        if w.get("chips") not in (1, 4):
            bad.append(f"workload {w['name']}: chips {w.get('chips')}")
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w['name']} has keys {sorted(w)}")
        if len(w["why"]) > 200:
            bad.append(f"workload {w['name']}: why is over 200 characters")
        for part, path in (("traffic", ("traffic", w["traffic"] + ".json")),
                           ("limits", ("limits", w["name"] + ".json"))):
            if not os.path.exists(os.path.join(here, *path)):
                bad.append(f"workload {w['name']}: no {part} file")
        if os.path.exists(os.path.join(here, "traffic",
                                       w["traffic"] + ".json")):
            kind = traffic(w["traffic"], here)["kind"]
            if not os.path.exists(os.path.join(here, "drivers",
                                               kind + ".py")):
                bad.append(f"traffic {w['traffic']}: no driver {kind}")
    cells = {w["name"] for w in sp.get("workloads", [])}
    seen = set()
    e2e = {m["name"] for m in sp.get("end_to_end", [])}
    for section in ("end_to_end", "per_layer"):
        for m in sp.get(section, []):
            name_ok(m["name"], "metric")
            if m["name"] in seen:
                bad.append(f"metric {m['name']} repeats")
            seen.add(m["name"])
            if not UNIT.match(m.get("unit", "")):
                bad.append(f"metric {m['name']}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                bad.append(f"metric {m['name']}: better {m.get('better')}")
            if m.get("source") not in SOURCES:
                bad.append(f"metric {m['name']}: source {m.get('source')}")
            for c in m.get("workloads", []):
                if c not in cells:
                    bad.append(f"metric {m['name']}: no workload {c}")
            if section == "per_layer":
                if m.get("moves") not in e2e:
                    bad.append(f"metric {m['name']}: moves {m.get('moves')}")
                if not os.path.exists(os.path.join(
                        here, "metrics", m["name"] + ".py")):
                    bad.append(f"metric {m['name']}: no reader file")
            elif not 0.01 <= m.get("bound", 0) <= 0.25:
                bad.append(f"metric {m['name']}: bound {m.get('bound')}")
    return bad


# ----------------------------------------------------------- the device


def card() -> dict:
    """The card of this run: name, count and power limit (W)."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1}
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.splitlines()[0]
        out["power_limit_w"] = float(line)
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        out["power_limit_w"] = None
    return out


def peaks(kind: str):
    """(bf16 FLOP/s, bytes/s) of the card called ``kind``, or None."""
    for key, flops, nbytes in PEAKS:
        if key in kind:
            return flops, nbytes
    return None


def forbidden_loaded() -> list:
    """The forbidden top-level names among ``sys.modules``."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def reference_borrowed() -> list:
    """What the loaded modules of ``benchmark/reference/`` hold of the
    program or of JAX: every module, class or function in their globals
    whose module's top-level name is forbidden or the program's."""
    bad = set(FORBIDDEN) | {PROGRAM}
    found = []
    for name, mod in list(sys.modules.items()):
        if name.split(".", 1)[0] != "reference" or mod is None:
            continue
        for key, v in vars(mod).items():
            owner = v.__name__ if isinstance(v, type(sys)) else getattr(
                v, "__module__", None)
            if isinstance(owner, str) and owner.split(".", 1)[0] in bad:
                found.append(f"{name}.{key} ({owner})")
    return sorted(found)


# ------------------------------------------------------------ the result


def emit(result: dict, checks: dict) -> None:
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line (``checks`` last in it) as the
    last line of standard output."""
    for name, c in checks.items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
