"""Traffic kind ``train_epoch``: the program's ``Trainer.train_epoch`` over
a window-cached store, as the CLI trains with ``--cache_device``.

Set-up builds one trainer from the seed's weights and vocabulary, drives
it through the checked first steps (one ``train_epoch`` call each, on
rows that all differ, through the same loader and upload as the window),
reads what the comparison needs from its state, warms the pipelined
epoch on a few more batches, and hands the same trainer to the window.
The window is one ``train_epoch`` over a loader that stops making batches
once ``--seconds`` have passed; its return ends the window.  Once the
window has closed, the program is freed and the reference follows the
first steps from the same weights, batches and dropout streams.

Parameters (``traffic/<name>.json``): ``batch`` rows a step,
``checked_steps`` (3), ``warm_batches``, ``trace_skip`` and
``trace_steps`` (the profiled sub-window of a ``--trace 1`` run).
"""

from __future__ import annotations

import gc
import time

import numpy as np

import compare
import seeded
import devtrace

#: the stream index of the window's batches (the checked steps are 0..)
WINDOW_BATCHES = 1000


class Store:
    """The window store as the trainer's window cache reads it."""

    window_cached = True

    def __init__(self, host: np.ndarray):
        self.window_cache = host


class Loader:
    """Batches ``make(0), make(1), ...``: ``n`` of them, or until
    ``deadline`` (host clock) when asked for the next."""

    def __init__(self, dataset, make, n=None, deadline=None):
        self.dataset, self.make = dataset, make
        self.n, self.deadline = n, deadline
        self.count = 0

    def __iter__(self):
        b = 0
        while (self.n is None or b < self.n) and (
                self.deadline is None or time.perf_counter() < self.deadline):
            yield self.make(b)
            b += 1
            self.count = b


def _edges(counts: np.ndarray, verbs: np.ndarray, r: int) -> int:
    """Nonzeros of the role graphs of ``verbs``: c(c-1) between the c real
    roles, one self-edge on each pad slot."""
    c = counts[verbs]
    return int((c * (c - 1) + (r - c)).sum())


def _faulty(trainer, fault: str) -> None:
    """Break the timed path underneath (the fault checks only)."""
    import torch

    if fault == "unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        step = trainer.accum_step

        def half(images, flip, verbs, labels, valid, first):
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = 0
            return step(images, flip, verbs, labels, valid, first)

        trainer.accum_step = half
    elif fault == "altered":
        predict = trainer.head.predict_train

        def altered(*a, **k):
            verb, nouns = predict(*a, **k)
            return verb, torch.cat([torch.zeros_like(nouns[:, :1]),
                                    nouns[:, 1:]], dim=1)

        trainer.head.predict_train = altered
    elif fault == "altered_gt":
        # the gt-verb branch alone: the head's noun branch run without a
        # gradient (the differentiated one runs with it)
        nouns_of = trainer.head.predict_nouns

        def altered_gt(*a, **k):
            nouns = nouns_of(*a, **k)
            if torch.is_grad_enabled():
                return nouns
            return torch.cat([torch.zeros_like(nouns[:, :1]),
                              nouns[:, 1:]], dim=1)

        trainer.head.predict_nouns = altered_gt
    elif fault:
        raise ValueError(f"no fault {fault!r} for train_epoch")


def run(ctx) -> tuple:
    import torch

    from reference import nets
    from reference import train as ref_train
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    h, bcfg, opt = cfg["head"], cfg["backbone"], cfg["optimizer"]
    big, checked = tr["batch"], tr["checked_steps"]
    rows, window = cfg["store"]["rows"], cfg["image"]["window"]
    seed = ctx.seed
    # the trainer's dropout streams take a seed of 31 bits
    tseed = seed % (1 << 31)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    ts = seeded.train_set(seed, h)
    counts = seeded.role_counts(ts)
    encoder = ImsituEncoder(ts, verbose=False)
    got_sizes = (encoder.get_num_verbs(), encoder.get_num_roles(),
                 encoder.get_num_labels(), encoder.max_role_count)
    want = (h["num_verbs"], h["num_roles"], h["num_labels"], h["max_roles"])
    if got_sizes != want:
        raise RuntimeError(f"vocabulary {got_sizes}, configuration {want}")
    bb, head = seeded.weights(cfg, seed, dev)
    tc = TrainerConfig(
        hidden=h["hidden"], lr=opt["lr"], batch_size=big,
        num_ggnn_steps=h["ggnn_steps"], dropout_rate=h["dropout"],
        backbone=bcfg["port_name"], image_size=cfg["image"]["crop"],
        compute_dtype=getattr(torch, cfg["compute_dtype"]), seed=tseed,
        train_backbone=bcfg["train"],
        remat_backbone=bcfg.get("remat", False),
        frozen_backbone_bn=bcfg.get("bn", "train"))
    trainer = Trainer(encoder, tc, device=dev, backbone_state=bb,
                      head_state=head)
    del bb, head
    d = trainer.optimizer.defaults
    if (tuple(d["betas"]), d["eps"]) != (tuple(opt["betas"]), opt["eps"]):
        raise RuntimeError(f"the trainer's Adamax {d} is not the "
                           f"configuration's {opt}")
    st = seeded.store(seed, rows, window, dev)
    ds = Store(st.cpu().numpy())
    del st
    _faulty(trainer, ctx.fault)
    ctx.phase("trainer built, store made")

    # ---- the checked first steps, one train_epoch each
    first = seeded.first_rows(seed, checked, big, rows)
    make = lambda b: seeded.batch(seed, b, big, rows, counts,  # noqa: E731
                                  h["num_labels"], h["max_roles"],
                                  distinct=first[b])
    choices, gt_choices = [], []

    def capture(top1, top5, host_topk, verbs, labels):
        choices.append(torch.as_tensor(np.asarray(host_topk[0])[:, 0]))
        gt_choices.append(torch.as_tensor(np.asarray(host_topk[2])[..., 0]))
        Trainer._score(top1, top5, host_topk, verbs, labels)

    trainer._score = capture
    named = [("head." + n, p) for n, p in trainer.head.named_parameters()]
    if bcfg["train"]:
        named += [("backbone." + n, p)
                  for n, p in trainer.backbone.named_parameters()]
    got = {"losses": []}
    b1 = opt["betas"][0]
    for s in range(checked):
        one = Loader(ds, lambda b, s=s: make(s), n=1)
        _, _, losses = trainer.train_epoch(one, epoch=0)
        got["losses"].append([float(x) for x in losses])
        if s == 0:
            state = trainer.optimizer.state
            got["grad"] = {n: float(state[p]["exp_avg"].norm() / (1 - b1))
                           if p in state else 0.0 for n, p in named}
    # the start drawn again on the card (a few calls; cheaper than a kept
    # copy, which would sit in the window's memory)
    bb0, head0 = seeded.weights(cfg, seed, dev)
    start = {**{"head." + k: v for k, v in head0.items()},
             **{"backbone." + k: v for k, v in bb0.items()}}
    with torch.no_grad():
        got["delta_t"] = {n: (p.float() - start[n]).cpu() for n, p in named}
    del bb0, head0, start
    del trainer._score
    ctx.phase(f"{checked} checked steps")

    # ---- warm the pipelined epoch, then the window
    warm = lambda b: seeded.batch(seed, WINDOW_BATCHES + b,  # noqa: E731
                                  big, rows, counts, h["num_labels"],
                                  h["max_roles"])
    trainer.train_epoch(Loader(ds, warm, n=tr["warm_batches"]), epoch=0)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    edges = []

    def timed(b):
        out = warm(tr["warm_batches"] + b)
        edges.append(_edges(counts, out["verbs"], h["max_roles"]))
        return out

    prof = None
    if ctx.trace:
        prof = _profiled(trainer, tr["trace_skip"], tr["trace_steps"], sync)
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    ctx.window_started(t0)
    loader = Loader(ds, timed, deadline=t0 + ctx.seconds)
    _, _, losses = trainer.train_epoch(loader, epoch=1)
    sync()
    t1 = time.perf_counter()
    ctx.window_closed()
    steps = loader.count
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    finite = bool(np.all(np.isfinite(losses)))
    result = {"correct": False, "attempted": steps,
              "failed": 0 if finite else steps}
    e2e = {"train_img_s": (steps * big / (t1 - t0), "img/s"),
           "train_peak_gb": (peak / 1e9, "GB")}
    counters = {"steps": steps, "batch": big, "window_s": t1 - t0,
                "k1_rows": big * h["max_roles"],
                "k1_edges": float(np.mean(edges)) if edges else 0.0}
    red = None
    if prof is not None:
        red = prof.finish()
    ctx.phase(f"window: {steps} steps in {t1 - t0:.2f} s")

    # ---- free the program, then the reference
    del trainer, loader, ds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nets.strict_f32()
    bb, head = seeded.weights(cfg, seed, dev)
    st = seeded.store(seed, rows, window, dev)
    tables = tuple(t.to(dev) for t in nets.role_tables(ts, h["max_roles"])[3:])
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in make(s).items()}
               for s in range(checked)]
    ref = ref_train.steps(cfg, tables, bb, head, batches, lambda i: st[i],
                          tseed, nets.Precision("f32"), choices=choices,
                          gt_choices=gt_choices)
    del bb, head, st
    readings = compare.training(got, ref)
    ok, checks = compare.checks(readings, ctx.limits)
    ctx.phase(f"reference done; worst leaves {readings['_at']}")
    result["correct"] = bool(ok and finite)
    return result, e2e, counters, red, peak, checks


class _profiled:
    """A profiler over steps ``skip`` .. ``skip + n`` of the window, started
    and stopped around the trainer's step call on the main thread."""

    def __init__(self, trainer, skip: int, n: int, sync):
        import torch

        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.sync, self.on, self.t = sync, False, [None, None]
        step = trainer.accum_step
        count = [0]

        def wrapped(*a, **k):
            if count[0] == skip:
                self.prof.start()
                self.on = True
                self.t[0] = time.perf_counter()
            elif count[0] == skip + n:
                self._stop()
            count[0] += 1
            return step(*a, **k)

        trainer.accum_step = wrapped

    def _stop(self):
        if self.on:
            self.sync()
            self.t[1] = time.perf_counter()
            self.prof.stop()
            self.on = False

    def finish(self):
        """The reduced trace, or None if the sub-window never opened."""
        self._stop()
        if self.t[0] is None:
            return None
        return devtrace.reduce(self.prof, self.t[1] - self.t[0])
