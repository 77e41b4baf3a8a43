"""Ranks of the multi-process CPU tests of the port's data and tensor
parallelism (``tests/test_torch_dist*.py``).

    python tests/torch_dist_worker.py <scenario> <rank> <world> <port> <dir>

Each rank takes one intra-op thread, joins a gloo world at
``127.0.0.1:<port>`` (``parallel.init_distributed``), runs ``<scenario>``
on the mini trainer (f32, the weights in ``<dir>/weights.pt``) and writes
what it saw to ``<dir>/<scenario>.r<rank>.pt``.  ``run_world`` starts the
ranks as subprocesses (never ``fork``: the test process holds JAX's
threads) and waits for them with a time limit.  This module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import torch

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.metrics.scorer import mean_of_eight
from situation_recognition_tpu_torch.parallel import (
    destroy, init_distributed, make_mesh)
from situation_recognition_tpu_torch.parallel.spmd import (
    make_spmd_train_step)
from situation_recognition_tpu_torch.train import (
    Preempted, Trainer, TrainerConfig)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
COMMON = dict(hidden=64, batch_size=B, backbone="mini", lr=0.002,
              dropout_rate=0.0, ggnn_impl="masked",
              compute_dtype=torch.float32)
#: the lockstep steps' batch sizes (the last one wrapped) and seeds
STEPS = ((B, 10), (B, 11), (5, 12))
EVAL = ((B, 30), (3, 31))


class ListLoader(list):
    """The loader interface of ``train_epoch`` / ``evaluate``."""

    start_batch = 0

    def set_epoch(self, epoch):
        pass


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(scenario: str, world: int, directory: str,
              timeout: float = 240.0) -> list:
    """Start ``world`` ranks of ``scenario``, wait for all of them (the
    time limit is the deadlock check) and → each rank's results."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), scenario, str(r),
         str(world), str(port), directory], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {scenario} exited "
                               f"{p.returncode}:\n{out[-6000:]}")
    return [torch.load(os.path.join(directory, f"{scenario}.r{r}.pt"),
                       weights_only=False) for r in range(world)]


def batch(enc, n: int, seed: int) -> dict:
    """A host batch of ``n`` rows from ``seed`` (``tests/test_torch_train.py``'s)."""
    rng = np.random.default_rng(seed)
    verbs = rng.integers(0, enc.get_num_verbs(), n)
    n_labels = enc.get_num_labels()
    labels = rng.integers(0, n_labels, (n, 3, enc.max_role_count))
    real = np.arange(enc.max_role_count)[None, None, :] \
        < enc.role_counts[verbs][:, None, None]
    labels = np.where(real & (rng.random(labels.shape) > 0.1), labels,
                      n_labels)
    return {"images": rng.integers(0, 256, (n, 256, 256, 3),
                                   dtype=np.uint8),
            "flip": rng.random(n) < 0.5,
            "verbs": verbs.astype(np.int32),
            "labels": labels.astype(np.int32)}


def trainer(directory: str, mesh=None, **kw) -> Trainer:
    """The mini trainer from the test's weights (``weights.pt``)."""
    bstate, hstate = torch.load(os.path.join(directory, "weights.pt"))
    return Trainer(ImsituEncoder.synthetic_full(0),
                   TrainerConfig(**{**COMMON, **kw}), device="cpu",
                   backbone_state=bstate, head_state=hstate, mesh=mesh)


def steps(tr: Trainer, plan=STEPS) -> dict:
    """``train_step`` on each batch of ``plan`` → losses and top-k."""
    losses, topk = [], []
    for n, seed in plan:
        args, _ = tr._upload(batch(tr.encoder, n, seed))
        l, k = tr.train_step(*args)
        tr.step_count += 1
        losses.append(l.numpy().copy())
        topk.append([x.numpy()[:n].copy() for x in k])
    return {"losses": np.stack(losses), "topk": topk}


def state(tr: Trainer) -> dict:
    """The head's state (whole kernels) and the BN statistics, as host
    copies."""
    msd = tr.model_state_dict()
    return {"msd": msd["model_state_dict"],
            "osd": msd["optimizer_state_dict"],
            "backbone": {k: v.clone() for k, v in
                         tr.backbone.state_dict().items()}}


def evaluate(tr: Trainer) -> dict:
    loader = ListLoader([batch(tr.encoder, n, s) for n, s in EVAL])
    t1, t5, losses, _ = tr.evaluate(loader)
    top1, top5 = t1.get_average_results_both(), t5.get_average_results_both()
    return {"top1": top1, "top5": top5, "losses": losses,
            "avg": mean_of_eight(top1, top5), "n": len(t1)}


def scenario_dp(rank: int, directory: str) -> dict:
    mesh = make_mesh()
    out = {}
    tr = trainer(directory, mesh)
    out["lockstep"] = steps(tr)
    out["lockstep"].update(state(tr))
    out["eval"] = evaluate(tr)

    tr = trainer(directory, mesh, dropout_rate=0.5)
    out["dropout"] = steps(tr, STEPS[:2])
    out["dropout"].update(state(tr))

    tr = trainer(directory, mesh, grad_accum=2)
    loader = ListLoader(batch(tr.encoder, B, 40 + i) for i in range(4))
    _, _, mean = tr.train_epoch(loader, 0)
    out["accum"] = {"mean": np.asarray(mean), "opt_steps": tr.opt_steps}
    out["accum"].update(state(tr))

    # a preemption flag on rank 1 only, set in its second step
    tr = trainer(directory, mesh)
    flag = threading.Event()
    real = tr.accum_step
    calls = []

    def accum_step(*args, **kwargs):
        calls.append(1)
        if rank == 1 and len(calls) == 2:
            flag.set()
        return real(*args, **kwargs)

    tr.accum_step = accum_step
    mids = []
    loader = ListLoader(batch(tr.encoder, B, 50 + i) for i in range(4))
    try:
        tr.train_epoch(loader, 0, save_callback=mids.append
                       if rank == 0 else None, preempt=flag)
        out["preempt"] = {"raised": False}
    except Preempted as p:
        out["preempt"] = {"raised": True, "batch": p.batch_in_epoch,
                          "saved": p.saved, "mids": len(mids),
                          "steps": len(calls)}

    tr = trainer(directory, mesh, epochs=1)
    folder = os.path.join(directory, "fit")
    os.makedirs(folder, exist_ok=True)
    tr.fit(ListLoader(batch(tr.encoder, B, 60 + i) for i in range(2)),
           ListLoader([batch(tr.encoder, 5, 62)]), "sr", folder=folder,
           plot=True, metrics_jsonl=os.path.join(folder, "metrics.jsonl"))

    # the backbone's gradients through the global-statistics BN
    tr = trainer(directory, mesh, train_backbone=True)
    args, _ = tr._upload(batch(tr.encoder, B, 70))
    tr.accum_step(*args, first=True)
    tr._reduce_grads()
    out["ft_grads"] = {n: p.grad.clone() for n, p in
                       list(tr.backbone.named_parameters())
                       + list(tr.head.named_parameters())}

    tr = trainer(directory, mesh)
    step = make_spmd_train_step(tr)
    losses = []
    for n, seed in STEPS[:2]:
        args, _ = tr._upload(batch(tr.encoder, n, seed))
        losses.append(step(*args)[0].numpy().copy())
        tr.step_count += 1
    out["spmd"] = {"losses": np.stack(losses)}
    out["spmd"].update(state(tr))
    return out


def scenario_tp(rank: int, directory: str) -> dict:
    mesh = make_mesh(model=2)
    tr = trainer(directory, mesh, model_axis=2)
    out = {"shape": mesh.shape,
           "shard_shape": tuple(tr.head.verb_classifier[1].weight.shape)}
    out["lockstep"] = steps(tr)
    out["lockstep"].update(state(tr))
    out["eval"] = evaluate(tr)
    # resume: the gathered checkpoint scattered into a fresh TP trainer
    # continues as the trainer it came from
    ck = tr.model_state_dict()
    fresh = trainer(directory, mesh, model_axis=2, seed=5)
    fresh.load_model_state(ck)
    plan = ((B, 80),)
    out["resume"] = {"from": steps(fresh, plan)["losses"],
                     "orig": steps(tr, plan)["losses"]}
    out["resume"].update(state(fresh))
    out["resume"]["orig_msd"] = state(tr)["msd"]
    try:
        make_spmd_train_step(tr)
        out["spmd_refused"] = False
    except NotImplementedError as e:
        out["spmd_refused"] = str(e)
    return out


def main(argv) -> None:
    scenario, rank, world, port, directory = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        if scenario == "dp":
            out = scenario_dp(rank, directory)
        else:
            out = scenario_tp(rank, directory)
    finally:
        destroy()
    torch.save(out, os.path.join(directory, f"{scenario}.r{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
