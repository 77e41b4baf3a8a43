"""The reference's training steps: features, the three branches with
dropout, the masked losses, the global-norm clip and Adamax, in plain
PyTorch on float32 state dicts.

``steps`` follows the configuration (``configs/<name>.json``): the
backbone frozen (features without a gradient) or fine-tuned, the head
always trained.  Dropout masks come from the configuration's stated
streams: for step ``s`` of a run seeded ``seed``, stream ``k`` (0: the
differentiated verb and noun branches, in that order; 1: the gt-verb noun
branch) is a ``torch.Generator`` on the batch's device seeded
``(seed · 1000003 + s) · 2 + k``, one ``torch.rand`` of each branch's
hidden state's shape, kept where it is below 1 - rate.
"""

from __future__ import annotations

import torch

from reference import backbones, nets

DROPOUT_STREAM = 1_000_003


def dropout_generator(seed: int, step: int, stream: int, device):
    g = torch.Generator(device=device)
    g.manual_seed((seed * DROPOUT_STREAM + step) * 2 + stream)
    return g


def features(cfg: dict, bb: dict, images_u8, flip, p: nets.Precision):
    """The backbone's features (B, D) of a batch of uint8 windows, by the
    file of the configuration's backbone kind."""
    x = p(nets.transform(images_u8, flip, cfg["image"]["crop"]))
    return backbones.of(cfg).features(cfg, bb, x, p)


def clip_(grads, max_norm: float) -> None:
    """Scale the gradients so that their global 2-norm is at most
    ``max_norm`` (with 1e-6 added to the norm, as torch's clip does)."""
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(coef)


class Adamax:
    """Adamax (Kingma & Ba, 2015, §7.1): m ← β1 m + (1-β1) g, u ←
    max(β2 u, |g| + ε), p ← p - lr/(1-β1ᵗ) · m/u."""

    def __init__(self, params, lr, betas, eps):
        self.params, self.lr, self.eps = params, lr, eps
        self.b1, self.b2 = betas
        self.m = [torch.zeros_like(q) for q in params]
        self.u = [torch.zeros_like(q) for q in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads) -> None:
        self.t += 1
        clr = self.lr / (1 - self.b1 ** self.t)
        for q, g, m, u in zip(self.params, grads, self.m, self.u):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            torch.maximum(u * self.b2, g.abs() + self.eps, out=u)
            q.sub_(clr * m / u)


def steps(cfg: dict, tables, backbone: dict, head: dict, batches,
          images_of, seed: int, p: nets.Precision, choices=None,
          gt_choices=None):
    """Run len(batches) train steps from the given f32 state dicts.

    ``batches``: dicts of device tensors ``indices``/``flip``/``verbs``/
    ``labels``; ``images_of(indices)`` gives their uint8 windows.
    ``choices``: for each step the verb ids whose noun branch is trained
    (the measured side's argmax), or None for this side's own argmax;
    ``gt_choices``: for each step the (B, R) nouns the measured side's
    gt-verb branch put first, or None for this side's own.
    Returns ``losses`` (steps, 3) = verb, nouns, gt nouns; ``grad`` and
    ``grad_t``, the first step's clipped gradient per leaf (its norm, and
    the tensor); ``delta_t``, each leaf's change (after - before) over all
    the steps; ``choices``, this side's argmax verbs per step;
    ``verb_gap``, per step the largest amount by which this side's logit
    of the given choice lies below its best; ``gt_choices`` and
    ``gt_noun_gap``, the same of the gt-verb branch's nouns, over each
    verb's real roles."""
    h = cfg["head"]
    opt_cfg = cfg["optimizer"]
    role_ids, counts = tables
    ignore = h["num_labels"]
    ft = cfg["backbone"]["train"]
    leaves = {("head." + k): v.detach().clone().float().requires_grad_(True)
              for k, v in head.items()}
    hsd = {k[5:]: v for k, v in leaves.items()}
    if ft:
        bleaves = {("backbone." + k): v.detach().clone().float()
                   .requires_grad_(True) for k, v in backbone.items()}
        leaves.update(bleaves)
        bsd = {k[9:]: v for k, v in bleaves.items()}
    else:
        bsd = backbone
    names = list(leaves)
    params = [leaves[n] for n in names]
    before = [q.detach().clone() for q in params]
    opt = Adamax(params, opt_cfg["lr"], tuple(opt_cfg["betas"]),
                 opt_cfg["eps"])
    out = {"losses": [], "choices": [], "verb_gap": [], "gt_choices": [],
           "gt_noun_gap": []}
    rate = h["dropout"]
    for s, batch in enumerate(batches):
        dev = batch["verbs"].device
        images = images_of(batch["indices"])
        with torch.set_grad_enabled(ft):
            feats = features(cfg, bsd, images, batch["flip"], p)
        if not ft:
            feats = feats.detach()
        g0 = dropout_generator(seed, s, 0, dev)
        vl = nets.verb_logits(hsd, feats, h["ggnn_steps"], p, rate, g0)
        own = torch.argmax(vl.detach(), dim=1)
        pick = own if choices is None else choices[s].to(dev)
        best = vl.detach().max(dim=1).values
        out["verb_gap"].append(float(
            (best - vl.detach().gather(1, pick[:, None])[:, 0]).max()))
        out["choices"].append(own.cpu())
        nl = nets.noun_logits(hsd, feats, pick, role_ids, counts,
                              h["ggnn_steps"], p, rate, g0)
        lv = nets.verb_loss(vl, batch["verbs"])
        ln = nets.nouns_loss(nl, batch["labels"], ignore)
        grads = torch.autograd.grad(lv + ln, params, allow_unused=True)
        grads = [torch.zeros_like(q) if g is None else g
                 for q, g in zip(params, grads)]
        with torch.no_grad():
            g1 = dropout_generator(seed, s, 1, dev)
            gn = nets.noun_logits(hsd, feats.detach(), batch["verbs"],
                                  role_ids, counts, h["ggnn_steps"], p,
                                  rate, g1)
            gl = nets.nouns_loss(gn, batch["labels"], ignore)
            gown = torch.argmax(gn, dim=-1)
            gpick = gown if gt_choices is None else gt_choices[s].to(dev)
            real = (torch.arange(gn.shape[1], device=dev)[None, :]
                    < counts[batch["verbs"]][:, None])
            under = gn.max(dim=-1).values - gn.gather(
                2, gpick[..., None].long())[..., 0]
            out["gt_noun_gap"].append(float(under[real].max()))
            out["gt_choices"].append(gown.cpu())
        out["losses"].append([float(lv.detach()), float(ln.detach()),
                              float(gl)])
        clip_(grads, opt_cfg["clip_norm"])
        if s == 0:
            out["grad"] = {n: float(g.norm()) for n, g in zip(names, grads)}
            out["grad_t"] = {n: g.clone() for n, g in zip(names, grads)}
        opt.step(grads)
        del grads, feats, vl, nl, gn
    out["delta_t"] = {n: q.detach() - b
                      for n, q, b in zip(names, params, before)}
    return out
