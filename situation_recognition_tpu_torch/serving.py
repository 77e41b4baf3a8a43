"""Serving artifacts: export → load → ``fn(images_u8)``.

Port of ``situation_recognition_tpu/serving.py``.  ``export_inference``
writes a directory that holds

* ``weights.pt`` — the weights once, in one of the JAX artifact's three
  encodings (``weights``): ``f32``; ``bf16``, every floating leaf of two or
  more dimensions cast; ``int8``, those leaves symmetric per output channel
  (the scale is max |w| / 127 over every axis but the last, floored at
  1e-12).  The leaves are the JAX package's (``convert``'s ``*_to_jax``
  view of the model: dense kernels (in, out), q/k/v kernels (D, heads,
  dh) whose scale is shared by the heads, the position embedding and
  the CLS token included), so that the decoded weights are the JAX
  artifact's bit for bit; 1-D leaves stay f32.  An f32 file holds the
  port's state dicts as they are (the format of the artifacts this package
  wrote before it had programs);
* ``model.pt2`` and ``model_gt.pt2`` — ``torch.export`` programs of the
  two entries, which take the weights as their leading argument (the JAX
  package's ``bake_weights=False`` artifact): a dict of the decoded
  tensors by the model's names, and on the ``cuda`` platform also the
  operands that its kernels read, prepared once at load
  (``kernel_operands``);
* ``meta.json`` — the JAX artifact's keys.

``platform="portable"`` exports the masked GGNN and the plain ViT blocks:
the programs run on the CPU and on the card (moved to the device they are
loaded on).  ``platform="cuda"`` keeps the kernels (``torch.library`` custom
ops: K1, K4, K5/K7 and K6) in the programs, which then run only on the card.

``load_inference`` decodes the weights once (``q.float() * scale``, the
bf16 upcast), loads the programs with ``torch.export.load`` — no model code
is rebuilt — and returns

    fn(images_u8 (B, 256, 256, 3) uint8)
        → (verb_logits (B, V) f32, verb_ids (B,), noun_logits (B, R, L) f32)

with ``fn.gt(images_u8, verb_ids) → noun_logits`` (the reference's
gt-verb path), ``fn.meta`` and ``fn.batch_size``.  ``devices=[...]``
serves on several cards (JAX ``load_inference(devices=)``): the artifact
is loaded once per card, a batch is split into baked-size chunks placed
round-robin over the cards, every chunk is dispatched before a result is
awaited, and the outputs are gathered onto the first card.  It rebuilds
``SituationModel`` from the meta and the same weights instead (``fn.model``)
for an artifact without programs, when ``ggnn_impl`` or ``block_impl``
choose the paths, and for a portable artifact on the card whose compute
type runs the kernels there (bf16): on the card the kernels serve either
kind of artifact unless ``rebuild=False`` asks for the portable program.
The path on the device: resize-as-matmul
+ ImageNet normalise, the backbone (eval-mode BN, its convolutions in the
compute type and its BatchNorm in f32), the FCGGNN verb branch, argmax,
the noun branch.  Like the JAX artifact the batch is baked at export and
any batch size is served by padding and chunking (``_over_chunks``).
"""

from __future__ import annotations

import contextlib
import json
import os
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch
from torch import nn

from situation_recognition_tpu_torch import convert
from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.data.transforms import CROP, eval_transform
from situation_recognition_tpu_torch.device import resolve_device
from situation_recognition_tpu_torch.models.backbone import build_backbone
from situation_recognition_tpu_torch.models.fcggnn import (
    GGSNN_NAMES, FCGGNNHead, resolve_ggnn_impl)
from situation_recognition_tpu_torch.ops.ggnn import GGNNParams
from situation_recognition_tpu_torch.ops.ggnn_kernel import (
    fold_gate_weights, kernel_weights)

FORMAT_VERSION = 7          # the JAX artifact's meta version this mirrors
WEIGHTS_FILE = "weights.pt"
PROGRAM_FILES = {"argmax": "model.pt2", "gt": "model_gt.pt2"}
ENCODINGS = ("f32", "bf16", "int8")
PLATFORMS = {"portable": ["cpu", "cuda"], "cuda": ["cuda"]}
_SIGNATURES = {"argmax": "images_u8 -> (verb_logits, verb_ids, "
                         "noun_logits)",
               "gt": "(images_u8, verb_ids) -> noun_logits"}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SituationModel(nn.Module):
    """Backbone + head + the encoder's tables: the served function.

    ``dtype`` is the compute type; ``ggnn_impl`` as in
    ``models.fcggnn.resolve_ggnn_impl`` (resolved by ``load_inference``
    for the device it serves on); ``block_impl`` a ViT's, as in
    ``models.vit.resolve_block_impl`` (resolved at each call)."""

    def __init__(self, encoder: ImsituEncoder, backbone: str = "resnet152",
                 hidden: int = 2048, image_size: int = CROP,
                 num_steps: int = 4, dtype: torch.dtype = torch.float32,
                 ggnn_impl: str = "masked", block_impl: str = "auto"):
        super().__init__()
        self.encoder = encoder
        self.backbone_name = backbone
        self.hidden = hidden
        self.image_size = image_size
        self.dtype = dtype
        self.backbone, self.backbone_has_bn = build_backbone(
            backbone, hidden, image_size, dtype, block_impl)
        self.head = FCGGNNHead(
            encoder.get_num_verbs(), encoder.get_num_roles(),
            encoder.get_num_labels(), encoder.max_role_count, hidden=hidden,
            num_steps=num_steps, dtype=dtype, ggnn_impl=ggnn_impl)
        self.register_buffer("role_ids", torch.as_tensor(
            encoder.role_ids, dtype=torch.long), persistent=False)
        self.register_buffer("role_mask", torch.as_tensor(
            encoder.role_mask), persistent=False)

    def features(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = eval_transform(images_u8, dtype=self.dtype,
                           crop=self.image_size)
        return self.backbone(x).float()

    def serve(self, images_u8: torch.Tensor):
        feats = self.features(images_u8)
        verb_logits = self.head.predict_verb(feats)
        verb_ids = torch.argmax(verb_logits, dim=1)
        noun_logits = self.head.predict_nouns(feats, verb_ids, self.role_ids,
                                              self.role_mask)
        return verb_logits, verb_ids, noun_logits

    def serve_gt(self, images_u8: torch.Tensor, verb_ids: torch.Tensor):
        feats = self.features(images_u8)
        return self.head.predict_nouns(feats, verb_ids, self.role_ids,
                                       self.role_mask)

    def forward(self, images_u8: torch.Tensor,
                verb_ids: torch.Tensor | None = None):
        """``serve``, or ``serve_gt`` when given verb ids (the entry a
        program traces)."""
        if verb_ids is None:
            return self.serve(images_u8)
        return self.serve_gt(images_u8, verb_ids)


# ------------------------------------------------------------------ weights


def jax_tree(backbone_state, head_state, heads: int | None = None) -> dict:
    """The port's state dicts → the JAX artifact's weight tree
    ``{"backbone": {"params", ["batch_stats"]}, "head": {"params"}}`` of
    numpy leaves in the JAX package's layout (``heads``: a ViT's)."""
    if "encoder.pos_embedding" in backbone_state:
        bvars = {"params": convert.vit_params_to_jax(backbone_state, heads)}
    else:
        bvars = {"params": convert.resnet_params_to_jax(backbone_state),
                 "batch_stats": convert.resnet_stats_to_jax(backbone_state)}
    return {"backbone": bvars,
            "head": {"params": convert.head_params_to_jax(head_state)}}


def _encode_leaf(w, weights: str):
    w = torch.as_tensor(np.asarray(w)) if not torch.is_tensor(w) else w
    if weights == "f32" or w.dim() < 2 or not w.is_floating_point():
        return w
    if weights == "bf16":
        return w.to(torch.bfloat16)
    w = w.to(torch.float32)
    scale = torch.amax(torch.abs(w), dim=tuple(range(w.dim() - 1)),
                       keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def encode_tree(tree, weights: str):
    """A JAX-layout weight tree → the artifact's encoding of it, leaf by
    leaf as the JAX package's ``_quantize_tree``: ``bf16`` casts every
    floating leaf of ndim ≥ 2, ``int8`` stores such a leaf as ``{"q": int8,
    "scale": f32}`` (per output channel: max |w| / 127 over all axes but
    the last, at least 1e-12); everything else stays as it is, f32."""
    if weights not in ENCODINGS:
        raise ValueError(f"weights must be f32|bf16|int8, got {weights!r}")
    if isinstance(tree, dict):
        return {k: encode_tree(v, weights) for k, v in tree.items()}
    return _encode_leaf(tree, weights)


def decode_tree(tree):
    """``encode_tree`` undone, once: ``q.float() * scale`` for an int8 leaf,
    the f32 upcast of a bf16 one."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "scale"}:
            return tree["q"].to(torch.float32) * tree["scale"]
        return {k: decode_tree(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.dtype == torch.bfloat16:
        return tree.to(torch.float32)
    return tree


def _state_dicts(model: "SituationModel"):
    def cpu(sd):
        return OrderedDict(
            (k, v.detach().to("cpu", torch.float32) if v.is_floating_point()
             else v.detach().cpu()) for k, v in sd.items())

    return cpu(model.backbone.state_dict()), cpu(model.head.state_dict())


def _write_weights(model, path: str, weights: str) -> None:
    backbone, head = _state_dicts(model)
    if weights == "f32":
        blob = {"backbone": backbone, "head": head}
    else:
        tree = jax_tree(backbone, head, getattr(model.backbone, "heads",
                                                None))
        blob = {"encoding": weights, "tree": encode_tree(tree, weights)}
    torch.save(blob, os.path.join(path, WEIGHTS_FILE))


def decode_weights(path: str, meta: dict | None = None):
    """An artifact's weights → (backbone state, head state) in the port's
    layout, decoded (f32 floating tensors)."""
    if meta is None:
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
    blob = torch.load(os.path.join(path, meta["weights_file"]),
                      map_location="cpu", weights_only=True)
    if "tree" not in blob:
        return blob["backbone"], blob["head"]
    tree = decode_tree(blob["tree"])
    bvars = tree["backbone"]
    if "cls_token" in bvars["params"]:
        backbone = convert.vit_state_from_jax(bvars["params"])
    else:
        backbone = convert.resnet_state_from_jax(bvars["params"],
                                                 bvars["batch_stats"])
    return backbone, convert.head_state_from_jax(tree["head"]["params"])


# --------------------------------------------------------------- programs


def kernel_operands(head_state, backbone_state, dtype: torch.dtype,
                    role_count: int, device, ggnn: bool, vit: bool
                    ) -> "OrderedDict[str, torch.Tensor]":
    """What a ``cuda`` program's kernels read besides the weights, made
    once (at load, on ``device``) by the model's names under ``operands``:
    with ``ggnn``, K1's ``kernel_weights`` of ``fold_gate_weights`` of the
    compute-type GGNN weights (three f32 d³ products) and the folded bias
    of each branch (``ba_1``, verb; ``ba_<R>``, nouns); with ``vit``, each
    encoder block's bf16 matrices."""
    out: OrderedDict = OrderedDict()
    if ggnn:
        ws = []
        for name in GGSNN_NAMES:
            w = head_state[f"ggsnn.{name}.weight"].to(device)
            b = head_state[f"ggsnn.{name}.bias"].to(device)
            ws += [w.t().to(dtype), b.to(dtype)]
        params = GGNNParams(*ws)
        pre = "head.ggsnn.operands."
        with torch.no_grad():
            for r in sorted({1, int(role_count)}):
                folded = fold_gate_weights(params, float(r))
                if r == 1:
                    for k, t in zip(("w_zr", "u_zr", "w_h", "u_h"),
                                    kernel_weights(folded)):
                        out[pre + k] = t
                out[f"{pre}ba_{r}"] = folded[3]
    if vit:
        prefix = "encoder.layers.encoder_layer_"
        blocks = sorted({int(k[len(prefix):].split(".")[0])
                         for k in backbone_state if k.startswith(prefix)})
        for i in blocks:
            src = f"{prefix}{i}"
            for name, key in (("in_w", "self_attention.in_proj_weight"),
                              ("out_w", "self_attention.out_proj.weight"),
                              ("fc1_w", "mlp.0.weight"),
                              ("fc2_w", "mlp.3.weight")):
                out[f"backbone.{src}.operands.{name}"] = (
                    backbone_state[f"{src}.{key}"].to(device)
                    .to(torch.bfloat16).contiguous())
    return out


def _serving_state(backbone_state, head_state, role_ids, role_mask,
                   has_bn: bool, dtype: torch.dtype, device
                   ) -> "OrderedDict[str, torch.Tensor]":
    """The served model's tensors by name, on ``device`` as the rebuilt
    model holds them: a ResNet's convolution weights in the compute type
    (channels-last on the card), everything else as decoded."""
    out: OrderedDict = OrderedDict()
    for k, v in backbone_state.items():
        v = v.to(device)
        if has_bn and v.dim() == 4:
            v = v.to(dtype)
            if device.type == "cuda":
                v = v.contiguous(memory_format=torch.channels_last)
        out["backbone." + k] = v
    for k, v in head_state.items():
        out["head." + k] = v.to(device)
    out["role_ids"] = torch.as_tensor(role_ids, dtype=torch.long,
                                      device=device)
    out["role_mask"] = torch.as_tensor(role_mask, device=device)
    return out


class _Program(nn.Module):
    """The exported entry: ``forward(weights, images_u8[, verb_ids])`` runs
    the model with ``weights`` in place of its tensors
    (``torch.func.functional_call``).  The model is not a submodule, so
    that the program holds no weights of its own."""

    def __init__(self, model: "SituationModel"):
        super().__init__()
        object.__setattr__(self, "model", model)

    def forward(self, weights, images_u8, verb_ids=None):
        args = (images_u8,) if verb_ids is None else (images_u8, verb_ids)
        return torch.func.functional_call(self.model, weights, args,
                                          strict=True)


@contextlib.contextmanager
def _program_paths(model: "SituationModel", platform: str, dev):
    """The model set up for a program of ``platform`` inside: the masked
    GGNN and plain ViT blocks (portable), or the kernels with their
    operands set as the GGNN's and each encoder block's ``operands``
    (cuda).  Yields the operands' names → tensors and the
    implementations; restores the model after."""
    head = model.head.ggsnn
    vit = not model.backbone_has_bn
    saved = (head.impl, getattr(model.backbone, "block_impl", None))
    owners = []
    try:
        if platform == "portable":
            head.impl = "masked"
            if vit:
                model.backbone.block_impl = "plain"
            impls = {"ggnn": "masked", "vit_blocks": "plain" if vit else None}
            yield OrderedDict(), impls
            return
        head.impl = resolve_ggnn_impl("auto", model.dtype, dev)
        use_vit = vit and model.backbone.resolved_impl(dev) == "kernel"
        if head.impl != "kernel" and not use_vit:
            print("platform='cuda' requested but the model resolves to the "
                  "portable paths on the card (masked GGNN / plain blocks: "
                  "a bf16 compute type is needed for the kernels) — the "
                  "artifact will be cuda-only WITHOUT the kernels' speedup")
        backbone, head_sd = _state_dicts(model)
        ops = kernel_operands(head_sd, backbone, model.dtype,
                              model.encoder.max_role_count, dev,
                              head.impl == "kernel", use_vit)
        for name, t in ops.items():
            owner_name, _, leaf = name.rpartition(".operands.")
            owner = model.get_submodule(owner_name)
            if owner.operands is None:
                owner.operands = nn.Module()
                owners.append(owner)
            owner.operands.register_buffer(leaf, t, persistent=False)
        from situation_recognition_tpu_torch.models.vit import vit_stream
        impls = {"ggnn": head.impl,
                 "vit_blocks": None if not vit else (
                     "plain" if not use_vit
                     else "stream" if vit_stream() else "block")}
        yield ops, impls
    finally:
        head.impl = saved[0]
        if vit:
            model.backbone.block_impl = saved[1]
        for owner in owners:
            owner.operands = None


def _export_programs(model: "SituationModel", path: str, batch_size: int,
                     platform: str) -> tuple:
    """Trace and save the two entries; → (the programs' weight names in
    order, the implementations they run, the device they were traced
    on)."""
    dev = next(model.parameters()).device
    with _program_paths(model, platform, dev) as (ops, impls):
        backbone, head_sd = _state_dicts(model)
        weights = _serving_state(backbone, head_sd, model.role_ids,
                                 model.role_mask, model.backbone_has_bn,
                                 model.dtype, dev)
        weights.update(ops)
        weights = dict(weights)       # the loader passes a dict (its spec)
        prog = _Program(model.eval())
        stub = torch.zeros((batch_size, 256, 256, 3), dtype=torch.uint8,
                           device=dev)
        vstub = torch.zeros((batch_size,), dtype=torch.long, device=dev)
        with torch.no_grad():
            for entry, args in (("argmax", (weights, stub)),
                                ("gt", (weights, stub, vstub))):
                ep = torch.export.export(prog, args, strict=False)
                # the program, not the weights it was traced with
                ep.example_inputs = None
                torch.export.save(ep, os.path.join(path,
                                                   PROGRAM_FILES[entry]))
    return list(weights), impls, dev.type


def export_inference(model: SituationModel, path: str, batch_size: int = 1,
                     weights: str = "f32", platform: str = "portable",
                     bake_weights: bool = False) -> None:
    """Write ``model`` as a serving artifact directory.

    ``weights``: the encoding of ``weights.pt`` — ``f32`` (exact),
    ``bf16`` or ``int8`` (``encode_tree``; 2x / 4x smaller matrices).
    ``platform``: ``portable`` (the programs run on the CPU and the card,
    without the kernels) or ``cuda`` (the kernels in the programs; the
    model must be on the card, and the artifact serves only there).
    ``bake_weights=True`` (weights inside each program) is not ported."""
    if weights not in ENCODINGS:
        raise ValueError(f"weights must be f32|bf16|int8, got {weights!r}")
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be portable|cuda, got "
                         f"{platform!r}")
    if bake_weights:
        raise NotImplementedError(
            "bake_weights=True (weights inside each program) is not ported "
            "yet (ROADMAP §1); the programs take the weights file as their "
            "argument")
    if platform == "cuda" and next(model.parameters()).device.type != "cuda":
        raise ValueError("platform='cuda' traces the CUDA kernels into the "
                         "programs: move the model to the card first")
    enc = model.encoder
    os.makedirs(path, exist_ok=True)
    _write_weights(model, path, weights)
    meta = {
        "format_version": FORMAT_VERSION,
        "batch_size": batch_size,
        "weights": weights,
        "weights_file": WEIGHTS_FILE,
        "compute_dtype": {v: k for k, v in _DTYPES.items()}[model.dtype],
        "entries": {e: {"signature": s} for e, s in _SIGNATURES.items()},
    }
    names, impls, traced_on = _export_programs(model, path, batch_size,
                                               platform)
    for e, f in PROGRAM_FILES.items():
        meta["entries"][e]["file"] = f
    meta.update({"platforms": PLATFORMS[platform], "bake_weights": False,
                 "program_weights": names, "impls": impls,
                 "traced_on": traced_on})
    meta.update({
        "backbone": model.backbone_name,
        "hidden": model.hidden,
        "image_size": model.image_size,
        "num_steps": model.head.ggsnn.num_steps,
        "num_verbs": enc.get_num_verbs(),
        "num_labels": enc.get_num_labels(),
        "max_role_count": enc.max_role_count,
        "verb_list": enc.verb_list,
        "label_list": enc.label_list,
        "role_list": enc.role_list,
        "roles_per_verb": enc.roles_per_verb,
    })
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def _encoder(meta: dict) -> ImsituEncoder:
    return ImsituEncoder.from_dict({
        "verb_list": meta["verb_list"], "role_list": meta["role_list"],
        "label_list": meta["label_list"],
        "roles_per_verb": meta["roles_per_verb"],
        "max_role_count": meta["max_role_count"]})


def load_inference(path: str, device=None, ggnn_impl: str = "auto",
                   block_impl: str = "auto", rebuild: bool | None = None,
                   devices=None) -> Callable:
    """Load an artifact → ``fn(images_u8)`` on ``device`` (default cuda;
    raises without a card unless ``device="cpu"``).

    ``rebuild``: ``True`` rebuilds the model from the meta and the decoded
    weights (``fn.model``), whose paths ``ggnn_impl`` and a ViT's
    ``block_impl`` choose (``masked`` and ``plain`` serve the weights
    through the plain paths); ``False`` serves the artifact's programs, on
    a device it was exported for (else this raises, as the JAX loader
    does).  ``None`` (the default) picks with ``_serves_rebuilt``: the
    programs, unless there are none, the paths are chosen, or the device
    would run the kernels that the programs leave out.  ``devices``: serve
    on each of them in turn (see the module docstring); ``device`` is then
    ``None`` or the first of them."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("devices must be a non-empty list (or None)")
        if device is not None and resolve_device(device) != devs[0]:
            raise ValueError(f"device {device} is not devices[0] "
                             f"({devs[0]})")
        return _over_devices([load_inference(path, d, ggnn_impl,
                                             block_impl, rebuild)
                              for d in devs], devs)
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    meta.setdefault("weights", "f32")
    meta.setdefault("platforms", ["cpu", "cuda"])
    if rebuild is None:
        rebuild = _serves_rebuilt(meta, dev, ggnn_impl, block_impl)
    if rebuild:
        return _load_rebuilt(path, meta, dev, ggnn_impl, block_impl)
    if "file" not in meta["entries"]["argmax"]:
        raise ValueError(f"artifact {path} holds no programs: load it with "
                         f"rebuild=True")
    if (ggnn_impl, block_impl) != ("auto", "auto"):
        raise ValueError(
            "ggnn_impl / block_impl choose the paths of a rebuilt model; "
            "this artifact's programs fixed theirs at export "
            f"({meta.get('impls')}): pass rebuild=True to choose")
    return _load_programs(path, meta, dev)


def _serves_rebuilt(meta: dict, dev: torch.device, ggnn_impl: str,
                    block_impl: str) -> bool:
    """``load_inference``'s default: rebuild the model for an artifact
    without programs (this package's format before them), when the caller
    chooses the paths, and where the programs run the GGNN without K1 on a
    device whose rebuilt model runs it (a portable program of a bf16 model
    on the card), so that the card serves through its kernels."""
    if "file" not in meta["entries"]["argmax"]:
        return True
    if (ggnn_impl, block_impl) != ("auto", "auto"):
        return True
    dtype = _DTYPES[meta["compute_dtype"]]
    return ((meta.get("impls") or {}).get("ggnn") != "kernel"
            and resolve_ggnn_impl("auto", dtype, dev) == "kernel")


def _load_programs(path: str, meta: dict, dev: torch.device) -> Callable:
    plats = meta["platforms"]
    if dev.type not in plats:
        raise RuntimeError(
            f"artifact {path} was exported for platforms {plats} but the "
            f"device is {dev.type!r}; re-export with platform='portable' to "
            f"serve here")
    # registers the kernels' custom ops, which the programs call
    from situation_recognition_tpu_torch.ops import ggnn_kernel  # noqa: F401
    from situation_recognition_tpu_torch.ops import vit_kernel  # noqa: F401
    from torch.export.passes import move_to_device_pass

    dtype = _DTYPES[meta["compute_dtype"]]
    enc = _encoder(meta)
    backbone, head = decode_weights(path, meta)
    names = meta["program_weights"]
    weights = _serving_state(backbone, head, enc.role_ids, enc.role_mask,
                             not meta["backbone"].startswith("vit"), dtype,
                             dev)
    impls = meta.get("impls") or {}
    if any(".operands." in n for n in names):
        weights.update(kernel_operands(
            head, backbone, dtype, meta["max_role_count"], dev,
            impls.get("ggnn") == "kernel",
            impls.get("vit_blocks") in ("stream", "block")))
    if set(weights) != set(names):
        raise ValueError(f"artifact {path}: its programs take "
                         f"{sorted(set(names) ^ set(weights))} that the "
                         f"weights do not give, or the other way round")
    weights = {n: weights[n] for n in names}
    calls = {}
    for entry, info in meta["entries"].items():
        ep = torch.export.load(os.path.join(path, info["file"]))
        if meta.get("traced_on") != dev.type:
            ep = move_to_device_pass(ep, dev)
        calls[entry] = _Call(ep.module(), weights)
    baked = int(meta["batch_size"])

    def fn(images_u8):
        with torch.inference_mode():
            return _over_chunks(_one(calls["argmax"]), baked,
                                (_coerce(images_u8, torch.uint8, dev),))

    def gt(images_u8, verb_ids):
        with torch.inference_mode():
            return _over_chunks(_one(calls["gt"]), baked,
                                (_coerce(images_u8, torch.uint8, dev),
                                 _coerce(verb_ids, torch.long, dev)))

    fn.gt = gt
    fn.meta = meta
    fn.batch_size = baked
    fn.weights = weights
    fn.programs = calls
    return fn


class _Call:
    """A loaded program with its weights bound.  The program checks its
    inputs against what it was traced with on the first call; after one
    that passed it checks no more (the weights are these, unchanged, and
    ``_over_chunks`` gives the baked batch of ``_coerce``'s types), which
    saves a Python check of every weight tensor per call."""

    def __init__(self, module, weights: dict):
        self.module = module
        self.weights = weights

    def __call__(self, *args):
        out = self.module(self.weights, *args)
        self.module.validate_inputs = False
        return out


def _load_rebuilt(path: str, meta: dict, dev: torch.device, ggnn_impl: str,
                  block_impl: str) -> Callable:
    dtype = _DTYPES[meta.get("compute_dtype", "float32")]
    model = SituationModel(
        _encoder(meta), backbone=meta["backbone"], hidden=meta["hidden"],
        image_size=meta.get("image_size", CROP),
        num_steps=meta.get("num_steps", 4), dtype=dtype,
        ggnn_impl=resolve_ggnn_impl(ggnn_impl, dtype, dev),
        block_impl=block_impl)
    backbone, head = decode_weights(path, meta)
    model.backbone.load_state_dict(backbone, strict=True)
    model.head.load_state_dict(head, strict=True)
    model.eval().to(dev)
    if model.backbone_has_bn:
        # a ResNet's convolutions run in the compute type and its
        # BatchNorm parameters and statistics stay f32, as the JAX serving
        # keeps every 1-D leaf and as Trainer casts; channels-last on the
        # card (cuDNN's layout)
        for m in model.backbone.modules():
            if isinstance(m, nn.Conv2d):
                m.to(dtype=dtype)
        if dev.type == "cuda":
            model.backbone.to(memory_format=torch.channels_last)
    else:
        # a ViT block_impl that cannot run raises here, not at a request
        model.backbone.resolved_impl(dev)
    baked = int(meta["batch_size"])

    def fn(images_u8):
        with torch.inference_mode():
            return _over_chunks(_one(model.serve), baked,
                                (_coerce(images_u8, torch.uint8, dev),))

    def gt(images_u8, verb_ids):
        with torch.inference_mode():
            return _over_chunks(_one(model.serve_gt), baked,
                                (_coerce(images_u8, torch.uint8, dev),
                                 _coerce(verb_ids, torch.long, dev)))

    fn.gt = gt
    fn.meta = meta
    fn.batch_size = baked
    fn.model = model
    return fn


def _one(call):
    """``call`` as ``_over_chunks`` calls it: chunk index first."""
    return lambda i, *chunk: call(*chunk)


def _over_devices(fns, devs) -> Callable:
    """The loaded artifacts ``fns`` (one per device of ``devs``) as one
    ``fn``: chunk i of a batch runs on ``fns[i % len(fns)]``, each chunk
    launched before any result is read, the outputs gathered onto
    ``devs[0]``.  A host batch served on cards is pinned once, so that each
    chunk's copy to its card is queued without waiting (a pageable copy
    would hold the host until it lands, and with it the next card's
    chunk); only the last chunk, zero-padded to the baked size, is copied
    from pageable memory."""
    baked = fns[0].batch_size
    pin = any(d.type == "cuda" for d in devs)

    def serve(entry, args):
        if pin:
            args = tuple(a.pin_memory() if a.device.type == "cpu" else a
                         for a in args)

        def call(i, *chunk):
            f = fns[i % len(fns)]
            chunk = tuple(c.to(devs[i % len(fns)], non_blocking=True)
                          for c in chunk)
            return (f if entry == "argmax" else f.gt)(*chunk)

        with torch.inference_mode():
            return _over_chunks(call, baked, args, gather=devs[0])

    def fn(images_u8):
        return serve("argmax", (_coerce(images_u8, torch.uint8, None),))

    def gt(images_u8, verb_ids):
        return serve("gt", (_coerce(images_u8, torch.uint8, None),
                            _coerce(verb_ids, torch.long, None)))

    fn.gt = gt
    fn.meta = fns[0].meta
    fn.batch_size = baked
    fn.devices = devs
    fn.loaded = fns
    return fn


def _over_chunks(call, baked: int, args, gather=None):
    """Serve any leading batch size through the baked batch: split into
    baked-size chunks, zero-pad the last one (zero images are safe with
    eval-mode BN), call ``call(i, *chunk)`` for chunk i, and slice the
    concatenated outputs (moved to ``gather`` where given) back to B.  An
    exactly baked batch is one call."""
    sizes = {a.shape[0] for a in args}
    if len(sizes) != 1:
        raise ValueError(f"argument batch sizes disagree: "
                         f"{[a.shape[0] for a in args]}")
    b = args[0].shape[0]
    if b == baked and gather is None:
        return call(0, *args)
    if b == 0:
        raise ValueError("empty batch")
    outs = []
    for i, lo in enumerate(range(0, b, baked)):
        chunk = tuple(a[lo:lo + baked] for a in args)
        short = baked - chunk[0].shape[0]
        if short:
            chunk = tuple(torch.cat([c, c.new_zeros((short,) + c.shape[1:])])
                          for c in chunk)
        res = call(i, *chunk)
        outs.append(res if isinstance(res, tuple) else (res,))
    if gather is not None:
        outs = [tuple(o.to(gather) for o in out) for out in outs]
    cat = tuple(torch.cat([o[i] for o in outs])[:b]
                for i in range(len(outs[0])))
    return cat if len(cat) > 1 else cat[0]


def _coerce(x, dtype: torch.dtype, device) -> torch.Tensor:
    """Host inputs (numpy, lists) or tensors → ``dtype`` on ``device``
    (``None``: where they are)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
    return x.to(device=device, dtype=dtype)
