"""Command-line interface of the port, flag for flag the JAX package's
``situation_recognition_tpu/cli.py`` (the reference ``sr.py``'s flags,
defaults, mode dispatch and stdout, and the JAX CLI's additions):

    python -m situation_recognition_tpu_torch.cli [flags]

It trains (``fit``, with ``--grad_accum`` microbatches per optimizer
step), resumes (``--resume_model``), evaluates (``--evaluate_dev`` /
``--evaluate_test``) and runs the reference's inference modes
(``--test_img`` with or without ``--verb``, ``--subset N``;
``inference.py``) on the CUDA card, or on the CPU with ``--platform cpu``;
without a card and without that flag it raises.

Reproduced behaviours:

* the encoder is always built from ``<dataset_folder>/train.json``, even
  when ``--train_file`` names another file;
* the encoder is kept in ``<saving_folder>/encoder`` (the JAX package's
  JSON) and read back with "Loading encoder file";
* the test loader shuffles (a quirk of the reference);
* a resume saves under the resumed name.

Checkpoints are the reference's ``torch.save`` layout
(``utils/checkpoint.py``): a reference checkpoint, one the JAX package
exported (``tools/export_torch.py``), or the JAX package's own msgpack
checkpoint (read by ``utils/msgpack.py`` and converted by
``convert.export_reference_checkpoint``, with no JAX installed) resumes
here, and this CLI's resumes in the reference and the JAX package.

``--backbone_ckpt`` (and a ``backbone_<size>.msgpack`` / ``backbone.pth``
dropped in ``--saving_folder``) is read as the JAX CLI reads it: a flax
msgpack backbone, a torchvision ViT or CLIP visual tower (its position
embedding resampled to ``--image_size``), a reference checkpoint or a
torchvision ResNet; a ViT grid that still does not fit raises.

Several cards: one process per card, started by ``torchrun``

    torchrun --nproc_per_node N -m situation_recognition_tpu_torch.cli \
        --distributed [flags]

or one command per process with the JAX CLI's ``--distributed
--coordinator host:port --num_processes N --process_id r`` (NCCL between
the cards; with ``--platform cpu``, gloo).  Each rank loads its block of
every global batch (``ImsituLoader(shard=...)``), ``--batch_size`` rounds
up to a multiple of the data axis (JAX's stderr line), ``--model_axis M``
splits the classifiers over groups of M ranks, ranks other than 0 send
their stdout to ``/dev/null``, and only rank 0 writes the encoder, the
backbone cache and the checkpoints (``parallel/``, ``train.py``).  Without
``--distributed`` the CLI drives one card, where the JAX CLI takes every
local chip (README, divergences).

The JAX package's run-time switches, read where it reads them and with
its defaults: ``SRTPU_HBM_BYTES`` (the device memory ``--cache_device``
budgets against, in place of ``torch.cuda.mem_get_info``),
``SRTPU_HBM_CHUNK_BYTES`` (the window cache's upload chunk, 256 MB),
``SRTPU_PIPELINE_DEPTH`` (train and eval steps in flight, 2),
``SRTPU_STEP_TRACE=1`` (the host's ``[trace]`` lines of the first 16
train steps, read from the spans ``train.readback`` and ``train.fetch``
that the steps record then), ``SRTPU_PROFILE_DIR`` (a ``torch.profiler``
trace of the first epoch's training, with the training loop's and the
uploader's spans, ``utils/trace.py``, which record while a profiler
does), ``SRTPU_UPLOAD_DEPTH`` (batches staged ahead,
2), ``SRTPU_GGNN_BWD=pallas`` (the K2/K3 route) and the ViT's
``SRTPU_VIT_STREAM`` / ``SRTPU_ATTN_CORE`` (``models/vit.py``).
"""

from __future__ import annotations

import json
import math
import os
import random
import sys
from argparse import ArgumentParser
from os.path import isfile as pisfile, join as pjoin
from pathlib import Path


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='Situation recognition with GNN.')
    parser.add_argument('--resume_model', type=str, default='',
                        help='The model we resume')

    parser.add_argument('--evaluate_dev', action='store_true',
                        help='Only use the testing mode')
    parser.add_argument('--evaluate_test', action='store_true',
                        help='Only use the testing mode')

    parser.add_argument('--test_img', type=str, default='',
                        help='Only use the results mode with a given img')
    parser.add_argument('--verb', type=str, default='',
                        help='Use a gt verb')
    parser.add_argument('--subset', type=int, default=0,
                        help='Analize a subset of a specified size')

    parser.add_argument('--model_saving_name', type=str, default='sr',
                        help='saving name of the outpul model')
    parser.add_argument('--saving_folder', type=str, default='checkpoints',
                        help='Location of annotations')
    parser.add_argument('--imgset_dir', type=str, default='resized_256',
                        help='Location of original images')
    parser.add_argument('--dataset_folder', type=str, default='imSitu',
                        help='Location of annotations')

    parser.add_argument('--train_file', type=str, default='train.json',
                        help='Train json file')
    parser.add_argument('--dev_file', type=str, default='dev.json',
                        help='Dev json file')
    parser.add_argument('--test_file', type=str, default='test.json',
                        help='test json file')

    parser.add_argument('--batch_size', type=int, default=6144)
    parser.add_argument('--num_workers', type=int, default=10)

    parser.add_argument('--epochs', type=int, default=1000)
    parser.add_argument('--lr', type=float, default=0.002)

    # --- additions (not in the reference CLI) ---
    parser.add_argument('--backbone', type=str, default='resnet152',
                        choices=['resnet18', 'resnet34', 'resnet50',
                                 'resnet101', 'resnet152', 'mini',
                                 'vit_l14', 'vit_l14_clip', 'vit_b16',
                                 'vit_tiny'],
                        help='Backbone architecture')
    parser.add_argument('--precision', type=str, default='auto',
                        choices=['auto', 'bf16', 'fp32'],
                        help='Compute dtype (auto: bf16 on the card, '
                             'fp32 with --platform cpu)')
    parser.add_argument('--image_size', type=int, default=224,
                        help='Model input resolution (default 224, the '
                             'reference\'s Resize(224)+Crop(224); e.g. 336 '
                             'for the CLIP ViT-L/14@336 grid — the device '
                             'resize serves any size from the same 256 '
                             'host windows, and the converters interpolate '
                             'pretrained ViT pos-embeds to match)')
    parser.add_argument('--model_axis', type=int, default=1,
                        help='Model-axis size (classifier tensor '
                             'parallelism over groups of this many ranks; '
                             'needs --distributed)')
    parser.add_argument('--backbone_ckpt', type=str, default='',
                        help='Pretrained backbone weights (.msgpack or '
                             'torch .pth: torchvision ResNet or ViT, CLIP '
                             'visual tower, reference checkpoint)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--ggnn', type=str, default='auto',
                        choices=['auto', 'masked', 'pallas'],
                        help='GGNN propagation implementation (auto: the '
                             'folded CUDA kernel on the card at bf16, the '
                             'masked sum elsewhere; pallas: request the '
                             'kernel (on the CPU its plain twin) — it '
                             'computes bf16 internally)')
    parser.add_argument('--frozen_bn', type=str, default='train',
                        choices=['train', 'eval'],
                        help='BN mode of the frozen backbone during train '
                             'steps: "train" matches the reference '
                             '(batch stats + running-stat updates); "eval" '
                             'uses running stats only — ~39%% faster, '
                             'diverges from the reference trajectory')
    parser.add_argument('--grad_accum', type=int, default=1,
                        help='Gradient accumulation: each optimizer step '
                             'averages the gradients of N microbatches of '
                             'batch_size/N rows — runs the global-batch '
                             'recipe when the backbone forward does not '
                             'fit device memory at the full batch (ViT-L/14 '
                             'on few cards).  Train-mode BN computes '
                             'per-microbatch stats (DIVERGENCES #17 '
                             'class)')
    parser.add_argument('--train_backbone', action='store_true',
                        help='Fine-tune the backbone (ADDITIVE: the '
                             'reference freezes its backbones at '
                             'construction and filters them out of the '
                             'optimizer).  One global-norm-1 clip over '
                             'head+backbone gradients, Adamax on both.  '
                             'Memory scales with the microbatch: combine '
                             '--grad_accum and --remat_backbone for '
                             'flagship widths')
    parser.add_argument('--backbone_lr', type=float, default=None,
                        help='Decoupled backbone learning rate (default: '
                             '--lr; exact — Adamax updates are linear in '
                             'lr).  Needs --train_backbone')
    parser.add_argument('--remat_backbone', action='store_true',
                        help='Rematerialize residual/encoder blocks on '
                             'the backward pass (backward activation '
                             'memory drops to block boundaries for one '
                             'extra forward).  Needs --train_backbone')
    parser.add_argument('--lr_schedule', default='constant',
                        choices=['constant', 'cosine', 'linear'],
                        help='Learning-rate schedule over optimizer steps '
                             '(ADDITIVE: the reference trains at a '
                             'constant lr forever).  cosine/linear decay '
                             'lr to --min_lr over --total_steps; driven '
                             'by the optimizer-step counter, so it ticks '
                             'once per grad-accum group and resumes '
                             'exactly from checkpoints')
    parser.add_argument('--warmup_steps', type=int, default=0,
                        help='Linear lr warmup over the first N optimizer '
                             'steps (step c runs at lr*(c+1)/N); composes '
                             'with every --lr_schedule — the standard '
                             'fine-tuning recipe with --train_backbone')
    parser.add_argument('--total_steps', type=int, default=None,
                        help='Decay horizon in optimizer steps for '
                             'cosine/linear (epochs * steps-per-epoch / '
                             '--grad_accum for a full run); steps past it '
                             'hold at --min_lr')
    parser.add_argument('--min_lr', type=float, default=0.0,
                        help='Floor of the cosine/linear decay '
                             '(default 0)')
    parser.add_argument('--save_steps', type=int, default=0,
                        help='Also checkpoint every N train steps '
                             '(mid-epoch, preemption-safe resume)')
    parser.add_argument('--async_save', action='store_true',
                        help='Write checkpoints on a background thread '
                             '(the flagship serialize+fsync '
                             'overlaps the next epoch; at most one write '
                             'in flight, joined before exit — same '
                             'durability, zero step-time cost)')
    parser.add_argument('--keep_best', action='store_true',
                        help='Additionally keep the best-val-mean epoch '
                             'as <model_saving_name>_best (the reference '
                             'overwrites every epoch and its own comment '
                             'flags this gap, sr.py:144)')
    parser.add_argument('--metrics_jsonl', type=str, default='',
                        help='Append one JSON line of structured metrics '
                             'per epoch (losses, all 8 metrics, val, '
                             'throughput) to this path — machine-readable '
                             'observability next to the reference-format '
                             'stdout')
    parser.add_argument('--cache_device', action='store_true',
                        help='Keep ALL image windows resident in device '
                             'memory (uploaded once; every batch becomes an '
                             'on-device gather — zero per-step image '
                             'transfer). Fits datasets up to a few GB, '
                             'e.g. the whole imSitu dev split; train '
                             'datasets require square sources (the '
                             'deterministic-window gate)')
    parser.add_argument('--cache_decoded', action='store_true',
                        help='Cache decoded images in host RAM '
                             '(~200KB/image; removes JPEG decode from the '
                             'input path after the first epoch)')
    parser.add_argument('--packed_dir', type=str, default='',
                        help='Pre-decoded packed image store '
                             '(tools/pack_dataset.py); removes JPEG decode '
                             'from the input path entirely')
    parser.add_argument('--platform', type=str, default='auto',
                        choices=['auto', 'cpu'],
                        help='"auto" runs on the CUDA card and fails '
                             'without one; "cpu" runs on the CPU')
    parser.add_argument('--preproc', type=str, default='window',
                        choices=['window', 'exact'],
                        help='Eval/inference preprocessing: "window" '
                             '(default — 256 crop window + device resize) '
                             'or "exact" (reference-exact host PIL '
                             'Resize(224)+CenterCrop(224) for bit-faithful '
                             'metric-parity runs; slower host path). '
                             'Training always uses the window pipeline.')
    parser.add_argument('--distributed', action='store_true',
                        help='Multi-process data parallelism, one process '
                             'per card: run under torchrun, or pass '
                             '--coordinator/--num_processes/--process_id '
                             'to every process; each loads only its shard '
                             'of every batch (parallel/distributed.py)')
    parser.add_argument('--coordinator', type=str, default='',
                        help='host:port of process 0')
    parser.add_argument('--num_processes', type=int, default=0,
                        help='world size')
    parser.add_argument('--process_id', type=int, default=-1,
                        help='this process rank')
    return parser




def _load_json(path):
    with open(path, 'r') as f:
        return json.load(f)


def _default_hidden(backbone: str) -> int:
    """The head's width for a backbone: its feature width (JAX
    ``default_hidden``)."""
    from situation_recognition_tpu_torch.models.resnet import BASIC_STACKS
    from situation_recognition_tpu_torch.models.vit import VIT_WIDTHS

    if backbone in VIT_WIDTHS:
        return VIT_WIDTHS[backbone]
    if backbone in BASIC_STACKS:
        return 512
    return 64 if backbone == 'mini' else 2048


def _working_reserve(encoder, cfg, device, window: int,
                     train: bool) -> int:
    """Device bytes the run needs beside ``--cache_device``'s window
    arrays, measured: a throw-away ``Trainer`` of the run's configuration
    on a batch of zero windows of side ``window`` (the microbatch) takes a
    train step, then a second one while it holds two checkpoint snapshots
    (``fit`` keeps the one being written and the next), or one eval batch
    when ``train`` is false.  Under ``grad_accum`` each step is a group of
    two microbatches, so that a forward and backward run while ``.grad``
    holds the first one's sum.  The reserve is the allocator's peak over
    that, plus the batches that stage or run beside the probe's one
    (``Trainer.batches_on_device``), plus a tenth for the fragmentation of
    a card that also holds the window arrays.  0 on the CPU, where a
    window cache is the host array itself."""
    import contextlib
    import io

    import numpy as np
    import torch

    from situation_recognition_tpu_torch.train import Trainer

    if device.type != 'cuda':
        return 0
    B, R = cfg.batch_size, encoder.max_role_count
    batch = {'images': np.zeros((B, window, window, 3), np.uint8),
             'flip': np.zeros(B, bool), 'verbs': np.zeros(B, np.int64),
             'labels': np.zeros((B, 3, R), np.int64)}
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(device)
    torch.cuda.reset_peak_memory_stats(device)
    probe = Trainer(encoder, cfg, device=device)
    if train:
        group = [batch] * min(cfg.grad_accum, 2)
        probe.train_epoch(group, 0)
        snapshots = [probe.model_state_snapshot() for _ in range(2)]
        probe.train_epoch(group, 1)
        del snapshots
    else:
        with contextlib.redirect_stderr(io.StringIO()):   # its img/s line
            probe.evaluate([batch])
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_reserved(device) - base
    del probe
    torch.cuda.empty_cache()
    staged = (Trainer.batches_on_device() - 1) * B * window * window * 3
    return int(1.1 * (peak + staged))


def _device_free_bytes(device) -> int:
    """Free device memory (``torch.cuda.mem_get_info``); for the CPU, the
    host's available physical memory.  ``SRTPU_HBM_BYTES`` overrides
    either, as in the JAX CLI (``cli.py:588-597``)."""
    import torch

    if os.environ.get('SRTPU_HBM_BYTES'):
        return int(os.environ['SRTPU_HBM_BYTES'])
    if device.type == 'cuda':
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf('SC_AVPHYS_PAGES') * os.sysconf('SC_PAGE_SIZE')


def _is_torch_checkpoint(path: str) -> bool:
    """torch.save writes a zip archive ('PK') or a legacy pickle
    ('\\x80<proto>'); the JAX package's own checkpoints are msgpack."""
    with open(path, 'rb') as f:
        magic = f.read(4)
    return magic.startswith(b'PK') or magic[:1] == b'\x80'


def _load_backbone(trainer, path: str) -> None:
    """Backbone weights from a flax msgpack file (``params`` and
    ``batch_stats`` as the JAX package writes them) or a torch ``.pth``,
    whose flavour is sniffed as the JAX CLI sniffs it: a torchvision ViT
    (``conv_proj.weight``), a CLIP visual tower (``ln_pre.weight``), a
    reference checkpoint (its ``convnet_nouns``, else ``convnet_verbs``)
    or a torchvision ResNet.  A ViT's position embedding is resampled to
    the trainer's ``image_size``; a grid that still differs raises.  The
    load is then tolerant by name (``Trainer.load_backbone_state``)."""
    import torch

    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.utils import msgpack

    size = trainer.config.image_size
    if path.endswith('.msgpack'):
        tree = msgpack.read(path)
        params = tree['params']
        if 'cls_token' in params:
            sd = convert.vit_state_from_jax(params)
        else:
            sd = convert.resnet_state_from_jax(params,
                                               tree.get('batch_stats') or {})
    else:
        sd = torch.load(path, map_location='cpu', weights_only=True)
        if isinstance(sd, dict) and 'model_state_dict' in sd:
            sd = sd['model_state_dict']
        if 'conv_proj.weight' in sd:                       # torchvision ViT
            sd = convert.convert_vit(sd, image_size=size)
        elif any(k.endswith('ln_pre.weight') for k in sd):  # CLIP visual
            sd = convert.convert_clip_vit(sd, image_size=size)
        else:
            for twin in ('convnet_nouns.model.', 'convnet_verbs.model.'):
                if any(k.startswith(twin) for k in sd):
                    sd = {k[len(twin):]: v for k, v in sd.items()
                          if k.startswith(twin)}
                    break
    pos = sd.get('encoder.pos_embedding')
    want = trainer.backbone.state_dict().get('encoder.pos_embedding')
    if want is not None and (pos is None
                             or tuple(pos.shape) != tuple(want.shape)):
        got = None if pos is None else tuple(pos.shape)
        raise ValueError(
            f'backbone pos_embed grid {got} does not match '
            f'--image_size {size} (expects {tuple(want.shape)}). A cached '
            f'backbone.msgpack converted at another --image_size cannot be '
            f'reused — delete it (the .pth auto-converts per size) or pass '
            f'the matching size.')
    trainer.load_backbone_state(sd)


def _save_backbone_msgpack(trainer, path: str) -> None:
    """The trainer's (converted) backbone as the flax msgpack file that
    ``_load_backbone`` and the JAX CLI read: ``params`` and
    ``batch_stats`` in the JAX layout."""
    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.utils import msgpack

    state = trainer._backbone_source()
    if 'encoder.pos_embedding' in state:
        tree = {'params': convert.vit_params_to_jax(
            state, trainer.backbone.heads), 'batch_stats': {}}
    else:
        tree = {'params': convert.resnet_params_to_jax(state),
                'batch_stats': convert.resnet_stats_to_jax(state)}
    msgpack.write(path, tree)


def _load_resume(trainer, path: str) -> dict:
    """A resume checkpoint (this package's, the reference's, a JAX export,
    or the JAX package's msgpack checkpoint, converted by
    ``convert.export_reference_checkpoint``) → its dict, the model and
    optimizer state already restored."""
    from situation_recognition_tpu_torch import convert
    from situation_recognition_tpu_torch.utils import msgpack
    from situation_recognition_tpu_torch.utils.checkpoint import (
        load_checkpoint)

    if _is_torch_checkpoint(path):
        ckpt = load_checkpoint(path)
    else:
        ckpt = convert.export_reference_checkpoint(msgpack.read(path))
    if not (ckpt.get('optimizer_state_dict') or {}).get('param_groups'):
        print('[srtorch] checkpoint has no optimizer state; starting with '
              'a fresh Adamax state', file=sys.stderr)
    trainer.load_model_state(ckpt)
    return ckpt


def _check_distributed(parser, args) -> None:
    """The JAX CLI's usage checks of ``--distributed``, and the port's: the
    world's flags need ``--distributed``, go together, or torchrun's
    environment stands in for them."""
    from situation_recognition_tpu_torch.parallel.distributed import (
        ENV_VARS)

    world = (('--coordinator', bool(args.coordinator)),
             ('--num_processes', args.num_processes != 0),
             ('--process_id', args.process_id != -1))
    if args.model_axis < 1:
        parser.error('--model_axis must be >= 1')
    if not args.distributed:
        for flag, on in world:
            if on:
                parser.error(f'{flag} needs --distributed')
        if args.model_axis > 1:
            parser.error(f'--model_axis {args.model_axis} needs '
                         f'--distributed: without it the CLI drives one '
                         f'card')
        return
    if args.test_img or args.subset > 0:
        parser.error('--distributed applies to the batch-iterated '
                     'modes (train / evaluate_dev / evaluate_test); '
                     'single-image inference runs on one process')
    if args.cache_device:
        parser.error('--distributed does not compose with '
                     '--cache_device (single-process HBM-resident '
                     'batching)')
    given = [on for _, on in world]
    if any(given) and not all(given):
        parser.error('--coordinator, --num_processes and --process_id go '
                     'together')
    if not any(given) and not all(v in os.environ for v in ENV_VARS):
        parser.error(f'--distributed needs torchrun\'s environment '
                     f'({", ".join(ENV_VARS)}) or --coordinator, '
                     f'--num_processes and --process_id')


def _check_usage(parser, args) -> None:
    """The JAX CLI's usage checks."""
    if args.cache_device and args.cache_decoded:
        parser.error('--cache_device and --cache_decoded are alternatives; '
                     'pick one')
    if args.packed_dir and args.cache_decoded:
        parser.error('--packed_dir already removes decode from the input '
                     'path; --cache_decoded would be silently ignored')
    if args.packed_dir and args.preproc == 'exact':
        parser.error('--preproc exact needs original pixels; --packed_dir '
                     'stores short-side-normalized images (double-resample '
                     'breaks reference-exact parity)')
    if args.preproc == 'exact' and args.image_size != 224:
        parser.error('--preproc exact is the reference\'s literal '
                     'Resize(224)+CenterCrop(224) pipeline; it cannot '
                     f'combine with --image_size {args.image_size}')
    if args.backbone_lr is not None and not args.train_backbone:
        parser.error('--backbone_lr needs --train_backbone (the frozen '
                     'backbone takes no optimizer steps)')
    if args.remat_backbone and not args.train_backbone:
        parser.error('--remat_backbone needs --train_backbone (a frozen '
                     'backbone stores no backward activations)')
    if args.lr_schedule == 'constant':
        if args.total_steps is not None:
            parser.error('--total_steps is the cosine/linear decay '
                         'horizon; it has no meaning with '
                         '--lr_schedule constant')
        if args.min_lr:
            parser.error('--min_lr is the cosine/linear decay floor; it '
                         'has no meaning with --lr_schedule constant')
    else:
        if args.total_steps is None:
            parser.error(f'--lr_schedule {args.lr_schedule} needs '
                         '--total_steps (the decay horizon in optimizer '
                         'steps)')
        if args.total_steps <= args.warmup_steps:
            parser.error(f'--total_steps ({args.total_steps}) must exceed '
                         f'--warmup_steps ({args.warmup_steps})')
    if args.warmup_steps < 0:
        parser.error('--warmup_steps must be >= 0')
    if args.min_lr < 0 or args.min_lr > args.lr:
        parser.error(f'--min_lr must be in [0, --lr={args.lr}]')


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_distributed(parser, args)
    _check_usage(parser, args)
    random.seed(args.seed)
    stdout = sys.stdout
    try:
        _main(args)
    finally:
        if sys.stdout is not stdout:
            sys.stdout.close()
            sys.stdout = stdout


def _main(args) -> None:

    import torch

    from situation_recognition_tpu_torch.data.dataset import (
        ImsituDataset, ImsituLoader)
    from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
    from situation_recognition_tpu_torch.device import resolve_device
    from situation_recognition_tpu_torch.inference import (
        analize_subset, print_results, results)
    from situation_recognition_tpu_torch.train import Trainer, TrainerConfig

    # 'auto' is the card: without one this raises rather than carrying on
    # on the CPU
    device = resolve_device('cpu' if args.platform == 'cpu' else 'cuda')
    mesh = None
    if args.distributed:
        from situation_recognition_tpu_torch.parallel import (
            init_distributed, make_mesh)

        # cuda → this rank's card (LOCAL_RANK); NCCL on the card, gloo on
        # the CPU
        device = init_distributed(
            args.coordinator or None, args.num_processes or None,
            args.process_id if args.process_id >= 0 else None,
            device=device)
        mesh = make_mesh(model=args.model_axis)
        if mesh.rank != 0:
            # one rank speaks: the reference's stdout from rank 0 (every
            # rank computes the same metrics); stderr stays live
            sys.stdout = open(os.devnull, 'w')
    # only rank 0 writes the encoder and the backbone cache (concurrent
    # writes to one path would corrupt them)
    is_main = mesh is None or mesh.rank == 0

    Path(args.saving_folder).mkdir(exist_ok=True)
    checkpoint = None

    # the encoder is always train.json's (the reference's behaviour)
    encoder_json = _load_json(pjoin(args.dataset_folder, 'train.json'))
    train_json = (encoder_json if args.train_file == 'train.json'
                  else _load_json(pjoin(args.dataset_folder,
                                        args.train_file)))
    dev_json = _load_json(pjoin(args.dataset_folder, args.dev_file))
    test_json = _load_json(pjoin(args.dataset_folder, args.test_file))

    encoder_path = pjoin(args.saving_folder, 'encoder')
    if not pisfile(encoder_path):
        encoder = ImsituEncoder(encoder_json)
        if is_main:
            encoder.save(encoder_path)
    else:
        print("Loading encoder file")
        if _is_torch_checkpoint(encoder_path):
            # the reference's pickled encoder: its class is not importable
            # here and the vocabulary is derived data, so rebuild it from
            # train.json and leave the file alone
            print('[srtorch] encoder file is a reference torch pickle; '
                  'rebuilding the (identical) vocab from train.json',
                  file=sys.stderr)
            encoder = ImsituEncoder(encoder_json, verbose=False)
        else:
            encoder = ImsituEncoder.load(encoder_path)

    if args.precision == 'bf16' or (args.precision == 'auto'
                                    and device.type == 'cuda'):
        dtype = torch.bfloat16
    else:
        dtype = torch.float32
    # the loaders and steps run at the microbatch; an optimizer step takes
    # grad_accum of them, --batch_size rounded up to a multiple of the data
    # axis (and of the world: each rank loads an equal block) x grad_accum
    batch = args.batch_size
    accum = max(1, args.grad_accum)
    world = 1 if mesh is None else mesh.world
    ndata = 1 if mesh is None else mesh.data
    quantum = math.lcm(ndata, world) * accum
    if batch % quantum != 0:
        batch = -(-batch // quantum) * quantum
        print(f'[srtorch] batch_size rounded up to {batch} (divisible by '
              f'data axis {ndata} x grad_accum {accum}'
              + (f' x world {world}' if world > 1 else '') + ')',
              file=sys.stderr)
    batch //= accum
    cfg = TrainerConfig(
        hidden=_default_hidden(args.backbone), lr=args.lr, batch_size=batch,
        epochs=args.epochs, backbone=args.backbone, compute_dtype=dtype,
        seed=args.seed, image_size=args.image_size,
        ggnn_impl='kernel' if args.ggnn == 'pallas' else args.ggnn,
        frozen_backbone_bn=args.frozen_bn, grad_accum=accum,
        train_backbone=args.train_backbone, backbone_lr=args.backbone_lr,
        remat_backbone=args.remat_backbone, lr_schedule=args.lr_schedule,
        warmup_steps=args.warmup_steps, total_steps=args.total_steps,
        min_lr=args.min_lr, model_axis=args.model_axis)

    # only the splits the mode reads are built (construction encodes every
    # annotation, and --cache_device decodes and uploads the split)
    if args.evaluate_dev:
        need = ('dev',)
    elif args.evaluate_test:
        need = ('test',)
    elif args.test_img:
        need = ()                  # one image, no split
    elif args.subset > 0:
        need = ('dev',)            # analize_subset indexes dev per image
    else:
        need = ('train', 'dev')
    # the inference modes index images one by one: no window cache
    per_image = bool(args.test_img) or args.subset > 0
    splits = {}
    if 'train' in need:
        splits['train'] = ImsituDataset(args.imgset_dir, train_json,
                                        encoder, train=True)
    for split, ann in (('dev', dev_json), ('test', test_json)):
        if split in need:
            splits[split] = ImsituDataset(args.imgset_dir, ann, encoder,
                                          train=False, preproc=args.preproc)

    # --cache_device is an optimisation, not a semantic: a split whose
    # windows would leave the run too little device memory streams (an
    # eval split caches the prefix that fits)
    budget = None
    if args.cache_device and splits and not per_image:
        reserve = _working_reserve(
            encoder, cfg, device,
            max(ds.window_size for ds in splits.values()),
            train='train' in splits)
        budget = _device_free_bytes(device) - reserve
        if reserve:
            print(f'[srtorch] --cache_device: the run needs '
                  f'{reserve / 1e9:.2f} GB of device memory beside the '
                  f'windows (measured by a probe step)', file=sys.stderr)

    for split, dataset in splits.items():
        if args.packed_dir:
            dataset.enable_packed(args.packed_dir)
        elif args.cache_decoded:
            dataset.enable_decode_cache()
        if budget is None:
            continue
        S = dataset.window_size
        row_bytes = S * S * 3
        need_bytes = len(dataset.names) * row_bytes
        if need_bytes <= budget:
            dataset.enable_window_cache()
            budget -= need_bytes
            continue
        rows = int(max(budget, 0) // row_bytes)
        if split != 'train' and rows >= batch:
            dataset.enable_window_cache(max_rows=rows)
            budget -= rows * row_bytes
            print(f'[srtorch] --cache_device: {split} split '
                  f'({need_bytes / 1e9:.1f} GB of windows) exceeds '
                  f'the device budget — caching the first '
                  f'{rows}/{len(dataset.names)} rows and streaming '
                  f'the rest', file=sys.stderr)
        else:
            print(f'[srtorch] --cache_device: {split} split '
                  f'({need_bytes / 1e9:.1f} GB of windows) exceeds '
                  f'the device budget ({max(budget, 0) / 1e9:.1f} '
                  f'GB after the working reserve) — streaming it',
                  file=sys.stderr)

    # each rank loads its data block of every global batch
    shard = None if mesh is None else (mesh.data_index, mesh.data)
    train_loader = dev_loader = test_loader = None
    if 'train' in splits:
        train_loader = ImsituLoader(splits['train'], batch_size=batch,
                                    shuffle=True, seed=args.seed,
                                    num_workers=args.num_workers,
                                    shard=shard)
    if 'dev' in splits:
        dev_loader = ImsituLoader(splits['dev'], batch_size=batch,
                                  shuffle=False,
                                  num_workers=args.num_workers, shard=shard)
    if 'test' in splits:
        # shuffled, as the reference's test loader
        test_loader = ImsituLoader(splits['test'], batch_size=batch,
                                   shuffle=True, seed=args.seed,
                                   num_workers=args.num_workers, shard=shard)

    trainer = Trainer(encoder, cfg, device=device, mesh=mesh)

    if args.backbone_ckpt:
        _load_backbone(trainer, args.backbone_ckpt)
    else:
        # the reference starts from pretrained features; with no network,
        # a checkpoint dropped at <saving_folder>/backbone.{msgpack,pth,pt}
        # is picked up, the converted msgpack first (per --image_size, as
        # the JAX CLI names it); a .pth is converted and cached as that
        # msgpack for the next run
        cache_name = ('backbone.msgpack' if args.image_size == 224
                      else f'backbone_{args.image_size}.msgpack')
        default_bb = next((p for p in [pjoin(args.saving_folder, cache_name)]
                           + [pjoin(args.saving_folder, 'backbone' + ext)
                              for ext in ('.pth', '.pt')]
                           if pisfile(p)), None)
        if default_bb is not None:
            _load_backbone(trainer, default_bb)
            if not default_bb.endswith('.msgpack') and is_main:
                cache = pjoin(args.saving_folder, cache_name)
                _save_backbone_msgpack(trainer, cache)
                print(f'[srtorch] converted {default_bb} -> {cache} '
                      '(picked up automatically next run)', file=sys.stderr)
        elif len(args.resume_model) <= 1:
            print('[srtorch] no pretrained backbone found (drop a '
                  'torchvision .pth at '
                  f'{pjoin(args.saving_folder, "backbone.pth")}, or use '
                  '--backbone_ckpt); training from random backbone '
                  'weights', file=sys.stderr)

    if len(args.resume_model) > 1:
        print('Resume training from: {}'.format(args.resume_model))
        checkpoint = _load_resume(
            trainer, pjoin(args.saving_folder, args.resume_model))
        args.model_saving_name = args.resume_model

    if args.evaluate_dev:
        print('=> evaluating model with dev-set...')
        trainer.evaluate(dev_loader, logging=True)
    elif args.evaluate_test:
        print('=> evaluating model with test-set...')
        trainer.evaluate(test_loader, logging=True)
    elif args.test_img:
        print_results(args.test_img, *results(
            trainer, args.test_img, encoder, args.verb,
            preproc=args.preproc))
    elif args.subset > 0:
        analize_subset(trainer, splits['dev'], encoder, args.subset)
    else:
        print('Model training started!')
        # _load_resume restored the model and optimizer; fit takes only
        # the bookkeeping (epoch, histories, mid)
        fit_ckpt = None
        if checkpoint is not None:
            fit_ckpt = {k: v for k, v in checkpoint.items()
                        if k not in ('model_state_dict',
                                     'optimizer_state_dict')}
        trainer.fit(train_loader, dev_loader, args.model_saving_name,
                    folder=args.saving_folder, checkpoint=fit_ckpt,
                    save_every_steps=args.save_steps or None,
                    handle_sigterm=True, keep_best=args.keep_best,
                    metrics_jsonl=args.metrics_jsonl or None,
                    async_save=args.async_save)


if __name__ == '__main__':
    main()
