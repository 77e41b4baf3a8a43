"""Train-mode BatchNorm with the ReLU and the residual add that follow it,
for the frozen ResNet on the card: the CUDA kernel pair of
``csrc/batchnorm.cu`` and its plain twin.

``batchnorm_act(x, bn, residual, relu)`` is ``relu?(bn(x) + residual?)``
for a ``models.resnet.BatchNorm`` in train mode on its own batch: batch
statistics in f32 with the biased variance, the running statistics
updated once (momentum ``bn.momentum`` on the mean and the biased
variance) and ``num_batches_tracked`` advanced.  It launches the pair,
built by ``nvcc`` at first use and bound with ``ctypes``, or raises; there
is no fallback:

* ``batchnorm_stats_kernel`` — the statistics in one read of x, and the
  running update, in one launch;
* ``batchnorm_apply_kernel`` — the normalisation, the residual add and
  ReLU in one pass, written over x.

The kernels take (N, C, H, W) bf16 or f32 CUDA tensors, channels-last or
plain contiguous NCHW, with f32 BN parameters and statistics
(``kernel_takes``), C channels of any count: channels-last, 16 bytes of
consecutive channels a thread where C allows, one channel a thread
otherwise; NCHW one channel a column of blocks, a block's threads along
the rows.  Their grids come from ``plan``.
``batchnorm_act.launches`` counts the calls that launched the pair.  The
twin, ``batchnorm_act_reference``, is the port's composition of torch ops
(``native_batch_norm``, the running update, ``add``, ``relu``), which the
CPU and every other case run through the module.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from situation_recognition_tpu_torch.ops import _build

#: csrc/batchnorm.cu's block size, loads in flight a thread, and the
#: statistics kernel's blocks an SM (its ``__launch_bounds__``)
THREADS, UNROLL, STATS_BLOCKS_PER_SM = 256, 4, 4
#: the apply kernel's grid strides over rows in this many blocks an SM
APPLY_BLOCKS_PER_SM = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: csrc/batchnorm.cu's layouts: channels-last one channel a thread,
#: channels-last 16 bytes of channels a thread, plain NCHW ("planar")
SCALAR, VECTOR, PLANAR = 0, 1, 2

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
#: csrc/batchnorm.cu's entry points → their parameters' ctypes types
SIGNATURES = {
    "batchnorm_stats": [_I, _I, _P] + [_I] * 5 + [_P] * 6
                       + [_F, _F, _D, _P],
    "batchnorm_apply": [_I, _I, _P, _P, _P] + [_I] * 5 + [_P] * 3
                       + [_I, _P],
}

# per (device index, stream): the statistics kernel's tickets, zero
# between launches (each launch's last blocks reset theirs)
_tickets: dict = {}


class Grid(NamedTuple):
    """A kernel's grid: tx threads of a block along the channels (a power
    of two, at most 32), 256 / tx along the rows; gx blocks along the
    channels, gy along the rows."""

    tx: int
    gx: int
    gy: int


class Plan(NamedTuple):
    stats: Grid
    apply: Grid


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _grid(rows: int, cv: int, tx: int, blocks: int) -> Grid:
    gx = -(-cv // tx)
    most = -(-rows // (THREADS // tx * UNROLL))
    return Grid(tx, gx, max(1, min(most, blocks // gx)))


@functools.lru_cache(maxsize=None)
def plan(rows: int, channels: int, vec: int, sms: int,
         planar: bool = False) -> Plan:
    """The grids for (rows, C) at ``vec`` channels a thread on a card of
    ``sms`` SMs, no more blocks along the rows than give each thread
    ``UNROLL`` rows.  The statistics: one wave (``STATS_BLOCKS_PER_SM``
    blocks an SM) in up to 8 columns of blocks, each at least 8 vectors
    wide (a 128-byte line of a row in bf16; narrower columns read the rows
    slower), so that each column's last block merges few partials.  The
    apply: ``APPLY_BLOCKS_PER_SM`` blocks an SM, rows of up to 32
    vectors.  (Both measured on an H100 against other widths and counts:
    PERF.md §6.)  ``planar`` (NCHW, ``vec`` 1): a column of blocks a
    channel, each block's 256 threads along its rows, so that a warp reads
    32 consecutive elements of a plane."""
    if planar:
        return Plan(*(_grid(rows, channels, 1, sms * k)
                      for k in (STATS_BLOCKS_PER_SM, APPLY_BLOCKS_PER_SM)))
    cv = channels // vec
    stats_tx = min(32, _pow2(cv), max(8, _pow2(-(-cv // 8))))
    return Plan(_grid(rows, cv, stats_tx, sms * STATS_BLOCKS_PER_SM),
                _grid(rows, cv, min(32, _pow2(cv)),
                      sms * APPLY_BLOCKS_PER_SM))


def _planar(t: torch.Tensor):
    """False for a channels-last contiguous (N, C, H, W) tensor, True for a
    plain contiguous one that is not also channels-last, None for any other
    layout."""
    if t.is_contiguous(memory_format=torch.channels_last):
        return False
    return True if t.is_contiguous() else None


def kernel_takes(x: torch.Tensor, bn, residual=None) -> bool:
    """True when the kernels take x (and the residual) with ``bn``'s
    tensors: x a non-empty (N, C, H, W) bf16 or f32 tensor, channels-last
    or plain contiguous, of fewer than 2^31 rows N·H·W, the residual of
    its shape, type and layout, the scale, shift and running statistics
    f32 and the batch count int64, all on x's device."""
    if x.dtype not in _DTYPES or x.dim() != 4 or x.numel() == 0 \
            or x.numel() // x.shape[1] >= 2 ** 31 or _planar(x) is None:
        return False
    if residual is not None and (
            residual.shape != x.shape or residual.dtype != x.dtype
            or residual.device != x.device
            or _planar(residual) is not _planar(x)):
        return False
    f32 = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    return all(t is not None and t.dtype == torch.float32
               and t.device == x.device for t in f32) \
        and bn.num_batches_tracked is not None \
        and bn.num_batches_tracked.dtype == torch.int64 \
        and bn.num_batches_tracked.device == x.device


# ------------------------------------------------------------- the twin


def batch_norm_train(x: torch.Tensor, bn, update: bool = True):
    """Train-mode BN of x over its own batch (``native_batch_norm``: f32
    statistics, x normalised in f32 and rounded to its type),
    differentiable in x and in the scale and shift; where ``update``, the
    running statistics moved toward the batch's, (1 - m) · running + m ·
    batch for the mean and the biased variance (from the invstd), and one
    more batch counted."""
    y, mean, invstd = torch.native_batch_norm(
        x, bn.weight, bn.bias, None, None, True, 0.0, bn.eps)
    if update:
        with torch.no_grad():
            m = bn.momentum
            var = torch.clamp_min(torch.reciprocal(invstd * invstd)
                                  - bn.eps, 0.0)
            bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1 - m) * bn.running_var + m * var)
            bn.num_batches_tracked.add_(1)
    return y


def batchnorm_act_reference(x: torch.Tensor, bn, residual=None,
                            relu: bool = True) -> torch.Tensor:
    """The twin: ``relu?(batch_norm_train(x, bn) + residual?)``, in new
    tensors."""
    y = batch_norm_train(x, bn)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


# ------------------------------------------------------------- the card


def _geometry(x: torch.Tensor, *others) -> tuple:
    """(rows, C, H·W, layout, plan) of x on its card."""
    n, c, h, w = x.shape
    rows = n * h * w
    planar = _planar(x)
    vec = 16 // x.element_size()
    if planar or c % vec or any(t.data_ptr() % 16 for t in (x,) + others):
        vec = 1
    layout = PLANAR if planar else VECTOR if vec > 1 else SCALAR
    return rows, c, h * w, layout, plan(rows, c, vec,
                                        _build.sm_count(x.device), planar)


def _tickets_for(x: torch.Tensor, stream: int, gx: int) -> torch.Tensor:
    key = (x.device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < gx:
        t = torch.zeros(max(gx, 64), dtype=torch.int32, device=x.device)
        _tickets[key] = t
    return t


def _check(x: torch.Tensor, bn, residual) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no batchnorm kernel for device {x.device}")
    if not kernel_takes(x, bn, residual):
        raise ValueError(
            "the batchnorm kernels take a non-empty (N, C, H, W) bf16 or f32 "
            "tensor, channels-last or contiguous, a residual of its shape, "
            "type and layout, f32 BN parameters and statistics and an int64 "
            f"batch count on its device; got x {tuple(x.shape)} {x.dtype} "
            f"{x.device} strides {x.stride()}")


# The launches: on x's card (``torch.cuda.device``) and its current stream,
# both entered once by the callers below.


def _stats(x, bn, geometry, stream: int) -> torch.Tensor:
    rows, c, hw, layout, p = geometry
    g = p.stats
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    scratch = torch.empty(2 * g.gy * c + g.gx * g.gy, dtype=torch.float32,
                          device=x.device)
    m = bn.momentum
    _build.launch(
        "batchnorm.cu", "batchnorm_stats", SIGNATURES, _DTYPES[x.dtype],
        layout, x.data_ptr(), rows, c, hw, g.tx, g.gy, scratch.data_ptr(),
        _tickets_for(x, stream, g.gx).data_ptr(), stats.data_ptr(),
        bn.running_mean.data_ptr(), bn.running_var.data_ptr(),
        bn.num_batches_tracked.data_ptr(), 1 - m, m, float(bn.eps), stream)
    return stats


def _apply(x, bn, stats, residual, relu: bool, out, geometry,
           stream: int) -> None:
    rows, c, hw, layout, p = geometry
    _build.launch(
        "batchnorm.cu", "batchnorm_apply", SIGNATURES, _DTYPES[x.dtype],
        layout, x.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        rows, c, hw, p.apply.tx, p.apply.gy, stats.data_ptr(),
        bn.weight.data_ptr(), bn.bias.data_ptr(), int(relu), stream)


def _lone_stats(x: torch.Tensor, bn) -> torch.Tensor:
    """The statistics kernel alone on a CUDA x (``kernel_takes``; for the
    card tests and ``chip_smoke.py``): → (2, C) f32, the batch's mean and
    1/sqrt(var + eps); ``bn``'s running statistics and batch count
    updated."""
    _check(x, bn, None)
    with torch.cuda.device(x.device):
        return _stats(x, bn, _geometry(x), _build.stream(x))


def _lone_apply(x: torch.Tensor, bn, stats: torch.Tensor,
               residual=None, relu: bool = True) -> torch.Tensor:
    """The apply kernel alone on a CUDA x (``kernel_takes``; for the card
    tests and ``chip_smoke.py``) with ``stats`` (2, C) f32, mean and
    invstd: → a new tensor of x's shape, type and layout holding
    relu?(round(w (x - mean) invstd + b) + residual?)."""
    _check(x, bn, residual)
    c = x.shape[1]
    if stats.shape != (2, c) or stats.dtype != torch.float32 \
            or stats.device != x.device or not stats.is_contiguous():
        raise ValueError(f"stats must be (2, {c}) f32 on {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _apply(x, bn, stats, residual, relu, out, _geometry(
            x, out, *(() if residual is None else (residual,))),
            _build.stream(x))
    return out


def batchnorm_act(x: torch.Tensor, bn, residual=None,
                  relu: bool = True) -> torch.Tensor:
    """``relu?(bn(x) + residual?)`` with ``bn`` in train mode on x's own
    batch, its running statistics updated: the kernel pair on x's card,
    writing the result over x (which the caller gives up: under no
    gradient, a convolution's output that nothing else reads).  Raises for
    any tensor the kernels do not take (``kernel_takes``), a CPU one
    included."""
    _check(x, bn, residual)
    geometry = _geometry(x, *(() if residual is None else (residual,)))
    with torch.cuda.device(x.device):
        stream = _build.stream(x)
        _apply(x, bn, _stats(x, bn, geometry, stream), residual, relu, x,
               geometry, stream)
    batchnorm_act.launches += 1
    return x


batchnorm_act.launches = 0
