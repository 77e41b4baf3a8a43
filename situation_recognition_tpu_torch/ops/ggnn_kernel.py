"""The folded multi-step GGNN kernels: CUDA kernels, their plain twins, and
the wrappers that choose between them by the device of the tensors.

Replaces three TPU kernels of ``situation_recognition_tpu/ops/ggnn_pallas.py``:

* K1 ``_folded_kernel`` (driven by ``ggnn_propagate_fused`` and
  ``_propagate_fwd_impl``), the forward: ``folded_rows``;
* K2 ``_folded_kernel_res`` (driven by ``_propagate_fwd_res_impl``), the
  forward that also returns each step's residuals: ``folded_rows_res``;
* K3 ``_folded_kernel_bwd`` (driven by ``_pallas_bwd``), the backward of
  the input: ``folded_bwd_rows``.

``W_p`` folds into the gate weights exactly (``fold_gate_weights``, f32
products):

    n @ W_g = agg @ (W_p W_g) + bias_mult * (b_p W_g)

so one step is ``agg = E @ h`` (the block adjacency of whole examples),
``agg @ [WpWz|WpWr|WpWh]``, ``h @ [Uz|Ur]`` and ``(r*h) @ Uh`` with the
gates in f32 and h kept in bf16 between steps — the TPU kernel's numerics.

* ``folded_reference``, ``folded_reference_res``, ``folded_bwd_reference``
  — the same functions step by step in PyTorch with the same bf16 casts
  (bf16 values multiplied in f32, which is exact, and summed in f32).  The
  CPU tests hold them against the JAX kernels in interpret mode;
  ``chip_smoke.py`` holds the CUDA kernels against them.
* ``folded_rows``, ``folded_rows_res``, ``folded_bwd_rows`` — the
  wrappers: a CPU tensor goes to the twin; a CUDA tensor launches
  ``csrc/ggnn_folded.cu`` (K1, K2) or ``csrc/ggnn_folded_bwd.cu`` (K3),
  built by ``nvcc`` at first use and bound with ``ctypes``, or raises.
  There is no fallback.  Each wrapper's ``launches`` counts its launches.
* ``torch.ops.srtorch.ggnn_folded`` — K1 as a ``torch.library`` custom
  op over the prepared operands (``kernel_weights``) and the bias, so that
  ``torch.export`` can trace a program through it (a ctypes launch cannot
  be traced); its fake implementation gives the shape only.
  ``folded_rows`` launches through it on the card, and a serving program
  calls it with operands prepared once at load (``folded_rows_prepared``,
  ``ggnn_propagate_prepared``).  On CPU tensors the op runs the twin.
* ``folded_operands`` — K1/K2's weights in the layout their GEMMs read
  (``kernel_weights``), kept until the folded weights are written in
  place or freed; ``tile_plan`` — their tiles for (M, d); ``bwd_tile_plan``
  — K3's.  K3 reads the folded weights as ``fold_gate_weights`` returns
  them.
* ``ggnn_propagate_folded`` — the (B, R, D) entry, flattening the batch
  into rows of whole examples as ``_propagate_fwd_impl`` does.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import NamedTuple

import torch

from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

#: the kernels take any d that is a multiple of this (a gate tile's group
#: of columns of h)
D_MULTIPLE = 64
#: streaming multiprocessors of an H100 SXM, for plans made without a card
H100_SMS = 132


def fold_gate_weights(params: GGNNParams, bias_mult: float,
                      dtype: torch.dtype = torch.bfloat16):
    """Fold W_p / bias_mult*b_p into the gate weights and biases.

    Returns (wa (d, 3d), uzr (d, 2d), uh (d, d), ba (1, 3d) f32), gate
    order [z | r | c] along the wide axis:

        wa  = [W_p W_z | W_p W_r | W_p W_h]
        uzr = [U_z | U_r]
        ba  = [bias_mult*b_p W_g + b_wg + b_ug  for g in (z, r, h)]
    """
    f32 = torch.float32
    wp = params.w_p.to(f32)
    bp = params.b_p.to(f32)
    gates = [(params.w_z, params.b_wz, params.b_uz),
             (params.w_r, params.b_wr, params.b_ur),
             (params.w_h, params.b_wh, params.b_uh)]
    wa = torch.cat([wp @ g[0].to(f32) for g in gates], dim=1)
    ba = torch.cat([bias_mult * (bp @ g[0].to(f32))
                    + g[1].to(f32) + g[2].to(f32) for g in gates])[None, :]
    uzr = torch.cat([params.u_z, params.u_r], dim=1)
    return (wa.to(dtype).contiguous(), uzr.to(dtype).contiguous(),
            params.u_h.to(dtype).contiguous(), ba.contiguous())


def block_adjacency(mask_rows: torch.Tensor, r: int) -> torch.Tensor:
    """(M,) role mask of whole examples → (M//r, r, r) per-example blocks
    of ``E = same * m mᵀ + diag(1 - 2m)``, rounded to bf16 like the TPU
    kernel's adjacency scratch.  Mask 0 gives E = I (the verb branch)."""
    m = mask_rows.to(torch.float32).reshape(-1, r)
    eye = torch.eye(r, dtype=torch.float32, device=m.device)
    e = m[:, :, None] * m[:, None, :] + eye * (1.0 - 2.0 * m)[:, :, None]
    return e.to(torch.bfloat16).to(torch.float32)


def _folded_steps(h, mask_rows, weights, r: int, steps: int, keep):
    wa, uzr, uh, ba = weights
    m, d = h.shape
    e = block_adjacency(mask_rows, r)
    wa_f, uzr_f, uh_f = wa.float(), uzr.float(), uh.float()
    ba_f = ba.float().reshape(1, 3 * d)
    for _ in range(steps):
        hf = h.float()
        agg = torch.einsum("bij,bjd->bid", e, hf.reshape(-1, r, d))
        agg = agg.reshape(m, d).to(torch.bfloat16).float()
        ga = agg @ wa_f + ba_f
        gh = hf @ uzr_f
        z = torch.sigmoid(ga[:, :d] + gh[:, :d])
        rr = torch.sigmoid(ga[:, d:2 * d] + gh[:, d:])
        rh = (rr * hf).to(torch.bfloat16).float()
        c = torch.tanh(ga[:, 2 * d:] + rh @ uh_f)
        if keep is not None:
            bf = torch.bfloat16
            keep.append((h, z.to(bf), rr.to(bf), c.to(bf)))
        h = ((1.0 - z) * hf + z * c).to(torch.bfloat16)
    return h


def folded_reference(h: torch.Tensor, mask_rows: torch.Tensor, weights,
                     r: int, steps: int) -> torch.Tensor:
    """Plain PyTorch twin of K1.  h (M, d) bf16 rows of whole examples,
    mask_rows (M,) → (M, d) bf16."""
    return _folded_steps(h, mask_rows, weights, r, steps, None)


def folded_reference_res(h: torch.Tensor, mask_rows: torch.Tensor, weights,
                         r: int, steps: int):
    """Plain PyTorch twin of K2: K1's output and the residual stacks
    ``(hs, zs, rs, cs)``, each (steps, M, d) bf16 — the step's input h
    and the bf16 gates z, r, c."""
    keep = []
    out = _folded_steps(h, mask_rows, weights, r, steps, keep)
    m, d = h.shape
    if not keep:
        empty = h.new_empty((0, m, d))
        return out, (empty,) * 4
    return out, tuple(torch.stack(x) for x in zip(*keep))


def kernel_weights(weights):
    """``fold_gate_weights`` output → the B operands of K1/K2's GEMMs, each
    K-major (output features by input features), contiguous:

    * ``w_zr`` (2d, d): ``wa[:, :2d]ᵀ`` with its rows in 64-row groups
      ``[z_j | r_j]`` for j = 0 .. d/64 - 1, i.e. row ``128 j + 64 g + i``
      is column ``g d + 64 j + i`` of ``wa`` (g = 0 for z, 1 for r);
    * ``u_zr`` (2d, d): ``uzrᵀ`` in the same order;
    * ``w_h`` (d, d): ``wa[:, 2d:]ᵀ``; ``u_h`` (d, d): ``uhᵀ``.

    A gate tile of 128 columns then holds z and r of the same 64 columns
    of h, and the candidate sums ``agg @ WpWh`` and ``rh @ Uh`` in one
    accumulator."""
    wa, uzr, uh, _ = weights
    d = wa.shape[0]
    groups = d // D_MULTIPLE

    def zr_groups(w):
        return (w.t().reshape(2, groups, D_MULTIPLE, d).transpose(0, 1)
                .reshape(2 * d, d).contiguous())

    return (zr_groups(wa[:, :2 * d]), zr_groups(uzr),
            wa[:, 2 * d:].t().contiguous(), uh.t().contiguous())


# id of each of (wa, uzr, uh) → (weak references to them, their
# ``_version``s, ``kernel_weights`` of them); an entry goes when one of its
# tensors is freed
_KERNEL_WEIGHTS: dict = {}


def folded_operands(weights):
    """``kernel_weights(weights)``, built once per set of folded weights:
    kept while ``wa``, ``uzr`` and ``uh`` live and rebuilt after an
    in-place write to any of them (``GGNN.folded`` hands the same tensors
    to every call until a GGNN weight changes).  Tensors made under
    ``torch.inference_mode`` (the serving paths fold there) keep no version
    counter, so only their identity is the key."""
    src = tuple(weights[:3])
    key = tuple(id(t) for t in src)
    versions = tuple(None if t.is_inference() else t._version for t in src)
    hit = _KERNEL_WEIGHTS.get(key)
    if (hit is not None and hit[1] == versions
            and all(ref() is t for ref, t in zip(hit[0], src))):
        return hit[2]
    with torch.no_grad():
        prepared = kernel_weights(weights)

    def drop(_, key=key):
        _KERNEL_WEIGHTS.pop(key, None)

    _KERNEL_WEIGHTS[key] = (tuple(weakref.ref(t, drop) for t in src),
                            versions, prepared)
    return prepared


def gemm_smem(bm: int, bn: int) -> int:
    """Dynamic shared memory of a block of the GGNN kernels' GEMM on bm ×
    bn tiles, as ``csrc/ggnn_gemm.cuh``'s ``Layout`` lays it out: 1024
    bytes to align the ring, then up to 8 stages of (bm + bn) rows of 64
    bf16 and a 16-byte pair of barriers each, within a block's 232,448
    bytes.  Raises for a tile that leaves the ring fewer than 4 stages,
    which the GEMM does not compile."""
    stage = (bm + bn) * 64 * 2
    stages = min(8, (232448 - 1024) // (stage + 16))
    if stages < 4:
        raise ValueError(f"a {bm}x{bn} tile leaves {stages} ring stages")
    return 1024 + stages * (stage + 16)


class TilePlan(NamedTuple):
    """Tiles of one step's GEMMs, rows by output columns: the gate's
    (``gate_bn`` / 128 groups of z and r of 64 columns each) and the
    candidate's."""
    gate_bm: int
    gate_bn: int
    cand_bm: int
    cand_bn: int


def _rounds_cost(m: int, n: int, bm: int, bn: int, sms: int) -> int:
    """Clocks per 64-deep stage of the busiest SM for an (m, n) output in
    bm × bn tiles: rounds of tiles over the SMs times one tile's stage, its
    products (2·bm·bn·64 FLOP at 4096 FLOP/clk) plus its operand bytes
    ((bm + bn)·128 at 64 B/clk), which the card does not fully overlap (the
    sum, not the larger, orders the plans as the card measured them:
    PERF.md §6)."""
    tiles = math.ceil(m / bm) * (n // bn)
    return math.ceil(tiles / sms) * (bm * bn // 32 + 2 * (bm + bn))


def _best_tile(m: int, n: int, widths, sms: int) -> tuple:
    return min((_rounds_cost(m, n, bm, bn, sms), -bm * bn, -bn, bm, bn)
               for bm in (128, 64) for bn in widths if n % bn == 0)[3:]


def tile_plan(m: int, d: int, sms: int = H100_SMS) -> TilePlan:
    """The tiles of K1/K2's GEMMs for M rows of width d on a card of
    ``sms`` SMs: for each GEMM the tile of least ``_rounds_cost``, ties to
    the larger tile.  Rows 128 or 64 (a 64-row tile splits its columns
    between the two consumer warpgroups); the gate's columns 256 or 128 of
    its 2d, the candidate's 256, 128 or 64 of its d."""
    return TilePlan(*_best_tile(m, 2 * d, (256, 128), sms),
                    *_best_tile(m, d, (256, 128, 64), sms))


class BwdTilePlan(NamedTuple):
    """Tiles of K3's three GEMMs of a reverse step, rows by output columns
    of d: drh (K = d), dagg (K = 3d) and the ``da[:, :2d] @ Uzrᵀ`` term
    (K = 2d)."""
    drh_bm: int
    drh_bn: int
    dagg_bm: int
    dagg_bn: int
    dh_bm: int
    dh_bn: int


def bwd_tile_plan(m: int, d: int, sms: int = H100_SMS) -> BwdTilePlan:
    """The tiles of K3's GEMMs for M rows of width d on a card of ``sms``
    SMs: for each, the tile of its (M, d) output of least
    ``_rounds_cost`` (clocks per 64-deep stage), ties to the larger tile;
    rows 128 or 64, columns 256, 128 or 64.  Their K (d, 3d, 2d) scales
    every tile's cost alike, so the three take the same tile."""
    return BwdTilePlan(*_best_tile(m, d, (256, 128, 64), sms) * 3)


def folded_bwd_reference(g: torch.Tensor, mask_rows: torch.Tensor, resids,
                         weights, r: int, steps: int):
    """Plain PyTorch twin of K3.  g (M, d) bf16, the cotangent of the
    output; ``resids`` from K2; ``weights`` from ``fold_gate_weights``.
    Returns (dh (M, d) bf16, da (steps, M, 3d) bf16): the reverse gate
    chain in f32, dh kept in f32 between steps, bf16(da) fed to the
    products, and dagg rounded to bf16 before E."""
    hs, zs, rs, cs = resids
    wa_t, uzr_t, uh_t = (w.float().t() for w in weights[:3])
    m, d = g.shape
    e = block_adjacency(mask_rows, r)
    dh = g.float()
    das = [None] * steps
    for t in reversed(range(steps)):
        h, z, rr, c = (x[t].float() for x in (hs, zs, rs, cs))
        dz = dh * (c - h)
        dc = dh * z
        dprev = dh * (1.0 - z)
        da_c = dc * (1.0 - c * c)
        drh = da_c.to(torch.bfloat16).float() @ uh_t
        dprev = dprev + drh * rr
        dr = drh * h
        da_z = dz * z * (1.0 - z)
        da_r = dr * rr * (1.0 - rr)
        da = torch.cat([da_z, da_r, da_c], dim=1).to(torch.bfloat16)
        das[t] = da
        daf = da.float()
        dagg = (daf @ wa_t).to(torch.bfloat16).float()
        dprev = dprev + torch.einsum(
            "bij,bjd->bid", e, dagg.reshape(-1, r, d)).reshape(m, d)
        dprev = dprev + daf[:, :2 * d] @ uzr_t
        dh = dprev
    da = torch.stack(das) if das else g.new_empty((0, m, 3 * d))
    return dh.to(torch.bfloat16), da


def _check_rows(h, mask_rows, r: int) -> tuple:
    if h.dim() != 2:
        raise ValueError(f"h must be (M, d), got {tuple(h.shape)}")
    m, d = h.shape
    if m < 1 or m % r != 0:
        raise ValueError(f"M={m} rows must be >= 1 whole examples of r={r}")
    if d % D_MULTIPLE != 0:
        raise ValueError(f"the GGNN kernel takes d that is a multiple of "
                         f"{D_MULTIPLE}, got d={d}")
    return m, d


def _check_tensors(device, want: dict) -> None:
    """``want``: name → (tensor, shape, dtype); each must match, lie on
    ``device``, and be contiguous and 16-byte aligned."""
    for name, (t, shape, dtype) in want.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, h on {device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def _check_cuda_args(h, mask_rows, weights, r: int) -> None:
    wa, uzr, uh, ba = weights
    m, d = _check_rows(h, mask_rows, r)
    bf = torch.bfloat16
    _check_tensors(h.device, {
        "h": (h, (m, d), bf), "mask": (mask_rows, (m,), torch.float32),
        "wa": (wa, (d, 3 * d), bf), "uzr": (uzr, (d, 2 * d), bf),
        "uh": (uh, (d, d), bf), "ba": (ba, (1, 3 * d), torch.float32)})


_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of each C entry: pointers, ints, the stream last
_SIGNATURES = {
    "ggnn_folded_forward": [_P] * 10 + [_I] * 8 + [_P],
    "ggnn_folded_forward_res": [_P] * 14 + [_I] * 8 + [_P],
    "ggnn_folded_backward": [_P] * 14 + [_I] * 10 + [_P],
    "ggnn_folded_smem": [_I] * 2,
    "ggnn_folded_maxnreg": [_I],
    "ggnn_folded_bwd_smem": [_I] * 2,
    "ggnn_folded_bwd_maxnreg": [_I],
}


def _lib(source: str, entry: str) -> ctypes.CDLL:
    from situation_recognition_tpu_torch.ops import _build

    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[entry]
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_args(h, mask_rows, weights, r: int, plan):
    """The launch arguments K1 and K2 share: a copy of h that the kernel
    updates in place, then mask, the prepared weights, ba and the scratch
    (agg, z, rh), and the tiles."""
    _check_cuda_args(h, mask_rows, weights, r)
    return _prepared_args(h, mask_rows, folded_operands(weights), weights[3],
                          r, plan)


def _prepared_args(h, mask_rows, operands, ba, r: int, plan):
    """``_forward_args`` from operands prepared already (``kernel_weights``)
    and the bias ba (1, 3d) f32, checked here."""
    m, d = _check_rows(h, mask_rows, r)
    bf, f32 = torch.bfloat16, torch.float32
    w_zr, u_zr, w_h, u_h = operands
    _check_tensors(h.device, {
        "h": (h, (m, d), bf), "mask": (mask_rows, (m,), f32),
        "w_zr": (w_zr, (2 * d, d), bf), "u_zr": (u_zr, (2 * d, d), bf),
        "w_h": (w_h, (d, d), bf), "u_h": (u_h, (d, d), bf),
        "ba": (ba, (1, 3 * d), f32)})
    if plan is None:
        sms = torch.cuda.get_device_properties(h.device).multi_processor_count
        plan = tile_plan(m, d, sms)
    out = h.clone()
    keep = [mask_rows, *operands, ba,
            torch.empty((m, d), dtype=bf, device=h.device),
            torch.empty((m, d), dtype=f32, device=h.device),
            torch.empty((m, d), dtype=bf, device=h.device)]
    return out, keep, tuple(plan)


def _launch(h, mask_rows, weights, r: int, steps: int, plan=None):
    """K1 on the card; ``plan``: a ``TilePlan`` in place of
    ``tile_plan``'s."""
    _check_cuda_args(h, mask_rows, weights, r)
    return _launch_prepared(h, mask_rows, folded_operands(weights),
                            weights[3], r, steps, plan)


def _launch_prepared(h, mask_rows, operands, ba, r: int, steps: int,
                     plan=None):
    """K1 on the card from prepared operands (``_prepared_args``)."""
    out, keep, plan = _prepared_args(h, mask_rows, operands, ba, r, plan)
    m, d = h.shape
    lib = _lib("ggnn_folded.cu", "ggnn_folded_forward")
    with torch.cuda.device(h.device):
        rc = lib.ggnn_folded_forward(
            out.data_ptr(), *(t.data_ptr() for t in keep), m, d, r, steps,
            *plan, _stream(h))
    if rc != 0:
        raise RuntimeError(f"ggnn_folded_forward failed to launch: CUDA "
                           f"error {rc}")
    folded_rows.launches += 1
    return out


def unprepare(operands, ba):
    """``kernel_weights`` inverted: the prepared operands and the bias →
    ``fold_gate_weights``' (wa, uzr, uh, ba).  Exact (a permutation)."""
    w_zr, u_zr, w_h, u_h = operands
    d = w_h.shape[0]
    groups = d // D_MULTIPLE

    def zr_ungroup(w):
        return (w.reshape(groups, 2, D_MULTIPLE, d).transpose(0, 1)
                .reshape(2 * d, d).t())

    return (torch.cat([zr_ungroup(w_zr), w_h.t()], dim=1).contiguous(),
            zr_ungroup(u_zr).contiguous(), u_h.t().contiguous(), ba)


@torch.library.custom_op("srtorch::ggnn_folded", mutates_args=())
def _ggnn_folded_op(h: torch.Tensor, mask_rows: torch.Tensor,
                    w_zr: torch.Tensor, u_zr: torch.Tensor,
                    w_h: torch.Tensor, u_h: torch.Tensor, ba: torch.Tensor,
                    r: int, steps: int) -> torch.Tensor:
    """K1 over prepared operands: CUDA tensors launch the kernel (or
    raise), CPU tensors run the twin."""
    operands = (w_zr, u_zr, w_h, u_h)
    if h.device.type == "cuda":
        return _launch_prepared(h, mask_rows, operands, ba, r, steps)
    if h.device.type == "cpu":
        return folded_reference(h, mask_rows, unprepare(operands, ba), r,
                                steps)
    raise ValueError(f"no GGNN kernel for device {h.device}")


@_ggnn_folded_op.register_fake
def _(h, mask_rows, w_zr, u_zr, w_h, u_h, ba, r, steps):
    return torch.empty_like(h)


def _launch_res(h, mask_rows, weights, r: int, steps: int, plan=None):
    """K2 on the card; ``plan`` as ``_launch``'s."""
    out, keep, plan = _forward_args(h, mask_rows, weights, r, plan)
    m, d = h.shape
    res = tuple(torch.empty((steps, m, d), dtype=torch.bfloat16,
                            device=h.device) for _ in range(4))
    lib = _lib("ggnn_folded.cu", "ggnn_folded_forward_res")
    with torch.cuda.device(h.device):
        rc = lib.ggnn_folded_forward_res(
            out.data_ptr(), *(t.data_ptr() for t in keep),
            *(x.data_ptr() for x in res), m, d, r, steps, *plan, _stream(h))
    if rc != 0:
        raise RuntimeError(f"ggnn_folded_forward_res failed to launch: "
                           f"CUDA error {rc}")
    folded_rows_res.launches += 1
    return out, res


def _launch_bwd(g, mask_rows, resids, weights, r: int, steps: int,
                plan=None):
    """K3 on the card; ``plan``: a ``BwdTilePlan`` in place of
    ``bwd_tile_plan``'s."""
    m, d = _check_rows(g, mask_rows, r)
    wa, uzr, uh = weights[:3]
    bf, f32 = torch.bfloat16, torch.float32
    want = {"g": (g, (m, d), bf), "mask": (mask_rows, (m,), f32),
            "wa": (wa, (d, 3 * d), bf), "uzr": (uzr, (d, 2 * d), bf),
            "uh": (uh, (d, d), bf)}
    for name, x in zip(("hs", "zs", "rs", "cs"), resids):
        want[name] = (x, (steps, m, d), bf)
    _check_tensors(g.device, want)
    if steps == 0:
        return g.clone(), g.new_empty((0, m, 3 * d))
    if plan is None:
        sms = torch.cuda.get_device_properties(g.device).multi_processor_count
        plan = bwd_tile_plan(m, d, sms)
    scratch = [torch.empty((m, d), dtype=f32, device=g.device),
               torch.empty((m, d), dtype=f32, device=g.device),
               torch.empty((m, d), dtype=bf, device=g.device)]
    da = torch.empty((steps, m, 3 * d), dtype=bf, device=g.device)
    out = torch.empty_like(g)
    lib = _lib("ggnn_folded_bwd.cu", "ggnn_folded_backward")
    with torch.cuda.device(g.device):
        rc = lib.ggnn_folded_backward(
            g.data_ptr(), mask_rows.data_ptr(),
            *(x.data_ptr() for x in resids), wa.data_ptr(), uzr.data_ptr(),
            uh.data_ptr(), *(t.data_ptr() for t in scratch), da.data_ptr(),
            out.data_ptr(), m, d, r, steps, *plan, _stream(g))
    if rc != 0:
        raise RuntimeError(f"ggnn_folded_backward failed to launch: CUDA "
                           f"error {rc}")
    folded_bwd_rows.launches += 1
    return out, da


def folded_rows(h: torch.Tensor, mask_rows: torch.Tensor, weights,
                r: int, steps: int) -> torch.Tensor:
    """K1: ``steps`` folded GGNN steps over (M, d) bf16 rows of whole
    examples (r rows each; ``mask_rows`` (M,) f32; ``weights`` from
    ``fold_gate_weights``).  CPU tensors run the plain twin; CUDA tensors
    launch the kernel or raise."""
    if h.device.type == "cpu":
        return folded_reference(h, mask_rows, weights, r, steps)
    if h.device.type == "cuda":
        _check_cuda_args(h, mask_rows, weights, r)
        return torch.ops.srtorch.ggnn_folded(
            h, mask_rows, *folded_operands(weights), weights[3], r, steps)
    raise ValueError(f"no GGNN kernel for device {h.device}")


folded_rows.launches = 0


def folded_rows_prepared(h: torch.Tensor, mask_rows: torch.Tensor, operands,
                         ba: torch.Tensor, r: int, steps: int
                         ) -> torch.Tensor:
    """K1 as ``folded_rows``, from operands prepared once by the caller
    (``kernel_weights`` of ``fold_gate_weights``) and the bias: always
    through the custom op, so that a traced program calls it with its
    arguments (no fold, no lookup in ``folded_operands``' cache).  On the
    CPU the op runs the twin."""
    return torch.ops.srtorch.ggnn_folded(h, mask_rows, *operands, ba, r,
                                         steps)


def folded_rows_res(h: torch.Tensor, mask_rows: torch.Tensor, weights,
                    r: int, steps: int):
    """K2: ``folded_rows`` that also returns the residual stacks
    ``(hs, zs, rs, cs)``, each (steps, M, d) bf16.  CPU tensors run the
    plain twin; CUDA tensors launch the kernel or raise."""
    if h.device.type == "cpu":
        return folded_reference_res(h, mask_rows, weights, r, steps)
    if h.device.type == "cuda":
        return _launch_res(h, mask_rows, weights, r, steps)
    raise ValueError(f"no GGNN kernel for device {h.device}")


folded_rows_res.launches = 0


def folded_bwd_rows(g: torch.Tensor, mask_rows: torch.Tensor, resids,
                    weights, r: int, steps: int):
    """K3: the cotangent g (M, d) bf16 of K2's output → (dh (M, d) bf16,
    da (steps, M, 3d) bf16), from K2's residuals and the folded weights
    (``fold_gate_weights``; the bias is not read).  CPU tensors run the
    plain twin; CUDA tensors launch the kernel or raise."""
    if g.device.type == "cpu":
        return folded_bwd_reference(g, mask_rows, resids, weights, r, steps)
    if g.device.type == "cuda":
        return _launch_bwd(g, mask_rows, resids, weights, r, steps)
    raise ValueError(f"no GGNN kernel for device {g.device}")


folded_bwd_rows.launches = 0


def ggnn_propagate_folded(params: GGNNParams, hidden: torch.Tensor,
                          mask: torch.Tensor, num_steps: int = 4,
                          weights=None) -> torch.Tensor:
    """Drop-in for ``ops.ggnn.ggnn_propagate`` through the folded kernel:
    hidden (B, R, D), mask (B, R) → (B, R, D) in hidden's dtype, computed
    in bf16 inside.  ``weights``: ``fold_gate_weights(params, R)``, when
    the caller keeps them folded already."""
    b, r, d = hidden.shape
    if weights is None:
        weights = fold_gate_weights(params, float(r))
    h = hidden.reshape(b * r, d).to(torch.bfloat16).contiguous()
    mask_rows = mask.reshape(b * r).to(torch.float32).contiguous()
    out = folded_rows(h, mask_rows, weights, r, num_steps)
    return out.reshape(b, r, d).to(hidden.dtype)


def ggnn_propagate_prepared(hidden: torch.Tensor, mask: torch.Tensor,
                            num_steps: int, operands, ba: torch.Tensor
                            ) -> torch.Tensor:
    """``ggnn_propagate_folded`` through ``folded_rows_prepared``: hidden
    (B, R, D), mask (B, R), the prepared operands and the bias of
    ``fold_gate_weights(params, R)`` → (B, R, D) in hidden's dtype."""
    b, r, d = hidden.shape
    h = hidden.reshape(b * r, d).to(torch.bfloat16).contiguous()
    mask_rows = mask.reshape(b * r).to(torch.float32).contiguous()
    out = folded_rows_prepared(h, mask_rows, operands, ba, r, num_steps)
    return out.reshape(b, r, d).to(hidden.dtype)
