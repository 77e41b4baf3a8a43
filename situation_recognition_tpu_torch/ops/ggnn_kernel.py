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
* ``ggnn_propagate_folded`` — the (B, R, D) entry, flattening the batch
  into rows of whole examples as ``_propagate_fwd_impl`` does.
"""

from __future__ import annotations

import ctypes

import torch

from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

#: the kernels take any d that is a multiple of this (their column tile)
D_MULTIPLE = 64
#: the backward kernel's row tiles hold whole examples of at most this
#: many rows
BWD_MAX_R = 64


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


def transpose_folded(weights):
    """``fold_gate_weights`` output → the backward's operands
    ``(waᵀ (3d, d), uzrᵀ (2d, d), uhᵀ (d, d))``, contiguous."""
    wa, uzr, uh, _ = weights
    return (wa.t().contiguous(), uzr.t().contiguous(), uh.t().contiguous())


def folded_bwd_reference(g: torch.Tensor, mask_rows: torch.Tensor, resids,
                         weights_t, r: int, steps: int):
    """Plain PyTorch twin of K3.  g (M, d) bf16, the cotangent of the
    output; ``resids`` from K2; ``weights_t`` from ``transpose_folded``.
    Returns (dh (M, d) bf16, da (steps, M, 3d) bf16): the reverse gate
    chain in f32, dh kept in f32 between steps, bf16(da) fed to the
    products, and dagg rounded to bf16 before E."""
    hs, zs, rs, cs = resids
    wa_t, uzr_t, uh_t = (w.float() for w in weights_t)
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


def _lib(source: str, entry: str, n_ptrs: int) -> ctypes.CDLL:
    from situation_recognition_tpu_torch.ops import _build

    lib = _build.load(source)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _forward_scratch(h):
    m, d = h.shape
    z = torch.empty((m, d), dtype=torch.float32, device=h.device)
    return z, torch.empty_like(z), torch.empty(
        (m, d), dtype=torch.bfloat16, device=h.device)


def _launch(h, mask_rows, weights, r: int, steps: int) -> torch.Tensor:
    _check_cuda_args(h, mask_rows, weights, r)
    wa, uzr, uh, ba = weights
    m, d = h.shape
    out = h.clone()
    z, gc, rh = _forward_scratch(h)
    lib = _lib("ggnn_folded.cu", "ggnn_folded_forward", 9)
    with torch.cuda.device(h.device):
        rc = lib.ggnn_folded_forward(
            out.data_ptr(), mask_rows.data_ptr(), wa.data_ptr(),
            uzr.data_ptr(), uh.data_ptr(), ba.data_ptr(), z.data_ptr(),
            rh.data_ptr(), gc.data_ptr(), m, d, r, steps, _stream(h))
    if rc != 0:
        raise RuntimeError(f"ggnn_folded_forward failed to launch: CUDA "
                           f"error {rc}")
    folded_rows.launches += 1
    return out


def _launch_res(h, mask_rows, weights, r: int, steps: int):
    _check_cuda_args(h, mask_rows, weights, r)
    wa, uzr, uh, ba = weights
    m, d = h.shape
    out = h.clone()
    z, gc, rh = _forward_scratch(h)
    res = tuple(torch.empty((steps, m, d), dtype=torch.bfloat16,
                            device=h.device) for _ in range(4))
    lib = _lib("ggnn_folded.cu", "ggnn_folded_forward_res", 13)
    with torch.cuda.device(h.device):
        rc = lib.ggnn_folded_forward_res(
            out.data_ptr(), mask_rows.data_ptr(), wa.data_ptr(),
            uzr.data_ptr(), uh.data_ptr(), ba.data_ptr(), z.data_ptr(),
            rh.data_ptr(), gc.data_ptr(), *(x.data_ptr() for x in res),
            m, d, r, steps, _stream(h))
    if rc != 0:
        raise RuntimeError(f"ggnn_folded_forward_res failed to launch: "
                           f"CUDA error {rc}")
    folded_rows_res.launches += 1
    return out, res


def _launch_bwd(g, mask_rows, resids, weights_t, r: int, steps: int):
    m, d = _check_rows(g, mask_rows, r)
    if r > BWD_MAX_R:
        raise ValueError(f"the GGNN backward kernel takes r <= {BWD_MAX_R}, "
                         f"got r={r}")
    wa_t, uzr_t, uh_t = weights_t
    bf = torch.bfloat16
    want = {"g": (g, (m, d), bf), "mask": (mask_rows, (m,), torch.float32),
            "wa_t": (wa_t, (3 * d, d), bf), "uzr_t": (uzr_t, (2 * d, d), bf),
            "uh_t": (uh_t, (d, d), bf)}
    for name, x in zip(("hs", "zs", "rs", "cs"), resids):
        want[name] = (x, (steps, m, d), bf)
    _check_tensors(g.device, want)
    if steps == 0:
        return g.clone(), g.new_empty((0, m, 3 * d))
    dh = g.float()
    dprev = torch.empty_like(dh)
    da = torch.empty((steps, m, 3 * d), dtype=torch.bfloat16,
                     device=g.device)
    out = torch.empty_like(g)
    lib = _lib("ggnn_folded_bwd.cu", "ggnn_folded_backward", 12)
    with torch.cuda.device(g.device):
        rc = lib.ggnn_folded_backward(
            dh.data_ptr(), mask_rows.data_ptr(),
            *(x.data_ptr() for x in resids), wa_t.data_ptr(),
            uzr_t.data_ptr(), uh_t.data_ptr(), dprev.data_ptr(),
            da.data_ptr(), out.data_ptr(), m, d, r, steps, _stream(g))
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
        return _launch(h, mask_rows, weights, r, steps)
    raise ValueError(f"no GGNN kernel for device {h.device}")


folded_rows.launches = 0


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
                    weights_t, r: int, steps: int):
    """K3: the cotangent g (M, d) bf16 of K2's output → (dh (M, d) bf16,
    da (steps, M, 3d) bf16), from K2's residuals and ``transpose_folded``
    weights.  CPU tensors run the plain twin; CUDA tensors launch the
    kernel or raise."""
    if g.device.type == "cpu":
        return folded_bwd_reference(g, mask_rows, resids, weights_t, r,
                                    steps)
    if g.device.type == "cuda":
        return _launch_bwd(g, mask_rows, resids, weights_t, r, steps)
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
