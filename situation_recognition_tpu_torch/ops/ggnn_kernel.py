"""The folded multi-step GGNN forward: CUDA kernel, its plain twin, and the
wrapper that chooses between them by the device of the tensors.

Replaces the TPU kernel ``_folded_kernel`` of
``situation_recognition_tpu/ops/ggnn_pallas.py`` (driven there by
``ggnn_propagate_fused`` and ``_propagate_fwd_impl``).  ``W_p`` folds into
the gate weights exactly (``fold_gate_weights``, f32 products):

    n @ W_g = agg @ (W_p W_g) + bias_mult * (b_p W_g)

so one step is ``agg = E @ h`` (the block adjacency of whole examples),
``agg @ [WpWz|WpWr|WpWh]``, ``h @ [Uz|Ur]`` and ``(r*h) @ Uh`` with the
gates in f32 and h kept in bf16 between steps — the TPU kernel's numerics.

* ``folded_reference`` — the same function step by step in PyTorch with
  the same bf16 casts (bf16 values multiplied in f32, which is exact, and
  summed in f32).  The CPU tests hold it against the JAX kernel in
  interpret mode; ``chip_smoke.py`` holds the CUDA kernel against it.
* ``folded_rows`` — the wrapper: a CPU tensor goes to the twin; a CUDA
  tensor launches ``csrc/ggnn_folded.cu`` (built by ``nvcc`` at first use,
  bound with ``ctypes``) or raises.  There is no fallback.
  ``folded_rows.launches`` counts the launches.
* ``ggnn_propagate_folded`` — the (B, R, D) entry, flattening the batch
  into rows of whole examples as ``_propagate_fwd_impl`` does.
"""

from __future__ import annotations

import ctypes

import torch

from situation_recognition_tpu_torch.ops.ggnn import GGNNParams

#: the kernel takes any d that is a multiple of this (its column tile)
D_MULTIPLE = 64


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


def folded_reference(h: torch.Tensor, mask_rows: torch.Tensor, weights,
                     r: int, steps: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel.  h (M, d) bf16 rows of whole
    examples, mask_rows (M,) → (M, d) bf16."""
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
        h = ((1.0 - z) * hf + z * c).to(torch.bfloat16)
    return h


def _check_cuda_args(h, mask_rows, weights, r: int) -> None:
    wa, uzr, uh, ba = weights
    if h.dim() != 2:
        raise ValueError(f"h must be (M, d), got {tuple(h.shape)}")
    m, d = h.shape
    if m < 1 or m % r != 0:
        raise ValueError(f"M={m} rows must be >= 1 whole examples of r={r}")
    if d % D_MULTIPLE != 0:
        raise ValueError(f"the GGNN kernel takes d that is a multiple of "
                         f"{D_MULTIPLE}, got d={d}")
    want = {"h": (h, (m, d), torch.bfloat16),
            "mask": (mask_rows, (m,), torch.float32),
            "wa": (wa, (d, 3 * d), torch.bfloat16),
            "uzr": (uzr, (d, 2 * d), torch.bfloat16),
            "uh": (uh, (d, d), torch.bfloat16),
            "ba": (ba, (1, 3 * d), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def _lib() -> ctypes.CDLL:
    from situation_recognition_tpu_torch.ops import _build

    lib = _build.load("ggnn_folded.cu")
    fn = lib.ggnn_folded_forward
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
    return lib


def _launch(h, mask_rows, weights, r: int, steps: int) -> torch.Tensor:
    _check_cuda_args(h, mask_rows, weights, r)
    wa, uzr, uh, ba = weights
    m, d = h.shape
    out = h.clone()
    z = torch.empty((m, d), dtype=torch.float32, device=h.device)
    gc = torch.empty_like(z)
    rh = torch.empty((m, d), dtype=torch.bfloat16, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        rc = lib.ggnn_folded_forward(
            out.data_ptr(), mask_rows.data_ptr(), wa.data_ptr(),
            uzr.data_ptr(), uh.data_ptr(), ba.data_ptr(), z.data_ptr(),
            rh.data_ptr(), gc.data_ptr(), m, d, r, steps, stream)
    if rc != 0:
        raise RuntimeError(f"ggnn_folded_forward failed to launch: CUDA "
                           f"error {rc}")
    folded_rows.launches += 1
    return out


def folded_rows(h: torch.Tensor, mask_rows: torch.Tensor, weights,
                r: int, steps: int) -> torch.Tensor:
    """``steps`` folded GGNN steps over (M, d) bf16 rows of whole examples
    (r rows each; ``mask_rows`` (M,) f32; ``weights`` from
    ``fold_gate_weights``).  CPU tensors run the plain twin; CUDA tensors
    launch the kernel or raise."""
    if h.device.type == "cpu":
        return folded_reference(h, mask_rows, weights, r, steps)
    if h.device.type == "cuda":
        return _launch(h, mask_rows, weights, r, steps)
    raise ValueError(f"no GGNN kernel for device {h.device}")


folded_rows.launches = 0


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
