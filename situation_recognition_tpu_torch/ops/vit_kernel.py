"""The ViT encoder kernels: wrappers that choose between the CUDA kernels
and their plain twins by the device of the tensors, and the two encoder
paths through them.

Replaces the four forward kernels of
``situation_recognition_tpu/ops/vit_pallas.py``:

* K4 ``_qkv_kernel``              → ``vit_qkv_forward``
  (``csrc/vit_block.cu``: a LayerNorm kernel, then one GEMM into q, k, v;
  the GEMM is a TMA-fed ``wgmma`` ring, the source says how);
* K5 ``_attn_core_kernel``        → ``vit_attention_forward`` and
  K7 ``_attn_core_stream_kernel`` → ``vit_attention_stream_forward``
  (both ``csrc/vit_attention.cu``: one kernel with a row stride and a count
  of real rows; the source says why one serves both);
* K6 ``_out_mlp_kernel``          → ``vit_out_mlp_forward``
  (``csrc/vit_block.cu``: three GEMMs with epilogues and a LayerNorm);

and the backward kernel of the fine-tuning path:

* K8 ``_attn_bwd_stream_kernel``  → ``vit_attention_backward``
  (``csrc/vit_attention_bwd.cu``: dq, then dk and dv, in two launches).

A CPU tensor runs the twin of ``ops/vit.py``; a CUDA tensor launches the
kernel, built by ``nvcc`` at first use and bound with ``ctypes``, or
raises.  There is no fallback.  Before a launch every operand is checked
to be contiguous and 16-byte aligned (``_check_tensors``): the GEMMs read
through TMA tensor maps, which need both.  Each wrapper's ``launches``
counts its calls that launched.

The encoder paths mirror the JAX package's two kernel paths:

* ``encoder_cls_stack`` — ``_fused_stack_impl``: every block as
  K4 → K7 → K6 on the (B·N, D) token stream, then the CLS rows.  The TPU
  pads the stream to n8 = ceil(N/8)·8 rows per example so that its 2-D and
  3-D layouts tile alike; on the card they are the same bytes, so the
  stream is not padded (K7's row stride is N);
* ``encoder_block`` — ``_fused_impl``: one block as K4 → K5 → K6 on
  (B, N, D).

Weights come as ``ops.vit.BlockWeights`` prepared by ``kernel_weights``:
bf16 matrices in ``nn.Linear``'s (out, in) layout, f32 vectors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from situation_recognition_tpu_torch.ops.ggnn_kernel import _check_tensors
from situation_recognition_tpu_torch.ops.vit import (
    BlockWeights, LOG2E, attn_bwd_reference, attn_core_reference,
    out_mlp_reference, qkv_reference)

#: the attention kernel's head width
HEAD_DIM = 64
#: the GEMMs take any width that is a multiple of this
D_MULTIPLE = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vit_qkv_forward": [_P] * 9 + [_I, _I, _F, _P],
    "vit_out_mlp_forward": [_P] * 14 + [_I, _I, _I, _F, _I, _P],
    "vit_attention_forward": [_P] * 4 + [_I] * 5 + [_F, _F, _I, _P],
    "vit_attention_backward": [_P] * 9 + [_I] * 5 + [_F, _P],
    # one GEMM of K4/K6 alone (``chip_smoke.py`` times each product)
    "vit_block_gemm": [_I] + [_P] * 5 + [_I] * 3 + [_P],
    "vit_block_gemm_smem": [_I, _I],
    "vit_block_gemm_maxnreg": [_I],
}


def block_supported(d: int, heads: int) -> bool:
    """True when the kernels take this encoder width: a multiple of 64,
    in heads of width 64.  Any token count runs: the attention kernel
    loops over tiles of 64 keys."""
    return (d >= D_MULTIPLE and d % D_MULTIPLE == 0 and heads >= 1
            and d == heads * HEAD_DIM)


def kernel_weights(w: BlockWeights) -> BlockWeights:
    """A block's weights as the kernels take them: bf16 matrices, f32
    vectors, contiguous."""
    return BlockWeights(*(
        t.detach().to(torch.bfloat16 if t.dim() == 2 else torch.float32)
        .contiguous() for t in w))


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


def _rows(x: torch.Tensor) -> tuple:
    if x.dim() != 2:
        raise ValueError(f"the stream must be (M, D), got {tuple(x.shape)}")
    m, d = x.shape
    if m < 1 or d < D_MULTIPLE or d % D_MULTIPLE:
        raise ValueError(f"the ViT kernels take M >= 1 rows of a width that "
                         f"is a multiple of {D_MULTIPLE}, got ({m}, {d})")
    return m, d


def _check_weights(x: torch.Tensor, w: BlockWeights, names) -> None:
    d = x.shape[1]
    hid = w.fc1_w.shape[0]
    shapes = {"ln1_w": (d,), "ln1_b": (d,), "in_w": (3 * d, d),
              "in_b": (3 * d,), "out_w": (d, d), "out_b": (d,),
              "ln2_w": (d,), "ln2_b": (d,), "fc1_w": (hid, d),
              "fc1_b": (hid,), "fc2_w": (d, hid), "fc2_b": (d,)}
    want = {}
    for name in names:
        shape = shapes[name]
        dtype = torch.bfloat16 if len(shape) == 2 else torch.float32
        want[name] = (getattr(w, name), shape, dtype)
    _check_tensors(x.device, want)


def _raise_on(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc}")


# ------------------------------------------------------------------ K4


def _launch_qkv(x, w: BlockWeights, eps: float):
    m, d = _rows(x)
    _check_tensors(x.device, {"x": (x, (m, d), torch.bfloat16)})
    _check_weights(x, w, ("ln1_w", "ln1_b", "in_w", "in_b"))
    y = torch.empty_like(x)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    lib = _lib("vit_block.cu", "vit_qkv_forward")
    with torch.cuda.device(x.device):
        rc = lib.vit_qkv_forward(
            x.data_ptr(), w.ln1_w.data_ptr(), w.ln1_b.data_ptr(),
            w.in_w.data_ptr(), w.in_b.data_ptr(), y.data_ptr(), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), m, d, float(eps), _stream(x))
    _raise_on(rc, "vit_qkv_forward")
    vit_qkv_forward.launches += 1
    return q, k, v


def vit_qkv_forward(x: torch.Tensor, w: BlockWeights, eps: float):
    """K4: the stream x (M, D) bf16 → (q, k, v), each (M, D): LN1 in f32,
    the packed projection, the f32 bias.  CPU tensors run the twin; CUDA
    tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return qkv_reference(x, w, eps)
    if x.device.type == "cuda":
        return _launch_qkv(x, w, eps)
    raise ValueError(f"no ViT kernel for device {x.device}")


vit_qkv_forward.launches = 0


# ---------------------------------------------------------------- K5/K7


def _attention_rows(q, heads: int, row_stride: int, n_valid: int,
                    tensors: dict) -> tuple:
    """Checks of the attention kernels' arguments → (rows, width,
    examples): (B·row_stride, D) bf16 CUDA tensors in heads of 64, whole
    examples, ``1 <= n_valid <= row_stride``."""
    if q.device.type != "cuda":
        raise ValueError(f"no ViT kernel for device {q.device}")
    m, d = _rows(q)
    if d != heads * HEAD_DIM:
        raise ValueError(f"the attention kernel takes heads of width "
                         f"{HEAD_DIM}, got d={d} over {heads} heads")
    if m % row_stride or not 1 <= n_valid <= row_stride:
        raise ValueError(f"{m} rows are not whole examples of {row_stride} "
                         f"rows with {n_valid} real")
    b = m // row_stride
    if b > 65535 or heads > 65535:
        raise ValueError(f"at most 65535 examples and heads, got {b}, "
                         f"{heads}")
    _check_tensors(q.device, {name: (t, (m, d), torch.bfloat16)
                              for name, t in tensors.items()})
    return m, d, b


def _attention(q, k, v, heads: int, folded: bool, row_stride: int,
               n_valid: int):
    """The attention core over (B·row_stride, D) q, k, v → (context,
    whether the kernel was launched)."""
    scale = 1.0 / math.sqrt(q.shape[1] // heads)
    if q.device.type == "cpu":
        return attn_core_reference(q, k, v, heads, scale, folded, row_stride,
                                   n_valid), False
    _, d, b = _attention_rows(q, heads, row_stride, n_valid,
                              {"q": q, "k": k, "v": v})
    out = torch.empty_like(q)
    lib = _lib("vit_attention.cu", "vit_attention_forward")
    with torch.cuda.device(q.device):
        rc = lib.vit_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            row_stride, n_valid, d, heads, float(scale * LOG2E),
            float(scale), int(folded), _stream(q))
    _raise_on(rc, "vit_attention_forward")
    return out, True


def vit_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          heads: int, folded: bool) -> torch.Tensor:
    """K5, the per-block attention core: q, k, v (B, N, D) bf16 → context
    (B, N, D), all N rows real.  CPU tensors run the twin; CUDA tensors
    launch ``csrc/vit_attention.cu`` or raise."""
    b, n, d = q.shape
    out, launched = _attention(q.reshape(b * n, d), k.reshape(b * n, d),
                               v.reshape(b * n, d), heads, folded, n, n)
    if launched:
        vit_attention_forward.launches += 1
    return out.reshape(b, n, d)


vit_attention_forward.launches = 0


def vit_attention_stream_forward(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, heads: int, folded: bool,
                                 row_stride: int,
                                 n_valid: int) -> torch.Tensor:
    """K7, the stream's attention core: q, k, v (B·row_stride, D) bf16 with
    ``n_valid`` real rows per example → context (B·row_stride, D) with the
    pad rows zero.  The same kernel as K5.  CPU tensors run the twin; CUDA
    tensors launch the kernel or raise."""
    out, launched = _attention(q, k, v, heads, folded, row_stride, n_valid)
    if launched:
        vit_attention_stream_forward.launches += 1
    return out


vit_attention_stream_forward.launches = 0


# ------------------------------------------------------------------ K8


def vit_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, do: torch.Tensor, heads: int,
                           row_stride: int, n_valid: int):
    """K8, the stream's attention backward: q, k, v, the forward's context
    o and its cotangent do, (B·row_stride, D) bf16 with ``n_valid`` real
    rows per example → (dq, dk, dv), the pad rows zero.  The softmax is
    recomputed in f32 whatever the forward's flavour.  CPU tensors run the
    twin; CUDA tensors launch ``csrc/vit_attention_bwd.cu`` (two kernels,
    counted as one call) or raise."""
    scale = 1.0 / math.sqrt(q.shape[1] // heads)
    if q.device.type == "cpu":
        return attn_bwd_reference(q, k, v, o, do, heads, scale, row_stride,
                                  n_valid)
    _, d, b = _attention_rows(q, heads, row_stride, n_valid,
                              {"q": q, "k": k, "v": v, "o": o, "do": do})
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((3, b, heads, row_stride), dtype=torch.float32,
                        device=q.device)
    lib = _lib("vit_attention_bwd.cu", "vit_attention_backward")
    with torch.cuda.device(q.device):
        rc = lib.vit_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), b, row_stride, n_valid, d, heads, float(scale),
            _stream(q))
    _raise_on(rc, "vit_attention_backward")
    vit_attention_backward.launches += 1
    return dq, dk, dv


vit_attention_backward.launches = 0


# ------------------------------------------------------------------ K6


def _launch_out_mlp(x, ctx, w: BlockWeights, eps: float, quick: bool):
    m, d = _rows(x)
    hid = w.fc1_w.shape[0]
    if hid < D_MULTIPLE or hid % D_MULTIPLE:
        raise ValueError(f"the MLP width must be a multiple of {D_MULTIPLE},"
                         f" got {hid}")
    bf = torch.bfloat16
    _check_tensors(x.device, {"x": (x, (m, d), bf), "ctx": (ctx, (m, d), bf)})
    _check_weights(x, w, ("out_w", "out_b", "ln2_w", "ln2_b", "fc1_w",
                          "fc1_b", "fc2_w", "fc2_b"))
    r = torch.empty((m, d), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    h = torch.empty((m, hid), dtype=bf, device=x.device)
    out = torch.empty_like(x)
    lib = _lib("vit_block.cu", "vit_out_mlp_forward")
    with torch.cuda.device(x.device):
        rc = lib.vit_out_mlp_forward(
            x.data_ptr(), ctx.data_ptr(), w.out_w.data_ptr(),
            w.out_b.data_ptr(), w.ln2_w.data_ptr(), w.ln2_b.data_ptr(),
            w.fc1_w.data_ptr(), w.fc1_b.data_ptr(), w.fc2_w.data_ptr(),
            w.fc2_b.data_ptr(), r.data_ptr(), y.data_ptr(), h.data_ptr(),
            out.data_ptr(), m, d, hid, float(eps), int(quick), _stream(x))
    _raise_on(rc, "vit_out_mlp_forward")
    vit_out_mlp_forward.launches += 1
    return out


def vit_out_mlp_forward(x: torch.Tensor, ctx: torch.Tensor, w: BlockWeights,
                        eps: float, quick: bool) -> torch.Tensor:
    """K6: the stream x and the context ctx, (M, D) bf16 → the block's
    output (M, D): out-projection and residual in f32, LN2, fc1 + GELU
    (QuickGELU with ``quick``), fc2 and the residual.  CPU tensors run the
    twin; CUDA tensors launch the kernels or raise."""
    if x.device.type == "cpu":
        return out_mlp_reference(x, ctx, w, eps, quick)
    if x.device.type == "cuda":
        return _launch_out_mlp(x, ctx, w, eps, quick)
    raise ValueError(f"no ViT kernel for device {x.device}")


vit_out_mlp_forward.launches = 0


# --------------------------------------------------------- encoder paths


def encoder_block(x: torch.Tensor, w: BlockWeights, heads: int, eps: float,
                  quick: bool, folded: bool) -> torch.Tensor:
    """One encoder block through K4 → K5 → K6: x (B, N, D) bf16 → (B, N,
    D)."""
    b, n, d = x.shape
    x2 = x.reshape(b * n, d).contiguous()
    q, k, v = vit_qkv_forward(x2, w, eps)
    ctx = vit_attention_forward(q.reshape(b, n, d), k.reshape(b, n, d),
                                v.reshape(b, n, d), heads, folded)
    return vit_out_mlp_forward(x2, ctx.reshape(b * n, d), w, eps,
                               quick).reshape(b, n, d)


def encoder_cls_stack(x: torch.Tensor, blocks, heads: int, eps: float,
                      quick: bool, folded: bool) -> torch.Tensor:
    """Every block through K4 → K7 → K6 on one (B·N, D) token stream:
    x (B, N, D) bf16 → the CLS rows (B, D) before the final LayerNorm."""
    b, n, d = x.shape
    xs = x.reshape(b * n, d).contiguous()
    for w in blocks:
        q, k, v = vit_qkv_forward(xs, w, eps)
        ctx = vit_attention_stream_forward(q, k, v, heads, folded, n, n)
        xs = vit_out_mlp_forward(xs, ctx, w, eps, quick)
    return xs.reshape(b, n, d)[:, 0, :]
