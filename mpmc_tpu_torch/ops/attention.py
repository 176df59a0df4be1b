"""Attention core: the hand-written CUDA kernels and their plain PyTorch
twins, forward and backward.

Port of ``mpmc_tpu/ops/attention.py``'s forward, backward and custom VJP.
Layout at the API is the
JAX package's: q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]``, a key-padding
mask ``[B, Sk]`` with 1 = attend, or ``[B, S]`` segment ids (0 = padding)
for packed self-attention.  Masking is the reference's additive -1e9 bias,
never -inf and never skipped keys, so a fully masked query row gives the
uniform average of V.

A CPU tensor runs the plain versions (:func:`attention_forward_reference`,
:func:`attention_backward_reference`); a CUDA tensor launches the kernels of
``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu`` or raises: bf16 on
the tensor cores (one backward launch at Sq, Sk <= 128, two beyond), IEEE
f32 register-tiled on the CUDA cores (two backward launches).
:class:`AttentionFunction` joins the two for autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mpmc_tpu_torch.ops import build

NEG_INF = -1e9  # the reference's additive mask value, not -inf
MODES = {"none": 0, "padding": 1, "segments": 2}
# Longest Sq and Sk the kernels take (csrc/mma_bf16.cuh kMaxSeq): ViT-B/16
# and ViT-L/16 at 384 pixels need 577; the card tests reach 1024.
MAX_SEQ = 1024
MAX_HEAD_DIM = 128

launch_counts = build.launch_counts


def _bias(mask: Optional[torch.Tensor], mode: str) -> Optional[torch.Tensor]:
    """Additive f32 bias broadcastable to the ``[B, H, Sq, Sk]`` scores."""
    if mode == "none":
        return None
    m = mask.to(torch.float32)
    if mode == "padding":
        return ((1.0 - m) * NEG_INF)[:, None, None, :]
    allow = (m[:, :, None] == m[:, None, :]) & (m[:, None, :] > 0)
    return ((1.0 - allow.to(torch.float32)) * NEG_INF)[:, None, :, :]


def attention_forward_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                mask: Optional[torch.Tensor] = None,
                                mode: str = "padding"
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel, following the TPU kernel ``_fwd_kernel``
    (not ``_attention_xla``: in bf16 they round at different places).

    Scores in f32 with the scale applied in f32, plus the additive bias;
    e = exp(s - rowmax) is rounded to the input dtype for the e.V product,
    whose f32 result is divided by the f32 row sum of the unrounded e.
    Returns ``out [B, Sq, H, D]`` in the input dtype and the f32
    ``lse = rowmax + log(rowsum)`` ``[B, H, Sq]``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    bias = _bias(mask, mode)
    if bias is not None:
        s = s + bias
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = torch.sum(e, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    out = (o / denom).to(q.dtype).permute(0, 2, 1, 3)
    lse = (m + torch.log(denom))[..., 0]
    return out, lse


def _check(q, k, v, mask, mode):
    if mode not in MODES:
        raise ValueError(f"unknown attention mode {mode!r}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mode == "segments" and Sq != Sk:
        raise ValueError(f"segment packing requires self-attention "
                         f"(Sq={Sq} != Sk={Sk})")
    if mode != "none" and (mask is None or tuple(mask.shape) != (B, Sk)):
        raise ValueError(f"{mode} mode needs a [B, Sk] = [{B}, {Sk}] mask")


def _check_cuda(who: str, *tensors: torch.Tensor) -> None:
    """What both kernels take: D and S in range, one CUDA device, f32 or
    bf16 (``tensors`` starts with q and k)."""
    q, k = tensors[0], tensors[1]
    D, Sq, Sk = q.shape[-1], q.shape[1], k.shape[1]
    if D > MAX_HEAD_DIM or Sq > MAX_SEQ or Sk > MAX_SEQ:
        raise ValueError(f"kernel takes D <= {MAX_HEAD_DIM} and Sq, Sk <= "
                         f"{MAX_SEQ}, got D={D}, Sq={Sq}, Sk={Sk}")
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{who} needs its tensors on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != q.dtype for t in tensors):
        raise ValueError(f"kernel takes float32 or bfloat16 tensors of one "
                         f"type, got {[t.dtype for t in tensors]}")


def _check_bf16_layout(who: str, *tensors: torch.Tensor) -> None:
    """What the bf16 tensor-core kernels take on top of :func:`_check_cuda`:
    D a multiple of 8, and every row of q, k, v (and, for the backward,
    out and dO) starting on a 16-byte boundary, for ``cp.async``.  The f32
    kernels take any D <= 128 and any stride: they copy 16 bytes at a time
    where D % 4 == 0 and the rows are 16-byte aligned, else 4 bytes."""
    if tensors[0].dtype != torch.bfloat16:
        return
    D = tensors[0].shape[-1]
    if D % 8:
        raise ValueError(f"{who}: bf16 kernel needs D % 8 == 0, got D={D}")
    for t in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{who}: bf16 kernel needs 16-byte aligned "
                             f"rows, got a tensor at {t.data_ptr():#x} with "
                             f"strides {t.stride()}")


def _mask_f32(q: torch.Tensor, mask: Optional[torch.Tensor],
              mode: str) -> Optional[torch.Tensor]:
    if mode == "none":
        return None
    return mask.to(device=q.device, dtype=torch.float32).contiguous()


def attention_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           mode: str = "padding"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/attention_fwd.cu`` on CUDA tensors; same contract as
    :func:`attention_forward_reference`.  Raises on anything the kernel does
    not take and on a launch error."""
    _check(q, k, v, mask, mode)
    _check_cuda("attention_forward_cuda", q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("kernel needs the head dim of q, k, v contiguous")
    _check_bf16_layout("attention_forward_cuda", q, k, v)
    mask_f = _mask_f32(q, mask, mode)
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mpmc_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_f.data_ptr() if mask_f is not None else None,
            out.data_ptr(), lse.data_ptr(),
            0 if q.dtype == torch.float32 else 1, MODES[mode],
            B, H, Sq, Sk, D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            1.0 / (D ** 0.5), stream)
    build.check_launch(lib, "attention_fwd", rc)
    build.count_launch("attention_fwd")
    return out, lse


def _library() -> ctypes.CDLL:
    lib = build.library("attention_fwd")
    if lib.mpmc_attention_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpmc_attention_fwd.argtypes = (
            [p] * 6 + [i] * 7 + [ll] * 12 + [ctypes.c_float, p])
        lib.mpmc_attention_fwd.restype = i
    return lib


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      mode: str = "padding"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if q.device.type == "cpu":
        _check(q, k, v, mask, mode)
        return attention_forward_reference(q, k, v, mask, mode)
    if q.device.type == "cuda":
        return attention_forward_cuda(q, k, v, mask, mode)
    raise ValueError(f"no attention path for device {q.device}")


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 mask: Optional[torch.Tensor], mode: str,
                                 out: torch.Tensor, lse: torch.Tensor,
                                 dout: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain version of the backward kernel, step by step as the TPU kernel
    ``_bwd_kernel`` rounds: ``qs = q * (1/sqrt(D))`` in the input dtype
    (the scale rounded to it first), f32 scores plus the bias, ``P`` from
    the saved ``lse`` (padding, none) or from the exact row max and sum
    (segments), ``dV = round(P)^T dO``, ``delta = sum(dO * out)`` over the
    saved ``out``, ``dS = round(P * (dP - delta))``, ``dQ = dS K * scale``,
    ``dK = dS^T qs``.  Returns ``(dq, dk, dv)`` in the input dtype."""
    dtype = q.dtype
    scale = 1.0 / (q.shape[-1] ** 0.5)
    f32 = torch.float32
    qs = q * torch.tensor(scale, dtype=dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.to(f32), k.to(f32))
    bias = _bias(mask, mode)
    if bias is not None:
        s = s + bias
    if mode == "segments":
        e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        p = e / torch.sum(e, dim=-1, keepdim=True)
    else:
        p = torch.exp(s - lse[..., None])
    do32 = dout.to(f32)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).to(f32), do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.to(f32))
    delta = torch.sum(do32 * out.to(f32), dim=-1).permute(0, 2, 1)
    ds = (p * (dp - delta[..., None])).to(dtype).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f32)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs.to(f32))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, mask: Optional[torch.Tensor],
                            mode: str, out: torch.Tensor, lse: torch.Tensor,
                            dout: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Launch ``csrc/attention_bwd.cu`` on CUDA tensors; same contract as
    :func:`attention_backward_reference`.  Raises on anything the kernel
    does not take and on a launch error."""
    _check(q, k, v, mask, mode)
    _check_cuda("attention_backward_cuda", q, k, v, out, dout)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if tuple(out.shape) != tuple(q.shape) or tuple(dout.shape) != tuple(
            q.shape) or tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"out and dout must be {tuple(q.shape)} and lse "
                         f"{(B, H, Sq)}, got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)}")
    if lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError("lse must be float32 on the device of q")
    # The kernel reads [B, S, H, D] in place with contiguous strides.
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    _check_bf16_layout("attention_backward_cuda", q, k, v, out, dout)
    mask_f = _mask_f32(q, mask, mode)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta, row_m, row_l = (torch.empty((B, H, Sq), dtype=torch.float32,
                                       device=q.device) for _ in range(3))
    lib = _library_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.mpmc_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask_f.data_ptr() if mask_f is not None else None,
            out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            delta.data_ptr(), row_m.data_ptr(), row_l.data_ptr(),
            0 if q.dtype == torch.float32 else 1, MODES[mode],
            B, H, Sq, Sk, D, 1.0 / (D ** 0.5), stream)
    build.check_launch(lib, "attention_bwd", rc)
    build.count_launch("attention_bwd")
    return dq, dk, dv


def _library_bwd() -> ctypes.CDLL:
    lib = build.library("attention_bwd")
    if lib.mpmc_attention_bwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mpmc_attention_bwd.argtypes = (
            [p] * 13 + [i] * 7 + [ctypes.c_float, p])
        lib.mpmc_attention_bwd.restype = i
    return lib


def attention_backward(q, k, v, mask, mode, out, lse, dout):
    """``(dq, dk, dv)``: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if q.device.type == "cpu":
        _check(q, k, v, mask, mode)
        return attention_backward_reference(q, k, v, mask, mode, out, lse,
                                            dout)
    if q.device.type == "cuda":
        return attention_backward_cuda(q, k, v, mask, mode, out, lse, dout)
    raise ValueError(f"no attention path for device {q.device}")


class AttentionFunction(torch.autograd.Function):
    """Attention with its hand-written backward (the JAX package's
    ``_attention_pallas`` custom VJP): ``(out, lse)`` from the forward,
    which saves ``(q, k, v, mask, out, lse)``; the backward rebuilds the
    gradients from them (``lse`` has none).

    Under ``torch.func.vmap`` (the fold-parallel step) the rule
    :meth:`vmap` folds the vmapped axis into the batch axis, ``[F, B, S,
    H, D] -> [F*B, S, H, D]`` (the mask likewise, an unbatched input
    repeated F times), so one launch of each kernel serves every fold."""

    @staticmethod
    def forward(q, k, v, mask, mode):
        return attention_forward(q, k, v, mask, mode)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, mask, mode = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.mode = mode
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, mask, ctx.mode, out, lse,
                                        dout)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, mask, mode):
        n = info.batch_size

        def fold(x, dim):
            if x is None:
                return None
            x = (x.movedim(dim, 0) if dim is not None
                 else x.expand(n, *x.shape))
            return x.reshape(n * x.shape[1], *x.shape[2:])

        out, lse = AttentionFunction.apply(
            *(fold(x, d) for x, d in zip((q, k, v, mask), in_dims[:4])),
            mode)
        return ((out.reshape(n, -1, *out.shape[1:]),
                 lse.reshape(n, -1, *lse.shape[1:])), (0, 0))


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          segments: Optional[torch.Tensor] = None,
                          impl: str = "auto", group=None) -> torch.Tensor:
    """Multi-head scaled dot-product attention, ``[B, Sq, H, D]`` out.

    mask: ``[B, Sk]`` (1 = attend) or None.  segments: ``[B, S]`` ids
    (0 = padding) for packed self-attention rows: token i attends token j
    iff both carry the same non-zero id; supersedes ``mask``.  Goes
    through :class:`AttentionFunction`, with or without a gradient, so
    that ``vmap`` finds its rule either way.

    ``impl`` "ring" or "ulysses" (with the process ``group`` of the
    sequence axis) is sequence-parallel attention, as the JAX package's
    ``ring:<axis>`` and ``ulysses:<axis>``: q, k, v and the mask are this
    rank's block of the sequence (:func:`ring_attention`,
    :func:`ulysses_attention`); they take no segments."""
    if impl in ("ring", "ulysses"):
        if segments is not None:
            raise ValueError("segment packing is not supported by the "
                             "sequence-parallel impls")
        fn = ring_attention if impl == "ring" else ulysses_attention
        return fn(q, k, v, mask, group)
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    if segments is not None:
        mask, mode = segments, "segments"
    else:
        mode = "none" if mask is None else "padding"
    return AttentionFunction.apply(q, k, v, mask, mode)[0]


# ---------------------------------------------------------------------------
# Sequence-parallel attention (port of ``_attention_ring`` and
# ``_attention_ulysses``).  Each rank of ``group`` holds one block of the
# sequence: q, k, v ``[B, S/P, H, D]``, the key-padding mask ``[B, S/P]``.
# ---------------------------------------------------------------------------

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], group) -> torch.Tensor:
    """Ring attention, in plain tensor operations as the JAX package's is
    in plain XLA: the K/V blocks (and their mask) pass around the ring of
    ``group`` in P - 1 rotations (``parallel.collectives.shift``), and each
    rank accumulates its queries' softmax block by block with an f32
    running max and denominator, so no ``[S, S]`` score matrix exists
    anywhere.  The scale is folded into q in the input dtype; scores and
    ``P.V`` take f32 products of the input-dtype operands, P rounded to
    V's dtype first.  The running max only shifts the exponents (the
    output does not depend on it), so no gradient flows through it; the
    gradient of the rotations is the reverse rotation."""
    from mpmc_tpu_torch.parallel.collectives import (_send_recv, group_size,
                                                     shift)
    P = group_size(group)
    B, Sq, H, D = q.shape
    scale = torch.full((), 1.0 / D ** 0.5, dtype=q.dtype, device=q.device)
    qs = (q * scale).transpose(1, 2).to(torch.float32)       # [B, H, Sq, D]
    kv = torch.stack([k, v])                                 # rotate as one
    mb = (torch.ones(B, k.shape[1], device=q.device) if mask is None
          else mask.to(torch.float32))
    acc = q.new_zeros((B, H, Sq, D), dtype=torch.float32)
    m = q.new_full((B, H, Sq), float("-inf"), dtype=torch.float32)
    l = q.new_zeros((B, H, Sq), dtype=torch.float32)
    for step in range(P):
        kb = kv[0].transpose(1, 2).to(torch.float32)          # [B, H, Sk, D]
        vb = kv[1].transpose(1, 2)
        s = torch.matmul(qs, kb.transpose(-1, -2))
        s = s + ((1.0 - mb) * NEG_INF)[:, None, None, :]
        new_m = torch.maximum(m, s.amax(dim=-1)).detach()
        alpha = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.matmul(p.to(v.dtype).to(torch.float32),
                          vb.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = new_m
        if step < P - 1:
            kv = shift(kv, group, wrap=True)
            mb = _send_recv(mb, group, 1, wrap=True)
    return (acc / l[..., None]).transpose(1, 2).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor], group) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism: one all-to-all swaps the
    sequence sharding of q, k and v for a sharding of the heads, the
    exact attention runs over the whole sequence for H/P heads through
    :func:`dot_product_attention` (the hand-written kernels on the card,
    where the JAX package runs XLA's), and the inverse all-to-all restores
    the sequence sharding."""
    from mpmc_tpu_torch.parallel.collectives import (all_to_all, gather_rows,
                                                     group_size)
    P = group_size(group)
    B, S, H, D = q.shape
    if H % P:
        raise ValueError(f"ulysses needs heads ({H}) divisible by the "
                         f"sequence-axis size ({P})")
    h = H // P
    # [3, B, S/P, H, D] -> chunk j (head group j) to rank j; back come the
    # rank's head group over every rank's block of the sequence.
    qkv = torch.stack([q, k, v]).view(3, B, S, P, h, D)
    got = all_to_all(qkv.permute(3, 0, 1, 2, 4, 5), group)
    qg, kg, vg = got.permute(1, 2, 0, 3, 4, 5).reshape(3, B, P * S, h, D)
    if mask is not None:
        mask = gather_rows(mask.t(), group).t()
    out = dot_product_attention(qg, kg, vg, mask)            # [B, S, h, D]
    back = all_to_all(out.view(B, P, S, h, D).transpose(0, 1), group)
    return back.permute(1, 2, 0, 3, 4).reshape(B, S, H, D)
