"""Attention core: the hand-written CUDA kernel and its plain PyTorch twin.

Port of ``mpmc_tpu/ops/attention.py``'s forward.  Layout at the API is the
JAX package's: q ``[B, Sq, H, D]``, k/v ``[B, Sk, H, D]``, a key-padding
mask ``[B, Sk]`` with 1 = attend, or ``[B, S]`` segment ids (0 = padding)
for packed self-attention.  Masking is the reference's additive -1e9 bias,
never -inf and never skipped keys, so a fully masked query row gives the
uniform average of V.

A CPU tensor runs :func:`attention_forward_reference`; a CUDA tensor
launches the kernel of ``csrc/attention_fwd.cu`` or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mpmc_tpu_torch.ops import build

NEG_INF = -1e9  # the reference's additive mask value, not -inf
MODES = {"none": 0, "padding": 1, "segments": 2}
MAX_SEQ = 512
MAX_HEAD_DIM = 128

# Kernel launches by name.  Each wrapper adds one where it launches its
# kernel; a run zeroes the counts before its main path and reads them after
# to show that the path went through the kernels.
launch_counts = {"attention_fwd": 0}


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


def attention_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           mode: str = "padding"
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/attention_fwd.cu`` on CUDA tensors; same contract as
    :func:`attention_forward_reference`.  Raises on anything the kernel does
    not take and on a launch error."""
    _check(q, k, v, mask, mode)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_forward_cuda needs q, k, v on one CUDA "
                         "device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == q.dtype and v.dtype == q.dtype):
        raise ValueError(f"kernel takes float32 or bfloat16 q/k/v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D > MAX_HEAD_DIM or Sq > MAX_SEQ or Sk > MAX_SEQ:
        raise ValueError(f"kernel takes D <= {MAX_HEAD_DIM} and Sq, Sk <= "
                         f"{MAX_SEQ}, got D={D}, Sq={Sq}, Sk={Sk}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("kernel needs the head dim of q, k, v contiguous")
    mask_f = None
    if mode != "none":
        mask_f = mask.to(device=q.device, dtype=torch.float32).contiguous()
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
    if rc != 0:
        raise RuntimeError(f"attention_fwd launch failed: CUDA error {rc} "
                           f"({lib.mpmc_cuda_error_string(rc).decode()})")
    launch_counts["attention_fwd"] += 1
    return out, lse


def _library() -> ctypes.CDLL:
    lib = build.library("attention_fwd")
    if lib.mpmc_attention_fwd.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mpmc_attention_fwd.argtypes = (
            [p] * 6 + [i] * 7 + [ll] * 12 + [ctypes.c_float, p])
        lib.mpmc_attention_fwd.restype = i
        lib.mpmc_cuda_error_string.argtypes = [i]
        lib.mpmc_cuda_error_string.restype = ctypes.c_char_p
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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          segments: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Multi-head scaled dot-product attention, ``[B, Sq, H, D]`` out.

    mask: ``[B, Sk]`` (1 = attend) or None.  segments: ``[B, S]`` ids
    (0 = padding) for packed self-attention rows: token i attends token j
    iff both carry the same non-zero id; supersedes ``mask``."""
    if segments is not None:
        return attention_forward(q, k, v, segments, "segments")[0]
    if mask is not None:
        return attention_forward(q, k, v, mask, "padding")[0]
    return attention_forward(q, k, v, None, "none")[0]
