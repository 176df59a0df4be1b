"""Fused uint8 -> normalized f32 image pass: the hand-written CUDA kernel
and its plain PyTorch twin (port of ``mpmc_tpu/ops/image_ops.py`` and the
flip in front of its kernel).

``out[b,h,w,c] = (clip(u8[b,h,w',c] * f32(1/255) * bright[b], 0, 1) -
mean[c]) * f32(1/std[c])`` with ``w' = W-1-w`` where ``flip[b]``.  Like the
TPU kernel, and unlike the JAX package's unfused branch, it multiplies by
``1/255`` and by ``1/std`` instead of dividing.

A CPU tensor runs :func:`fused_normalize_flip_brightness_reference`; a CUDA
tensor launches ``csrc/image_normalize.cu`` or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mpmc_tpu_torch.ops import build

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# The kernel's constants, rounded to f32 as the TPU kernel rounds them.
INV_255 = np.float32(1.0 / 255.0)
MEAN_F32 = np.asarray(IMAGENET_MEAN, np.float32)
INV_STD_F32 = np.float32(1.0) / np.asarray(IMAGENET_STD, np.float32)

launch_counts = build.launch_counts


def _check(images_u8: torch.Tensor, flip: torch.Tensor,
           bright: torch.Tensor) -> None:
    if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
        raise ValueError(f"images must be uint8 [B, H, W, C], got "
                         f"{images_u8.dtype} {tuple(images_u8.shape)}")
    if images_u8.shape[-1] != 3:
        raise ValueError(f"the fused image pass takes C = 3 (ImageNet "
                         f"statistics), got C = {images_u8.shape[-1]}")
    B = images_u8.shape[0]
    if tuple(flip.shape) != (B,) or tuple(bright.shape) != (B,):
        raise ValueError(f"flip and bright must be [{B}], got "
                         f"{tuple(flip.shape)}, {tuple(bright.shape)}")


def fused_normalize_flip_brightness_reference(images_u8: torch.Tensor,
                                              flip: torch.Tensor,
                                              bright: torch.Tensor
                                              ) -> torch.Tensor:
    """Plain version of the kernel, in its order of f32 operations."""
    mean, inv_std = _stats(images_u8.device)
    x = torch.where(flip.bool()[:, None, None, None],
                    torch.flip(images_u8, dims=(2,)), images_u8)
    # A Python float times an f32 tensor multiplies by the float rounded
    # to f32, which is INV_255 itself.
    x = x.to(torch.float32) * float(INV_255)
    x = torch.clamp(x * bright.to(torch.float32)[:, None, None, None],
                    0.0, 1.0)
    return (x - mean) * inv_std


@functools.lru_cache(maxsize=None)
def _stats(device: torch.device):
    """The per-channel mean and 1/std on ``device``, made once (so that a
    CUDA graph can capture the plain version)."""
    return (torch.from_numpy(MEAN_F32).to(device),
            torch.from_numpy(INV_STD_F32).to(device))


def fused_normalize_flip_brightness_cuda(images_u8: torch.Tensor,
                                         flip: torch.Tensor,
                                         bright: torch.Tensor
                                         ) -> torch.Tensor:
    """Launch ``csrc/image_normalize.cu``; same contract as the plain
    version.  Raises on anything the kernel does not take and on a launch
    error."""
    _check(images_u8, flip, bright)
    dev = images_u8.device
    if not (images_u8.is_cuda and flip.device == dev
            and bright.device == dev):
        raise ValueError("fused_normalize_flip_brightness_cuda needs its "
                         "tensors on one CUDA device")
    images_u8 = images_u8.contiguous()
    flip_u8 = flip.to(torch.uint8).contiguous()
    bright_f = bright.to(torch.float32).contiguous()
    out = torch.empty(images_u8.shape, dtype=torch.float32, device=dev)
    B, H, W, _ = images_u8.shape
    lib = _library()
    mean = (ctypes.c_float * 3)(*MEAN_F32.tolist())
    inv_std = (ctypes.c_float * 3)(*INV_STD_F32.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mpmc_image_normalize(
            images_u8.data_ptr(), flip_u8.data_ptr(), bright_f.data_ptr(),
            out.data_ptr(), B, H, W, float(INV_255), mean, inv_std, stream)
    build.check_launch(lib, "image_normalize", rc)
    build.count_launch("image_normalize")
    return out


def _library() -> ctypes.CDLL:
    lib = build.library("image_normalize")
    if lib.mpmc_image_normalize.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fp = ctypes.POINTER(ctypes.c_float)
        lib.mpmc_image_normalize.argtypes = [p, p, p, p, i, i, i, f, fp, fp,
                                             p]
        lib.mpmc_image_normalize.restype = i
    return lib


def fused_normalize_flip_brightness(images_u8: torch.Tensor,
                                    flip: torch.Tensor,
                                    bright: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B,H,W,3]``, bool ``flip [B]``, f32 ``bright [B]`` -> f32
    ``[B,H,W,3]``: the plain version for CPU tensors, the kernel for CUDA
    tensors."""
    if images_u8.device.type == "cpu":
        _check(images_u8, flip, bright)
        return fused_normalize_flip_brightness_reference(images_u8, flip,
                                                         bright)
    if images_u8.device.type == "cuda":
        return fused_normalize_flip_brightness_cuda(images_u8, flip, bright)
    raise ValueError(f"no image path for device {images_u8.device}")
