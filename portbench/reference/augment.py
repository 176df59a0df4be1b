"""The training augmentation in float32, from its description: a horizontal
flip, a brightness gain with the pixels clipped to [0, 1], ImageNet
normalization, then a rotation by the Paeth three-shear decomposition
ShearX(-tan(a/2)) ShearY(sin a) ShearX(-tan(a/2)) about the image centre,
each shear a linear interpolation along its axis with zeros outside.  The
random draws (flip, gain, angle in radians) are given."""

from __future__ import annotations

import torch

from portbench.reference.nets import IMAGENET_MEAN, IMAGENET_STD


def _shear(x: torch.Tensor, t: torch.Tensor, axis: int) -> torch.Tensor:
    """``out[pos] = x[pos - t]`` along ``axis`` (2: along each row, ``t
    [B, H]``; 1: along each column, ``t [B, W]``), linear between the two
    nearest pixels, zero outside."""
    L = x.shape[axis]
    pos = torch.arange(L, device=x.device, dtype=torch.float32)
    src = pos[None, None, :] - t[:, :, None]        # [B, lines, L]
    i0 = torch.floor(src)
    w1 = src - i0
    i0 = i0.long()
    if axis == 1:
        x = x.transpose(1, 2)                      # lines are columns
    out = torch.zeros_like(x)
    for idx, w in ((i0, 1.0 - w1), (i0 + 1, w1)):
        ok = (idx >= 0) & (idx < L)
        gathered = torch.gather(
            x, 2, idx.clamp(0, L - 1)[..., None].expand(-1, -1, -1,
                                                         x.shape[-1]))
        out = out + gathered * (w * ok)[..., None]
    return out.transpose(1, 2) if axis == 1 else out


def rotate(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[1], x.shape[2]
    rows = torch.arange(H, device=x.device, dtype=torch.float32) - (H - 1) / 2
    cols = torch.arange(W, device=x.device, dtype=torch.float32) - (W - 1) / 2
    alpha = -torch.tan(angle / 2.0)
    beta = torch.sin(angle)
    tx = alpha[:, None] * rows[None, :]
    ty = beta[:, None] * cols[None, :]
    x = _shear(x, tx, axis=2)
    x = _shear(x, ty, axis=1)
    return _shear(x, tx, axis=2)


def augment(images_u8: torch.Tensor, flip: torch.Tensor, bright: torch.Tensor,
            angle: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC and the draws ``[B]`` to the model's float32 input."""
    x = images_u8.to(torch.float32) / 255.0
    x = torch.where(flip.bool()[:, None, None, None], x.flip(2), x)
    x = torch.clamp(x * bright.float()[:, None, None, None], 0.0, 1.0)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return rotate((x - mean) / std, angle.float())
