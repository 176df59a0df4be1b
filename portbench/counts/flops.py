"""Model FLOPs of one meme's forward pass, from its own token counts and the
image size: matrix products and convolutions at 2 FLOPs a multiply-add,
attention's two products over the meme's own tokens; no padding, no
recomputation, nothing elementwise.  A training meme costs three forwards
(forward, and a backward of twice its products)."""

from __future__ import annotations

import numpy as np

TRAIN_FACTOR = 3


def encoder(tokens: np.ndarray, hidden: int, inter: int, layers: int
            ) -> np.ndarray:
    """Per sequence of ``tokens`` tokens: q, k, v and out (8 L H^2), the MLP
    (4 L H I) and attention's scores and weighted sum (4 L^2 H), per layer."""
    L = np.asarray(tokens, np.float64)
    return layers * (8 * L * hidden ** 2 + 4 * L * hidden * inter
                     + 4 * L * L * hidden)


def resnet18(size: int) -> float:
    """One image through ResNet-18's convolutions at ``size`` pixels."""
    total = 0.0

    def conv(c_in, c_out, k, stride, pad, hw):
        nonlocal total
        out = (hw + 2 * pad - k) // stride + 1
        total += 2.0 * c_in * k * k * c_out * out * out
        return out

    hw = conv(3, 64, 7, 2, 3, size)
    hw = (hw + 2 - 3) // 2 + 1                       # max-pool 3/2
    ch = 64
    for si, width in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            stride = 2 if (bi == 0 and si > 0) else 1
            out = conv(ch, width, 3, stride, 1, hw)
            conv(width, width, 3, 1, 1, out)
            if stride != 1 or ch != width:
                conv(ch, width, 1, stride, 0, hw)
            hw, ch = out, width
    return total


def vit(c: dict) -> float:
    """One image through the patch embedding and the encoder."""
    patches = (c["image_size"] // c["patch_size"]) ** 2
    embed = 2.0 * 3 * c["patch_size"] ** 2 * c["hidden_size"] * patches
    return embed + float(encoder(patches + 1, c["hidden_size"],
                                 c["intermediate_size"],
                                 c["num_hidden_layers"]))


def linears(pairs) -> float:
    return float(sum(2.0 * a * b for a, b in pairs))


def forward(cfg: dict, n: int, text_tokens=None, caption_tokens=None
            ) -> float:
    """Forward FLOPs of ``n`` memes with these ``[n]`` token counts (an
    image model takes none)."""
    img, head = cfg["image_encoder"], cfg["head"]
    if cfg["kind"] == "image":
        return n * (vit(img) + linears([(img["hidden_size"],
                                         head["num_classes"])]))
    t, c = cfg["text_encoder"], cfg["caption_encoder"]
    proj, fdim = head["proj_dim"], img["finetune_dim"]
    width = 2 * proj + fdim
    fixed = resnet18(img["image_size"]) + linears([
        (t["hidden_size"], proj), (c["hidden_size"], proj),
        (img["feature_dim"], fdim), (fdim, fdim), (width, width),
        (width, proj), (proj, head["num_classes"])])
    return float(np.sum(encoder(text_tokens, t["hidden_size"],
                                t["intermediate_size"],
                                t["num_hidden_layers"]))
                 + np.sum(encoder(caption_tokens, c["hidden_size"],
                                  c["intermediate_size"],
                                  c["num_hidden_layers"]))
                 + n * fixed)
