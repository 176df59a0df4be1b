"""Model weights from the seed, made on the device in a few large draws.

A model kind's ``param_specs(cfg)`` (``portbench/kinds/``, composed from
the blocks here) names every parameter and buffer of a configuration's
model, with its shape and how it is drawn; ``make_weights`` draws them.
The same dict is loaded into the system under test and read by the plain
reference (``portbench/reference``), so both start from the same numbers.

Draws, as BERT and the system initialize: normal(0, 0.02) for every
linear and embedding weight, ViT's class token and positions (one
``randn`` over all of them); He-normal (fan out) for convolutions (one
``randn``, scaled per tensor); zero biases; ones and zeros for the norms'
scales and shifts; BatchNorm running statistics (0, 1).  (Random biases
would swamp the 2C head's gated features, whose weights sum to one over
1,536 inputs, and a BatchNorm after them would then magnify rounding.)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import spec

Spec = Tuple[str, Tuple[int, ...], str]


def linear_specs(name: str, n_in: int, n_out: int) -> List[Spec]:
    return [(name + ".weight", (n_out, n_in), "normal"),
            (name + ".bias", (n_out,), "zeros")]


def norm_specs(name: str, n: int, batch: bool = False) -> List[Spec]:
    out = [(name + ".weight", (n,), "ones"), (name + ".bias", (n,), "zeros")]
    if batch:
        out += [(name + ".running_mean", (n,), "zeros"),
                (name + ".running_var", (n,), "ones")]
    return out


def text_encoder_specs(p: str, c: dict) -> List[Spec]:
    H, I = c["hidden_size"], c["intermediate_size"]
    out = [(p + "word_embeddings.weight", (c["vocab_size"], H), "normal"),
           (p + "position_embeddings.weight",
            (c["max_position_embeddings"], H), "normal")]
    if c["type_vocab_size"] > 0:
        out.append((p + "token_type_embeddings.weight",
                    (c["type_vocab_size"], H), "normal"))
    out += norm_specs(p + "embeddings_ln", H)
    for i in range(c["num_hidden_layers"]):
        lp = f"{p}layer_{i}."
        for part in ("query", "key", "value", "out"):
            out += linear_specs(f"{lp}attention.{part}", H, H)
        out += norm_specs(lp + "attention_ln", H)
        out += (linear_specs(lp + "intermediate", H, I)
                + linear_specs(lp + "output", I, H))
        out += norm_specs(lp + "output_ln", H)
    return out + linear_specs(p + "pooler", H, H)


def _conv(name: str, c_in: int, c_out: int, k: int) -> Spec:
    return (name + ".weight", (c_out, c_in, k, k), "conv")


def resnet18_specs(p: str) -> List[Spec]:
    out = [_conv(p + "stem_conv", 3, 64, 7)]
    out += norm_specs(p + "stem_bn", 64, True)
    ch = 64
    for si, width in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            stride = 2 if (bi == 0 and si > 0) else 1
            bp = f"{p}stage{si}_block{bi}."
            out += [_conv(bp + "conv1", ch, width, 3)]
            out += norm_specs(bp + "bn1", width, True)
            out += [_conv(bp + "conv2", width, width, 3)]
            out += norm_specs(bp + "bn2", width, True)
            if stride != 1 or ch != width:
                out += [_conv(bp + "downsample_conv", ch, width, 1)]
                out += norm_specs(bp + "downsample_bn", width, True)
            ch = width
    return out


def vit_specs(p: str, c: dict) -> List[Spec]:
    H, I, patch = c["hidden_size"], c["intermediate_size"], c["patch_size"]
    tokens = 1 + (c["image_size"] // patch) ** 2
    out = [(p + "patch_embed.weight", (H, 3, patch, patch), "conv"),
           (p + "patch_embed.bias", (H,), "zeros"),
           (p + "cls_token", (1, 1, H), "normal"),
           (p + "pos_embed", (1, tokens, H), "normal")]
    for i in range(c["num_hidden_layers"]):
        lp = f"{p}layer_{i}."
        out += norm_specs(lp + "ln1", H)
        for part in ("q", "k", "v", "out"):
            out += linear_specs(lp + part, H, H)
        out += norm_specs(lp + "ln2", H)
        out += (linear_specs(lp + "mlp1", H, I)
                + linear_specs(lp + "mlp2", I, H))
    return out + norm_specs(p + "ln_final", H)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one named stream of draws of run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHT_STREAM = 1


def make_weights(cfg: dict, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    specs = spec.kind(cfg["kind"]).param_specs(cfg)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed,
                                                           WEIGHT_STREAM))
    out: Dict[str, torch.Tensor] = {}
    for kind in ("normal", "conv"):
        group = [(n, s) for n, s, k in specs if k == kind]
        sizes = [int(np.prod(s)) for _, s in group]
        flat = torch.randn(sum(sizes), generator=g, device=device)
        for (n, s), part in zip(group, torch.split(flat, sizes)):
            if kind == "normal":
                out[n] = part.view(s).mul_(0.02)
            else:                      # He-normal, fan out
                out[n] = part.view(s).mul_(float(np.sqrt(2.0 / (
                    s[0] * s[2] * s[3]))))
    for n, s, k in specs:
        if k == "ones":
            out[n] = torch.ones(s, device=device)
        elif k == "zeros":
            out[n] = torch.zeros(s, device=device)
    return {n: out[n] for n, _, _ in specs}
