"""Model weights from the seed, made on the device in a few large draws.

``param_specs(cfg)`` names every parameter and buffer of a configuration's
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

Spec = Tuple[str, Tuple[int, ...], str]


def _linear(name: str, n_in: int, n_out: int) -> List[Spec]:
    return [(name + ".weight", (n_out, n_in), "normal"),
            (name + ".bias", (n_out,), "zeros")]


def _norm(name: str, n: int, batch: bool = False) -> List[Spec]:
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
    out += _norm(p + "embeddings_ln", H)
    for i in range(c["num_hidden_layers"]):
        lp = f"{p}layer_{i}."
        for part in ("query", "key", "value", "out"):
            out += _linear(f"{lp}attention.{part}", H, H)
        out += _norm(lp + "attention_ln", H)
        out += _linear(lp + "intermediate", H, I) + _linear(lp + "output", I, H)
        out += _norm(lp + "output_ln", H)
    return out + _linear(p + "pooler", H, H)


def _conv(name: str, c_in: int, c_out: int, k: int) -> Spec:
    return (name + ".weight", (c_out, c_in, k, k), "conv")


def resnet18_specs(p: str) -> List[Spec]:
    out = [_conv(p + "stem_conv", 3, 64, 7)] + _norm(p + "stem_bn", 64, True)
    ch = 64
    for si, width in enumerate((64, 128, 256, 512)):
        for bi in range(2):
            stride = 2 if (bi == 0 and si > 0) else 1
            bp = f"{p}stage{si}_block{bi}."
            out += [_conv(bp + "conv1", ch, width, 3)]
            out += _norm(bp + "bn1", width, True)
            out += [_conv(bp + "conv2", width, width, 3)]
            out += _norm(bp + "bn2", width, True)
            if stride != 1 or ch != width:
                out += [_conv(bp + "downsample_conv", ch, width, 1)]
                out += _norm(bp + "downsample_bn", width, True)
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
        out += _norm(lp + "ln1", H)
        for part in ("q", "k", "v", "out"):
            out += _linear(lp + part, H, H)
        out += _norm(lp + "ln2", H)
        out += _linear(lp + "mlp1", H, I) + _linear(lp + "mlp2", I, H)
    return out + _norm(p + "ln_final", H)


def param_specs(cfg: dict) -> List[Spec]:
    """Every parameter and buffer of the configuration's model, in the
    system's naming."""
    head = cfg["head"]
    if cfg["kind"] == "image":
        c = cfg["image_encoder"]
        return vit_specs("backbone.", c) + _linear(
            "output", c["hidden_size"], head["num_classes"])
    img = cfg["image_encoder"]
    proj, fdim = head["proj_dim"], img["finetune_dim"]
    out = text_encoder_specs("text_model.", cfg["text_encoder"])
    out += _linear("text_fc.fc", cfg["text_encoder"]["hidden_size"], proj)
    out += _norm("text_fc.bn", proj, True)
    out += resnet18_specs("image_model.backbone.")
    out += _linear("image_model.finetune_fc1", img["feature_dim"], fdim)
    out += _linear("image_model.finetune_fc2", fdim, fdim)
    out += text_encoder_specs("caption_text_model.", cfg["caption_encoder"])
    out += _linear("caption_text_fc.fc", cfg["caption_encoder"]["hidden_size"],
                   proj)
    out += _norm("caption_text_fc.bn", proj, True)
    width = proj + fdim + proj
    out += _linear("fusion.gated.gate_fc", width, width)
    out += _norm("fusion.gated.gate_bn", width, True)
    out += _linear("fusion.gated.reduce_fc", width, proj)
    out += _norm("fusion.gated.reduce_bn", proj, True)
    out += _linear("output_fc", proj, head["num_classes"])
    return out + _norm("output_bn", head["num_classes"], True)


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one named stream of draws of run seed ``seed``."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHT_STREAM = 1


def make_weights(cfg: dict, seed: int, device: torch.device
                 ) -> Dict[str, torch.Tensor]:
    specs = param_specs(cfg)
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
