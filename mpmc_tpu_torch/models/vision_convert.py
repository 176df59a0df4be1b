"""torchvision/timm/HF vision checkpoint to the flax-layout variable
trees (port of ``mpmc_tpu/models/vision_convert.py``).

A local torch state dict (numpy arrays) becomes the same ``{"params": ...,
"batch_stats": ...}`` numpy trees as the JAX package's converter produces
for its NHWC flax modules (``models.resnet``, ``models.vit``,
``models.convnext``); the port's weight bridge
(``models/convert.from_jax_variables``) then loads them into the port's
backbones (conv kernels HWIO back to OIHW, the BatchNorm statistics into
the running buffers).

Key layouts (auto-detected):

* ResNet: torchvision and timm share the layout
  (``conv1/bn1/layer{L}.{B}.conv{i}/bn{i}/downsample.{0,1}/fc``); timm's
  SE blocks (``se.fc1/fc2`` 1x1 convs) map onto the Dense SE module.
* ViT: timm (``cls_token/pos_embed/patch_embed.proj/blocks.N.attn.qkv``,
  the packed qkv split into q, k and v by heads) and HF ``ViTModel``
  (``embeddings.*/encoder.layer.N.attention.attention``).
* ConvNeXt: HF ``ConvNextModel`` (``embeddings.patch_embeddings/
  encoder.stages.S.{downsampling_layer,layers}``) and torchvision
  (``features.{0,2,4,6}`` downsamples between the block stages), the
  layer scale ``gamma`` flattened from either layout.

EfficientNet has no converter, as in the JAX package: it raises.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _conv(w: np.ndarray) -> np.ndarray:
    """torch conv weight [out, in/g, kh, kw] → flax kernel [kh, kw, in/g, out]."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _bn(sd: Dict[str, np.ndarray], prefix: str) -> Tuple[Dict, Dict]:
    params = {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}
    stats = {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]}
    return params, stats


def _ln(sd: Dict[str, np.ndarray], prefix: str) -> Dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


# ---------------------------------------------------------------------------
# ResNet (torchvision / timm layout)
# ---------------------------------------------------------------------------

def convert_resnet_state_dict(sd: Dict[str, np.ndarray],
                              num_classes: int = 0) -> Dict:
    """torchvision/timm ResNet state_dict → flax ResNet variables."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: Dict = {"stem_conv": {"kernel": _conv(sd["conv1.weight"])}}
    stats: Dict = {}
    params["stem_bn"], stats["stem_bn"] = _bn(sd, "bn1")

    n_stages = max(int(k.split(".")[0][5:]) for k in sd
                   if k.startswith("layer"))
    for li in range(1, n_stages + 1):
        blocks = {int(k.split(".")[1]) for k in sd
                  if k.startswith(f"layer{li}.")}
        for bi in sorted(blocks):
            src = f"layer{li}.{bi}"
            dst = f"stage{li - 1}_block{bi}"
            bp: Dict = {}
            bs: Dict = {}
            for ci in (1, 2, 3):
                if f"{src}.conv{ci}.weight" not in sd:
                    continue
                bp[f"conv{ci}"] = {
                    "kernel": _conv(sd[f"{src}.conv{ci}.weight"])}
                bp[f"bn{ci}"], bs[f"bn{ci}"] = _bn(sd, f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _conv(sd[f"{src}.downsample.0.weight"])}
                bp["downsample_bn"], bs["downsample_bn"] = _bn(
                    sd, f"{src}.downsample.1")
            if f"{src}.se.fc1.weight" in sd:  # timm SEModule (1×1 convs)
                bp["se"] = {
                    "fc1": {"kernel": _linear(
                        sd[f"{src}.se.fc1.weight"][:, :, 0, 0]),
                        "bias": sd[f"{src}.se.fc1.bias"]},
                    "fc2": {"kernel": _linear(
                        sd[f"{src}.se.fc2.weight"][:, :, 0, 0]),
                        "bias": sd[f"{src}.se.fc2.bias"]},
                }
            params[dst] = bp
            stats[dst] = bs
    if num_classes and "fc.weight" in sd:
        params["classifier"] = {"kernel": _linear(sd["fc.weight"]),
                                "bias": sd["fc.bias"]}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# ViT (timm / HF ViTModel layouts)
# ---------------------------------------------------------------------------

def convert_vit_state_dict(sd: Dict[str, np.ndarray], num_heads: int,
                           num_classes: int = 0) -> Dict:
    """timm or HF ViT state_dict → flax ViT params (no batch stats)."""
    sd = {k.removeprefix("vit."): np.asarray(v) for k, v in sd.items()}
    hf = any(k.startswith("embeddings.cls_token") for k in sd)
    p: Dict = {}
    if hf:
        p["cls_token"] = sd["embeddings.cls_token"]
        p["pos_embed"] = sd["embeddings.position_embeddings"]
        proj_w = sd["embeddings.patch_embeddings.projection.weight"]
        proj_b = sd["embeddings.patch_embeddings.projection.bias"]
    else:
        p["cls_token"] = sd["cls_token"]
        p["pos_embed"] = sd["pos_embed"]
        proj_w = sd["patch_embed.proj.weight"]
        proj_b = sd["patch_embed.proj.bias"]
    p["patch_embed"] = {"kernel": _conv(proj_w), "bias": proj_b}

    D = proj_w.shape[0]
    H = num_heads
    hd = D // H

    def qkv_split(w3, b3):
        """[3D, D] packed qkv → three DenseGeneral kernels [D, H, hd]."""
        out = []
        for i in range(3):
            w = w3[i * D:(i + 1) * D]
            b = b3[i * D:(i + 1) * D]
            out.append({"kernel": np.ascontiguousarray(
                w.T.reshape(D, H, hd)), "bias": b.reshape(H, hd)})
        return out

    layer_keys = ("encoder.layer." if hf else "blocks.")
    n_layers = 1 + max(int(k.removeprefix(layer_keys).split(".")[0])
                       for k in sd if k.startswith(layer_keys))
    for i in range(n_layers):
        lp: Dict = {}
        if hf:
            pre = f"encoder.layer.{i}."
            lp["ln1"] = _ln(sd, pre + "layernorm_before")
            for ours, theirs in (("q", "query"), ("k", "key"),
                                 ("v", "value")):
                w = sd[pre + f"attention.attention.{theirs}.weight"]
                b = sd[pre + f"attention.attention.{theirs}.bias"]
                lp[ours] = {"kernel": np.ascontiguousarray(
                    w.T.reshape(D, H, hd)), "bias": b.reshape(H, hd)}
            ow = sd[pre + "attention.output.dense.weight"]
            lp["out"] = {"kernel": np.ascontiguousarray(
                ow.T.reshape(H, hd, D)),
                "bias": sd[pre + "attention.output.dense.bias"]}
            lp["ln2"] = _ln(sd, pre + "layernorm_after")
            lp["mlp1"] = {"kernel": _linear(sd[pre + "intermediate.dense.weight"]),
                          "bias": sd[pre + "intermediate.dense.bias"]}
            lp["mlp2"] = {"kernel": _linear(sd[pre + "output.dense.weight"]),
                          "bias": sd[pre + "output.dense.bias"]}
        else:
            pre = f"blocks.{i}."
            lp["ln1"] = _ln(sd, pre + "norm1")
            q, k, v = qkv_split(sd[pre + "attn.qkv.weight"],
                                sd[pre + "attn.qkv.bias"])
            lp["q"], lp["k"], lp["v"] = q, k, v
            ow = sd[pre + "attn.proj.weight"]
            lp["out"] = {"kernel": np.ascontiguousarray(
                ow.T.reshape(H, hd, D)), "bias": sd[pre + "attn.proj.bias"]}
            lp["ln2"] = _ln(sd, pre + "norm2")
            lp["mlp1"] = {"kernel": _linear(sd[pre + "mlp.fc1.weight"]),
                          "bias": sd[pre + "mlp.fc1.bias"]}
            lp["mlp2"] = {"kernel": _linear(sd[pre + "mlp.fc2.weight"]),
                          "bias": sd[pre + "mlp.fc2.bias"]}
        p[f"layer_{i}"] = lp
    p["ln_final"] = _ln(sd, "layernorm" if hf else "norm")
    if num_classes and "head.weight" in sd:
        p["classifier"] = {"kernel": _linear(sd["head.weight"]),
                           "bias": sd["head.bias"]}
    return {"params": p, "batch_stats": {}}


# ---------------------------------------------------------------------------
# ConvNeXt (HF ConvNextModel / torchvision layouts)
# ---------------------------------------------------------------------------

def convert_convnext_state_dict(sd: Dict[str, np.ndarray],
                                depths: Sequence[int] = (3, 3, 9, 3),
                                num_classes: int = 0) -> Dict:
    sd = {k.removeprefix("convnext."): np.asarray(v) for k, v in sd.items()}
    hf = any(k.startswith("embeddings.patch_embeddings") for k in sd)
    p: Dict = {}

    def block(src_dw, src_ln, src_pw1, src_pw2, src_gamma):
        return {
            "dwconv": {"kernel": _conv(sd[src_dw + ".weight"]),
                       "bias": sd[src_dw + ".bias"]},
            "norm": _ln(sd, src_ln),
            "pwconv1": {"kernel": _linear(sd[src_pw1 + ".weight"]),
                        "bias": sd[src_pw1 + ".bias"]},
            "pwconv2": {"kernel": _linear(sd[src_pw2 + ".weight"]),
                        "bias": sd[src_pw2 + ".bias"]},
            # torchvision stores layer_scale as [dim, 1, 1]; HF as [dim]
            "gamma": sd[src_gamma].reshape(-1),
        }

    if hf:
        p["stem_conv"] = {"kernel": _conv(sd["embeddings.patch_embeddings.weight"]),
                          "bias": sd["embeddings.patch_embeddings.bias"]}
        p["stem_norm"] = _ln(sd, "embeddings.layernorm")
        for si, depth in enumerate(depths):
            if si > 0:
                pre = f"encoder.stages.{si}.downsampling_layer"
                p[f"down{si}_norm"] = _ln(sd, pre + ".0")
                p[f"down{si}_conv"] = {
                    "kernel": _conv(sd[pre + ".1.weight"]),
                    "bias": sd[pre + ".1.bias"]}
            for bi in range(depth):
                pre = f"encoder.stages.{si}.layers.{bi}"
                p[f"stage{si}_block{bi}"] = block(
                    pre + ".dwconv", pre + ".layernorm", pre + ".pwconv1",
                    pre + ".pwconv2", pre + ".layer_scale_parameter")
        p["final_norm"] = _ln(sd, "layernorm")
    else:  # torchvision: features.0=stem, odd=stages, even=downsamples
        p["stem_conv"] = {"kernel": _conv(sd["features.0.0.weight"]),
                          "bias": sd["features.0.0.bias"]}
        p["stem_norm"] = _ln(sd, "features.0.1")
        for si, depth in enumerate(depths):
            if si > 0:
                pre = f"features.{2 * si}"
                p[f"down{si}_norm"] = _ln(sd, pre + ".0")
                p[f"down{si}_conv"] = {
                    "kernel": _conv(sd[pre + ".1.weight"]),
                    "bias": sd[pre + ".1.bias"]}
            for bi in range(depth):
                pre = f"features.{2 * si + 1}.{bi}"
                p[f"stage{si}_block{bi}"] = block(
                    pre + ".block.0", pre + ".block.2", pre + ".block.3",
                    pre + ".block.5", pre + ".layer_scale")
        p["final_norm"] = _ln(sd, "classifier.0")
        if num_classes and "classifier.2.weight" in sd:
            p["classifier"] = {"kernel": _linear(sd["classifier.2.weight"]),
                               "bias": sd["classifier.2.bias"]}
    return {"params": p, "batch_stats": {}}


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_VIT_HEADS = {"vit_base_16": 12, "vit_base_patch16_224": 12,
              "vit_base_patch16_384": 12, "vit_base_32": 12,
              "clip_vit_b32": 12, "vit_large_16": 16,
              "vit_large_patch16_384": 16}


def convert_image_state_dict(sd: Dict[str, np.ndarray], arch: str,
                             num_classes: int = 0) -> Dict:
    """Dispatch on the factory arch names of ``create_image_backbone``."""
    if arch.startswith(("resnet", "resnext", "seresnext")):
        return convert_resnet_state_dict(sd, num_classes)
    if arch in _VIT_HEADS:
        return convert_vit_state_dict(sd, _VIT_HEADS[arch], num_classes)
    if arch.startswith("convnext"):
        return convert_convnext_state_dict(sd, num_classes=num_classes)
    raise ValueError(f"no converter for image arch {arch!r}")
