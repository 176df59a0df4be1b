"""Model kinds (``portbench/kinds/``).  The two kinds that the first cells
run read what they read before the kinds took them over: the
``TrainConfig`` (held against the parent's own construction, kept here),
and the tiny weights, memes, counts and reference logits (pinned from the
parent's code on the CPU).  Nothing outside ``kinds/`` branches on a
kind's name: a configuration's ``kind`` is only ever looked up."""

import ast
import hashlib
import os

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.counts import attention
from portbench.data import make_memes
from portbench.drivers.common import bucket, train_config
from portbench.reference import nets
from portbench.weights import make_weights
from tiny import TRAFFIC, tiny_config

CPU = torch.device("cpu")
SEED = 2 ** 31 + 7
TOKENS = {"text": np.array([14, 40, 112]), "caption": np.array([10, 20, 30])}

# From the parent's code: the SHA-256 of the tiny weights (names and
# values) and of 10 tiny memes of split 3 (keys and values), the counts of
# the real configuration over ``TOKENS`` (forward FLOPs; attention
# operations and bytes, training and forward), and the reference's
# training-mode logits of those memes.
PINS = {
    "2c_flagship": {
        "weights": "e4da39fdd25b9f9f1c37bb73ea99451edf290dcab496df27f4271959cb3fdb6f",
        "memes": "904e18efcdf645ca9c3e4e6bfd3f384159294356b73321596a7c5c8ad6de6a92",
        "counts": (49878813696.0, (2030837760.0, 49987584.0),
                   (580239360.0, 16662528.0)),
        "logits": [-0.21276167035102844, -0.30790767073631287,
                   0.5547878742218018, 0.2934182286262512,
                   -0.18958444893360138, -0.19544656574726105,
                   1.3206712007522583, -0.3632791340351105,
                   -0.24472668766975403, -0.6551713943481445]},
    "2b_vit_b16_384": {
        "weights": "b4ae9c7865ed45d99430e0fb5a9d46659efc3c461847befa7e00e3225c181106",
        "memes": "a394b172c656cfd29adfa331c6833320d83e9e2d802e2f00ae2748bf6c491ee4",
        "counts": (332901504000.0, (128867493888.0, 382869504.0),
                   (36819283968.0, 127623168.0)),
        "logits": [0.882811963558197, -0.128324955701828,
                   1.3058338165283203, 0.31196409463882446,
                   0.814293622970581, 0.39220893383026123,
                   1.185930609703064, -0.045627474784851074,
                   1.0624473094940186, 0.5127230286598206,
                   0.8101887106895447, 0.5456550717353821,
                   0.24826964735984802, -0.4356237053871155,
                   -0.0034307632595300674, 0.07426746189594269,
                   0.5971163511276245, 0.5426594018936157,
                   0.810302734375, 0.04733383655548096]},
}


def _sha(named) -> str:
    d = hashlib.sha256()
    for name, _ in named:
        d.update(np.frombuffer(name.encode(), np.uint8).tobytes())
    for _, value in named:
        d.update(np.ascontiguousarray(value).tobytes())
    return d.hexdigest()


def _parent_train_config(cfg: dict, seed: int, device: torch.device):
    """The parent's ``train_config``, as it was before the kinds split
    it, with ``device_resident`` true as its configuration files said."""
    from mpmc_tpu_torch.config import (DataConfig, FusionMethod,
                                       ImageEncoderConfig, LossType,
                                       ModelConfig, PoolingType, Subtask,
                                       TextEncoderConfig, TrainConfig)

    r, head = cfg["recipe"], cfg["head"]
    img = cfg["image_encoder"]

    def text(c: dict) -> TextEncoderConfig:
        return TextEncoderConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            num_layers=c["num_hidden_layers"],
            num_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_position_embeddings=c["max_position_embeddings"],
            type_vocab_size=c["type_vocab_size"],
            layer_norm_eps=c["layer_norm_eps"],
            hidden_dropout=c["hidden_dropout_prob"],
            attention_dropout=c["attention_probs_dropout_prob"],
            pad_token_id=c["pad_token_id"],
            roberta_style_positions=c["position_offset"] == "roberta")

    if cfg["kind"] == "multimodal":
        model = ModelConfig(
            subtask=Subtask.C, text=text(cfg["text_encoder"]),
            caption=text(cfg["caption_encoder"]),
            image=ImageEncoderConfig(
                arch=img["arch"], image_size=img["image_size"],
                feature_dim=img["feature_dim"],
                finetune_dim=img["finetune_dim"],
                finetune_dropout=img["finetune_dropout"]),
            pooling=PoolingType(head["pooling"]),
            fusion=FusionMethod(head["fusion"]), proj_dim=head["proj_dim"],
            dropout=head["dropout"], num_classes=head["num_classes"],
            max_text_len=head["max_text_len"],
            max_caption_len=head["max_caption_len"])
    else:
        model = ModelConfig(
            subtask=Subtask.B, text=None, caption=None,
            image=ImageEncoderConfig(arch=img["arch"],
                                     image_size=img["image_size"],
                                     feature_dim=img["feature_dim"],
                                     patch_size=img["patch_size"]),
            num_classes=head["num_classes"])
    data = DataConfig(batch_size=r["batch_size"],
                      eval_batch_size=r["batch_size"],
                      num_folds=r["num_folds"], fold_seed=r["fold_seed"],
                      seq_bucket_multiple=r["seq_bucket_multiple"],
                      pack_rows=r["pack_rows"],
                      device_resident=True)
    return TrainConfig(
        model=model, data=data,
        loss=LossType.FOCAL if head["loss"] == "focal"
        else LossType.CROSS_ENTROPY,
        focal_alpha=head.get("focal_alpha", 0.25),
        focal_gamma=head.get("focal_gamma", 2.0),
        learning_rate=r["learning_rate"],
        encoder_lr_scale=r["encoder_lr_scale"],
        warmup_fraction=r["warmup_fraction"], lr_schedule=r["lr_schedule"],
        grad_clip_norm=r["grad_clip_norm"], epochs=r["epochs"], seed=seed,
        eval_per_epoch=r["eval_per_epoch"],
        bf16=r["bf16"] and device.type == "cuda",
        run_id="portbench", adam_mu_dtype=r["adam_mu_dtype"],
        embedding_optimizer=r["embedding_optimizer"],
        scan_steps=r["scan_steps"])


@pytest.mark.parametrize("config", sorted(PINS))
def test_train_config_is_the_parents(config):
    """Train and predict cells alike: the data mode now comes from the
    traffic, true in both of their mixes, as the parent's recipe said."""
    cfg = spec.config(config)
    want = _parent_train_config(dict(cfg, recipe=dict(
        cfg["recipe"], device_resident=True)), SEED, CPU)
    for traffic in ("fold_training", "manifests"):
        resident = spec.traffic(traffic).get("device_resident", True)
        assert train_config(cfg, SEED, CPU, device_resident=resident) == want


@pytest.mark.parametrize("config", sorted(PINS))
def test_weights_memes_counts_and_logits_are_the_parents(config):
    pins, cfg, real = PINS[config], tiny_config(config), spec.config(config)
    kind = spec.kind(real["kind"])
    W = make_weights(cfg, SEED, CPU)
    assert _sha([(n, W[n].numpy()) for n in W]) == pins["weights"]
    traffic = dict(spec.traffic("fold_training"), **TRAFFIC)
    memes = make_memes(cfg, traffic, 10, SEED, 3, CPU)
    assert _sha([(k, memes[k]) for k in sorted(memes)]) == pins["memes"]
    counts = (kind.forward_flops(real, 3, TOKENS),
              attention.model_need(kind.attention_parts(real, 3, TOKENS),
                                   True),
              attention.model_need(kind.attention_parts(real, 3, TOKENS),
                                   False))
    assert counts == pins["counts"]
    bucket(train_config(cfg, 7, CPU), [memes])
    batch = {k: torch.from_numpy(v) for k, v in memes.items()}
    batch["image"] = nets.normalize(batch["image"])
    with torch.no_grad():
        got = kind.logits(W, cfg, batch, True).flatten()
    # float32 on this CPU: the pins were exact here; another CPU's kernels
    # may round a last bit differently.
    np.testing.assert_allclose(got.numpy(), pins["logits"], rtol=1e-5,
                               atol=1e-6)


def _kind_lookups_only(path: str) -> list:
    """Each ``<x>["kind"]`` of the file that is not the argument of a
    ``kind(...)`` call (``spec.kind``): a branch on a kind's name."""
    tree = ast.parse(open(path).read(), path)
    allowed = {id(a) for node in ast.walk(tree) if isinstance(node, ast.Call)
               and getattr(node.func, "attr", getattr(node.func, "id", None))
               == "kind" for a in node.args}
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Subscript)
            and isinstance(node.slice, ast.Constant)
            and node.slice.value == "kind" and id(node) not in allowed]


def test_no_file_outside_kinds_branches_on_a_kind():
    names = {f[:-3] for f in os.listdir(os.path.join(spec.PKG, "kinds"))
             if f.endswith(".py") and not f.startswith("_")}
    assert {"multimodal", "image", "text"} <= names
    for dirpath, dirs, files in os.walk(spec.PKG):
        dirs[:] = [d for d in dirs if d not in ("kinds", "__pycache__",
                                                ".cache")]
        for f in files:
            # This file keeps the parent's branching code, to compare.
            if not f.endswith(".py") or f == os.path.basename(__file__):
                continue
            path = os.path.join(dirpath, f)
            assert _kind_lookups_only(path) == [], path
            # The one name that is a kind and nothing else.
            assert '"multimodal"' not in open(path).read(), path
