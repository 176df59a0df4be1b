"""The port's 2A, 2B and simple 2C models against their flax counterparts at
tiny sizes, in f32 on the CPU: the six poolers, ``TextClassifier``,
``ImageClassifier`` (tiny ResNet and a narrow bottleneck ResNet with groups
and SE, with and without ``BinaryHead``), ``SimpleMultimodalClassifier``,
the bottleneck backbones, the cross-entropy, the config presets, and the
eval step of every kind.  Weights come from the flax modules' own init
(BatchNorm statistics drawn from a numpy seed) and cross over through
``from_jax_variables``; inputs come from a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpmc_tpu.models.classifier as j_classifier
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TextEncoderConfig as JTextConfig
from mpmc_tpu.config import model_config_to_dict as j_config_to_dict
from mpmc_tpu.models.pooling import Pooler as JPooler
from mpmc_tpu.models.resnet import ResNet as JResNet
from mpmc_tpu.models.vit import BinaryHead as JBinaryHead
from mpmc_tpu.ops.losses import softmax_cross_entropy as j_ce
from mpmc_tpu_torch.config import (ModelConfig, TextEncoderConfig,
                                   TrainConfig, model_config_from_dict,
                                   model_config_to_dict)
from mpmc_tpu_torch.models import classifier
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.models.pooling import Pooler
from mpmc_tpu_torch.models.resnet import ResNet
from mpmc_tpu_torch.models.vit import BinaryHead
from mpmc_tpu_torch.ops.losses import softmax_cross_entropy
from mpmc_tpu_torch.train.step import make_eval_step

POOL_TOL = 1e-5      # one pooling op over f32 hidden states
MODEL_TOL = 1e-4     # layers of matmuls, LayerNorms and convs (f32)
POOLINGS = ["cls", "nopooling", "max", "mean", "attention", "cnn"]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape)
                         if path[-1].key == "var"
                         else rng.normal(0.0, 0.5, x.shape)).astype(np.float32),
        _np_tree(stats))


def _port(module, variables, stats_seed=None):
    stats = None
    if "batch_stats" in variables:
        stats = _random_stats(variables["batch_stats"], stats_seed)
    module.load_state_dict(from_jax_variables(_np_tree(variables["params"]),
                                              stats), strict=True)
    return module.eval(), stats


def _apply(jm, variables, stats, *args):
    v = {"params": variables["params"]}
    if stats is not None:
        v["batch_stats"] = stats
    return np.asarray(jm.apply(v, *args))


def _ids_mask(rng, B, S, vocab):
    """Padded rows of 1 to S tokens; row 0 holds a single real token."""
    lens = rng.integers(1, S + 1, B)
    lens[0] = 1
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(5, vocab, (B, S)) * mask).astype(np.int32)
    return ids, mask


def _torch_cfg(jcfg) -> ModelConfig:
    return model_config_from_dict(j_config_to_dict(jcfg))


@pytest.mark.parametrize("pooling", POOLINGS)
def test_pooler_matches_flax(pooling):
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((4, 10, 16)).astype(np.float32)
    _, mask = _ids_mask(rng, 4, 10, 50)
    jm = JPooler(pooling, 16)
    variables = jm.init(jax.random.key(1), hidden, mask)
    tm, _ = _port(Pooler(pooling, 16),
                  {"params": variables.get("params", {})})
    want = _apply(jm, {"params": variables.get("params", {})}, None, hidden,
                  mask)
    with torch.no_grad():
        got = tm(torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=POOL_TOL, rtol=0)


@pytest.mark.parametrize("pooling", ["attention", "cnn"])
def test_text_classifier_matches_flax(pooling):
    """The cnn case also holds the bridge's 1-D conv kernel layout
    ``[k, in, out]``, which a q/k/v kernel's reshape would scramble."""
    jcfg = dataclasses.replace(JModelConfig.small_2a(),
                               text=JTextConfig.tiny(), pooling=pooling)
    rng = np.random.default_rng(2)
    ids, mask = _ids_mask(rng, 4, 24, jcfg.text.vocab_size)
    jm = j_classifier.TextClassifier(jcfg)
    variables = jm.init(jax.random.key(3), ids, mask)
    want = _apply(jm, variables, None, ids, mask)
    tm, _ = _port(classifier.TextClassifier(_torch_cfg(jcfg)), variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)


def _narrow_bottleneck(jax_side: bool, num_classes=0, name=None):
    """Bottleneck blocks with 4 groups of width 4 and SE, 16-wide stem."""
    kw = dict(depths=(1, 2), widths=(8, 16), block="bottleneck", groups=4,
              base_width=32, use_se=True, num_classes=num_classes,
              stem_width=16)
    if jax_side:
        return JResNet(**kw, name=name)
    return ResNet(**kw)


@pytest.mark.parametrize("binary_head", [False, True], ids=["linear", "binary"])
@pytest.mark.parametrize("arch", ["tiny_resnet", "narrow_bottleneck"])
def test_image_classifier_matches_flax(monkeypatch, arch, binary_head):
    jcfg = dataclasses.replace(
        JModelConfig(), num_classes=2,
        image=dataclasses.replace(JModelConfig.tiny_2c().image, arch=arch))
    if arch == "narrow_bottleneck":
        monkeypatch.setattr(
            j_classifier, "create_image_backbone",
            lambda cfg, name=None, num_classes=0: _narrow_bottleneck(
                True, num_classes, name))
        monkeypatch.setitem(
            classifier._BACKBONES, arch,
            lambda num_classes=0, in_channels=3: _narrow_bottleneck(
                False, num_classes))
    rng = np.random.default_rng(4)
    image = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    jm = j_classifier.ImageClassifier(jcfg, binary_head)
    variables = jm.init(jax.random.key(5), image)
    tm, stats = _port(build_model(_torch_cfg(jcfg), torch.device("cpu"),
                                  kind="image", binary_head=binary_head),
                      variables, stats_seed=6)
    want = _apply(jm, variables, stats, image)
    with torch.no_grad():
        got = tm(torch.from_numpy(image)).numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)


def test_bottleneck_backbone_and_binary_head_match_flax():
    """The narrow bottleneck ResNet with its ``classifier`` head, and the
    BinaryHead alone on features of several norms."""
    rng = np.random.default_rng(7)
    image = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = _narrow_bottleneck(True, num_classes=10)
    variables = jm.init(jax.random.key(8), image)
    tm, stats = _port(_narrow_bottleneck(False, num_classes=10), variables, 9)
    with torch.no_grad():
        got = tm(torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(got, _apply(jm, variables, stats, image),
                               atol=MODEL_TOL, rtol=0)
    # SE hidden width max(int(ch / 16), 8): 8 at 64 channels.
    assert tm.stage1_block0.se.fc1.weight.shape == (8, 64)
    feats = (rng.standard_normal((5, 12))
             * np.array([[1e-3], [0.1], [1.0], [10.0], [1e3]])
             ).astype(np.float32)
    jh = JBinaryHead(3)
    hv = jh.init(jax.random.key(10), feats)
    th, _ = _port(BinaryHead(12, 3), hv)
    with torch.no_grad():
        got = th(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, _apply(jh, hv, None, feats),
                               atol=POOL_TOL, rtol=0)


def _simple_cfg():
    """The simple 2C model at tiny width: the tiny text encoder and ResNet,
    two classes, no captions."""
    return dataclasses.replace(JModelConfig.tiny_2c(), caption=None,
                               num_classes=2)


def test_simple_multimodal_classifier_matches_flax():
    """Last-token pooling reads a pad position on the padded rows."""
    jcfg = _simple_cfg()
    rng = np.random.default_rng(11)
    ids, mask = _ids_mask(rng, 3, 16, jcfg.text.vocab_size)
    image = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    jm = j_classifier.SimpleMultimodalClassifier(jcfg)
    variables = jm.init(jax.random.key(12), ids, mask, image)
    assert variables["params"]["backbone"]["classifier"]["kernel"].shape == \
        (64, 1000)
    tm, stats = _port(build_model(_torch_cfg(jcfg), torch.device("cpu"),
                                  kind="simple"), variables, 13)
    want = _apply(jm, variables, stats, ids, mask, image)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                 torch.from_numpy(image)).numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=MODEL_TOL, rtol=0)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(14)
    logits = (rng.standard_normal((32, 2)) * 3).astype(np.float32)
    labels = rng.integers(0, 2, 32).astype(np.int32)
    for reduction in ("none", "mean", "sum"):
        want = j_ce(jnp.asarray(logits), jnp.asarray(labels),
                    reduction=reduction)
        got = softmax_cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("make", ["small_2a", "simple_2c", "captions_2b"])
def test_model_presets_match_jax(make):
    jcfg, cfg = getattr(JModelConfig, make)(), getattr(ModelConfig, make)()
    assert model_config_to_dict(cfg) == j_config_to_dict(jcfg)
    assert model_config_from_dict(j_config_to_dict(jcfg)) == cfg
    for enc in ("arabertv2", "qarib", "distilbert_multilingual"):
        assert (dataclasses.asdict(getattr(TextEncoderConfig, enc)())
                == dataclasses.asdict(getattr(JTextConfig, enc)()))


@pytest.mark.parametrize("kind", ["text", "image", "simple"])
def test_eval_step_on_training_copies_builds_the_models_own_skeleton(kind):
    """``cast_in_place=False`` evaluates on bf16 copies through an unpacked
    skeleton of the model's own kind (it used to be a MultimodalClassifier
    whatever the model, which fails for a TextClassifier), and gives the
    numbers of the same weights cast in place."""
    base = _torch_cfg(_simple_cfg())
    if kind == "text":
        base = _torch_cfg(dataclasses.replace(
            JModelConfig.small_2a(), text=JTextConfig.tiny()))
    model = build_model(base, torch.device("cpu"), seed=0, kind=kind)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(15)
    ids, mask = _ids_mask(rng, 4, 16, 100)
    batch = {"text_ids": ids, "text_mask": mask,
             "image": rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
             "label": np.array([0, 1, 1, 0], np.int32)}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    probs, loss = make_eval_step(model, TrainConfig(bf16=True),
                                 cast_in_place=False)(batch)
    assert probs.shape == loss.shape == (4,)
    assert torch.isfinite(probs).all() and (loss > 0).all()
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    served = build_model(base, torch.device("cpu"), kind=kind)
    served.load_state_dict(before)
    want, want_loss = make_eval_step(served, TrainConfig(bf16=True))(batch)
    torch.testing.assert_close(probs, want, atol=0, rtol=0)
    torch.testing.assert_close(loss, want_loss, atol=0, rtol=0)
