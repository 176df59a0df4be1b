"""The port's ``Trainer`` wrapper (mpmc_tpu_torch/train/trainer.py) and the
``clip_style_2c`` preset: the JAX package's ``test_trainer_wrapper`` and
``test_clip_style_config`` ported, resume restoring the exact state, and a
``clip_style_2c`` ``MultimodalClassifier`` forward at full width (BERT-base
text encoder, ViT-B/32 image trunk) at a small image size against flax on
the same weights, in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import model_config_to_dict as j_config_to_dict
from mpmc_tpu.models import MultimodalClassifier as JClassifier
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TrainConfig,
                                   model_config_to_dict)
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.train.trainer import Trainer

CPU = torch.device("cpu")


def test_trainer_wrapper(tmp_path):
    """Port of the JAX package's test: a trivially learnable text task,
    ``train``, ``evaluate``, ``predict``, ``save_model``, and a second
    ``Trainer`` with ``resume`` whose ``evaluate`` equals the first's
    (the saved state is the trained one: its step follows training's)."""
    rng = np.random.default_rng(0)
    mcfg = dataclasses.replace(ModelConfig.tiny_2c(), num_classes=2,
                               pooling=PoolingType.ATTENTION)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=8), epochs=2,
                      learning_rate=1e-3, bf16=False,
                      loss=LossType.CROSS_ENTROPY,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    n = 48
    y = (rng.random(n) > 0.5).astype(np.int32)
    ids = rng.integers(5, mcfg.text.vocab_size, (n, 16)).astype(np.int32)
    ids[:, 0] = y * 3 + 1                       # learnable from first token
    data = {"text_ids": ids, "text_mask": np.ones_like(ids), "label": y}

    trainer = Trainer(build_model(mcfg, CPU, seed=0, kind="text"), cfg, data,
                      eval_data=data, device=CPU)
    result = trainer.train()
    assert len(result.steps) == 2 * 6
    ev = trainer.evaluate()
    assert ev.macro_f1 > 0.8
    probs = trainer.predict({k: v for k, v in data.items() if k != "label"})
    assert probs.shape == (n,)
    np.testing.assert_array_equal(probs, ev.probs)
    trainer.save_model(step=len(result.steps),
                       metrics={"test_f1": ev.macro_f1})

    cfg2 = dataclasses.replace(cfg, resume=True)
    trainer2 = Trainer(build_model(mcfg, CPU, seed=0, kind="text"), cfg2,
                       data, eval_data=data, device=CPU)
    ev2 = trainer2.evaluate()
    assert ev2.macro_f1 == pytest.approx(ev.macro_f1, abs=1e-6)
    np.testing.assert_allclose(ev2.probs, ev.probs, atol=1e-6, rtol=0)
    # Resumed at the end: nothing left to train.
    assert trainer2.train().steps == []


def test_trainer_needs_a_checkpoint_dir_to_save_and_asks_for_cuda():
    mcfg = dataclasses.replace(ModelConfig.tiny_2c(), num_classes=2)
    data = {"text_ids": np.ones((4, 8), np.int32),
            "text_mask": np.ones((4, 8), np.int32),
            "label": np.zeros(4, np.int32)}
    cfg = TrainConfig(model=mcfg, bf16=False, loss=LossType.CROSS_ENTROPY)
    trainer = Trainer(build_model(mcfg, CPU, seed=0, kind="text"), cfg,
                      data, device=CPU)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        trainer.save_model()
    with pytest.raises(ValueError, match="eval_data"):
        trainer.evaluate()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(build_model(mcfg, CPU, seed=0, kind="text"), cfg, data)


def test_clip_style_config():
    cfg = ModelConfig.clip_style_2c()
    assert cfg.caption is None
    assert cfg.image.arch == "vit_base_32"
    assert cfg.image.feature_dim == 768
    assert model_config_to_dict(cfg) == j_config_to_dict(
        JModelConfig.clip_style_2c())


def _small_clip(cls):
    """``clip_style_2c`` at its widths (BERT-base, ViT-B/32) with a small
    vocab and 64 pixels (4 patches and the class token)."""
    cfg = cls.clip_style_2c()
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, vocab_size=256),
        image=dataclasses.replace(cfg.image, image_size=64))


def test_clip_style_forward_matches_flax():
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 256, (2, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 10:] = 0
    img = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = JClassifier(_small_clip(JModelConfig))
    variables = jmodel.init(jax.random.key(0), jnp.asarray(ids),
                            jnp.asarray(mask), jnp.asarray(img))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: np.array(x, np.float32) + (
            0.1 * rng.standard_normal(x.shape).astype(np.float32)
            if p[-1].key in ("bias", "cls_token", "pos_embed") else 0),
        variables["params"])
    stats = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32) + rng.uniform(
            0.0, 0.5, x.shape).astype(np.float32), variables["batch_stats"])
    want = np.asarray(jmodel.apply({"params": params, "batch_stats": stats},
                                   jnp.asarray(ids), jnp.asarray(mask),
                                   jnp.asarray(img)))
    model = build_model(_small_clip(ModelConfig), CPU, kind="multimodal")
    model.load_state_dict(from_jax_variables(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(img), None, None).numpy()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
