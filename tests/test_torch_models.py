"""Port models and host helpers (mpmc_tpu_torch) against their flax / JAX
counterparts at tiny sizes.  Weights come from the flax modules' own init
(BatchNorm statistics drawn from a numpy seed) and cross over through
``from_jax_variables``; inputs come from a numpy seed; both sides run in
f32."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli.experiments import bucket_seq_len as j_bucket_seq_len
from mpmc_tpu.cli.experiments import corpus_wordpiece_vocab as j_corpus_vocab
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TextEncoderConfig as JTextConfig
from mpmc_tpu.config import model_config_to_dict as j_config_to_dict
from mpmc_tpu.image.augment import eval_preprocess as j_eval_preprocess
from mpmc_tpu.image.decode import decode_batch as j_decode_batch
from mpmc_tpu.models.bert import TextEncoder as JTextEncoder
from mpmc_tpu.models.captioner import precompute_captions as j_captions
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.fusion import ConcatAttention3 as JConcat3
from mpmc_tpu.models.resnet import TinyResNet as JTinyResNet
from mpmc_tpu.models.resnet import resnet18 as j_resnet18
from mpmc_tpu.ops.losses import sigmoid_focal_loss as j_focal
from mpmc_tpu.text.normalize import preprocess_arabic_tweet as j_preprocess
from mpmc_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.metrics import optimal_threshold_youden as j_youden
from mpmc_tpu.train.metrics import roc_curve as j_roc
from mpmc_tpu_torch.cli.experiments import bucket_seq_len, corpus_wordpiece_vocab
from mpmc_tpu_torch.config import (ModelConfig, TextEncoderConfig,
                                   model_config_from_dict,
                                   model_config_to_dict)
from mpmc_tpu_torch.image.augment import eval_preprocess
from mpmc_tpu_torch.image.decode import decode_batch
from mpmc_tpu_torch.models.bert import TextEncoder
from mpmc_tpu_torch.models.captioner import precompute_captions
from mpmc_tpu_torch.models.classifier import MultimodalClassifier
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.models.fusion import ConcatAttention3
from mpmc_tpu_torch.models.resnet import TinyResNet, resnet18
from mpmc_tpu_torch.ops.losses import sigmoid_focal_loss
from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
from mpmc_tpu_torch.train.loop import batch_iter
from mpmc_tpu_torch.train.metrics import optimal_threshold_youden, roc_curve

# f32 on both sides; layers of matmuls, LayerNorms and convs summed in
# different orders by XLA and by PyTorch's CPU kernels.
TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _random_stats(stats, seed):
    """BatchNorm running statistics drawn from a numpy seed, so the eval
    BatchNorm formula is exercised away from (0, 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.uniform(0.5, 2.0, x.shape)
                         if path[-1].key == "var"
                         else rng.normal(0.0, 0.5, x.shape)).astype(np.float32),
        _np_tree(stats))


def _port(module, params, stats=None):
    module.load_state_dict(from_jax_variables(params, stats), strict=True)
    return module.eval()


def _ids_mask(rng, B, S, vocab, min_len=3):
    lens = rng.integers(min_len, S + 1, B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    ids = (rng.integers(5, vocab, (B, S)) * mask).astype(np.int32)
    return ids, mask


ROBERTA_TINY = dataclasses.replace(
    JTextConfig.tiny(), type_vocab_size=1, pad_token_id=1,
    roberta_style_positions=True, layer_norm_eps=1e-5)


@pytest.mark.parametrize("jcfg,packed", [
    (JTextConfig.tiny(), False), (ROBERTA_TINY, False),
    (ROBERTA_TINY, True)], ids=["bert", "roberta", "positions-segments"])
def test_text_encoder_matches_flax(jcfg, packed):
    rng = np.random.default_rng(0)
    ids, mask = _ids_mask(rng, 3, 24, jcfg.vocab_size)
    kw_j, kw_t = {}, {}
    if packed:
        # Two packed samples per row with restarting positions.
        seg = np.where(np.arange(24)[None] < 10, 1, 2) * mask
        pos = np.where(np.arange(24) < 10, np.arange(24),
                       np.arange(24) - 10)[None].repeat(3, 0) * mask
        kw_j = dict(segments=jnp.asarray(seg), positions=jnp.asarray(pos))
        kw_t = dict(segments=torch.from_numpy(seg),
                    positions=torch.from_numpy(pos))
    jm = JTextEncoder(jcfg)
    params = jm.init(jax.random.key(1), ids, mask)["params"]
    want_h, want_p = jm.apply({"params": params}, ids, mask,
                              return_pooled=True, **kw_j)
    tm = _port(TextEncoder(TextEncoderConfig(**dataclasses.asdict(jcfg))),
               _np_tree(params))
    with torch.no_grad():
        got_h, got_p = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                          return_pooled=True, **kw_t)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=TOL)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=TOL)


@pytest.mark.parametrize("arch", ["resnet18", "tiny_resnet"])
def test_resnet_matches_flax(arch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jm = j_resnet18() if arch == "resnet18" else JTinyResNet()
    variables = jm.init(jax.random.key(3), x)
    stats = _random_stats(variables["batch_stats"], 4)
    want = jm.apply({"params": variables["params"], "batch_stats": stats}, x)
    tm = _port(resnet18() if arch == "resnet18" else TinyResNet(),
               _np_tree(variables["params"]), stats)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_concat_attention3_matches_flax():
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((4, d)).astype(np.float32)
             for d in (16, 8, 16)]
    jm = JConcat3(40, 16)
    variables = jm.init(jax.random.key(6), *feats)
    stats = _random_stats(variables["batch_stats"], 7)
    want = jm.apply({"params": variables["params"], "batch_stats": stats},
                    *feats)
    tm = _port(ConcatAttention3(40, 16), _np_tree(variables["params"]), stats)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(f) for f in feats))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def _tiny_2c_inputs(seed):
    rng = np.random.default_rng(seed)
    t_ids, t_mask = _ids_mask(rng, 4, 32, 512)
    c_ids, c_mask = _ids_mask(rng, 4, 16, 512)
    image = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    return t_ids, t_mask, image, c_ids, c_mask


def test_multimodal_classifier_matches_flax_and_pins_bridge_keys():
    inputs = _tiny_2c_inputs(8)
    jm = JClassifier(JModelConfig.tiny_2c())
    variables = jm.init(jax.random.key(9), *inputs)
    stats = _random_stats(variables["batch_stats"], 10)
    want = jm.apply({"params": variables["params"], "batch_stats": stats},
                    *inputs)
    sd = from_jax_variables(_np_tree(variables["params"]), stats)
    # Flax auto-names the fusion module; the bridge renames it.
    assert "ConcatAttention3_0" in variables["params"]
    assert sd["fusion.gated.gate_fc.weight"].shape == (192, 192)
    cfg = model_config_from_dict(j_config_to_dict(JModelConfig.tiny_2c()))
    assert cfg == ModelConfig.tiny_2c()
    tm = MultimodalClassifier(cfg)
    assert set(tm.state_dict()) == set(sd)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm.eval()(*(torch.from_numpy(x) for x in inputs))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("make", ["default", "tiny_2c"])
def test_model_config_dict_matches_jax(make):
    """run_meta.json written by either package restores the same variant."""
    jcfg = getattr(JModelConfig, make)() if make != "default" else JModelConfig()
    cfg = getattr(ModelConfig, make)() if make != "default" else ModelConfig()
    assert model_config_to_dict(cfg) == j_config_to_dict(jcfg)
    assert model_config_from_dict(j_config_to_dict(jcfg)) == cfg


def test_sigmoid_focal_loss_matches_jax():
    rng = np.random.default_rng(11)
    logits = (rng.standard_normal(64) * 3).astype(np.float32)
    targets = (rng.random(64) > 0.7).astype(np.float32)
    for reduction in ("none", "mean"):
        want = j_focal(jnp.asarray(logits), jnp.asarray(targets),
                       reduction=reduction)
        got = sigmoid_focal_loss(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 reduction=reduction)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("crop,grayscale", [(None, False), (48, False),
                                            (None, True)])
def test_eval_preprocess_matches_jax(crop, grayscale):
    rng = np.random.default_rng(12)
    u8 = rng.integers(0, 256, (2, 64, 64, 1 if grayscale else 3),
                      dtype=np.uint8)
    want = j_eval_preprocess(jnp.asarray(u8), crop=crop, grayscale=grayscale)
    got = eval_preprocess(torch.from_numpy(u8), crop=crop,
                          grayscale=grayscale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


TEXTS = ["كلمة نص دعاية مهم جدا #وسم https://x.co/a", "نصّ عادي يومي 12 🙂",
         "إعلان لا ﻻ مهمّ", "english only words", ""]


def test_text_pipeline_matches_jax():
    assert ([preprocess_arabic_tweet(t) for t in TEXTS]
            == [j_preprocess(t) for t in TEXTS])
    vocab = corpus_wordpiece_vocab(TEXTS)
    assert vocab == j_corpus_vocab(TEXTS)
    ids, mask = WordPieceTokenizer(vocab).encode_batch(TEXTS, 12)
    j_ids, j_mask = JWordPiece(vocab).encode_batch(TEXTS, 12)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(mask, j_mask)
    assert bucket_seq_len([mask], 4, 12) == j_bucket_seq_len([mask], 4, 12)


def test_synthetic_images_and_captions_match_jax(tmp_path):
    paths = ["d/a.png", "d/b.jpg", "missing/c.png"]
    for gray in (False, True):
        np.testing.assert_array_equal(
            decode_batch(paths, 24, gray, root=str(tmp_path)),
            j_decode_batch(paths, 24, gray, root=str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        decode_batch(paths, 24, root=str(tmp_path), strict=True)
    u8 = np.zeros((3, 8, 8, 3), np.uint8)
    caps = precompute_captions(paths, cache_dir=str(tmp_path / "c"))
    assert caps == j_captions(paths, u8, cache_dir=str(tmp_path / "j"))
    assert caps[0] == "a meme of " + hashlib.sha256(b"d/a.png").hexdigest()[:8]
    # The second call reads the JSON cache.
    assert precompute_captions(paths, cache_dir=str(tmp_path / "c")) == caps


def test_metrics_and_batching_match_jax():
    rng = np.random.default_rng(13)
    y = (rng.random(50) > 0.6).astype(int)
    s = np.round(rng.random(50), 2)
    for got, want in zip(roc_curve(y, s), j_roc(y, s)):
        np.testing.assert_array_equal(got, want)
    assert optimal_threshold_youden(y, s) == j_youden(y, s)
    data = {"a": np.arange(11), "b": np.arange(22).reshape(11, 2)}
    for (gb, gn), (jb, jn) in zip(batch_iter(data, 4),
                                  j_batch_iter(data, 4)):
        assert gn == jn
        for key in data:
            np.testing.assert_array_equal(gb[key], jb[key])


def test_bridge_carries_the_packed_classifier_tree():
    """The JAX package's PackedMultimodalClassifier has the plain model's
    parameter tree; the bridge loads it into the port's packed model."""
    from mpmc_tpu.models.classifier import PackedMultimodalClassifier as JP
    from mpmc_tpu.ops.packing import pack_sequences as j_pack
    from mpmc_tpu_torch.models.classifier import PackedMultimodalClassifier
    t_ids, t_mask, image, c_ids, c_mask = _tiny_2c_inputs(14)

    def packed(ids, mask):
        p = j_pack(ids, mask, ids.shape[1])
        return {k: jnp.asarray(v) for k, v in p.asdict().items()}

    jm = JP(JModelConfig.tiny_2c())
    variables = jm.init(jax.random.key(15), packed(t_ids, t_mask), image,
                        packed(c_ids, c_mask))
    plain = JClassifier(JModelConfig.tiny_2c()).init(
        jax.random.key(15), t_ids, t_mask, image, c_ids, c_mask)
    assert (jax.tree_util.tree_structure(_np_tree(variables))
            == jax.tree_util.tree_structure(_np_tree(plain)))
    stats = _random_stats(variables["batch_stats"], 16)
    tm = PackedMultimodalClassifier(ModelConfig.tiny_2c())
    tm.load_state_dict(from_jax_variables(_np_tree(variables["params"]),
                                          stats), strict=True)
    want = jm.apply({"params": variables["params"], "batch_stats": stats},
                    packed(t_ids, t_mask), image, packed(c_ids, c_mask))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in
          j_pack(t_ids, t_mask, 32).asdict().items()}
    cp = {k: torch.from_numpy(np.asarray(v)) for k, v in
          j_pack(c_ids, c_mask, 16).asdict().items()}
    with torch.no_grad():
        got = tm.eval()(tp, torch.from_numpy(image), cp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
