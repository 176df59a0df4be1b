"""Frozen-encoder feature extraction (port of
``mpmc_tpu/baselines/extract_features.py``).

For every meme of a split: 768-d image features (ConvNeXt-Tiny at 224 on
the eval transform, the pooled ``final_norm`` output) and 768-d text
features (the BERT pooler over the Arabic-normalized text at 128 tokens),
in batches of 32, written as the JSON the feature-SVM baselines read:
``{"imgfeats": {id: [768 floats]}, "textfeats": {id: [768 floats]}}``.

Both encoders compute in IEEE f32, as the JAX package's flax modules do by
default: TF32 is off in cuBLAS and cuDNN while they run, and the text
encoder's attention runs the f32 forward kernel on the card (padding mode;
the zero rows that fill the last batch are fully masked and dropped).

Weights: ``--image-params`` is a torchvision or HF ConvNeXt-Tiny state
dict, ``--text-params`` an HF BERT checkpoint (directory or file) or the
flax-tree npz of corpus MLM pretraining, whose architecture comes from its
shapes and whose ``vocab.txt`` is then mandatory.  Without a checkpoint an
encoder keeps random weights from a seed.  Flax ``.msgpack`` files are a
JAX-side format and raise.  Without ``--text-vocab`` the vocabulary is the
JAX function's inline corpus vocab.  Images decode through
``image/decode.decode_batch``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.config import TextEncoderConfig
from mpmc_tpu_torch.io.manifest import read_manifest

log = logging.getLogger(__name__)

TEXT_LEN = 128
IMAGE_SIZE = 224
SEED = 0


def _refuse_msgpack(path: Optional[str]) -> None:
    if path and path.endswith(".msgpack"):
        raise ValueError(
            f"{path}: flax .msgpack serialization is a JAX-side format that "
            "this package does not read; pass the torch/HF checkpoint it "
            "was converted from, or a flax-tree .npz")


def resolve_text(texts, text_vocab_path: Optional[str],
                 text_params_path: Optional[str]):
    """``(tokenizer, TextEncoderConfig, MLM tree or None)`` as the JAX
    function resolves them: an MLM npz gives its own config and needs its
    vocab file, whose size must match; a vocab file alone gives BERT-base
    at its size; no vocab file gives the inline corpus vocab."""
    from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
    cfg = TextEncoderConfig.arabertv2()
    mlm_tree = None
    if text_params_path and text_params_path.endswith(".npz"):
        from mpmc_tpu_torch.models.pretrained import (
            FLAX_MARKER, infer_text_config_from_tree, load_state_dict,
            unflatten_params)
        sd = load_state_dict(text_params_path)
        if FLAX_MARKER in sd:
            mlm_tree = unflatten_params(sd)
            cfg = infer_text_config_from_tree(mlm_tree)
            if not text_vocab_path:
                raise ValueError(
                    "a corpus-MLM npz encoder needs its matching vocab file "
                    "(the vocab.txt saved next to it) via text_vocab_path: "
                    "the inline corpus vocab would assign other token ids")
    if text_vocab_path:
        tok = WordPieceTokenizer.from_file(text_vocab_path)
        vocab_size = max(tok.vocab.values()) + 1
        if mlm_tree is not None:
            if vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"vocab file has {vocab_size} ids but the MLM encoder "
                    f"was trained with {cfg.vocab_size}: wrong vocab.txt?")
        else:
            cfg = TextEncoderConfig(vocab_size=vocab_size)
    else:
        # The JAX function's own inline vocab, not corpus_wordpiece_vocab:
        # a word that is also a character stays twice (the later id wins)
        # and the size counts both, so the ids and the table size match.
        words: Dict[str, int] = {}
        for t in texts:
            for w in t.split():
                words[w] = words.get(w, 0) + 1
        top = sorted(words, key=words.get, reverse=True)[:30000]
        chars = sorted({c for w in top for c in w})
        vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + top
                 + ["##" + c for c in chars] + chars)
        tok = WordPieceTokenizer({t: i for i, t in enumerate(vocab)})
        cfg = TextEncoderConfig(vocab_size=len(vocab))
    return tok, cfg, mlm_tree


def image_encoder(image_params_path: Optional[str],
                  device: torch.device) -> torch.nn.Module:
    """ConvNeXt-Tiny in eval mode on ``device``: the converted checkpoint,
    else random weights from a seed."""
    from mpmc_tpu_torch.models.classifier import init_weights
    from mpmc_tpu_torch.models.convnext import ConvNeXt
    from mpmc_tpu_torch.models.pretrained import _load, _validate
    _refuse_msgpack(image_params_path)
    with torch.device(device):
        net = ConvNeXt()
    init_weights(net, torch.Generator(device=device).manual_seed(SEED))
    if image_params_path:
        from mpmc_tpu_torch.models.convert import to_jax_variables
        from mpmc_tpu_torch.models.pretrained import load_state_dict
        from mpmc_tpu_torch.models.vision_convert import \
            convert_convnext_state_dict
        tree = convert_convnext_state_dict(
            load_state_dict(image_params_path))["params"]
        _validate(to_jax_variables(net)[0], tree, "convnext_tiny")
        _load(net, tree, {})
    return net.eval()


def text_encoder(cfg: TextEncoderConfig, text_params_path: Optional[str],
                 mlm_tree: Optional[Dict], device: torch.device
                 ) -> torch.nn.Module:
    """The BERT encoder of ``cfg`` in eval mode on ``device``: the MLM tree
    or the converted HF checkpoint, else random weights from a seed."""
    from mpmc_tpu_torch.models.bert import TextEncoder
    from mpmc_tpu_torch.models.classifier import init_weights
    from mpmc_tpu_torch.models.convert import to_jax_params
    from mpmc_tpu_torch.models.pretrained import _load, _validate
    _refuse_msgpack(text_params_path)
    with torch.device(device):
        enc = TextEncoder(cfg)
    init_weights(enc, torch.Generator(device=device).manual_seed(SEED + 1))
    tree = mlm_tree
    if tree is None and text_params_path:
        from mpmc_tpu_torch.models.hf_convert import convert_bert_state_dict
        from mpmc_tpu_torch.models.pretrained import load_state_dict
        tree = convert_bert_state_dict(load_state_dict(text_params_path),
                                       cfg)
    if tree is not None:
        _validate(to_jax_params(enc), tree, "text encoder")
        _load(enc, tree, {})
    return enc.eval()


def _batches(arrays, batch_size: int):
    """``(padded batch arrays, n_real)`` of ``batch_size`` rows, the last
    batch padded with zero rows as the JAX function pads it."""
    n = len(arrays[0])
    for s in range(0, n, batch_size):
        chunk = [a[s:s + batch_size] for a in arrays]
        pad = batch_size - len(chunk[0])
        if pad:
            chunk = [np.concatenate([c, np.zeros((pad,) + c.shape[1:],
                                                 c.dtype)]) for c in chunk]
        yield chunk, batch_size - pad


@torch.inference_mode()
def encode_images(net: torch.nn.Module, images_u8: np.ndarray,
                  batch_size: int, device: torch.device) -> np.ndarray:
    """``[N, 768]`` f32 features of uint8 ``[N, 224, 224, 3]`` images."""
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32
    out = []
    with ieee_f32():
        for (u8,), n in _batches([images_u8], batch_size):
            x = eval_preprocess(torch.from_numpy(u8).to(device))
            out.append(net(x)[:n])
    return torch.cat(out).cpu().numpy()


@torch.inference_mode()
def encode_texts(enc: torch.nn.Module, ids: np.ndarray, mask: np.ndarray,
                 batch_size: int, device: torch.device) -> np.ndarray:
    """``[N, hidden]`` f32 pooler outputs of the token ids and masks."""
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32
    out = []
    with ieee_f32():
        for (i, m), n in _batches([ids, mask], batch_size):
            _, pooled = enc(torch.from_numpy(i).to(device),
                            torch.from_numpy(m).to(device),
                            return_pooled=True)
            out.append(pooled[:n])
    return torch.cat(out).cpu().numpy()


def prepare(data_dir: str, file_name: str, image_root: Optional[str],
            text_vocab_path: Optional[str], text_params_path: Optional[str]
            ) -> Tuple:
    """The manifest, its decoded uint8 images, token ids and mask, and the
    text config and MLM tree."""
    from mpmc_tpu_torch.image.decode import decode_batch
    from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
    manifest = read_manifest(os.path.join(data_dir, file_name))
    texts = [preprocess_arabic_tweet(t) for t in manifest.texts]
    tok, cfg, mlm_tree = resolve_text(texts, text_vocab_path,
                                      text_params_path)
    ids, mask = tok.encode_batch(texts, TEXT_LEN)
    images = decode_batch(manifest.img_paths, IMAGE_SIZE, False,
                          image_root or data_dir, num_threads=16)
    return manifest, images, ids, mask, cfg, mlm_tree


def extract_features(data_dir: str, file_name: str, out_file_name: str,
                     image_root: Optional[str] = None,
                     batch_size: int = 32,
                     text_vocab_path: Optional[str] = None,
                     text_params_path: Optional[str] = None,
                     image_params_path: Optional[str] = None,
                     features_dir: Optional[str] = None,
                     device="cuda") -> str:
    """Write ``<features_dir or data_dir/features>/<out_file_name>`` for
    the manifest ``data_dir/file_name`` and return its path."""
    device = torch.device(device)
    manifest, images, ids, mask, cfg, mlm_tree = prepare(
        data_dir, file_name, image_root, text_vocab_path, text_params_path)
    n = len(manifest)
    t0 = time.perf_counter()
    img_feats = encode_images(image_encoder(image_params_path, device),
                              images, batch_size, device)
    t1 = time.perf_counter()
    txt_feats = encode_texts(text_encoder(cfg, text_params_path, mlm_tree,
                                          device),
                             ids, mask, batch_size, device)
    t2 = time.perf_counter()
    log.info("extract-features: %d memes, images %.3f s, texts %.3f s on %s",
             n, t1 - t0, t2 - t1, device)
    out_dir = features_dir or os.path.join(data_dir, "features")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, out_file_name)
    with open(out_path, "w") as f:
        json.dump({
            "imgfeats": {i: v.tolist() for i, v in zip(manifest.ids,
                                                       img_feats)},
            "textfeats": {i: v.tolist() for i, v in zip(manifest.ids,
                                                        txt_feats)},
        }, f)
    return out_path
