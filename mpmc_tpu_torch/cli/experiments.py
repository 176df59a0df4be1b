"""The port's experiment drivers (port of ``mpmc_tpu/cli/experiments.py``):
corpus vocabulary, tokenization and sequence-length bucketing shared by
the entry points, the optional corpus MLM stage (``_maybe_mlm_pretrain``)
and SimCLR image stage (``_maybe_simclr_pretrain``), and the training
entry points ``run_subtask_2a`` (text), ``run_subtask_2b`` (image) and
``run_subtask_2c`` (multimodal, or the simple baseline) over
``_run_folds`` on one device.  Packed (``pack_rows > 0``) 2A is fed from
the host by a ``PackedTrainPlan``; packed 2C keeps its images on the
device; unpacked (2B and the simple 2C always), every array stays on the
device and batches carry row indices."""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.config import (LossType, PoolingType, Subtask,
                                   TrainConfig, model_config_to_dict)
from mpmc_tpu_torch.cv.kfold import stratified_kfold
from mpmc_tpu_torch.image.augment import eval_preprocess
from mpmc_tpu_torch.image.decode import decode_batch
from mpmc_tpu_torch.io.manifest import Manifest, read_manifest
from mpmc_tpu_torch.models.captioner import precompute_captions
from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer

log = logging.getLogger(__name__)


def corpus_wordpiece_vocab(texts, max_words: int = 30000) -> Dict[str, int]:
    """Corpus-derived WordPiece vocab for runs without a pretrained vocab
    file: whole words by frequency, then ``##`` and bare character pieces."""
    words: Dict[str, int] = {}
    for t in texts:
        for w in t.split():
            words[w] = words.get(w, 0) + 1
    top = sorted(words, key=words.get, reverse=True)[:max_words]
    chars = sorted({c for w in top for c in w})
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + top
              + ["##" + c for c in chars] + chars)
    return {t: i for i, t in enumerate(dict.fromkeys(tokens))}


def build_tokenizer(texts, vocab_path: Optional[str],
                    corpus_vocab_mode: str = "words",
                    corpus_vocab_size: int = 30000) -> WordPieceTokenizer:
    """The vocab file when one exists, else a corpus vocab over ``texts``:
    ``corpus_vocab_mode`` "words" (:func:`corpus_wordpiece_vocab`, at most
    ``corpus_vocab_size`` words) or "subword" (BPE-learned pieces,
    ``corpus_vocab_size`` in all).  The JAX package fronts the same vocab
    with its C++ tokenizer when that is built; the token ids are the same
    either way."""
    if vocab_path and os.path.exists(vocab_path):
        return WordPieceTokenizer.from_file(vocab_path)
    if corpus_vocab_mode == "subword":
        from mpmc_tpu_torch.text.wordpiece_learn import learn_wordpiece_vocab
        vocab = learn_wordpiece_vocab(texts, vocab_size=corpus_vocab_size)
    elif corpus_vocab_mode == "words":
        vocab = corpus_wordpiece_vocab(texts, max_words=corpus_vocab_size)
    else:
        raise ValueError(f"unknown corpus_vocab_mode: {corpus_vocab_mode!r} "
                         "(expected 'words' or 'subword')")
    return WordPieceTokenizer(vocab)


def prepare_text(manifest: Manifest, tok: WordPieceTokenizer, max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    texts = [preprocess_arabic_tweet(t) for t in manifest.texts]
    return tok.encode_batch(texts, max_len)


def bucket_seq_len(masks, multiple: int, cap: int) -> int:
    """Shortest padded length covering every real token across the given
    attention masks, rounded up to ``multiple``, capped at ``cap``.
    Trimming trailing all-PAD columns is exact for CLS pooling: padded keys
    are masked out and padded queries are never read."""
    longest = 0
    for m in masks:
        if m is not None and m.size:
            longest = max(longest, int(np.max(np.sum(m, axis=-1))))
    length = max(multiple, ((longest + multiple - 1) // multiple) * multiple)
    return min(cap, length)


def bucket_trim(data: Dict[str, np.ndarray], ids_key: str, mask_key: str,
                length: int) -> None:
    """In-place trim of one (ids, mask) pair to ``length`` columns."""
    data[ids_key] = np.ascontiguousarray(data[ids_key][:, :length])
    data[mask_key] = np.ascontiguousarray(data[mask_key][:, :length])


_UNMASKED_POOLINGS = (PoolingType.MAX, PoolingType.CNN, PoolingType.NOPOOLING)


def bucketing_enabled(cfg: TrainConfig) -> bool:
    """Bucketing is exact only for the masked poolings (cls, mean,
    attention): max, cnn and nopooling run over every position, padding
    included, so trimming would change their logits; they keep the fixed
    length."""
    if not cfg.data.seq_bucket_multiple:
        return False
    if cfg.model.pooling in _UNMASKED_POOLINGS:
        log.warning("sequence bucketing auto-disabled: %s pooling is "
                    "unmasked; running at the fixed max length",
                    cfg.model.pooling.value)
        return False
    return True


# ---------------------------------------------------------------------------
# Training drivers
# ---------------------------------------------------------------------------

def _select(data: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in data.items()}


def _persist_vocab(tok: WordPieceTokenizer, cfg: TrainConfig, out_dir: str,
                   filename: str = "vocab.txt") -> None:
    """Save the training vocab next to the outputs and the checkpoints, so
    ``predict`` restores the exact token ids."""
    for d in [out_dir] + ([cfg.checkpoint_dir] if cfg.checkpoint_dir else []):
        os.makedirs(d, exist_ok=True)
        tok.save(os.path.join(d, filename))


def _maybe_mlm_pretrain(cfg: TrainConfig, mcfg, tok, corpus_texts,
                        seq_len: int, out_dir: str, pretrained,
                        device: torch.device):
    """The corpus MLM stage (``cfg.mlm_epochs`` > 0) on ``device``: its
    encoder npz becomes the spec's text checkpoint, unless the spec already
    has one."""
    from mpmc_tpu_torch.models.pretrained import PretrainedSpec
    from mpmc_tpu_torch.train.pretrain import MLMConfig, pretrain_and_save
    if cfg.mlm_epochs <= 0 or (pretrained is not None and pretrained.text):
        return pretrained
    os.makedirs(out_dir, exist_ok=True)
    mlm_path = os.path.join(out_dir, "mlm_encoder.npz")
    pretrain_and_save(mcfg.text, list(corpus_texts), tok, mlm_path,
                      MLMConfig(epochs=cfg.mlm_epochs, seed=cfg.seed,
                                pack=cfg.mlm_pack),
                      max_len=seq_len, device=device)
    return (dataclasses.replace(pretrained, text=mlm_path)
            if pretrained else PretrainedSpec(text=mlm_path))


def _maybe_simclr_pretrain(cfg: TrainConfig, mcfg, images_u8: np.ndarray,
                           out_dir: str, pretrained, device: torch.device):
    """The SimCLR stage (``cfg.simclr_epochs`` > 0) over the train images on
    ``device``, batch ``min(4 * batch_size, N)``: its backbone npz becomes
    the spec's image checkpoint, unless the spec already has one."""
    from mpmc_tpu_torch.models.pretrained import PretrainedSpec
    from mpmc_tpu_torch.train.pretrain_image import (SimCLRConfig,
                                                     pretrain_and_save_image)
    if cfg.simclr_epochs <= 0 or (pretrained is not None and pretrained.image):
        return pretrained
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "simclr_backbone.npz")
    pretrain_and_save_image(
        mcfg.image, images_u8, path,
        SimCLRConfig(epochs=cfg.simclr_epochs, seed=cfg.seed,
                     batch_size=min(cfg.data.batch_size * 4,
                                    len(images_u8))),
        device=device)
    return (dataclasses.replace(pretrained, image=path)
            if pretrained else PretrainedSpec(image=path))


def _persist_run_meta(cfg: TrainConfig, mcfg, kind: str, out_dir: str,
                      data: Dict[str, np.ndarray], *, augment: bool,
                      grayscale: bool = False,
                      eval_transform_only: bool = False,
                      binary_head: bool = False) -> None:
    """``run_meta.json`` next to the outputs and checkpoints: the model kind
    (``text``, ``image``, ``simple`` or ``multimodal``), the resolved model
    config, the preprocessing mode and the training bucket lengths, which
    ``predict --checkpoint`` reads to rebuild the trained variant."""
    meta = {
        "kind": kind,
        "subtask": mcfg.subtask.value,
        "model": model_config_to_dict(mcfg),
        "augment": augment,
        "grayscale": grayscale,
        "eval_transform_only": eval_transform_only,
        "binary_head": binary_head,
        "text_len": (int(data["text_ids"].shape[1])
                     if "text_ids" in data else None),
        "caption_len": (int(data["caption_ids"].shape[1])
                        if "caption_ids" in data else None),
        "pipeline_stages": 1,
    }
    for d in [out_dir] + ([cfg.checkpoint_dir] if cfg.checkpoint_dir else []):
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "run_meta.json"), "w") as f:
            json.dump(meta, f, indent=1)


@dataclasses.dataclass
class FoldRun:
    """What one fold trains with: the model (packed form when packing), the
    packing plan (None unpacked), the train and eval steps."""

    model: torch.nn.Module
    plan: object
    train_step: Callable
    eval_step: Callable
    steps_per_epoch: int


def build_fold(cfg: TrainConfig, train_d: Dict[str, np.ndarray],
               tr_idx: np.ndarray, store: Dict[str, torch.Tensor],
               device: torch.device, fold: int,
               augment: Optional[Callable] = None, kind: str = "multimodal",
               pretrained=None, grayscale: bool = False,
               binary_head: bool = False) -> FoldRun:
    """Model of ``kind`` (the image model with ``binary_head``), plan and
    steps of fold ``fold`` over its train rows ``tr_idx`` of the resident
    ``store``: random weights from ``cfg.seed`` (the same for every fold,
    as the JAX package initializes) with the ``pretrained`` text encoder
    spliced in, dropout and augmentation from a generator seeded with
    ``cfg.seed + fold``, and eval normalizing with the grayscale statistics
    under ``grayscale``.
    Packing gives 2A a ``PackedTrainPlan`` of ``pack_rows`` rows a step
    over the host arrays, and 2C a ``PackedMultimodalPlan`` that indexes
    the resident images."""
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.models.pretrained import apply_pretrained
    from mpmc_tpu_torch.train.packed import (PackedMultimodalPlan,
                                             PackedTrainPlan)
    from mpmc_tpu_torch.train.step import build_train_step, make_eval_step

    bs = cfg.data.batch_size
    packing = cfg.data.pack_rows > 0
    plan = None
    if packing and kind == "text":
        plan = PackedTrainPlan(train_d, pack_len=train_d["text_ids"].shape[1],
                               rows_per_batch=cfg.data.pack_rows)
    elif packing:
        plan = PackedMultimodalPlan(train_d, batch_size=bs, abs_idx=tr_idx,
                                    resident_images=True)
    steps_per_epoch = (plan.steps_per_epoch if plan is not None
                       else (len(tr_idx) + bs - 1) // bs)
    model = apply_pretrained(build_model(cfg.model, device, seed=cfg.seed,
                                         kind=kind, packed=packing,
                                         binary_head=binary_head),
                             kind, pretrained)
    generator = torch.Generator(device=device).manual_seed(cfg.seed + fold)
    train_step = build_train_step(model, cfg, steps_per_epoch * cfg.epochs,
                                  store, generator, augment)
    eval_step = make_eval_step(model, cfg, grayscale=grayscale,
                               cast_in_place=False)
    return FoldRun(model, plan, train_step, eval_step, steps_per_epoch)


def resident_store(cfg: TrainConfig, full_data: Dict[str, np.ndarray],
                   device: torch.device) -> Dict[str, torch.Tensor]:
    """The arrays that stay on the device for the whole run: the images,
    and unpacked every array (batches then carry only row indices).  Packed
    2A has no image, so its store is empty and the plan feeds it."""
    packing = cfg.data.pack_rows > 0
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in full_data.items() if k == "image" or not packing}


def _run_folds(cfg: TrainConfig, full_data: Dict[str, np.ndarray],
               ids: List[str], test_data: Optional[Dict[str, np.ndarray]],
               test_ids: Optional[List[str]], out_dir: str, name: str,
               device: torch.device, folds: Optional[List[int]] = None,
               augment: Optional[Callable] = None, kind: str = "multimodal",
               pretrained=None, grayscale: bool = False,
               binary_head: bool = False,
               soft_targets: Optional[np.ndarray] = None) -> List:
    """Train the selected stratified folds of the ``kind`` model one after
    another on ``device`` (:func:`build_fold`).  Without a test split the
    fold's val split is the test split too, evaluated twice per check as in
    the JAX package.  Each fold writes its TSVs under ``out_dir`` (the val
    TSV under ``cfg.emit_val_tsv``) and, with ``cfg.checkpoint_dir``, its
    best-test-F1 weights as ``<checkpoint_dir>/fold_<k>/model.pt`` (what
    ``predict --checkpoint`` reads) and, through a ``Checkpointer`` over
    the same directory, the whole training state at each new best; with
    ``cfg.resume`` the fold first restores its newest checkpoint.  Its
    per-step losses and evals go to
    ``<out_dir>/<name>_train_metrics_fold_<k>.json``.

    ``soft_targets`` ``[F, N]`` (``train/distill.py``): fold k trains on
    ``soft_targets[k]`` of its train rows, beside their labels."""
    from mpmc_tpu_torch.train.checkpoint import Checkpointer
    from mpmc_tpu_torch.train.loop import fit

    os.makedirs(out_dir, exist_ok=True)
    splits = stratified_kfold(full_data["label"], cfg.data.num_folds,
                              cfg.data.fold_seed)
    store = resident_store(cfg, full_data, device)
    results = []
    for k, (tr_idx, va_idx) in enumerate(splits):
        if folds is not None and k not in folds:
            continue
        log.info("=== fold %d/%d ===", k, cfg.data.num_folds)
        train_d = _select(full_data, tr_idx)
        val_d = _select(full_data, va_idx)
        fold_store = store
        if soft_targets is not None:
            soft = soft_targets[k].astype(np.float32)
            train_d["soft"] = soft[tr_idx]
            if "label" in store:        # unpacked: batches index the store
                fold_store = dict(store, soft=torch.from_numpy(soft).to(device))
        t_data = test_data if test_data is not None else val_d
        t_ids = test_ids if test_ids is not None else [ids[i] for i in va_idx]
        run = build_fold(cfg, train_d, tr_idx, fold_store, device, k, augment,
                         kind, pretrained, grayscale, binary_head)
        on_best, checkpointer = None, None
        if cfg.checkpoint_dir:
            fold_dir = os.path.join(cfg.checkpoint_dir, f"fold_{k}")
            checkpointer = Checkpointer(fold_dir)
            if cfg.resume:
                checkpointer.restore_latest(run.train_step)

            def on_best(step, fold_dir=fold_dir, model=run.model):
                torch.save(model.state_dict(),
                           os.path.join(fold_dir, "model.pt"))
                log.info("best weights at step %d -> %s", step, fold_dir)
        prefix = os.path.join(out_dir, f"{name}_{cfg.team_name}")
        res = fit(run.train_step, run.eval_step, cfg, train_d, device,
                  test_data=t_data, val_data=val_d, test_ids=t_ids,
                  val_ids=[ids[i] for i in va_idx], fold=k,
                  tsv_prefix=prefix, packed_plan=run.plan, train_rows=tr_idx,
                  on_best=on_best, checkpointer=checkpointer)
        if checkpointer is not None:
            checkpointer.wait()
        with open(os.path.join(out_dir, f"{name}_train_metrics_fold_{k}.json"),
                  "w") as f:
            json.dump({"fold": k, "n_train": len(tr_idx),
                       "n_val": len(va_idx), "n_test": len(t_ids),
                       "steps_per_epoch": run.steps_per_epoch,
                       "row_budgets": (list(run.plan.row_budgets)
                                       if run.plan else None),
                       "steps": res.steps, "evals": res.history}, f,
                      indent=1)
        results.append(res)
        log.info("fold %d best test macro-F1: %.4f", k, res.best_macro_f1)
    return results


@dataclasses.dataclass
class Prepared2A:
    """The 2A run's resolved config (attention pooling, 2 classes, CE, the
    2A TSV rules, the vocab size), the tokenized and bucketed fold data,
    its ids, the tokenizer, the normalized texts (the MLM corpus) and the
    raw texts (the distillation teacher's)."""

    cfg: TrainConfig
    data: Dict[str, np.ndarray]
    ids: List[str]
    tok: WordPieceTokenizer
    corpus: List[str]
    raw_texts: List[str]


def prepare_2a(cfg: TrainConfig, out_dir: str,
               vocab_path: Optional[str] = None) -> Prepared2A:
    """Manifests (train+dev under ``fold_over_train_plus_dev``), the vocab
    (``vocab_path``, else a corpus vocab over the normalized texts, saved
    under ``out_dir`` and the checkpoint dir), and the text bucketed to the
    shortest multiple of ``seq_bucket_multiple`` covering it."""
    train = read_manifest(cfg.data.train_manifest)
    dev = read_manifest(cfg.data.dev_manifest)
    combined = train.concat(dev) if cfg.data.fold_over_train_plus_dev else train
    texts = [preprocess_arabic_tweet(t) for t in combined.texts]
    tok = build_tokenizer(texts, vocab_path, cfg.data.corpus_vocab_mode,
                          cfg.data.corpus_vocab_size)
    _persist_vocab(tok, cfg, out_dir)
    mcfg = dataclasses.replace(
        cfg.model, subtask=Subtask.A, num_classes=2,
        pooling=PoolingType.ATTENTION,
        text=dataclasses.replace(cfg.model.text,
                                 vocab_size=max(tok.vocab.values()) + 1))
    cfg = dataclasses.replace(cfg, model=mcfg, loss=LossType.CROSS_ENTROPY,
                              emit_threshold=0.5, emit_val_tsv=True,
                              prob_header="propaganda_probability")
    ids_arr, mask_arr = prepare_text(combined, tok, mcfg.max_text_len)
    data = {"text_ids": ids_arr, "text_mask": mask_arr,
            "label": combined.labels}
    if bucketing_enabled(cfg):
        seq_len = bucket_seq_len([mask_arr], cfg.data.seq_bucket_multiple,
                                 mcfg.max_text_len)
        bucket_trim(data, "text_ids", "text_mask", seq_len)
        log.info("text bucketed to %d tokens (cap %d)", seq_len,
                 mcfg.max_text_len)
    return Prepared2A(cfg, data, combined.ids, tok, texts,
                      list(combined.texts))


def distill_soft_targets(cfg: TrainConfig, raw_texts: List[str],
                         labels: np.ndarray) -> Optional[np.ndarray]:
    """The teacher's soft targets over the run's folds when
    ``cfg.distill_lambda`` > 0 (``train/distill.ngram_soft_targets`` on the
    raw texts, the fold seed and the cache dir), else None."""
    if cfg.distill_lambda <= 0:
        return None
    from mpmc_tpu_torch.train.distill import ngram_soft_targets
    return ngram_soft_targets(
        raw_texts, labels,
        stratified_kfold(labels, cfg.data.num_folds, cfg.data.fold_seed),
        seed=cfg.data.fold_seed, cache_dir=cfg.data.cache_dir)


def run_subtask_2a(cfg: TrainConfig, device: torch.device,
                   out_dir: str = "outputs/2a",
                   vocab_path: Optional[str] = None,
                   folds: Optional[List[int]] = None,
                   pretrained=None) -> List:
    """The 2A text model: stratified folds over train+dev, cross-entropy,
    attention pooling, 2 classes, the val split as the test split, labels
    at 0.5, the val TSVs and the ``propaganda_probability`` header; the
    corpus MLM stage first when ``cfg.mlm_epochs`` > 0; with
    ``cfg.distill_lambda`` > 0 each fold mixes in the teacher's soft
    targets over the same folds."""
    prep = prepare_2a(cfg, out_dir, vocab_path)
    pretrained = _maybe_mlm_pretrain(
        prep.cfg, prep.cfg.model, prep.tok, prep.corpus,
        prep.data["text_ids"].shape[1], out_dir, pretrained, device)
    soft = distill_soft_targets(prep.cfg, prep.raw_texts, prep.data["label"])
    _persist_run_meta(prep.cfg, prep.cfg.model, "text", out_dir, prep.data,
                      augment=False)
    return _run_folds(prep.cfg, prep.data, prep.ids, None, None, out_dir,
                      "task2A", device, folds, kind="text",
                      pretrained=pretrained, soft_targets=soft)


def grayscale_eval_transform(images_u8: torch.Tensor,
                             generator: torch.Generator) -> torch.Tensor:
    """The grayscale 2B variant's training transform: the deterministic
    eval normalization with grayscale statistics, no random draw."""
    return eval_preprocess(images_u8, grayscale=True)


@dataclasses.dataclass
class Prepared2B:
    """The 2B run's resolved config (2 classes, cross-entropy), the decoded
    train and dev images with their labels, and their ids."""

    cfg: TrainConfig
    data: Dict[str, np.ndarray]
    test: Dict[str, np.ndarray]
    train_ids: List[str]
    dev_ids: List[str]


def prepare_2b(cfg: TrainConfig) -> Prepared2B:
    """Manifests and their images decoded at ``image.image_size`` (one
    channel for the grayscale variant); 2 classes, cross-entropy, and no
    packing (an image batch has no tokens to pack)."""
    train = read_manifest(cfg.data.train_manifest)
    dev = read_manifest(cfg.data.dev_manifest)
    mcfg = dataclasses.replace(cfg.model, subtask=Subtask.B, num_classes=2)
    cfg = dataclasses.replace(cfg, model=mcfg, loss=LossType.CROSS_ENTROPY,
                              data=dataclasses.replace(cfg.data, pack_rows=0))
    size, gray = mcfg.image.image_size, mcfg.image.grayscale
    data = {"image": decode_batch(train.img_paths, size, gray,
                                  cfg.data.image_root),
            "label": train.labels}
    test = {"image": decode_batch(dev.img_paths, size, gray,
                                  cfg.data.image_root),
            "label": dev.labels}
    return Prepared2B(cfg, data, test, train.ids, dev.ids)


def run_subtask_2b(cfg: TrainConfig, device: torch.device,
                   out_dir: str = "outputs/2b", binary_head: bool = False,
                   folds: Optional[List[int]] = None,
                   pretrained=None) -> List:
    """The 2B image model (``cfg.model.image``'s backbone, a Linear head or
    ``binary_head``): stratified folds over the train manifest, the dev
    manifest as the test split, cross-entropy over 2 classes, never packed.
    Color images train through ``train_augment`` (the image kernel once a
    step); the grayscale variant trains on the deterministic eval
    transform with grayscale statistics, as the JAX package does.  The
    SimCLR stage runs first over the train images when
    ``cfg.simclr_epochs`` > 0 (color only).  A ``pretrained`` text
    checkpoint is refused: the model has no text encoder."""
    prep = prepare_2b(cfg)
    gray = prep.cfg.model.image.grayscale
    pretrained = _maybe_simclr_pretrain(prep.cfg, prep.cfg.model,
                                        prep.data["image"], out_dir,
                                        pretrained, device)
    _persist_run_meta(prep.cfg, prep.cfg.model, "image", out_dir, prep.data,
                      augment=True, grayscale=gray, eval_transform_only=gray,
                      binary_head=binary_head)
    return _run_folds(prep.cfg, prep.data, prep.train_ids, prep.test,
                      prep.dev_ids, out_dir, "task2B", device, folds,
                      augment=grayscale_eval_transform if gray else None,
                      kind="image", pretrained=pretrained, grayscale=gray,
                      binary_head=binary_head)


def eval_transform(images_u8: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """The simple 2C baseline's training transform: the deterministic eval
    normalization, no random draw (no image kernel)."""
    return eval_preprocess(images_u8)


@dataclasses.dataclass
class Prepared2C:
    """The 2C run's resolved config (vocab sizes filled in), tokenized and
    bucketed train and dev arrays, their ids, the text tokenizer, the
    normalized train+dev texts (the MLM corpus) and the raw train texts
    (the distillation teacher's)."""

    cfg: TrainConfig
    data: Dict[str, np.ndarray]
    test: Dict[str, np.ndarray]
    train_ids: List[str]
    dev_ids: List[str]
    tok: WordPieceTokenizer
    corpus: List[str]
    raw_texts: List[str]


def prepare_2c(cfg: TrainConfig, out_dir: str,
               vocab_path: Optional[str] = None,
               simple: bool = False,
               caption_vocab_path: Optional[str] = None,
               caption_generate_fn: Optional[Callable] = None,
               scratch_captioner: bool = False,
               device: Optional[torch.device] = None) -> Prepared2C:
    """Manifests, vocabularies (text: ``vocab_path``, else a corpus vocab
    over the train texts; captions, when the model has a caption branch:
    ``caption_vocab_path``, else a corpus vocab over both splits' captions;
    both saved under ``out_dir`` and the checkpoint dir), decoded images,
    captions, and text and caption lengths bucketed jointly over both
    splits.  The captions come from ``caption_generate_fn``, else with
    ``scratch_captioner`` from the from-scratch captioner on ``device``
    (its vocab over the train texts, its weights from ``cfg.seed``), else
    they are the placeholders; they exist before the caption vocab is
    built.  ``simple``: the simple baseline's config (at least 2 classes,
    cross-entropy, no captions, never bucketed or packed: it pools the last
    position)."""
    train = read_manifest(cfg.data.train_manifest)
    dev = read_manifest(cfg.data.dev_manifest)
    tok = build_tokenizer([preprocess_arabic_tweet(t) for t in train.texts],
                          vocab_path, cfg.data.corpus_vocab_mode,
                          cfg.data.corpus_vocab_size)
    _persist_vocab(tok, cfg, out_dir)
    mcfg = dataclasses.replace(
        cfg.model, subtask=Subtask.C,
        num_classes=max(cfg.model.num_classes, 2) if simple else 1,
        caption=None if simple else cfg.model.caption,
        text=dataclasses.replace(cfg.model.text,
                                 vocab_size=max(tok.vocab.values()) + 1))
    size = mcfg.image.image_size
    imgs = {"train": decode_batch(train.img_paths, size, False,
                                  cfg.data.image_root),
            "dev": decode_batch(dev.img_paths, size, False,
                                cfg.data.image_root)}
    cap_tok, caps = None, {}
    if (scratch_captioner and caption_generate_fn is None
            and mcfg.caption is not None):
        from mpmc_tpu_torch.models.captioner import make_scratch_caption_fn
        caption_generate_fn, _ = make_scratch_caption_fn(
            [preprocess_arabic_tweet(t) for t in train.texts],
            image_size=size, seed=cfg.seed, device=device)
    if mcfg.caption is not None:
        caps = {key: precompute_captions(
                    split.img_paths, imgs[key], cache_dir=cfg.data.cache_dir,
                    generate_fn=caption_generate_fn)
                for key, split in (("train", train), ("dev", dev))}
        cap_tok = build_tokenizer(caps["train"] + caps["dev"],
                                  caption_vocab_path)
        _persist_vocab(cap_tok, cfg, out_dir, "caption_vocab.txt")
        mcfg = dataclasses.replace(mcfg, caption=dataclasses.replace(
            mcfg.caption, vocab_size=max(cap_tok.vocab.values()) + 1))
    data_cfg = cfg.data
    if simple and data_cfg.pack_rows > 0:
        log.warning("--pack-rows %d ignored: the simple model trains "
                    "unpacked", data_cfg.pack_rows)
        data_cfg = dataclasses.replace(data_cfg, pack_rows=0)
    cfg = dataclasses.replace(
        cfg, model=mcfg, data=data_cfg,
        loss=LossType.CROSS_ENTROPY if simple else LossType.FOCAL)

    def prep(split: Manifest, key: str) -> Dict[str, np.ndarray]:
        ids_arr, mask_arr = prepare_text(split, tok, mcfg.max_text_len)
        d = {"text_ids": ids_arr, "text_mask": mask_arr, "image": imgs[key]}
        if cap_tok is not None:
            d["caption_ids"], d["caption_mask"] = cap_tok.encode_batch(
                caps[key], mcfg.max_caption_len)
        if split.labels is not None:
            d["label"] = split.labels
        return d

    data = prep(train, "train")
    test = prep(dev, "dev")
    if bucketing_enabled(cfg) and not simple:
        mult = cfg.data.seq_bucket_multiple
        pairs = [("text_ids", "text_mask", mcfg.max_text_len)]
        if cap_tok is not None:
            pairs.append(("caption_ids", "caption_mask",
                          mcfg.max_caption_len))
        for ids_key, mask_key, cap in pairs:
            length = bucket_seq_len([data[mask_key], test[mask_key]], mult,
                                    cap)
            for d in (data, test):
                bucket_trim(d, ids_key, mask_key, length)
            log.info("%s bucketed to %d tokens (cap %d)", ids_key, length,
                     cap)
    corpus = [preprocess_arabic_tweet(t) for t in train.texts + dev.texts]
    return Prepared2C(cfg, data, test, train.ids, dev.ids, tok, corpus,
                      list(train.texts))


def run_subtask_2c(cfg: TrainConfig, device: torch.device,
                   out_dir: str = "outputs/2c",
                   vocab_path: Optional[str] = None,
                   caption_vocab_path: Optional[str] = None,
                   folds: Optional[List[int]] = None,
                   augment: Optional[Callable] = None,
                   pretrained=None, caption_generate_fn=None,
                   simple: bool = False,
                   scratch_captioner: bool = False) -> List:
    """The 2C fine-tune: stratified folds over the train manifest, the dev
    manifest as the test split, focal loss, captions (when the model has a
    caption branch) from ``caption_generate_fn``, else from the
    from-scratch captioner on ``device`` under ``scratch_captioner``, else
    the placeholders, the text and caption vocabs from ``vocab_path`` and
    ``caption_vocab_path`` when given; the corpus MLM stage of the text
    branch first when
    ``cfg.mlm_epochs`` > 0, then the SimCLR stage of the image backbone
    when ``cfg.simclr_epochs`` > 0.  ``simple``: the organizers' simple
    baseline instead (C28: ``SimpleMultimodalClassifier``, 2-class
    cross-entropy, no captions, unbucketed and unpacked, trained on the
    deterministic eval transform), which takes no SimCLR stage: its
    backbone keeps the 1000-logit head a headless backbone cannot fill,
    and no distillation.  Otherwise, with ``cfg.distill_lambda`` > 0, each
    fold mixes the teacher's soft targets (over the train-only folds) into
    the focal loss."""
    prep = prepare_2c(cfg, out_dir, vocab_path, simple, caption_vocab_path,
                      caption_generate_fn, scratch_captioner, device)
    pretrained = _maybe_mlm_pretrain(
        prep.cfg, prep.cfg.model, prep.tok, prep.corpus,
        prep.data["text_ids"].shape[1], out_dir, pretrained, device)
    if simple:
        _persist_run_meta(prep.cfg, prep.cfg.model, "simple", out_dir,
                          prep.data, augment=True, eval_transform_only=True)
        return _run_folds(prep.cfg, prep.data, prep.train_ids, prep.test,
                          prep.dev_ids, out_dir, "task2C", device, folds,
                          augment=augment or eval_transform, kind="simple",
                          pretrained=pretrained)
    pretrained = _maybe_simclr_pretrain(prep.cfg, prep.cfg.model,
                                        prep.data["image"], out_dir,
                                        pretrained, device)
    soft = distill_soft_targets(prep.cfg, prep.raw_texts, prep.data["label"])
    _persist_run_meta(prep.cfg, prep.cfg.model, "multimodal", out_dir,
                      prep.data, augment=True)
    return _run_folds(prep.cfg, prep.data, prep.train_ids, prep.test,
                      prep.dev_ids, out_dir, "task2C", device, folds,
                      augment=augment, pretrained=pretrained,
                      soft_targets=soft)
