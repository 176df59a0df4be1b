"""Command line of the PyTorch port.

  python -m mpmc_tpu_torch.cli.main predict --subtask 2a|2b|2c --manifest M \\
      --out pred.tsv [--probs-out probs.tsv] [--checkpoint DIR] \\
      [--small] [--tiny] [--simple] [--image-arch A] [--image-size N] \\
      [--binary-head] [--device cuda|cpu] [--batch-size 16]
  python -m mpmc_tpu_torch.cli.main train --subtask 2a|2b|2c -tr TRAIN \\
      -te DEV [--recipe fast|reference] [--small] [--tiny] [--simple] \\
      [--fold K] [--num-folds N] [--epochs N] [--lr X] \\
      [--lr-schedule constant|linear_warmup] [--pack-rows G] [--vocab V] \\
      [--corpus-vocab words|subword] [--corpus-vocab-size N] \\
      [--mlm-epochs N] [--mlm-pack] [--text-params T] [--caption-params C] \\
      [--simclr-epochs N] [--image-params I] [--distill-lambda X] \\
      [--image-arch A] [--image-size N] [--binary-head] \\
      [--pooling P] [--fusion concatenation|mca|cross_modal|self_attention] \\
      [--scratch-captioner] [--caption-vocab C] \\
      [--checkpoint-dir DIR [--resume]] [--out-dir DIR] [--device cuda|cpu]
  python -m mpmc_tpu_torch.cli.main check -p pred.tsv [more.tsv ...]
  python -m mpmc_tpu_torch.cli.main score -g gold.json -p pred.tsv
  python -m mpmc_tpu_torch.cli.main combine --files f0.tsv .. --gold G \\
      [--out ens.tsv] [--metric binary|macro|youden] [--average prob|logit] \\
      [--group-by-run-id] [--scan-family-weight] [--per-member]
  python -m mpmc_tpu_torch.cli.main analyze -g gold.json -p pred.tsv
  python -m mpmc_tpu_torch.cli.main baselines --subtask 2a|2b|2c -tr TRAIN \\
      -te DEV [-o OUT] [--ngram-analyzer word|char|char_wb] \\
      [--ngram-range MIN MAX] [--ngram-max-features N] [--ngram-probs] \\
      [--ngram-fold-probs K] [--ngram-cv K] [--skip-features] \\
      [--features-dir D] [--text-vocab V] [--text-params T] \\
      [--image-params I] [--device cuda|cpu]
  python -m mpmc_tpu_torch.cli.main extract-features -d DATA_DIR \\
      -f MANIFEST.json -o OUT.json [--features-dir D] [--text-vocab V] \\
      [--text-params T] [--image-params I] [--device cuda|cpu]
  python -m mpmc_tpu_torch.cli.main smoke [--device cuda|cpu]

``train`` follows the JAX package's ``_cmd_train`` for 2A, 2B and 2C.
2A trains the text model (attention pooling, 2 classes, cross-entropy, a
constant LR) over stratified folds of train+dev, each fold's val split
serving as its test split, with labels at 0.5, the val TSVs and the
``propaganda_probability`` header; 2B trains the image model (the
``--image-arch`` backbone at ``--image-size``, a Linear head or
``--binary-head``, 2 classes, cross-entropy, linear warmup, never packed)
and 2C the multimodal model (focal loss, linear warmup), both over folds
of the train manifest with the dev manifest as the test split.  Per fold
come the best-test-F1 TSVs and, with ``--checkpoint-dir``,
``fold_<k>/model.pt`` next to ``run_meta.json`` and the vocab files, which
``predict --checkpoint DIR/fold_<k>`` reads, and the whole training state
at each new best (``fold_<k>/<step>/state.pt``), from which ``--resume``
continues a run exactly where it stopped.
``--recipe fast`` (the default) packs the text tokens (2A: batches of
``--pack-rows 4`` packed rows; 2C: each batch's text and caption tokens in
rows, ``--pack-rows 8``), keeps the Adam first moment in bf16 and gives the
word embeddings factored RMS; ``--recipe reference`` turns all three off.
An explicitly passed flag wins over its recipe value.  ``--mlm-epochs``
first pretrains the text encoder on the train+dev texts with masked
language modelling (``--mlm-pack`` packs that corpus) and starts every
fold from it; ``--text-params`` starts from such an encoder file instead.
``--simclr-epochs`` likewise pretrains the image backbone contrastively
(SimCLR) on the train images before 2B or the 2C flagship, and
``--image-params`` starts from such a backbone file instead.  The three
``--*-params`` flags also take Hugging Face, torchvision and timm
checkpoints (``models/pretrained.py``): ``--text-params`` a BERT-family
checkpoint for the text encoder, ``--caption-params`` a RoBERTa-family one
for the 2C caption encoder, ``--image-params`` a state dict of the image
backbone's arch; pass the checkpoint's own ``vocab.txt`` through
``--vocab`` or ``--caption-vocab``.  Without a vocab file the corpus vocab
is whole words (``--corpus-vocab words``) or BPE-learned subword pieces
(``subword``), ``--corpus-vocab-size`` entries at most.
``--distill-lambda X`` (2A, and the 2C flagship) mixes the char-n-gram SVM
teacher's soft targets into the train loss, ``(1-X)·loss + X·CE(soft)``;
the teacher needs sklearn, or its ``distill_<key>.npz`` under
``--cache-dir``, and the TSVs' run id ends in ``_distill``.  For 2C,
``--small`` trains the small_2c model (no captions), ``--simple`` the
organizers' simple baseline (C28), ``--fusion`` picks the fusion family
and ``--pooling`` the pooling mode (the unmasked ones turn bucketing off);
``--scratch-captioner`` captions the images with the from-scratch
encoder-decoder instead of placeholder strings, and ``--caption-vocab``
tokenizes the captions with a vocab file instead of a corpus vocab.

``predict`` follows the JAX package's ``_cmd_predict`` for every model
kind: ``text`` (2A), ``image`` (2B), ``simple`` (2C ``--simple``, the
organizers' baseline) and ``multimodal`` (2C).  The trained variant and
bucket lengths come from the ``run_meta.json`` next to a checkpoint, whose
``vocab.txt`` (and for the multimodal kind ``caption_vocab.txt``) are then
required; without one the variant comes from the flags, and without a
checkpoint the model runs on random weights from a seeded generator and
corpus vocabularies.  A port checkpoint is the model's ``state_dict`` saved
as ``model.pt`` in the checkpoint directory.  The model runs on CUDA unless
``--device cpu`` is passed; the CUDA path computes in bf16, the CPU path in
f32.

``check``, ``score``, ``combine`` and ``analyze`` are the JAX package's
submission tools: the official format check, the official scorer, the fold
ensemble (its label TSV carries the run id ``ensemble``) and the error
report.

``baselines`` runs the organizers' classic baselines of a subtask and
scores each (majority, random, the n-gram SVM; for 2B and 2C the SVM over
frozen features, extracted first unless ``--skip-features``), and
``extract-features`` writes those features (ConvNeXt-Tiny and the BERT
pooler, f32); both follow the JAX package's commands, and the n-gram and
SVM rows need sklearn.  ``smoke`` trains the tiny 2C model on synthetic
memes for two epochs and exits 1 unless its best macro-F1 is above 0.6.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpmc_tpu_torch.cli.experiments import (build_tokenizer, bucket_seq_len,
                                            bucket_trim, prepare_text)
from mpmc_tpu_torch.config import (DataConfig, FusionMethod, ModelConfig,
                                   PoolingType, TextEncoderConfig,
                                   TrainConfig, model_config_from_dict)
from mpmc_tpu_torch.image.decode import decode_batch
from mpmc_tpu_torch.io.manifest import Manifest, read_manifest
from mpmc_tpu_torch.io.tsv import write_label_tsv, write_prob_tsv
from mpmc_tpu_torch.models.captioner import precompute_captions
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.train.loop import run_eval
from mpmc_tpu_torch.train.step import make_eval_step

log = logging.getLogger(__name__)

KIND_OF_SUBTASK = {"2a": "text", "2b": "image", "2c": "multimodal"}
IMAGE_ARCHS = ("resnet18, resnet50, resnext50_32x4d, seresnext50_32x4d, "
               "vit_base_16, vit_base_32, vit_large_16, convnext_tiny, "
               "efficientnet_b0..b4, tiny_resnet")


def resolve_device(name: str) -> torch.device:
    """The device to run on; raises when CUDA is asked for and absent."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass --device cpu to run on the CPU")
    return device


def _ckpt_dirs(checkpoint: Optional[str]) -> List[str]:
    if not checkpoint:
        return []
    return [checkpoint, os.path.dirname(checkpoint.rstrip("/"))]


@dataclasses.dataclass
class Variant:
    """The trained model variant ``predict`` rebuilds."""

    model_cfg: ModelConfig
    kind: str                      # text | image | simple | multimodal
    grayscale: bool
    binary_head: bool
    text_len: Optional[int]        # training bucket lengths, when known
    caption_len: Optional[int]


def resolve_variant(args, meta: Optional[dict]) -> Variant:
    """The variant from ``run_meta.json`` when there is one, else from the
    flags, as the JAX package's ``_cmd_predict`` resolves it: ``--small``
    (2A), ``--tiny``, ``--simple`` (2C), then 2A gets attention pooling and
    2 classes, 2B 2 classes, and ``--image-arch`` / ``--image-size`` swap
    the backbone or its resolution."""
    if meta is not None:
        return Variant(model_config_from_dict(meta["model"]), meta["kind"],
                       meta.get("grayscale", False),
                       meta.get("binary_head", False), meta.get("text_len"),
                       meta.get("caption_len"))
    if args.checkpoint:
        log.warning("no run_meta.json next to %s — rebuilding the model from "
                    "CLI flags; pass the same variant flags used at train "
                    "time", args.checkpoint)
    simple = args.simple and args.subtask == "2c"
    if args.small and args.subtask == "2a":
        cfg = ModelConfig.small_2a()
    elif args.tiny:
        cfg = ModelConfig.tiny_2c()
    elif simple:
        cfg = ModelConfig.simple_2c()
    else:
        cfg = ModelConfig()
    if args.subtask == "2a":
        cfg = dataclasses.replace(cfg, pooling=PoolingType.ATTENTION,
                                  num_classes=2)
    if args.subtask == "2b":
        cfg = dataclasses.replace(cfg, num_classes=2)
    if simple:
        # What ``run_subtask_2c(simple=True)`` trains from the preset; the
        # JAX package's predict skips this, so its --simple --tiny model has
        # one logit and a caption config that no trained checkpoint has.
        cfg = dataclasses.replace(cfg, num_classes=max(cfg.num_classes, 2),
                                  caption=None)
    if args.image_arch or args.image_size:
        if cfg.image is None:
            raise SystemExit("--image-arch / --image-size need a model with "
                             "an image branch")
        cfg = dataclasses.replace(cfg, image=dataclasses.replace(
            cfg.image, arch=args.image_arch or cfg.image.arch,
            image_size=args.image_size or cfg.image.image_size))
    kind = "simple" if simple else KIND_OF_SUBTASK[args.subtask]
    grayscale = cfg.image.grayscale if cfg.image else False
    return Variant(cfg, kind, grayscale, args.binary_head, None, None)


@dataclasses.dataclass
class PredictInputs:
    manifest: Manifest
    variant: Variant
    data: Dict[str, np.ndarray]   # host arrays, one row per meme


def prepare_inputs(args) -> PredictInputs:
    """Manifest, resolved model variant and the tokenized, bucketed,
    decoded host arrays of a ``predict`` invocation: text for every kind
    but ``image``, images for every kind but ``text``, captions for the
    ``multimodal`` kind only."""
    manifest = read_manifest(args.manifest, is_test=True)
    meta = None
    for d in _ckpt_dirs(args.checkpoint):
        cand = os.path.join(d, "run_meta.json")
        if os.path.exists(cand):
            with open(cand) as f:
                meta = json.load(f)
            break
    variant = resolve_variant(args, meta)
    model_cfg, kind = variant.model_cfg, variant.kind
    data_cfg = DataConfig()

    def required_vocab(flag_value, filename, what):
        """A restored checkpoint needs its training vocab: a vocab rebuilt
        from the inference manifest assigns different token ids."""
        if flag_value:
            return flag_value
        if not args.checkpoint:
            return None
        for d in _ckpt_dirs(args.checkpoint):
            cand = os.path.join(d, filename)
            if os.path.exists(cand):
                return cand
        raise SystemExit(
            f"predict with --checkpoint needs the training {what}vocab: "
            f"pass --{what.replace(' ', '-')}vocab or place {filename} in "
            f"the checkpoint dir")

    def fit_vocab(tok, enc_cfg: TextEncoderConfig, what) -> TextEncoderConfig:
        size = max(tok.vocab.values()) + 1
        if meta is not None:
            if size != enc_cfg.vocab_size:
                raise SystemExit(
                    f"{what} vocab has {size} entries but the checkpoint "
                    f"was trained with {enc_cfg.vocab_size} — wrong vocab "
                    f"file?")
            return enc_cfg
        return dataclasses.replace(enc_cfg, vocab_size=size)

    def bucket(masks_key, ids_key, trained_len, cap):
        """Trim to the training bucket length, else to this manifest's.
        The simple model pools the last position, so its result depends on
        this length exactly."""
        length = trained_len if trained_len is not None else bucket_seq_len(
            [data[masks_key]], data_cfg.seq_bucket_multiple, cap)
        if length < cap:
            bucket_trim(data, ids_key, masks_key, length)

    data: Dict[str, np.ndarray] = {}
    if model_cfg.text is not None and kind != "image":
        tok = build_tokenizer(manifest.texts,
                              required_vocab(args.vocab, "vocab.txt", ""))
        model_cfg = dataclasses.replace(
            model_cfg, text=fit_vocab(tok, model_cfg.text, "text"))
        data["text_ids"], data["text_mask"] = prepare_text(
            manifest, tok, model_cfg.max_text_len)
        bucket("text_mask", "text_ids", variant.text_len,
               model_cfg.max_text_len)
    if kind != "text":
        data["image"] = decode_batch(manifest.img_paths,
                                     model_cfg.image.image_size,
                                     variant.grayscale, args.image_root)
    if kind == "multimodal" and model_cfg.caption is not None:
        caps = precompute_captions(manifest.img_paths,
                                   cache_dir=data_cfg.cache_dir)
        cap_tok = build_tokenizer(
            caps, required_vocab(args.caption_vocab, "caption_vocab.txt",
                                 "caption "))
        model_cfg = dataclasses.replace(
            model_cfg,
            caption=fit_vocab(cap_tok, model_cfg.caption, "caption"))
        data["caption_ids"], data["caption_mask"] = cap_tok.encode_batch(
            caps, model_cfg.max_caption_len)
        bucket("caption_mask", "caption_ids", variant.caption_len,
               model_cfg.max_caption_len)
    variant = dataclasses.replace(variant, model_cfg=model_cfg)
    return PredictInputs(manifest, variant, data)


def load_model(args, variant: Variant, device: torch.device,
               seed: int) -> torch.nn.Module:
    """The checkpoint's weights (``model.pt``), or random weights from
    ``seed`` when there is no checkpoint."""
    build = dict(kind=variant.kind, binary_head=variant.binary_head)
    if not args.checkpoint:
        return build_model(variant.model_cfg, device, seed, **build)
    path = os.path.join(args.checkpoint, "model.pt")
    if not os.path.exists(path):
        raise SystemExit(f"no model.pt under {args.checkpoint} — did you "
                         f"mean a fold subdir (e.g. {args.checkpoint}/"
                         f"fold_0)?")
    model = build_model(variant.model_cfg, device, **build)
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True))
    return model


def _cmd_predict(args) -> int:
    device = resolve_device(args.device)
    inputs = prepare_inputs(args)
    n = len(inputs.manifest)
    cfg = TrainConfig(bf16=device.type == "cuda")
    model = load_model(args, inputs.variant, device, cfg.seed)
    step = make_eval_step(model, cfg, grayscale=inputs.variant.grayscale)
    t0 = time.perf_counter()
    probs = run_eval(step, inputs.data, args.batch_size, device).probs
    seconds = time.perf_counter() - t0
    pred = (probs > args.threshold).astype(int)
    write_label_tsv(args.out, inputs.manifest.ids, pred, args.run_id)
    if args.probs_out:
        write_prob_tsv(args.probs_out, inputs.manifest.ids, pred, probs,
                       args.run_id)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"wrote {args.out} ({n} predictions)")
    print(f"predict: {inputs.variant.kind} model, {n} memes, eval "
          f"{seconds:.4f} s, {n / seconds:.2f} memes/s on {where}")
    return 0


def _cmd_check(args) -> int:
    from mpmc_tpu_torch.io.tsv import check_format
    ok = all(check_format(p) for p in args.pred_files_path)
    print("OK" if ok else "FORMAT ERROR")
    return 0 if ok else 1


def _cmd_score(args) -> int:
    from mpmc_tpu_torch.io.scorer import evaluate, validate_files
    if not validate_files(args.pred_file_path):
        return 1
    acc, p, r, f1 = evaluate(args.gold_file_path, args.pred_file_path)
    print(f"acc: {acc}, P:{p}, R:{r}, F1:{f1}")
    return 0


def _cmd_combine(args) -> int:
    from mpmc_tpu_torch.cv.ensemble import (average_probability,
                                            family_weight_scan,
                                            group_average, majority_voting,
                                            threshold_optimization)
    from mpmc_tpu_torch.io.scorer import read_gold
    from mpmc_tpu_torch.io.tsv import read_prob_predictions, read_run_id
    folds, run_ids = [], []
    for path in args.files:
        ids, _, probs = read_prob_predictions(path)
        folds.append(dict(zip(ids, probs)))
        run_ids.append(read_run_id(path))
    gold = {}
    for g in args.gold:
        gold.update(read_gold(g))
    if args.per_member:
        for path, f in zip(args.files, folds):
            _, thr, f1 = threshold_optimization(f, gold, metric=args.metric)
            print(f"  member {path}: {args.metric}-F1 {f1:.4f} "
                  f"(threshold {thr:.3f})")
    if args.group_by_run_id or args.scan_family_weight:
        families = group_average(folds, run_ids, space=args.average)
        print(f"families: { {g: run_ids.count(g) for g in families} }")
        if args.scan_family_weight:
            if len(families) != 2:
                print(f"--scan-family-weight needs exactly 2 run-id "
                      f"families, got {len(families)}")
                return 1
            (ga, gb) = families.values()
            avg, w, _ = family_weight_scan(ga, gb, gold, metric=args.metric,
                                           space=args.average)
            names = list(families)
            print(f"family blend: {w:.2f}*{names[0]} + {1-w:.2f}*{names[1]}")
        else:
            avg = average_probability(list(families.values()),
                                      space=args.average)
    else:
        avg = average_probability(folds, space=args.average)
    labels, thr, f1 = threshold_optimization(avg, gold, metric=args.metric)
    mv = majority_voting(folds)
    agree = sum(labels[i] == mv[i] for i in labels) / len(labels)
    print(f"avg-prob + threshold {thr:.3f}: {args.metric}-F1 {f1:.4f} "
          f"(majority-vote agreement {agree:.1%})")
    if args.out:
        ids = list(labels)
        write_label_tsv(args.out, ids,
                        [1 if labels[i] == "propaganda" else 0 for i in ids],
                        "ensemble")
        print(f"wrote {args.out}")
    return 0


def _cmd_analyze(args) -> int:
    from mpmc_tpu_torch.analysis import (misclassified, per_class_report,
                                         word_frequencies)
    rep = per_class_report(args.pred_file_path, args.gold_file_path)
    print(json.dumps(rep, indent=2, default=float))
    mis = misclassified(args.pred_file_path, args.gold_file_path)
    print(f"misclassified: {len(mis)}/{rep['n']}")
    if args.top_words:
        print("top words among misclassified (normalized):")
        for word, count in word_frequencies(mis, top_k=args.top_words):
            print(f"  {count:4d}  {word}")
    return 0


def _cmd_baselines(args) -> int:
    """The run, check and score loop over every baseline of the subtask,
    the frozen-feature SVMs after feature extraction included, as the JAX
    package's ``_cmd_baselines``."""
    from mpmc_tpu_torch.baselines import (run_feature_svm_baseline,
                                          run_majority_baseline,
                                          run_ngram_baseline,
                                          run_random_baseline)
    sub = args.subtask.upper()
    results = {}
    results["majority"] = run_majority_baseline(
        args.train_file_path, args.dev_file_path,
        f"{args.out_dir}/majority_baseline_{sub}.tsv")
    results["random"] = run_random_baseline(
        args.train_file_path, args.dev_file_path,
        f"{args.out_dir}/random_baseline_{sub}.tsv", subtask=sub)
    if sub in ("2A", "2C"):
        # A vectorizer other than the default gets its own file names and
        # run id, a family of its own in `combine --group-by-run-id`.
        ngram_kw = dict(analyzer=args.ngram_analyzer,
                        ngram_range=tuple(args.ngram_range),
                        max_features=args.ngram_max_features)
        fam = "ngram"
        if ngram_kw != dict(analyzer="word", ngram_range=(1, 1),
                            max_features=5000):
            fam += f"_{args.ngram_analyzer}"
            if tuple(args.ngram_range) != (1, 1):
                fam += f"_{args.ngram_range[0]}_{args.ngram_range[1]}"
            if args.ngram_max_features != 5000:
                fam += f"_{args.ngram_max_features}"
        results[fam] = run_ngram_baseline(
            args.train_file_path, args.dev_file_path,
            f"{args.out_dir}/{fam}_baseline_{sub}.tsv", run_id=fam,
            probs_out=(f"{args.out_dir}/{fam}_baseline_{sub}_probs.tsv"
                       if args.ngram_probs else None), **ngram_kw)
        if args.ngram_fold_probs:
            from mpmc_tpu_torch.baselines import run_ngram_fold_probs
            paths = run_ngram_fold_probs(
                args.train_file_path, args.dev_file_path,
                f"{args.out_dir}/{fam}_baseline_{sub}",
                num_folds=args.ngram_fold_probs, run_id=fam, **ngram_kw)
            print(f"ngram fold probs: {len(paths)} TSVs under {args.out_dir}")
        if args.ngram_cv:
            from mpmc_tpu_torch.baselines import run_ngram_cv
            f1s = run_ngram_cv(
                args.train_file_path, args.dev_file_path,
                f"{args.out_dir}/{fam}_cv_{sub}",
                num_folds=args.ngram_cv, run_id=fam, **ngram_kw)
            print(f"ngram-cv ({args.ngram_cv}-fold over train+dev): "
                  f"mean macro-F1 {np.mean(f1s):.4f} "
                  f"(folds {[round(f, 3) for f in f1s]})")
    if sub in ("2B", "2C") and not args.skip_features:
        from mpmc_tpu_torch.baselines.extract_features import \
            extract_features
        feats_dir = args.features_dir or os.path.join(args.out_dir,
                                                      "features")
        feats = {}
        for split, path in (("train", args.train_file_path),
                            ("dev", args.dev_file_path)):
            out = os.path.join(feats_dir, f"{split}_feats.json")
            if not os.path.exists(out):
                extract_features(
                    os.path.dirname(path) or ".", os.path.basename(path),
                    f"{split}_feats.json", image_root=args.image_root,
                    text_vocab_path=args.text_vocab,
                    text_params_path=args.text_params,
                    image_params_path=args.image_params,
                    features_dir=feats_dir,
                    device=resolve_device(args.device))
            feats[split] = out
        name = "resnet" if sub == "2B" else "imgbert"
        results[name] = run_feature_svm_baseline(
            feats["train"], feats["dev"], args.train_file_path,
            args.dev_file_path, f"{args.out_dir}/{name}_baseline_{sub}.tsv",
            use_text=(sub == "2C"))
    for name, (acc, p, r, f1) in results.items():
        print(f"{name}: acc={acc:.3f} macro-F1={f1:.3f}")
    return 0


def _cmd_extract_features(args) -> int:
    from mpmc_tpu_torch.baselines.extract_features import extract_features
    out = extract_features(args.data_dir, args.file_name, args.out_file_name,
                           image_root=args.image_root,
                           features_dir=args.features_dir,
                           text_vocab_path=args.text_vocab,
                           text_params_path=args.text_params,
                           image_params_path=args.image_params,
                           device=resolve_device(args.device))
    print(f"features written to {out}")
    return 0


def smoke_data(mcfg: ModelConfig, n: int, rng: np.random.Generator
               ) -> Dict[str, np.ndarray]:
    """``n`` synthetic 2C memes of ``mcfg``'s shapes whose label shows only
    in the pixels: random token ids, propaganda images bright and the
    others dark."""
    y = (rng.random(n) > 0.6).astype(np.int32)
    size = mcfg.image.image_size
    ids = rng.integers(5, mcfg.text.vocab_size,
                       (n, mcfg.max_text_len)).astype(np.int32)
    img = (rng.integers(0, 106, (n, size, size, 3))
           + 150 * y[:, None, None, None]).astype(np.uint8)
    cap = rng.integers(5, mcfg.caption.vocab_size,
                       (n, mcfg.max_caption_len)).astype(np.int32)
    return {"text_ids": ids, "text_mask": np.ones_like(ids), "image": img,
            "caption_ids": cap, "caption_mask": np.ones_like(cap),
            "label": y}


def _cmd_smoke(args) -> int:
    """The tiny 2C model trained on synthetic memes for two epochs (batch
    8, lr 1e-3) through ``fit``; exits 1 unless the best macro-F1 over 32
    test memes is above 0.6, as the JAX package's ``smoke``."""
    from mpmc_tpu_torch.train.loop import fit
    from mpmc_tpu_torch.train.step import build_train_step
    device = resolve_device(args.device)
    mcfg = ModelConfig.tiny_2c()
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=8), epochs=2,
                      learning_rate=1e-3, bf16=device.type == "cuda")
    rng = np.random.default_rng(0)
    train_d, test_d = smoke_data(mcfg, 64, rng), smoke_data(mcfg, 32, rng)
    model = build_model(mcfg, device, seed=0, kind="multimodal")
    store = {k: torch.from_numpy(v).to(device) for k, v in train_d.items()}
    steps = cfg.epochs * -(-len(train_d["label"]) // cfg.data.batch_size)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    res = fit(build_train_step(model, cfg, steps, store, generator),
              make_eval_step(model, cfg, cast_in_place=False), cfg,
              {"label": train_d["label"]}, device, test_data=test_d)
    print(json.dumps({"smoke_best_macro_f1": round(res.best_macro_f1, 4)}))
    return 0 if res.best_macro_f1 > 0.6 else 1


def _resolve_recipe(args) -> None:
    """Fill the recipe-controlled flags that were left unset, as the JAX
    package's ``_resolve_recipe`` does for the flags the port takes: the
    fast recipe packs 4 rows a step in 2A and each batch's tokens into rows
    in 2C (``pack_rows`` 8); 2B has no tokens and the simple 2C model pools
    the last position, so neither packs."""
    fast = args.recipe == "fast"
    if args.embedding_optimizer is None:
        args.embedding_optimizer = "factored" if fast else "adam"
    if args.adam_mu_dtype is None and fast:
        args.adam_mu_dtype = "bfloat16"
    if args.pack_rows is None:
        packs = {"2a": 4} if args.simple else {"2a": 4, "2c": 8}
        args.pack_rows = packs.get(args.subtask, 0) if fast else 0


def train_config(args) -> Tuple[TrainConfig, torch.device]:
    """The ``TrainConfig`` and device of a parsed ``train`` command line;
    raises when CUDA is asked for and absent.  As in the JAX package:
    ``--image-arch`` and ``--image-size`` swap the image backbone or its
    resolution of the chosen preset; ``--pooling`` and ``--fusion`` set
    those fields, and a fusion other than concatenation sets the image
    branch's ``finetune_dim`` to ``proj_dim`` (it needs equal widths);
    ``--simple`` without ``--tiny`` swaps in ``simple_2c`` after all of
    that."""
    device = resolve_device(args.device)
    _resolve_recipe(args)
    data = DataConfig(train_manifest=args.train_file_path,
                      dev_manifest=args.dev_file_path,
                      image_root=args.image_root,
                      batch_size=args.batch_size, num_folds=args.num_folds,
                      fold_over_train_plus_dev=args.subtask == "2a",
                      cache_dir=args.cache_dir, pack_rows=args.pack_rows,
                      corpus_vocab_mode=args.corpus_vocab,
                      corpus_vocab_size=args.corpus_vocab_size)
    if args.small and args.subtask == "2a":
        model = ModelConfig.small_2a()
    elif args.small and args.subtask == "2c":
        model = ModelConfig.small_2c()
    elif args.tiny:
        model = ModelConfig.tiny_2c()
    else:
        model = ModelConfig()
    if args.image_arch or args.image_size:
        model = dataclasses.replace(model, image=dataclasses.replace(
            model.image, arch=args.image_arch or model.image.arch,
            image_size=args.image_size or model.image.image_size))
    if args.pooling or args.fusion:
        model = dataclasses.replace(
            model,
            pooling=PoolingType(args.pooling) if args.pooling
            else model.pooling,
            fusion=FusionMethod(args.fusion) if args.fusion
            else model.fusion)
        if (model.fusion != FusionMethod.CONCATENATION
                and model.image is not None
                and model.image.finetune_dim != model.proj_dim):
            model = dataclasses.replace(model, image=dataclasses.replace(
                model.image, finetune_dim=model.proj_dim))
    if args.simple and args.subtask == "2c" and not args.tiny:
        model = ModelConfig.simple_2c()
    lr_schedule = args.lr_schedule or (
        "constant" if args.subtask == "2a" else "linear_warmup")
    cfg = TrainConfig(model=model, data=data, epochs=args.epochs,
                      learning_rate=args.lr, lr_schedule=lr_schedule,
                      seed=args.seed, bf16=device.type == "cuda",
                      checkpoint_dir=args.checkpoint_dir,
                      resume=args.resume,
                      adam_mu_dtype=args.adam_mu_dtype,
                      embedding_optimizer=args.embedding_optimizer,
                      mlm_epochs=args.mlm_epochs, mlm_pack=args.mlm_pack,
                      simclr_epochs=args.simclr_epochs,
                      distill_lambda=args.distill_lambda)
    return cfg, device


def _cmd_train(args) -> int:
    from mpmc_tpu_torch.cli.experiments import (run_subtask_2a,
                                                run_subtask_2b,
                                                run_subtask_2c)
    from mpmc_tpu_torch.models.pretrained import PretrainedSpec
    cfg, device = train_config(args)
    folds = [args.fold] if args.fold is not None else None
    kwargs = dict(out_dir=args.out_dir, folds=folds,
                  pretrained=PretrainedSpec(text=args.text_params,
                                            caption=args.caption_params,
                                            image=args.image_params))
    if args.subtask == "2a":
        results = run_subtask_2a(cfg, device, vocab_path=args.vocab,
                                 **kwargs)
    elif args.subtask == "2b":
        results = run_subtask_2b(cfg, device, binary_head=args.binary_head,
                                 **kwargs)
    else:
        results = run_subtask_2c(cfg, device, vocab_path=args.vocab,
                                 caption_vocab_path=args.caption_vocab,
                                 simple=args.simple,
                                 scratch_captioner=args.scratch_captioner,
                                 **kwargs)
    for k, r in zip(folds or range(args.num_folds), results):
        print(f"fold {k}: best macro-F1 {r.best_macro_f1:.4f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mpmc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("check", help="check label TSVs against the "
                                     "official format")
    p.add_argument("--pred-files-path", "-p", nargs="+", required=True)
    p.set_defaults(fn=_cmd_check)

    p = sub.add_parser("score", help="the official scorer: accuracy, "
                                     "weighted P and R, macro-F1")
    p.add_argument("--gold-file-path", "-g", required=True)
    p.add_argument("--pred-file-path", "-p", required=True)
    p.set_defaults(fn=_cmd_score)

    p = sub.add_parser("predict", help="run a manifest through a 2A, 2B or "
                                       "2C model and write the submission "
                                       "TSV")
    p.add_argument("--subtask", choices=["2a", "2b", "2c"], required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--probs-out", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--image-root", default=".")
    p.add_argument("--vocab", default=None)
    p.add_argument("--caption-vocab", default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--run-id", default="mpmc_tpu")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny_2c config (when no run_meta.json)")
    p.add_argument("--small", action="store_true",
                   help="2A: the small_2a config (when no run_meta.json)")
    p.add_argument("--simple", action="store_true",
                   help="2C: the organizers' simple baseline (C28), "
                        "distilbert + resnet50 logits, no captions")
    p.add_argument("--image-arch", default=None,
                   help=f"image backbone ({IMAGE_ARCHS}) when no "
                        f"run_meta.json")
    p.add_argument("--image-size", type=int, default=None,
                   help="input resolution when no run_meta.json")
    p.add_argument("--binary-head", action="store_true",
                   help="2B: the l2-normalized scaled BinaryHead (when no "
                        "run_meta.json)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_predict)

    p = sub.add_parser("combine", help="ensemble per-fold probability TSVs")
    p.add_argument("--files", nargs="+", required=True)
    p.add_argument("--gold", nargs="+", required=True,
                   help="gold manifest(s); several are merged by id")
    p.add_argument("--out", default=None)
    p.add_argument("--metric", choices=["binary", "macro", "youden"],
                   default="binary",
                   help="threshold rule: binary or macro F1 over a "
                        "100-point scan, or the ROC Youden threshold")
    p.add_argument("--per-member", action="store_true",
                   help="print each member's own threshold-optimized F1")
    p.add_argument("--average", choices=["prob", "logit"], default="prob",
                   help="average probabilities or log-odds")
    p.add_argument("--group-by-run-id", action="store_true",
                   help="average within each run-id family first, then "
                        "across families")
    p.add_argument("--scan-family-weight", action="store_true",
                   help="with exactly 2 run-id families, scan their blend "
                        "weight on the gold labels")
    p.set_defaults(fn=_cmd_combine)

    p = sub.add_parser("analyze", help="per-class report and the words of "
                                       "the misclassified memes")
    p.add_argument("--gold-file-path", "-g", required=True)
    p.add_argument("--pred-file-path", "-p", required=True)
    p.add_argument("--top-words", type=int, default=15,
                   help="the N most frequent normalized words among "
                        "misclassified samples (0 disables)")
    p.set_defaults(fn=_cmd_analyze)

    p = sub.add_parser("train", help="train the 2A text model, the 2B "
                                     "image model or the 2C multimodal "
                                     "model over stratified folds")
    p.add_argument("--subtask", choices=["2a", "2b", "2c"], required=True,
                   help="2a: text, folds over train+dev; 2b: image, 2c: "
                        "text + image + caption, folds over train, dev as "
                        "the test split")
    p.add_argument("--recipe", choices=["fast", "reference"], default="fast",
                   help="fast (default): packed text rows (2A: 4 packed "
                        "rows a step; 2C: each batch's text and caption "
                        "tokens), bf16 Adam first moment, factored-RMS word "
                        "embeddings; reference: unpacked, f32 Adam "
                        "everywhere")
    p.add_argument("--train-file-path", "-tr", required=True)
    p.add_argument("--dev-file-path", "-te", required=True)
    p.add_argument("--image-root", default=".")
    p.add_argument("--out-dir", "-o", default="outputs")
    p.add_argument("--fold", type=int, default=None)
    p.add_argument("--num-folds", type=int, default=5)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--lr-schedule", choices=["constant", "linear_warmup"],
                   default=None,
                   help="default: constant for 2a, linear_warmup for 2c")
    p.add_argument("--pack-rows", type=int, default=None,
                   help="> 0 packs the text tokens: 2a trains on batches of "
                        "this many packed rows, 2c packs each batch's text "
                        "and caption tokens (recipe default: fast 4 for 2a "
                        "and 8 for 2c, reference 0)")
    p.add_argument("--embedding-optimizer", choices=["factored", "adam"],
                   default=None)
    p.add_argument("--adam-mu-dtype", choices=["bfloat16", "float32"],
                   default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="per-fold checkpoint dir (also receives the vocab "
                        "files and run_meta.json)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint per fold from "
                        "--checkpoint-dir before training (exact state: "
                        "params + optimizer + step + generator)")
    p.add_argument("--cache-dir", default=".cache")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny_2c config")
    p.add_argument("--small", action="store_true",
                   help="the from-scratch small config (2a: small_2a; 2c: "
                        "small_2c, a tiny ResNet at 64 pixels and no "
                        "captions)")
    p.add_argument("--simple", action="store_true",
                   help="2c: the organizers' simple baseline (C28), "
                        "distilbert + resnet50 logits, CE, no captions, "
                        "trained on the eval transform")
    p.add_argument("--vocab", default=None,
                   help="2a, 2c: a WordPiece text vocab file instead of the "
                        "corpus vocab")
    p.add_argument("--caption-vocab", default=None,
                   help="2c: caption-encoder vocab file instead of the "
                        "corpus vocab over the captions")
    p.add_argument("--scratch-captioner", action="store_true",
                   help="2c: generate captions with the from-scratch "
                        "ImageCaptioner (real pixels -> decoded words) "
                        "instead of placeholder strings")
    p.add_argument("--mlm-epochs", type=int, default=0,
                   help="> 0 first pretrains the text encoder by masked "
                        "language modelling on the train+dev texts "
                        "(character-noise copies, 64-row batches) and "
                        "starts every fold from it (skipped when "
                        "--text-params is given)")
    p.add_argument("--mlm-pack", action="store_true",
                   help="pack the MLM corpus into segment-masked rows")
    p.add_argument("--corpus-vocab", default="words",
                   choices=["words", "subword"],
                   help="corpus vocab when no --vocab file is given: "
                        "'words' = whole words + character pieces; "
                        "'subword' = BPE-learned WordPiece pieces")
    p.add_argument("--corpus-vocab-size", type=int, default=30000,
                   help="corpus vocab budget (words: most words kept; "
                        "subword: pieces in all)")
    p.add_argument("--distill-lambda", type=float, default=0.0,
                   help="> 0 mixes the cross-fitted char-n-gram SVM's soft "
                        "targets into the 2a and 2c train loss: (1-X)·loss"
                        "(hard) + X·CE(teacher prob), the teacher fitted "
                        "only inside each fold's train rows; eval and TSVs "
                        "stay neural.  The teacher needs sklearn, or its "
                        "cached distill_<key>.npz under --cache-dir")
    p.add_argument("--text-params", default=None,
                   help="text-encoder weights to start from: a Hugging "
                        "Face BERT-family checkpoint (dir or .bin/.pt/"
                        ".safetensors/.npz file), or the flax-tree .npz "
                        "that MLM pretraining writes (mlm_encoder.npz) in "
                        "either package")
    p.add_argument("--caption-params", default=None,
                   help="2c: caption-encoder weights (a Hugging Face "
                        "RoBERTa-family checkpoint, dir or file)")
    p.add_argument("--image-arch", default=None,
                   help=f"image backbone from the 2B zoo ({IMAGE_ARCHS})")
    p.add_argument("--image-size", type=int, default=None,
                   help="input resolution (the zoo uses 384 for its ViT "
                        "and EfficientNet variants)")
    p.add_argument("--binary-head", action="store_true",
                   help="2b: the l2-normalized scaled BinaryHead")
    p.add_argument("--simclr-epochs", type=int, default=0,
                   help="> 0 first pretrains the image backbone with SimCLR "
                        "on the train images (2b, and 2c without --simple) "
                        "and starts every fold from it (skipped when "
                        "--image-params is given; color images only)")
    p.add_argument("--image-params", default=None,
                   help="image-backbone weights to start from: a "
                        "torchvision/timm/HF checkpoint of the backbone's "
                        "arch (ResNet family, ViT, ConvNeXt), or the "
                        "flax-tree .npz that SimCLR pretraining writes "
                        "(simclr_backbone.npz) in either package")
    p.add_argument("--pooling", default=None,
                   choices=["cls", "nopooling", "max", "mean", "attention",
                            "cnn"],
                   help="pooling mode (default: the preset's); max, cnn "
                        "and nopooling turn sequence bucketing off")
    p.add_argument("--fusion", default=None,
                   choices=["concatenation", "mca", "cross_modal",
                            "self_attention"],
                   help="2c fusion family (default: the preset's)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_train)

    p = sub.add_parser("baselines", help="the organizers' classic baselines "
                                         "of a subtask, each checked and "
                                         "scored")
    p.add_argument("--subtask", choices=["2a", "2b", "2c"], required=True)
    p.add_argument("--train-file-path", "-tr", required=True)
    p.add_argument("--dev-file-path", "-te", required=True)
    p.add_argument("--out-dir", "-o", default=".")
    p.add_argument("--image-root", default=None)
    p.add_argument("--features-dir", default=None,
                   help="reuse or write the feature JSONs here (default: "
                        "<out-dir>/features)")
    p.add_argument("--text-vocab", default=None)
    p.add_argument("--text-params", default=None,
                   help="BERT checkpoint for the text feature branch")
    p.add_argument("--image-params", default=None,
                   help="ConvNeXt-Tiny checkpoint for the image branch")
    p.add_argument("--skip-features", action="store_true",
                   help="skip the frozen-feature SVM rows (no device pass)")
    p.add_argument("--ngram-probs", action="store_true",
                   help="also write a Platt-calibrated n-gram probability "
                        "TSV (a member for `combine`)")
    p.add_argument("--ngram-analyzer", default="word",
                   choices=["word", "char", "char_wb"],
                   help="TF-IDF n-gram family (word: the organizers' row)")
    p.add_argument("--ngram-range", type=int, nargs=2, default=[1, 1],
                   metavar=("MIN", "MAX"),
                   help="n-gram span for the TF-IDF vectorizer")
    p.add_argument("--ngram-max-features", type=int, default=5000,
                   help="TF-IDF vocabulary cap")
    p.add_argument("--ngram-cv", type=int, default=0, metavar="K",
                   help="also run the n-gram SVM under the 2A fold protocol "
                        "(K folds over train+dev, each fold's val macro-F1 "
                        "at its Youden threshold)")
    p.add_argument("--ngram-fold-probs", type=int, default=0, metavar="K",
                   help="write K per-fold calibrated n-gram probability "
                        "TSVs over the dev split")
    p.add_argument("--device", default="cuda",
                   help="feature extraction: cuda (default) or cpu")
    p.set_defaults(fn=_cmd_baselines)

    p = sub.add_parser("extract-features", help="frozen ConvNeXt-Tiny image "
                                                "and BERT pooler text "
                                                "features of a manifest")
    p.add_argument("--data-dir", "-d", required=True)
    p.add_argument("--file-name", "-f", required=True)
    p.add_argument("--out-file-name", "-o", required=True)
    p.add_argument("--image-root", default=None)
    p.add_argument("--features-dir", default=None,
                   help="output dir (default <data-dir>/features)")
    p.add_argument("--text-vocab", default=None,
                   help="WordPiece vocab file (required with a corpus-MLM "
                        "npz encoder: the vocab.txt saved next to it)")
    p.add_argument("--text-params", default=None,
                   help="text encoder weights: an HF BERT checkpoint (dir "
                        "or file) or a corpus-MLM flax-tree npz")
    p.add_argument("--image-params", default=None,
                   help="ConvNeXt-Tiny weights (torchvision or HF state "
                        "dict)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_extract_features)

    p = sub.add_parser("smoke", help="train the tiny 2C model on synthetic "
                                     "memes; exit 1 unless it learns")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_smoke)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
