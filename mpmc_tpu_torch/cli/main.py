"""Command line of the PyTorch port.

  python -m mpmc_tpu_torch.cli.main predict --subtask 2c --manifest M \\
      --out pred.tsv [--probs-out probs.tsv] [--checkpoint DIR] [--tiny] \\
      [--device cuda|cpu] [--batch-size 16]
  python -m mpmc_tpu_torch.cli.main train --subtask 2c -tr TRAIN -te DEV \\
      [--recipe fast|reference] [--fold K] [--epochs N] \\
      [--checkpoint-dir DIR] [--out-dir DIR] [--tiny] [--device cuda|cpu]

``train`` follows the JAX package's ``_cmd_train`` for 2C: stratified folds
over the train manifest, the dev manifest as the test split, and per fold
the best-test-F1 TSVs and, with ``--checkpoint-dir``, ``fold_<k>/model.pt``
next to ``run_meta.json`` and the vocab files, which ``predict --checkpoint
DIR/fold_<k>`` reads.  ``--recipe fast`` (the default) packs the text and
caption tokens (``--pack-rows 8``), keeps the Adam first moment in bf16 and
gives the word embeddings factored RMS; ``--recipe reference`` turns all
three off.  An explicitly passed flag wins over its recipe value.

``predict`` follows the JAX package's ``_cmd_predict`` for the multimodal
(2C) model: the trained variant and bucket lengths come from the
``run_meta.json`` next to a checkpoint, whose ``vocab.txt`` and
``caption_vocab.txt`` are then required; without a checkpoint the model
runs on random weights from a seeded generator and corpus vocabularies.
A port checkpoint is the model's ``state_dict`` saved as ``model.pt`` in
the checkpoint directory.  The model runs on CUDA unless ``--device cpu``
is passed; the CUDA path computes in bf16, the CPU path in f32.
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
from mpmc_tpu_torch.config import (DataConfig, ModelConfig, TextEncoderConfig,
                                   TrainConfig, model_config_from_dict)
from mpmc_tpu_torch.image.decode import decode_batch
from mpmc_tpu_torch.io.manifest import Manifest, read_manifest
from mpmc_tpu_torch.io.tsv import write_label_tsv, write_prob_tsv
from mpmc_tpu_torch.models.captioner import precompute_captions
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.train.loop import run_eval
from mpmc_tpu_torch.train.step import make_eval_step

log = logging.getLogger(__name__)


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
class PredictInputs:
    manifest: Manifest
    model_cfg: ModelConfig
    grayscale: bool
    data: Dict[str, np.ndarray]   # host arrays, one row per meme


def prepare_inputs(args) -> PredictInputs:
    """Manifest, resolved model variant and the tokenized, bucketed,
    decoded host arrays of a ``predict`` invocation."""
    manifest = read_manifest(args.manifest, is_test=True)
    meta = None
    for d in _ckpt_dirs(args.checkpoint):
        cand = os.path.join(d, "run_meta.json")
        if os.path.exists(cand):
            with open(cand) as f:
                meta = json.load(f)
            break
    if meta is not None:
        if meta["kind"] != "multimodal":
            raise SystemExit(f"checkpoint kind {meta['kind']!r} is not "
                             "ported yet (only the 2C multimodal model)")
        model_cfg = model_config_from_dict(meta["model"])
        grayscale = meta.get("grayscale", False)
        text_len, caption_len = meta.get("text_len"), meta.get("caption_len")
    else:
        if args.checkpoint:
            log.warning("no run_meta.json next to %s — rebuilding the model "
                        "from CLI flags", args.checkpoint)
        model_cfg = ModelConfig.tiny_2c() if args.tiny else ModelConfig()
        grayscale = model_cfg.image.grayscale
        text_len = caption_len = None
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
        """Trim to the training bucket length, else to this manifest's."""
        length = trained_len if trained_len is not None else bucket_seq_len(
            [data[masks_key]], data_cfg.seq_bucket_multiple, cap)
        if length < cap:
            bucket_trim(data, ids_key, masks_key, length)

    data: Dict[str, np.ndarray] = {}
    if model_cfg.text is not None:
        tok = build_tokenizer(manifest.texts,
                              required_vocab(args.vocab, "vocab.txt", ""))
        model_cfg = dataclasses.replace(
            model_cfg, text=fit_vocab(tok, model_cfg.text, "text"))
        data["text_ids"], data["text_mask"] = prepare_text(
            manifest, tok, model_cfg.max_text_len)
        bucket("text_mask", "text_ids", text_len, model_cfg.max_text_len)
    data["image"] = decode_batch(manifest.img_paths,
                                 model_cfg.image.image_size, grayscale,
                                 args.image_root)
    if model_cfg.caption is not None:
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
        bucket("caption_mask", "caption_ids", caption_len,
               model_cfg.max_caption_len)
    return PredictInputs(manifest, model_cfg, grayscale, data)


def load_model(args, model_cfg: ModelConfig, device: torch.device,
               seed: int) -> torch.nn.Module:
    """The checkpoint's weights (``model.pt``), or random weights from
    ``seed`` when there is no checkpoint."""
    if not args.checkpoint:
        return build_model(model_cfg, device, seed)
    path = os.path.join(args.checkpoint, "model.pt")
    if not os.path.exists(path):
        raise SystemExit(f"no model.pt under {args.checkpoint}")
    model = build_model(model_cfg, device)
    model.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True))
    return model


def _cmd_predict(args) -> int:
    device = resolve_device(args.device)
    inputs = prepare_inputs(args)
    n = len(inputs.manifest)
    cfg = TrainConfig(bf16=device.type == "cuda")
    model = load_model(args, inputs.model_cfg, device, cfg.seed)
    step = make_eval_step(model, cfg, grayscale=inputs.grayscale)
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
    print(f"predict: {n} memes, eval {seconds:.4f} s, "
          f"{n / seconds:.2f} memes/s on {where}")
    return 0


def _resolve_recipe(args) -> None:
    """Fill the recipe-controlled flags that were left unset, as the JAX
    package's ``_resolve_recipe`` does for the flags the port takes."""
    fast = args.recipe == "fast"
    if args.embedding_optimizer is None:
        args.embedding_optimizer = "factored" if fast else "adam"
    if args.adam_mu_dtype is None and fast:
        args.adam_mu_dtype = "bfloat16"
    if args.pack_rows is None:
        args.pack_rows = 8 if fast else 0


def train_config(args) -> Tuple[TrainConfig, torch.device]:
    """The ``TrainConfig`` and device of a parsed ``train`` command line;
    raises when CUDA is asked for and absent."""
    device = resolve_device(args.device)
    _resolve_recipe(args)
    data = DataConfig(train_manifest=args.train_file_path,
                      dev_manifest=args.dev_file_path,
                      image_root=args.image_root,
                      batch_size=args.batch_size, num_folds=args.num_folds,
                      cache_dir=args.cache_dir, pack_rows=args.pack_rows)
    model = ModelConfig.tiny_2c() if args.tiny else ModelConfig()
    cfg = TrainConfig(model=model, data=data, epochs=args.epochs,
                      learning_rate=args.lr, seed=args.seed,
                      bf16=device.type == "cuda",
                      checkpoint_dir=args.checkpoint_dir,
                      adam_mu_dtype=args.adam_mu_dtype,
                      embedding_optimizer=args.embedding_optimizer)
    return cfg, device


def _cmd_train(args) -> int:
    from mpmc_tpu_torch.cli.experiments import run_subtask_2c
    cfg, device = train_config(args)
    folds = [args.fold] if args.fold is not None else None
    results = run_subtask_2c(cfg, device, out_dir=args.out_dir, folds=folds)
    for k, r in zip(folds or range(args.num_folds), results):
        print(f"fold {k}: best macro-F1 {r.best_macro_f1:.4f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mpmc_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("predict", help="run a manifest through the 2C model "
                                       "and write the submission TSV")
    p.add_argument("--subtask", choices=["2c"], required=True)
    p.add_argument("--manifest", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--probs-out", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--image-root", default=".")
    p.add_argument("--vocab", default=None)
    p.add_argument("--caption-vocab", default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--run-id", default="mpmc_tpu_torch")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny_2c config (when no run_meta.json)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_predict)

    p = sub.add_parser("train", help="fine-tune the 2C model over "
                                     "stratified folds")
    p.add_argument("--subtask", choices=["2c"], required=True)
    p.add_argument("--recipe", choices=["fast", "reference"], default="fast",
                   help="fast (default): packed text and caption rows, bf16 "
                        "Adam first moment, factored-RMS word embeddings; "
                        "reference: unpacked, f32 Adam everywhere")
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
    p.add_argument("--pack-rows", type=int, default=None,
                   help="> 0 packs each batch's text and caption tokens "
                        "(recipe default: 8 fast, 0 reference)")
    p.add_argument("--embedding-optimizer", choices=["factored", "adam"],
                   default=None)
    p.add_argument("--adam-mu-dtype", choices=["bfloat16", "float32"],
                   default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--cache-dir", default=".cache")
    p.add_argument("--tiny", action="store_true",
                   help="the tiny_2c config")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.set_defaults(fn=_cmd_train)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
