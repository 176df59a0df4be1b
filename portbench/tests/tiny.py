"""Tiny versions of the benchmark's cells for CPU tests: the real cells'
files with every width, depth, vocabulary, image and split shrunk (the
image backbones keep their fixed widths), so that a whole run of a cell
takes seconds on the CPU."""

from __future__ import annotations

import copy

from portbench import spec

TEXT = {"vocab_size": 97, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 160}
TRAFFIC = {"train_memes": 160, "test_memes": 12, "checked_steps": 8,
           "split_memes": 40, "batch_size": 8, "scan_steps": 4,
           "trace_seconds": 1, "words_max": 20}


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(spec.config(name))
    for enc in ("text_encoder", "caption_encoder"):
        if enc in cfg:
            cfg[enc].update(TEXT)
    if "caption_encoder" in cfg:
        cfg["caption_encoder"]["max_position_embeddings"] = 162
    img = cfg.get("image_encoder")
    if img is not None:
        img.update(image_size=32)
        if "finetune_dim" in img:
            img.update(finetune_dim=16)
    for key, size in (("proj_dim", 16), ("max_text_len", 32),
                      ("max_caption_len", 32)):
        if key in cfg["head"]:
            cfg["head"][key] = size
    cfg["recipe"].update(batch_size=8, scan_steps=4, epochs=1,
                         seq_bucket_multiple=8)
    return cfg


def tiny_cell(name: str) -> dict:
    cell = spec.cell(name)
    cell["config"] = tiny_config(cell["entry"]["config"])
    cell["traffic"] = dict(cell["traffic"], **{
        k: v for k, v in TRAFFIC.items() if k in cell["traffic"]})
    return cell
