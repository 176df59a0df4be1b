"""Smoke run of the PyTorch port (mpmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  Phases, each of which raises on failure:

1. build every CUDA kernel from ``mpmc_tpu_torch/csrc`` with nvcc, and
   beside them the C++ host runtime (``mpmc_tpu_torch/native``: the
   tokenizer and the libjpeg/libpng image decoder) with g++, printing each
   library's route (the system's libraries, or Pillow's bundled ones), the
   compiler's error for a route that failed, the libjpeg and libpng
   versions, and the host's g++, Pillow, numpy and CPU count;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (attention: padding, segments and Sq != Sk, bf16
   and f32, fully masked rows included), and time kernel, plain version,
   one PyTorch library call computing the same function, and the bound;
3. drive the 2C ``predict`` command line at full model width (AraBERT-base
   text and RoBERTa-base caption encoders, ResNet-18 at 224x224, random
   weights from a seed) on a synthetic manifest whose images are PNGs the
   script writes (every one decoded by the native path), with every
   kernel's launch count zeroed before and read after; then time the eval
   pass again warm;
4. compare the card with the CPU on one full-width batch in f32 (TF32 off);
5. drive the 2C ``train`` command line at full width (fold 0, one epoch,
   bf16, the default fast recipe: packed text and caption rows) on
   synthetic labelled manifests with written PNG images (decoded by the
   native path), with every kernel's launch count zeroed
   before and read after; check the losses, the TSVs, and that ``predict
   --checkpoint`` reproduces the best eval's probabilities; then time warm
   train steps, profile them by kernel, and time the backward kernel at the
   realized packed shapes;
6. one packed train step in f32 on the card (kernels) and on the CPU (plain
   versions) from the same weights, batch and augmentation draws, with
   dropout 0 and TF32 off, the encoders cut to 4 layers at full width:
   loss, grad norm, augmented image, and the parameters and batch
   statistics after the optimizer step;
7. drive ``predict`` for the other kinds at full width on phase 3's
   manifest, launch counts zeroed before and read after, then warm:
   2A (AraBERT-base shape, attention pooling, 2 classes), 2B (ResNet-18 at
   224x224; ResNet-50 with BinaryHead) and the simple 2C baseline
   (distilbert-multilingual shape, ResNet-50's 1000 logits); compare each
   new model class card vs CPU in f32 (TF32 off) on a few memes; and run
   ``combine``, ``check`` and ``score`` over the probability TSVs of
   phases 3 and 7 against a synthetic labelled manifest, the ensemble and
   its score recomputed in plain numpy;
8. drive the 2A ``train`` command line at full width (AraBERT-base shape,
   attention pooling, 2 classes) on phase 5's manifests: folds over
   train+dev, fold 0, one epoch, bf16, the fast recipe's 4 packed rows a
   step, launch counts zeroed before and read after (12 forward and 12
   backward launches a step, 12 forward launches per eval batch, no image
   kernel); check the losses, the three TSVs (labels at 0.5) and that
   ``predict --checkpoint`` reproduces the best eval; time warm packed 2A
   steps with device and host profiles; one packed 2A step in f32 card vs
   CPU as in phase 6; then ``pretrain_and_save`` (corpus MLM) at full
   width, one epoch, unpacked, f32, with 12 launches of each attention
   kernel a step, its own steps timed and two of them profiled, and the
   written npz spliced into a ``TextClassifier`` on the card equal to the
   MLM encoder bit for bit; then ``train --subtask 2a --recipe reference
   --mlm-epochs 2 --mlm-pack`` (a packed MLM stage, its npz spliced into an
   unpacked fine-tune) and ``train --subtask 2a --text-params`` with that
   npz, launches checked as before;
9. hold the attention pair at ViT's shapes in mode none (``[16,197,12,64]``,
   ``[16,50,12,64]``, ``[16,577,12,64]``, ``[16,577,16,64]``) against the
   plain versions in f32 and bf16, and time it in bf16 beside SDPA; the
   image kernel likewise at ``[16,384,384,3]``; drive the 2B ``train``
   command line at full width on phase 5's manifests (folds over train,
   dev as the test split, fold 0, one epoch, bf16, unpacked), once with
   ResNet-18 at 224 and once with ViT-B/16 at 384, launch counts zeroed
   before and read after (the image kernel once a step; for the ViT 12
   forward and 12 backward launches a step and 12 forward per eval batch);
   ``predict --checkpoint`` from the ViT run reproduces its best eval; warm
   steps with device and host profiles; and ViT-B/32, ViT-L/16,
   EfficientNet-B3 and ConvNeXt-Tiny card vs CPU in f32;
10. hold the image kernel at the SimCLR batch ``[64,224,224,3]`` and at
   small_2c's ``[16,64,64,3]``, and the f32 attention pair at ViT-B/16's
   SimCLR batch ``[128,197,12,64]`` (mode none), against the plain
   versions, and time them; drive ``train`` on phase 5's manifests, launch
   counts zeroed before and read after, for ``--subtask 2b --simclr-epochs
   2`` (ResNet-18 at 224: 2 SimCLR steps an epoch at batch 64, the image
   kernel twice a SimCLR step and once a train step; the fold starts from
   the SimCLR npz bit for bit; warm SimCLR steps and a profiled one),
   ``--subtask 2c --simclr-epochs 1 --fusion mca`` (the flagship with the
   SimCLR stage and the MCA fusion), ``--simple`` and ``--small``, each
   followed by ``predict --checkpoint``; the attention pair at the
   ``--small`` run's packed text shape (bf16, segments, 4 heads of D = 32,
   its own segment ids) held and timed; ``simclr_pretrain`` over ViT-B/16
   at 224 for two steps (12 forward and 12 backward calls a step, two
   f32 backward kernels a call); two SimCLR steps of ResNet-18 card vs CPU in
   f32; and the flagship with the cross-modal and the self-attention
   fusions card vs CPU in f32;
11. hold the f32 attention forward at the scratch captioner's shapes
   (``[64,197,4,32]``, and ``[64,24,6,21]`` over 197 keys: D = 21), mode
   none, against the plain version and time it beside SDPA (TF32 off);
   caption phase 5's 224 images at 224 pixels with
   ``make_scratch_caption_fn`` (48 forward launches a generate batch, ms a
   batch, the busy share of a profiled batch, logits and greedy ids card vs
   CPU in f32); drive ``train --subtask 2c --scratch-captioner`` at full
   width; kill phase 8's 2A run after its first checkpoint and
   ``--resume`` it (ids and labels equal to phase 8's TSVs, probabilities
   within a stated tolerance); and run the ``Trainer`` over
   ``clip_style_2c`` (BERT-base + ViT-B/32 at 224): a few steps,
   ``evaluate``, ``predict``, ``save_model`` and a resumed ``evaluate``
   equal to the first;
12. write random checkpoints from a seeded numpy generator in the exact
   Hugging Face and torchvision key layouts (a BERT-base directory and a
   RoBERTa-base one, each with phase 5's vocab file its embedding rows fit,
   a ResNet-18 ``.pt`` and a ConvNeXt-Tiny ``.bin``); hold the f32
   attention forward at ``extract-features``' text shape
   (``[32,128,12,64]``, padding, a fully masked sample) against the plain
   version and time it beside SDPA (TF32 off) and the bound; drive ``train
   --subtask 2c --text-params --caption-params --image-params`` on the
   first 64 and 16 memes of phase 5's manifests (each spliced part equal
   to its converted checkpoint bit for bit before the first step, launches
   as in phase 5); drive ``extract-features`` over 72 memes (12 forward
   launches a text batch
   of 32), then warm images/s and texts/s, the busy share of a profiled
   pass and the card against the CPU on 8 memes in f32; drive ``train
   --subtask 2a --corpus-vocab subword --distill-lambda 0.5`` from a
   synthetic teacher cache (a GPU host usually has no sklearn to fit the
   teacher; the run id ends in ``_distill``); and hold the bf16 pair at
   ``smoke``'s shape, then run ``smoke`` (exit 0);
13. the host runtime: decode the committed fixtures
   (``tests/torch_data``) through the native decoder against their
   expected pixels (PNGs bit-equal, JPEGs within ``JPEG_LEVEL_TOL``);
   ``ImagePipeline.preload`` images/s over phase 5's images, native and
   PIL; the native and Python tokenizers on phase 5's corpus (0 differing
   rows, texts/s); ``train --subtask 2a --recipe reference
   --embedding-optimizer sparse --profile-dir`` at full width (launches
   as phase 8's, the trace naming both attention kernels); one batch of
   sparse against dense Adam on the card; and the warm 2A step under
   ``adam``, ``factored`` and ``sparse`` at the corpus vocab and at
   64,000 rows;
14. one dispatch for K steps and fold-parallel training: phase 5's run is
   ``--scan-steps 4`` (groups of 4 steps and of 4 eval batches, each a
   CUDA graph after an eager first group); the same command line at
   ``--scan-steps 1``: graphs captured and replayed, the three kernels'
   launches equal, TSVs, per-step losses and final weights bit for bit
   (or within Adam's bound); phase 5's fold also runs 4 single steps and
   one replay of their group in turns (warm ms a step, the busy share of
   each profiled, one ``cudaGraphLaunch`` a group); ``predict
   --scan-steps 8`` against 1 on phase 3's memes and warm memes/s of
   both; phase 13's sparse 2A run again at ``--scan-steps 4`` (phase 8's
   2A run and phase 11's kill-and-``--resume`` are at ``--scan-steps 4``
   too); ``train --subtask 2c --fold-parallel --scan-steps 4`` (4 folds:
   24 attention forwards and 24 backwards a step at ``[64, S, 12, 64]``,
   one image kernel at ``[64, 224, 224, 3]``, per-fold TSVs and
   checkpoints, ``predict --checkpoint`` from fold 2); and one f32
   fold-parallel step against each replica's own step;
15. the multi-GPU layouts at world size 1 (one card): phase 5's command
   line again, without checkpoints, in a world of one process over NCCL
   (``parallel/dist_worker.launch_processes``), through the data-parallel
   path (rows of each global batch, the BatchNorm statistics, the loss
   weight and the gradients summed over the data group in one flat buffer,
   evals gathered); its TSVs, per-step losses and final weights against
   phase 5's (bit for bit, else within Adam's bound), the three kernels'
   launches equal, the collectives a step, its warm group replay beside
   phase 5's; then, in that world, the 2A text classifier at full width
   (12 layers, ``[16, 128]``, bf16) sequence-parallel (ring, Ulysses) and
   pipelined (S = 1, M = 4) and tensor-parallel (one shard), forward and
   backward against the plain classifier, with their kernel launches.

Phase 1 also counts the tensor-core instructions (HMMA/HGMMA) of each
attention library with ``cuobjdump -sass``.  Phase 2 also holds the
attention backward kernel (padding with a fully masked sample, segments with
id-0 rows, none with Sq != Sk; bf16 and f32; the main paths' shapes, text
buckets of 256 and 512, D = 128 and D = 8), with two runs bit-equal (also
in f32 at the MLM shape ``[64,128,12,64]``), and the
fused image kernel ([16,224,224,3], both flip values) against their plain
versions, and times them beside SDPA (forward, backward alone, and the
pair).  Phases 5 and 8 also check that the profiled steps launch one
backward kernel, 24 (2C) or 12 (2A) times a step, and time the attention
pair and SDPA at the packed shapes (a [B,1,S,S] bias built from the
segment ids) and at the MLM shapes, packed and unpacked, after holding
the forward and backward kernels against their plain versions there.
Phase 10 also measures every BatchNorm of the attention-fusion flagships
over ``[B, F]`` features (each modality FC's, the fusion's) card vs CPU,
input and output, at 12 encoder layers and, for the cross-modal one, at 4
(printed, not checked).

Prints the card's name and power limit, each phase's result, the
``predict_kinds``, ``train_2a``/``mlm``, ``train_2b``,
``train_variants``, ``fusion_batchnorms``, ``phase_11``, ``phase_12``,
``phase_13``, ``phase_14`` and ``phase_15`` JSON lines, a
``kernels`` JSON line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero without a CUDA device or outside the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 on the tensor cores; f32 on the CUDA cores, no TF32).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TEXT_SHAPE = (16, 128, 12, 64)       # predict batch 16, text bucket 128
CAPTION_SHAPE = (16, 64, 12, 64)     # placeholder captions bucket to 64
N_MEMES = 128
BATCH = 16
N_TRAIN, N_DEV = 160, 64             # phase 5 manifests: fold 0 trains 128
IMAGE_SHAPE = (16, 224, 224, 3)      # the train step's image batch
# Shapes beyond the main paths, held against the plain versions in phase 2:
# text buckets of 256 and 512 (real manifests), D = 128, and D = 8 with a
# ragged Sq (name, [B, Sq, H, D], mode, Sk override).
LONG_CASES = [("long-256", (4, 256, 12, 64), "padding", None),
              ("long-512", (2, 512, 12, 64), "segments", None),
              ("d128", (4, 128, 6, 128), "padding", None),
              ("d8", (4, 100, 12, 8), "none", 300)]
ARABIC_LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"
# Kernel vs plain version, by input type.  Forward: max |out| and max |lse|
# differences.  Backward: (atol, rtol) on dq, dk, dv; f32 sums of up to 512
# terms in another order (a fully masked padding sample has P = exp(s -
# lse) ~ 1 on every key, so its sums reach ~10); bf16 adds one rounding of
# P or dS to bf16 (an ulp is 2^-8 relative) flipped by that order.
FWD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 1e-3)}
BWD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 1.6e-2)}
# Kernels the backward launches a call, by path (csrc/attention_bwd.cu):
# bf16 one fused launch at Sq, Sk <= 128 and dQ then dK/dV beyond; f32 dQ
# then dK/dV at every length.
BWD_LAUNCHES = {"bfloat16, S <= 128": 1, "bfloat16, S > 128": 2,
                "float32": 2}
MLM_SHAPE = (64, 128, 12, 64)        # corpus MLM: batch 64, f32
# The f32 train steps held card vs CPU (phases 6, 8) run their encoders at
# this depth, full width: the CPU side of a full-depth step costs more host
# time than the whole-script budget leaves.  (Phase 10's fusion flagships
# keep 12 layers: at 4 the cross-modal one failed its train-mode check,
# the fusion output after BatchNorm over 8 memes.)
CARD_VS_CPU_LAYERS = 4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def graph_ms(torch, fn, reps: int = 20, trials: int = 5,
             stream=None) -> float:
    """Median device time of ``fn`` in ms: ``reps`` calls captured in a CUDA
    graph, replayed ``trials`` times between CUDA events (the host's
    per-call overhead is not in the number).  ``stream``: warm up and
    capture on it (a backward alone must run on its forward's stream)."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def kernel_name(line: str) -> str:
    """``attention_bwd_fused_kernel<64>`` or ``..._f32_kernel<64, true>``
    from a line naming a mangled kernel (the name follows its length, the
    template arguments ILi64E and Lb1E)."""
    m = re.search(r"\d((?:attention|image)_[a-z0-9_]*?kernel)"
                  r"(?:ILi(\d+)E(?:Lb([01])E)?)?", line)
    if not m:
        return line.strip()[-60:]
    args = [a for a in (m.group(2), {"0": "false", "1": "true"}.get(
        m.group(3) or "")) if a]
    return m.group(1) + (f"<{', '.join(args)}>" if args else "")


def tensor_core_instructions(lib_path: str):
    """(HMMA and HGMMA, all) SASS instructions per kernel of the library,
    or None where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, kernel = {}, "?"
    for line in sass.splitlines():
        if "Function : " in line:
            kernel = kernel_name(line)
            counts[kernel] = [0, 0]
        elif kernel in counts and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[kernel][1] += 1
            counts[kernel][0] += bool(re.search(r"\bHG?MMA\.", line))
    return counts


def attention_inputs(torch, shape, mode, dtype, gen, sk=None):
    B, Sq, H, D = shape
    Sk = sk or Sq
    q = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, Sk, H, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, Sk, H, D, device="cuda", generator=gen).to(dtype)
    if mode == "padding":
        lens = torch.randint(1, Sk + 1, (B,), device="cuda", generator=gen)
        lens[3] = 0                                  # a fully masked sample
        mask = (torch.arange(Sk, device="cuda")[None] < lens[:, None]).float()
    elif mode == "segments":
        mask = torch.randint(1, 5, (B, Sk), device="cuda", generator=gen)
        mask = torch.sort(mask, dim=1).values.float()
        mask[:, Sk - Sk // 4:] = 0                   # padding: id 0 rows
    else:
        mask = None
    return q, k, v, mask


def attention_bound_ms(q, k, mode) -> tuple:
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    item = q.element_size()
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * H * D) * item + B * H * Sq * 4
    if mode != "none":
        nbytes += B * Sk * 4
    flops = 4 * B * H * Sq * Sk * D
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def check_forward(A, q, k, v, mask, mode, out, lse, tag) -> float:
    """Hold the forward kernel's ``out`` and ``lse`` against the plain
    version on the same inputs (``FWD_TOL``); returns max |out - plain|."""
    ref_out, ref_lse = A.attention_forward_reference(q, k, v, mask, mode)
    atol, lse_atol = FWD_TOL[dtype_name(q.dtype)]
    err = (out.float() - ref_out.float()).abs().max().item()
    lerr = (lse - ref_lse).abs().max().item()
    print(f"  attention_fwd {tag}: max|out-plain| {err:.3g} (tol {atol}), "
          f"max|lse-plain| {lerr:.3g} (tol {lse_atol})")
    check(bool(out.float().isfinite().all()), f"{tag}: non-finite")
    check(err <= atol and lerr <= lse_atol,
          f"{tag}: kernel disagrees with the plain version")
    return err


def check_backward(A, q, k, v, mask, mode, out, lse, do, got, tag) -> float:
    """Hold the backward kernel's ``got = (dq, dk, dv)`` against the plain
    version on the same inputs (``BWD_TOL``); returns the largest max
    |difference|."""
    want = A.attention_backward_reference(q, k, v, mask, mode, out, lse, do)
    atol, rtol = BWD_TOL[dtype_name(q.dtype)]
    errs = []
    for g_name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, ok = within(g, w, atol, rtol)
        errs.append(err)
        check(bool(g.float().isfinite().all()), f"{tag}: non-finite {g_name}")
        check(ok, f"{tag}: {g_name} disagrees with the plain version "
                  f"(max |diff| {err:.3g})")
    print(f"  attention_bwd {tag}: max|dq,dk,dv - plain| {max(errs):.3g} "
          f"(tol {atol} + {rtol}|plain|)")
    return max(errs)


def phase_kernels(torch):
    """Attention kernel vs plain version on the card; timings."""
    import torch.nn.functional as F
    from mpmc_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (name, shape, mode, Sk override); the main paths' shapes, then the
    # long buckets of real manifests (several key blocks), D = 128 and a
    # ragged D = 8 case.
    cases = [("text", TEXT_SHAPE, "padding", None),
             ("caption", CAPTION_SHAPE, "padding", None),
             ("packed-text", TEXT_SHAPE, "segments", None),
             ("cross", TEXT_SHAPE, "none", CAPTION_SHAPE[1])] + LONG_CASES
    timed = {}
    err_main = 0.0
    for name, shape, mode, sk in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(torch, shape, mode, dtype, gen, sk)
            out, lse = A.attention_forward_cuda(q, k, v, mask, mode)
            torch.cuda.synchronize()
            tag = f"{name} {mode} {tuple(q.shape)}x{k.shape[1]} {dtype}"
            err = check_forward(A, q, k, v, mask, mode, out, lse, tag)
            if name in ("text", "caption") and dtype == torch.bfloat16:
                err_main = max(err_main, err)
                timed[name] = (q, k, v, mask)
    results = {}
    for name, (q, k, v, mask) in timed.items():
        bias = ((1.0 - mask) * -1e9).to(q.dtype)[:, None, None, :]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = graph_ms(torch, lambda: A.attention_forward_cuda(q, k, v, mask,
                                                              "padding"))
        plain_ms = graph_ms(torch, lambda: A.attention_forward_reference(
            q, k, v, mask, "padding"))
        library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias))
        bound_ms, bound_by = attention_bound_ms(q, k, "padding")
        results[name] = dict(shape=list(q.shape), dtype=str(q.dtype),
                             ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"  attention_fwd {name} {tuple(q.shape)} bf16 padding: kernel "
              f"{ms:.5f} ms, plain {plain_ms:.5f} ms, sdpa {library_ms:.5f} "
              f"ms, bound {bound_ms:.5f} ms ({bound_by})")
    return results, err_main


def write_png(path: str, img) -> None:
    """uint8 ``[H, W, 3]`` as an RGB PNG, written with the standard
    library's ``zlib`` (filter 0 on every row)."""
    import struct
    import zlib
    import numpy as np
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + chunk(b"IEND", b""))


def meme_pixels(rng):
    """A meme-sized image, 240 to 400 pixels a side: a smooth two-colour
    gradient, a few flat text-like bars, and a little noise."""
    import numpy as np
    h, w = (int(x) for x in rng.integers(240, 401, 2))
    yy = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    a, b = rng.integers(0, 256, (2, 3)).astype(np.float32)
    img = a * (1 - xx * yy) + b * xx
    for _ in range(int(rng.integers(2, 6))):
        y0, x0 = int(rng.integers(0, h - 20)), int(rng.integers(0, w // 2))
        img[y0:y0 + 18, x0:x0 + int(rng.integers(40, w // 2))] = (
            rng.integers(0, 256, 3))
    img += rng.integers(-4, 5, img.shape, dtype=np.int8)
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic_manifest(path: str, n: int, seed: int = 0,
                       labelled: bool = False, first_id: int = 0,
                       pool: int = 0, images: bool = False) -> None:
    """Arabic texts of 3..110 words (the text bucket is 128 tokens).
    ``images``: each meme's image is written as a PNG next to the manifest
    (``memes/img_<k>.png``, decoded by the native path); otherwise the image
    files are missing and decode substitutes synthetic pixels.
    ``labelled``: about a third are propaganda.  ``pool``: words drawn from
    one list of that many words (the same for every manifest), so a dev
    manifest shares the train manifest's vocabulary, as real splits do."""
    import numpy as np
    rng = np.random.default_rng(seed)
    pixels = np.random.default_rng(seed + 1000)
    letters = list(ARABIC_LETTERS)

    def word(r):
        return "".join(r.choice(letters, int(r.integers(2, 7))))

    pool_rng = np.random.default_rng(12345)
    words_pool = [word(pool_rng) for _ in range(pool)]
    rows, pngs = [], []
    for i in range(n):
        n_words = 110 if i == 0 else int(rng.integers(3, 60))
        words = ([words_pool[j] for j in rng.integers(0, pool, n_words)]
                 if pool else [word(rng) for _ in range(n_words)])
        name = f"memes/img_{first_id + i}." + ("png" if images else "jpg")
        rows.append({"id": name, "img_path": name, "text": " ".join(words)})
        if images:
            pngs.append((os.path.join(os.path.dirname(path), name),
                         meme_pixels(pixels)))
        if labelled:
            rows[-1]["class_label"] = ("propaganda" if rng.random() < 0.35
                                       else "not_propaganda")
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(8) as pool_:    # zlib releases the GIL
        list(pool_.map(lambda a: write_png(*a), pngs))
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


@contextlib.contextmanager
def decoded_by(backend: str, n: int, what: str):
    """Zero ``image.decode``'s backend counts, run the block, then check
    that ``backend`` decoded exactly ``n`` images and no other backend ran;
    print the counts either way."""
    from mpmc_tpu_torch.image import decode
    for key in decode.backend_counts:
        decode.backend_counts[key] = 0
    yield
    counts = dict(decode.backend_counts)
    print(f"  {what}: images decoded by backend {counts}")
    check(counts == {**{k: 0 for k in counts}, backend: n},
          f"{what}: expected {n} images decoded by the {backend} path, got "
          f"{counts}")


def phase_predict(torch, work: str):
    """Full-width predict through the command line, with launch counts."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import attention as A
    manifest = os.path.join(work, "memes.json")
    synthetic_manifest(manifest, N_MEMES, images=True)
    out, probs_out = (os.path.join(work, n) for n in ("pred.tsv", "probs.tsv"))
    argv = ["predict", "--subtask", "2c", "--manifest", manifest, "--out",
            out, "--probs-out", probs_out, "--image-root", work,
            "--batch-size", str(BATCH), "--device", "cuda"]
    for key in A.launch_counts:
        A.launch_counts[key] = 0
    t0 = time.perf_counter()
    with decoded_by("native", N_MEMES, "predict"):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(A.launch_counts)
    n_batches = math.ceil(N_MEMES / BATCH)
    check(rc == 0, f"predict returned {rc}")
    check(launches["attention_fwd"] == 24 * n_batches,
          f"attention_fwd launched {launches['attention_fwd']} times, "
          f"expected 24 x {n_batches} batches")
    with open(probs_out) as f:
        next(f)
        probs = [float(line.split("\t")[2]) for line in f]
    check(len(probs) == N_MEMES and all(math.isfinite(p) for p in probs),
          "predict wrote non-finite or missing probabilities")
    check(0.0 <= min(probs) and max(probs) <= 1.0, "probs outside [0, 1]")
    check(check_format(out), "the label TSV fails check_format")
    print(f"  predict --subtask 2c, {N_MEMES} memes, batch {BATCH}, bf16: "
          f"rc 0, {wall:.3f} s wall (model build and first-call set-up "
          f"included), attention_fwd launches {launches['attention_fwd']} = "
          f"24 x {n_batches}, probs in [{min(probs):.4f}, {max(probs):.4f}], "
          f"TSV passes check_format")
    return argv, launches


def warm_eval(torch, argv):
    """The eval pass of a ``predict`` command line again on a warm model:
    (memes/s, median of 3 passes after one untimed; the prepared inputs;
    the step)."""
    from mpmc_tpu_torch.cli.main import build_parser, load_model, prepare_inputs
    from mpmc_tpu_torch.config import TrainConfig
    from mpmc_tpu_torch.train.loop import run_eval
    from mpmc_tpu_torch.train.step import make_eval_step
    args = build_parser().parse_args(argv)
    inputs = prepare_inputs(args)
    cfg = TrainConfig(bf16=True)
    model = load_model(args, inputs.variant, torch.device("cuda"), cfg.seed)
    step = make_eval_step(model, cfg, grayscale=inputs.variant.grayscale)
    run_eval(step, inputs.data, BATCH, torch.device("cuda"))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_eval(step, inputs.data, BATCH, torch.device("cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return N_MEMES / sorted(times)[1], inputs, step


def profile_pass(torch, step, data, top: int):
    """Where the device time of one warm eval pass goes: wall and kernel
    ms, and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    from mpmc_tpu_torch.train.loop import run_eval
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_eval(step, data, BATCH, torch.device("cuda"))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"  profiled pass: {wall_us / 1e3:.3f} ms wall, kernels "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} % of wall; "
          f"device idle otherwise, counting no overlap) in "
          f"{sum(e.count for e in events)} launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3


def phase_warm_eval(torch, argv):
    """The 2C eval pass again on a warm model: memes/s of the serving loop,
    and a device profile of one pass."""
    memes_s, inputs, step = warm_eval(torch, argv)
    print(f"  warm eval pass: {N_MEMES} memes at {memes_s:.2f} memes/s "
          f"(median of 3), text {inputs.data['text_ids'].shape}, "
          f"caption {inputs.data['caption_ids'].shape}")
    profile_pass(torch, step, inputs.data, 10)
    check(inputs.data["text_ids"].shape[1] == TEXT_SHAPE[1]
          and inputs.data["caption_ids"].shape[1] == CAPTION_SHAPE[1],
          "bucket lengths differ from the path's shapes")
    return inputs


def phase_card_vs_cpu(torch, inputs):
    """One full-width batch in f32 on the card (kernel) and the CPU (plain
    path), same weights; TF32 off for matmuls and convolutions."""
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = {k: torch.from_numpy(v[:BATCH]) for k, v in inputs.data.items()}
    gpu = build_model(inputs.variant.model_cfg, torch.device("cuda"), seed=7)
    cpu = build_model(inputs.variant.model_cfg, torch.device("cpu"))
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})

    # The random head gives logits of order 1e-4 (the softmax gate over
    # 1536 features shrinks them), so the branch outputs, of order 1, are
    # compared as well.
    stages = ("text_model", "image_model", "caption_text_model", "fusion")

    def run(model, device):
        seen = {}
        hooks = [getattr(model, name).register_forward_hook(
            lambda mod, inp, out, name=name: seen.__setitem__(
                name, out.float().cpu())) for name in stages]
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.inference_mode():
            seen["logits"] = model(b["text_ids"], b["text_mask"],
                                   eval_preprocess(b["image"]),
                                   b["caption_ids"],
                                   b["caption_mask"]).float().cpu()
        for h in hooks:
            h.remove()
        return seen

    before = A.launch_counts["attention_fwd"]
    on_card = run(gpu, "cuda")
    check(A.launch_counts["attention_fwd"] - before == 24,
          "the f32 card forward did not launch the kernel 24 times")
    on_cpu = run(cpu, "cpu")
    for name in stages + ("logits",):
        err = (on_card[name] - on_cpu[name]).abs().max().item()
        scale = on_cpu[name].abs().max().item()
        print(f"  f32 {name} {tuple(on_cpu[name].shape)}, card vs CPU: max "
              f"abs diff {err:.3g} (tol 1e-3 and 1e-3 of max |x| = "
              f"{scale:.3g})")
        check(bool(torch.isfinite(on_card[name]).all()),
              f"non-finite {name} on the card")
        check(err <= 1e-3 and err <= 1e-3 * scale,
              f"card and CPU disagree in f32 on {name}")


def within(got, want, atol: float, rtol: float):
    """``(max |got - want|, all |got - want| <= atol + rtol * |want|)``."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), bool((d <= atol + rtol * want.float().abs()).all())


def backward_bound_ms(q, k, mode) -> tuple:
    """q, k, v, out, dO read and dq, dk, dv written in the input type, the
    f32 lse and the mask; 10 B H Sq Sk D operations."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    nbytes = ((4 * B * Sq * H * D + 4 * B * Sk * H * D) * q.element_size()
              + B * H * Sq * 4 + (B * Sk * 4 if mode != "none" else 0))
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = 10 * B * H * Sq * Sk * D / PEAK_FLOPS[str(q.dtype).split(".")[-1]]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sdpa_times(torch, q, k, v, bias, do):
    """SDPA with an additive bias on the port's inputs ([B,S,H,D] viewed as
    [B,H,S,D]): forward, backward alone (autograd.grad of a forward made
    outside the graph, retain_graph) and the forward+backward pair, ms."""
    import torch.nn.functional as F
    leaves = [x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v)]
    do_t = do.transpose(1, 2)
    fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        *leaves, attn_mask=bias))
    pair = graph_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(*leaves, attn_mask=bias), leaves,
        do_t))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
    bwd = graph_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do_t, retain_graph=True), stream=stream)
    return fwd, bwd, pair


def segment_bias(seg, dtype):
    """The kernels' segments-mode bias as a [B, 1, S, S] SDPA mask."""
    allow = (seg[:, :, None] == seg[:, None, :]) & (seg[:, None, :] > 0)
    return ((1.0 - allow.float()) * -1e9).to(dtype)[:, None]


def phase_kernels_bwd(torch):
    """Attention backward kernel vs plain version on the card, two runs
    bit-equal, one autograd round trip, and timings at the text and caption
    shapes beside SDPA's."""
    from mpmc_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [("text", TEXT_SHAPE, "padding", None),
             ("caption", CAPTION_SHAPE, "padding", None),
             ("packed-text", TEXT_SHAPE, "segments", None),
             ("packed-caption", CAPTION_SHAPE, "segments", None),
             ("cross", TEXT_SHAPE, "none", CAPTION_SHAPE[1])] + LONG_CASES
    err_main, timed = 0.0, {}
    for name, shape, mode, sk in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(torch, shape, mode, dtype, gen,
                                             sk)
            do = torch.randn(q.shape, device="cuda", generator=gen).to(dtype)
            out, lse = A.attention_forward_cuda(q, k, v, mask, mode)
            got = A.attention_backward_cuda(q, k, v, mask, mode, out, lse, do)
            again = A.attention_backward_cuda(q, k, v, mask, mode, out, lse,
                                              do)
            torch.cuda.synchronize()
            tag = f"{name} {mode} {tuple(q.shape)}x{k.shape[1]} {dtype}"
            err = check_backward(A, q, k, v, mask, mode, out, lse, do, got,
                                 tag)
            for g_name, g, g2 in zip(("dq", "dk", "dv"), got, again):
                check(torch.equal(g, g2), f"{tag}: two runs of the backward "
                                          f"differ in {g_name}")
            print("    a second run bit-equal")
            if dtype == torch.bfloat16:
                err_main = max(err_main, err)
                if name in ("text", "caption"):
                    timed[name] = (q, k, v, mask, out, lse, do)
    # The f32 kernels at the MLM shape: two runs bit-equal.
    q, k, v, mask = attention_inputs(torch, MLM_SHAPE, "padding",
                                     torch.float32, gen)
    do = torch.randn(q.shape, device="cuda", generator=gen)
    out, lse = A.attention_forward_cuda(q, k, v, mask, "padding")
    runs = [A.attention_backward_cuda(q, k, v, mask, "padding", out, lse, do)
            for _ in range(2)]
    torch.cuda.synchronize()
    tag = f"mlm padding {tuple(q.shape)} {q.dtype}"
    check_backward(A, q, k, v, mask, "padding", out, lse, do, runs[0], tag)
    check(all(torch.equal(a, b) for a, b in zip(*runs)),
          f"{tag}: two runs of the backward differ")
    print("    a second run bit-equal")
    del q, k, v, mask, do, out, lse, runs
    # One autograd round trip through AttentionFunction.
    q, k, v, mask = attention_inputs(torch, TEXT_SHAPE, "segments",
                                     torch.bfloat16, gen)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = dict(A.launch_counts)
    A.dot_product_attention(q, k, v, segments=mask).sum().backward()
    torch.cuda.synchronize()
    check(A.launch_counts["attention_bwd"] == before["attention_bwd"] + 1
          and A.launch_counts["attention_fwd"] == before["attention_fwd"] + 1,
          "autograd did not go through the attention kernels once each")
    check(all(bool(torch.isfinite(x.grad.float()).all()) for x in (q, k, v)),
          "autograd round trip: non-finite gradients")
    print("  autograd through AttentionFunction: attention_fwd +1, "
          "attention_bwd +1, finite dq, dk, dv")

    results = {}
    for name, (q, k, v, mask, out, lse, do) in timed.items():
        ms = graph_ms(torch, lambda: A.attention_backward_cuda(
            q, k, v, mask, "padding", out, lse, do))
        plain_ms = graph_ms(torch, lambda: A.attention_backward_reference(
            q, k, v, mask, "padding", out, lse, do))
        # Forward + backward pairs through autograd, like with like: the
        # port's two kernels, and SDPA with the same additive bias.
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        pair_ms = graph_ms(torch, lambda: torch.autograd.grad(
            A.dot_product_attention(*leaves, mask), leaves, do))
        bias = ((1.0 - mask) * -1e9).to(q.dtype)[:, None, None, :]
        _, library_ms, library_pair_ms = sdpa_times(torch, q, k, v, bias, do)
        bound_ms, bound_by = backward_bound_ms(q, k, "padding")
        results[name] = dict(shape=list(q.shape), dtype=str(q.dtype),
                             ms=ms, plain_ms=plain_ms,
                             fwd_bwd_pair_ms=pair_ms,
                             library_ms=library_ms,
                             library="sdpa backward alone (autograd.grad of "
                                     "a forward outside the graph)",
                             library_pair_ms=library_pair_ms,
                             bound_ms=bound_ms, bound_by=bound_by)
        print(f"  attention_bwd {name} {tuple(q.shape)} bf16 padding: kernel "
              f"{ms:.5f} ms, sdpa backward alone {library_ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
              f"forward+backward: port {pair_ms:.5f} ms, sdpa "
              f"{library_pair_ms:.5f} ms")
    return results, err_main


def phase_image_kernel(torch, shape=IMAGE_SHAPE):
    """The fused image kernel vs its plain version at a train step's image
    shape, both flip values present; timings."""
    from mpmc_tpu_torch.ops import image_ops as I
    gen = torch.Generator(device="cuda").manual_seed(2)
    B = shape[0]
    u8 = torch.randint(0, 256, shape, device="cuda", generator=gen,
                       dtype=torch.uint8)
    flip = torch.arange(B, device="cuda") % 2 == 0
    bright = 0.9 + 0.2 * torch.rand(B, device="cuda", generator=gen)
    bright[0] = 1.1                                  # some pixels clip
    got = I.fused_normalize_flip_brightness_cuda(u8, flip, bright)
    torch.cuda.synchronize()
    want = I.fused_normalize_flip_brightness_reference(u8, flip, bright)
    # The same f32 operations in the same order (no FMA can form).
    err, ok = within(got, want, 1e-6, 0.0)
    check(ok, f"image_normalize disagrees with the plain version ({err:.3g})")
    ms = graph_ms(torch, lambda: I.fused_normalize_flip_brightness_cuda(
        u8, flip, bright))
    plain_ms = graph_ms(torch, lambda: (
        I.fused_normalize_flip_brightness_reference(u8, flip, bright)))
    n = u8.numel()
    t_bytes, t_ops = 5 * n / PEAK_BYTES_S, 5 * n / PEAK_FLOPS["float32"]
    bound_ms = max(t_bytes, t_ops) * 1e3
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  image_normalize {shape} uint8 -> f32, flips "
          f"{int(flip.sum())}/{B}: max|out-plain| {err:.3g} (tol 1e-6); "
          f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); no single PyTorch call computes "
          f"this function")
    return dict(shape=list(shape), dtype="uint8->float32", ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err)


def phase_train(torch, work: str):
    """Full-width 2C train through the command line, launch counts, TSVs,
    and predict from the checkpoint."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import build
    train_m, dev_m = (os.path.join(work, n) for n in ("train.json",
                                                      "dev.json"))
    synthetic_manifest(train_m, N_TRAIN, seed=1, labelled=True, pool=1500,
                       images=True)
    synthetic_manifest(dev_m, N_DEV, seed=2, labelled=True, first_id=10000,
                       pool=1500, images=True)
    out_dir, ckpt = os.path.join(work, "train_out"), os.path.join(work, "ck")
    argv = ["train", "--subtask", "2c", "-tr", train_m, "-te", dev_m,
            "--image-root", work, "--fold", "0", "--epochs", "1",
            "--checkpoint-dir", ckpt, "--out-dir", out_dir,
            "--scan-steps", str(SCAN_K), "--device", "cuda"]
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with decoded_by("native", N_TRAIN + N_DEV, "train --subtask 2c"):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train returned {rc}")
    with open(os.path.join(out_dir, "task2C_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    steps = len(metrics["steps"])
    check(steps == metrics["steps_per_epoch"] > 0, "steps missing")
    evals = len(metrics["evals"])
    eval_batches = evals * (math.ceil(metrics["n_test"] / BATCH)
                            + math.ceil(metrics["n_val"] / BATCH))
    want = {"attention_bwd": 24 * steps, "image_normalize": steps,
            "attention_fwd": 24 * steps + 24 * eval_batches}
    for key, n in want.items():
        check(launches[key] == n, f"{key} launched {launches[key]} times in "
                                  f"train, expected {n}")
    bad = [s for s in metrics["steps"]
           if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    check(not bad, f"non-finite loss or grad norm: {bad}")
    prefix = os.path.join(out_dir, "task2C_kevinmathew")
    check(check_format(prefix + ".tsv"), "the label TSV fails check_format")
    R, Rc = metrics["row_budgets"]
    print(f"  train --subtask 2c --fold 0 --epochs 1, {metrics['n_train']} "
          f"train / {metrics['n_val']} val / {metrics['n_test']} test memes, "
          f"batch {BATCH}, bf16, fast recipe: rc 0, {wall:.3f} s wall (model "
          f"build, {evals} evals and first-call set-up included)")
    print(f"  {steps} steps, packed rows R={R} (text) and Rc={Rc} (caption); "
          f"losses "
          f"{[round(s['loss'], 5) for s in metrics['steps']]}, grad norms "
          f"{[round(s['grad_norm'], 4) for s in metrics['steps']]}")
    print(f"  launches: attention_fwd {launches['attention_fwd']} = 24 x "
          f"{steps} steps + 24 x {eval_batches} eval batches, attention_bwd "
          f"{launches['attention_bwd']} = 24 x {steps}, image_normalize "
          f"{launches['image_normalize']} = {steps}; TSVs pass check_format")

    # predict on the best checkpoint reproduces the best eval's probs.
    pred_out, pred_probs = (os.path.join(work, n) for n in ("tp.tsv",
                                                            "tpp.tsv"))
    check(cli_main(["predict", "--subtask", "2c", "--manifest", dev_m,
                    "--checkpoint", os.path.join(ckpt, "fold_0"),
                    "--image-root", work, "--out", pred_out, "--probs-out",
                    pred_probs, "--device", "cuda"]) == 0, "predict failed")
    got, best = (read_probs(p) for p in (pred_probs,
                                         prefix + "_probs_fold_0.tsv"))
    err = max(abs(a - b) for a, b in zip(got, best))
    # The same bf16 weights, inputs and kernels on the same card.
    check(len(got) == len(best) == N_DEV and err <= 1e-4,
          f"predict from the checkpoint differs from the best eval by {err}")
    print(f"  predict --checkpoint on the dev manifest: max |prob - best "
          f"eval prob| {err:.3g} (tol 1e-4)")
    return argv, launches, (R, Rc)


def read_probs(path: str):
    with open(path) as f:
        next(f)
        return [float(line.split("\t")[2]) for line in f]


def _fold0(torch, argv, bf16: bool, dropout_zero: bool, device, augment=None,
           layers=None, vocab=None):
    """Fold 0 of a phase 5 (2C), phase 8 (2A) or phase 9 (2B) run rebuilt
    from its command line: prepared data, the epoch's batches (host arrays:
    the plan's packed batches, or unpacked the shuffled row indices), and
    the fold's model and steps (weights from the run's seed).  ``layers``
    cuts the text and caption encoders to that depth (full width);
    ``vocab`` gives the text encoder that many embedding rows (a shape
    only: the token ids stay the corpus vocab's)."""
    import dataclasses
    import numpy as np
    from mpmc_tpu_torch.cli.experiments import (_select, build_fold,
                                                prepare_2a, prepare_2b,
                                                prepare_2c, resident_store)
    from mpmc_tpu_torch.cli.main import build_parser, train_config
    from mpmc_tpu_torch.cv.kfold import stratified_kfold
    from mpmc_tpu_torch.train.loop import batch_iter
    args = build_parser().parse_args(argv)
    cfg, _ = train_config(args)
    cfg = dataclasses.replace(cfg, checkpoint_dir=None)
    if args.subtask == "2b":
        prep, kind = prepare_2b(cfg), "image"
    else:
        prepare, kind = ((prepare_2a, "text") if args.subtask == "2a"
                         else (prepare_2c, "multimodal"))
        prep = prepare(cfg, tempfile.mkdtemp(dir=os.getcwd()))
    cfg = _cut_cfg(prep.cfg, bf16, dropout_zero, layers, vocab)
    tr_idx = stratified_kfold(prep.data["label"], cfg.data.num_folds,
                              cfg.data.fold_seed)[0][0]
    store = resident_store(cfg, prep.data, device)
    run = build_fold(cfg, _select(prep.data, tr_idx), tr_idx, store, device,
                     0, augment, kind)
    rng = np.random.default_rng(cfg.seed)
    it = (run.plan.epoch_iter(rng) if run.plan is not None else batch_iter(
        {"idx": tr_idx.astype(np.int64)}, cfg.data.batch_size, shuffle=True,
        rng=rng, with_valid=True))
    return cfg, run, [b for b, _ in it]


def _cut_cfg(cfg, bf16: bool, dropout_zero: bool, layers=None, vocab=None):
    """``cfg`` in bf16 or f32, with dropout 0 (``dropout_zero``), the text
    and caption encoders cut to ``layers`` (full width), and ``vocab``
    embedding rows for the text encoder (a shape only)."""
    import dataclasses
    cfg = dataclasses.replace(cfg, bf16=bf16)
    if vocab:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, text=dataclasses.replace(cfg.model.text,
                                                vocab_size=vocab)))
    if dropout_zero:
        m = cfg.model
        enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, dropout=0.0, text=dataclasses.replace(m.text, **enc),
            caption=m.caption and dataclasses.replace(m.caption, **enc),
            image=m.image and dataclasses.replace(m.image,
                                                  finetune_dropout=0.0)))
    if layers:
        m = cfg.model
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            m, text=dataclasses.replace(m.text, num_layers=layers),
            caption=m.caption and dataclasses.replace(m.caption,
                                                      num_layers=layers)))
    return cfg


def time_attention_at(torch, mask, mode: str, dtype, gen, what: str,
                      heads: int = 12, rows_seq=None, head_dim: int = 64):
    """The attention pair at one main-path shape ``[rows, S, heads,
    head_dim]``, ``mask`` the path's own key mask or segment ids (None in
    mode none, with ``rows_seq = (rows, S)``): forward and backward kernels
    held against their plain versions on the same inputs, then timed beside
    the plain versions, the autograd pair, and SDPA with the same additive
    bias (for segments a ``[B,1,S,S]`` bias from the ids; none in mode
    none)."""
    from mpmc_tpu_torch.ops import attention as A
    rows, S = rows_seq or mask.shape
    q, k, v, do = (torch.randn(rows, S, heads, head_dim, device="cuda",
                               generator=gen).to(dtype) for _ in range(4))
    out, lse = A.attention_forward_cuda(q, k, v, mask, mode)
    got = A.attention_backward_cuda(q, k, v, mask, mode, out, lse, do)
    torch.cuda.synchronize()
    tag = f"{what} {mode} {tuple(q.shape)} {dtype}"
    fwd_err = check_forward(A, q, k, v, mask, mode, out, lse, tag)
    bwd_err = check_backward(A, q, k, v, mask, mode, out, lse, do, got, tag)
    del got
    ms = graph_ms(torch, lambda: A.attention_backward_cuda(
        q, k, v, mask, mode, out, lse, do))
    fwd_ms = graph_ms(torch, lambda: A.attention_forward_cuda(
        q, k, v, mask, mode))
    plain_ms = graph_ms(torch, lambda: A.attention_backward_reference(
        q, k, v, mask, mode, out, lse, do))
    fwd_plain_ms = graph_ms(torch, lambda: A.attention_forward_reference(
        q, k, v, mask, mode))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    if mode == "segments":
        pair = lambda: torch.autograd.grad(A.dot_product_attention(  # noqa
            *leaves, segments=mask), leaves, do)
        bias = segment_bias(mask, dtype)
    else:
        pair = lambda: torch.autograd.grad(A.dot_product_attention(  # noqa
            *leaves, mask), leaves, do)
        bias = (None if mask is None
                else ((1.0 - mask) * -1e9).to(dtype)[:, None, None, :])
    pair_ms = graph_ms(torch, pair)
    sdpa_fwd, sdpa_bwd, sdpa_pair = sdpa_times(torch, q, k, v, bias, do)
    bound_ms, bound_by = backward_bound_ms(q, k, mode)
    fwd_bound_ms, _ = attention_bound_ms(q, k, mode)
    print(f"  attention at {what} [{rows},{S},{heads},{head_dim}] "
          f"{str(dtype)[6:]} {mode}: "
          f"backward {ms:.5f} ms (sdpa backward alone {sdpa_bwd:.5f}, plain "
          f"{plain_ms:.5f}, bound {bound_ms:.5f} {bound_by}), forward "
          f"{fwd_ms:.5f} ms (sdpa {sdpa_fwd:.5f}, plain {fwd_plain_ms:.5f}, "
          f"bound {fwd_bound_ms:.5f}), forward+backward {pair_ms:.5f} ms "
          f"(sdpa {sdpa_pair:.5f})")
    return dict(shape=[rows, S, heads, head_dim], mode=mode,
                dtype=str(dtype),
                max_abs_err=bwd_err, fwd_max_abs_err=fwd_err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                fwd_bound_ms=fwd_bound_ms, fwd_bwd_pair_ms=pair_ms,
                library_fwd_ms=sdpa_fwd, library_ms=sdpa_bwd,
                library_pair_ms=sdpa_pair)


def warm_steps(torch, run, batches, per_step: int, bwd_kernels: int = 1):
    """Warm train steps of a fold: ms per step (the first step excluded), a
    device-time profile by kernel of 3 steps (which must launch
    ``bwd_kernels`` backward kernels ``per_step`` times a step each: one at
    S <= 128, dQ and dK/dV beyond; none when ``per_step`` is 0) and a host
    profile of 3 more.  Returns the warm times, the profile's wall and
    kernel ms, and the batches on the card."""
    dev = torch.device("cuda")
    to_dev = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
              for b in batches]
    times = []
    for b in to_dev:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.train_step(b)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    warm = sorted(times[1:])
    rows = (f"packed row budgets {tuple(run.plan.row_budgets)}"
            if run.plan is not None else "unpacked")
    print(f"  warm train steps ({len(warm)} after the first, {rows}): median "
          f"{warm[len(warm) // 2]:.3f} ms/step, mean "
          f"{sum(warm) / len(warm):.3f} ms/step (first step "
          f"{times[0]:.3f} ms)")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in to_dev[1:4]:
            run.train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ours_us = sum(e.self_device_time_total for e in events
                  if "attention_" in e.key or "image_normalize" in e.key)
    print(f"  profiled 3 steps: {wall_us / 1e3:.3f} ms wall, kernels "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} % of wall; "
          f"device idle otherwise, counting no overlap) in "
          f"{sum(e.count for e in events)} launches; this port's kernels "
          f"{ours_us / 1e3:.3f} ms")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    ours = sorted((e for e in events if "attention_" in e.key
                   or "image_normalize" in e.key), key=lambda e: e.key)
    print("  this port's kernels in the profile (3 steps):")
    for e in ours:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:100]}")
    bwd = [(e.key, e.count) for e in ours if "attention_bwd" in e.key]
    want = bwd_kernels if per_step else 0
    check(len(bwd) == want and all(n == per_step * 3 for _, n in bwd),
          f"the backward should be {want} kernels launched {per_step} times "
          f"a step each, got {bwd}")
    # Where the host's time goes (Python's profiler, 3 more steps).
    import cProfile
    import pstats
    prof_py = cProfile.Profile()
    prof_py.enable()
    for b in to_dev[4:7]:
        run.train_step(b)
    torch.cuda.synchronize()
    prof_py.disable()
    stats = pstats.Stats(prof_py).stats
    total = max(v[3] for v in stats.values())
    print(f"  host profile of 3 more steps: {total * 1e3 / 3:.3f} ms/step; "
          f"most self time (ms per step, calls per step, function):")
    for (path, line, fn), v in sorted(stats.items(),
                                      key=lambda kv: -kv[1][2])[:10]:
        print(f"    {v[2] * 1e3 / 3:8.3f} ms  {v[1] // 3:6d}x  "
              f"{os.path.basename(path)}:{line}({fn})"[:110])
    return warm, wall_us / 1e3, busy_us / 1e3, to_dev


def phase_warm_train(torch, argv):
    """Warm train steps of the phase 5 configuration: K = 1 steps against
    K = ``SCAN_K`` group replays (``scan_turns``: ms per step, device
    profiles), and the backward kernel timed at the realized packed
    shapes."""
    cfg, run, batches = _fold0(torch, argv, bf16=True, dropout_zero=False,
                               device=torch.device("cuda"))
    turns = scan_turns(torch, run, batches)
    # The backward kernel at this run's packed shapes, real segment ids.
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = {}
    for name, prefix in (("text", "t"), ("caption", "c")):
        shapes[name] = time_attention_at(
            torch, torch.from_numpy(batches[1][f"{prefix}_segments"]).to(
                torch.device("cuda")).float(), "segments", torch.bfloat16, gen,
            f"the packed {name} shape")
    del run
    torch.cuda.empty_cache()
    return shapes, turns.pop("k1_ms"), turns


def scan_turns(torch, run, batches):
    """Warm steps of phase 5's fold: ``SCAN_K`` single steps (K = 1) and
    one replay of their group (K = ``SCAN_K``) on the same batches, in
    turns (1, K, K, 1, twice): ms per step; then a device profile of one
    single step and of one group (busy share, kernels by name, one
    ``cudaGraphLaunch`` a group; the single step must launch one backward
    kernel 24 times)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    group = {k: torch.from_numpy(np.stack([b[k] for b in batches[:SCAN_K]]))
             for k in batches[0]}
    singles = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in batches[:SCAN_K]]

    def one_k1():
        for b in singles:
            run.train_step({k: v.to(dev, non_blocking=True)
                            for k, v in b.items()})

    def one_k4():
        run.scan_train_step(group)

    # The timed turns train past the run's 8 steps: the optimizer's
    # tables must cover them before the capture.
    run.train_step.optimizer.ensure_steps(run.train_step.optimizer.count
                                          + 32 * SCAN_K)
    one_k4()                            # eager group, then the capture
    one_k1()
    times = {1: [], SCAN_K: []}
    for _ in range(2):
        for k, fn in ((1, one_k1), (SCAN_K, one_k4), (SCAN_K, one_k4),
                      (1, one_k1)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3 / SCAN_K)
    check(run.scan_train_step.replays >= 4, "the group did not replay")
    shares = {}
    # One single step at K = 1 (a profile of eager steps is costly to
    # read back), one group at K = 4.
    for k, fn in ((1, lambda: run.train_step(
            {n: v.to(dev, non_blocking=True) for n, v in singles[0].items()})),
                  (SCAN_K, one_k4)):
        steps = 1 if k == 1 else SCAN_K
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = prof.key_averages()
        cuda = [e for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA]
        ours = [e for e in cuda
                if "attention_" in e.key or "image_normalize" in e.key]
        busy = sum(e.self_device_time_total for e in cuda)
        shares[k] = dict(
            steps=steps, wall_ms=wall_us / 1e3, kernel_ms=busy / 1e3,
            busy_pct=100 * busy / wall_us, kernels=sum(e.count for e in cuda),
            graph_launches=sum(e.count for e in events
                               if e.key == "cudaGraphLaunch"),
            our_kernels_per_step=sum(e.count for e in ours) / steps)
        if k == 1:
            for e in sorted(cuda, key=lambda e: -e.self_device_time_total
                            )[:8] + ours:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms  "
                      f"{e.count:5d}x  {e.key[:90]}")
            bwd = [e.count for e in ours if "attention_bwd" in e.key]
            check(bwd == [24], f"the backward should be one kernel launched "
                               f"24 times a step, got {bwd}")
    check(shares[SCAN_K]["graph_launches"] == 1,
          f"the profiled group made {shares[SCAN_K]['graph_launches']} graph "
          f"launches")
    check(shares[SCAN_K]["our_kernels_per_step"]
          == shares[1]["our_kernels_per_step"] > 0,
          f"the profiles' kernels of this port a step differ: {shares}")
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    for k in (1, SCAN_K):
        print(f"  warm 2C step at K = {k}: median {med[k]:.3f} ms/step over "
              f"{len(times[k])} turns of {SCAN_K} steps; profiled "
              f"{shares[k]['steps']} steps: {shares[k]['wall_ms']:.3f} ms "
              f"wall, kernels {shares[k]['kernel_ms']:.3f} ms "
              f"({shares[k]['busy_pct']:.1f} % busy) in "
              f"{shares[k]['kernels']} kernels, "
              f"{shares[k]['graph_launches']} cudaGraphLaunch, this port's "
              f"kernels a step {shares[k]['our_kernels_per_step']:g}")
    return dict(warm_step_ms={str(k): v for k, v in med.items()},
                profile={str(k): v for k, v in shares.items()},
                k1_ms=sorted(times[1]))


def phase_train_card_vs_cpu(torch, argv):
    """One packed train step in f32 on the card (kernels) and the CPU
    (plain versions): same weights, batch and draws; dropout 0; TF32 off;
    the encoders cut to ``CARD_VS_CPU_LAYERS`` layers at full width.  A 2A
    command line (phase 8) has no image, so no draws and no batch
    statistics."""
    import numpy as np
    from mpmc_tpu_torch.image.augment import augment_with_draws
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    draws = (rng.random(BATCH) < 0.5,
             rng.uniform(0.9, 1.1, BATCH).astype(np.float32),
             (rng.uniform(-15, 15, BATCH) * math.pi / 180).astype(np.float32))
    seen = {}

    def hook(where):
        def augment(u8, generator):
            d = [torch.from_numpy(x).to(u8.device) for x in draws]
            seen[where] = augment_with_draws(u8, *d)
            return seen[where]
        return augment

    runs, metrics, init = {}, {}, None
    t0 = time.perf_counter()
    for where in ("cuda", "cpu"):
        dev = torch.device(where)
        cfg, run, batches = _fold0(torch, argv, bf16=False, dropout_zero=True,
                                   device=dev, augment=hook(where),
                                   layers=CARD_VS_CPU_LAYERS)
        if init is None:               # the card's weights, before its step
            init = {k: v.cpu().clone()
                    for k, v in run.model.state_dict().items()}
        else:
            run.model.load_state_dict(init)
        runs[where] = run
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
        m = run.train_step(batch)
        metrics[where] = {k: float(v) for k, v in m.items()}
    layers = [cfg.model.text.num_layers] + (
        [cfg.model.caption.num_layers] if seen else [])
    print(f"  encoders at {' + '.join(map(str, layers))} layers, packed row "
          f"budgets {tuple(runs['cpu'].plan.row_budgets)}, "
          f"{time.perf_counter() - t0:.1f} s for both sides")
    lc, lg = metrics["cpu"]["loss"], metrics["cuda"]["loss"]
    gc, gg = metrics["cpu"]["grad_norm"], metrics["cuda"]["grad_norm"]
    print(f"  loss card {lg:.8g} cpu {lc:.8g} (|diff| {abs(lg - lc):.3g}, tol "
          f"1e-4 relative); grad norm card {gg:.8g} cpu {gc:.8g} (rel diff "
          f"{abs(gg - gc) / gc:.3g}, tol 1e-3)")
    if seen:
        img_err, _ = within(seen["cuda"].cpu(), seen["cpu"], 0, 0)
        same = float((seen["cuda"].cpu() == seen["cpu"]).float().mean())
        print(f"  augmented image max |diff| {img_err:.3g} (tol 1.6e-2, one "
              f"bf16 ulp below 4), {100 * same:.3f} % identical")
        check(img_err <= 1.6e-2 and same >= 0.99,
              "augmented image: card and CPU disagree")
    gpu_sd = {k: v.cpu() for k, v in runs["cuda"].model.state_dict().items()}
    cpu_sd = runs["cpu"].model.state_dict()
    lr = runs["cpu"].train_step.optimizer.schedules["head"](0)
    # Adam moves each entry by about lr whatever its gradient's size, so an
    # entry whose gradient is at the f32 noise floor may step the other way
    # (at most 2 x 3.17 lr, Adam's bound); all others agree to a tenth of lr.
    p_max = s_max = 0.0
    off = count = 0
    for name, w in cpu_sd.items():
        d = (gpu_sd[name] - w).abs()
        if "running_" in name:
            s_max = max(s_max, d.max().item())
            continue
        p_max = max(p_max, d.max().item())
        off += int((d > 0.1 * lr).sum())
        count += d.numel()
    print(f"  after the step (lr {lr:.3g}): parameters max |diff| {p_max:.3g} "
          f"(bound {2 * 3.17 * lr:.3g}), {off} of {count} entries beyond "
          f"0.1 lr (tol 1 %); batch statistics max |diff| {s_max:.3g} "
          f"(tol 1e-5)")
    # The head's training-mode BatchNorm scales the logits to unit variance,
    # so the 1e-5-relative differences of two 12-layer f32 stacks summed in
    # other orders reach the loss undamped.
    check(abs(lg - lc) <= 1e-4 * abs(lc), "loss: card and CPU disagree")
    check(abs(gg - gc) <= 1e-3 * gc, "grad norm: card and CPU disagree")
    check(p_max <= 2 * 3.17 * lr and off <= 0.01 * count,
          "parameters after the step: card and CPU disagree")
    check(s_max <= 1e-5, "batch statistics: card and CPU disagree")
    del runs
    torch.cuda.empty_cache()


def tsv_rows(path: str):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t") for line in f]


@contextlib.contextmanager
def watch_stage(torch, module, stage: str, trainer_cls, record_splice,
                record_first=None, profiled: range = range(0),
                profiled_group=None):
    """While active, wrap a pretraining stage (``module.<stage>``), its
    ``trainer_cls.step``, ``GroupedSteps.__call__`` and
    ``apply_pretrained`` (the port's own functions, called as a run calls
    them) and record: each stage run and the launch counts at its end,
    each eagerly run step's wall time (synchronized before and after; a
    step called while a graph is captured runs untimed), each of the
    stage's groups of K steps (``groups``: K, synchronized wall ms, and
    whether it was a graph replay), ``record_first`` of the first step's
    arguments, ``record_splice(model, kind, spec)`` after each splice
    (None is not kept), and a device profile of the eager steps in
    ``profiled`` or of group number ``profiled_group``."""
    from torch.profiler import ProfilerActivity, profile
    from mpmc_tpu_torch.models import pretrained as PT
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train import graphs
    seen = dict(runs=[], launches=None, step_ms=[], first=None, spliced=[],
                groups=[], profiled=profiled, in_stage=False,
                prof=profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]))
    run, step, splice, call = (getattr(module, stage), trainer_cls.step,
                               PT.apply_pretrained,
                               graphs.GroupedSteps.__call__)

    def ran(*args, **kwargs):
        seen["in_stage"] = True
        try:
            seen["runs"].append(run(*args, **kwargs))
        finally:
            seen["in_stage"] = False
        seen["launches"] = dict(build.launch_counts)
        return seen["runs"][-1]

    def timed(self, *args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            return step(self, *args, **kwargs)
        i = len(seen["step_ms"])
        if i == 0 and record_first is not None:
            seen["first"] = record_first(*args, **kwargs)
        if profiled and i == profiled[0]:
            seen["prof"].start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(self, *args, **kwargs)
        torch.cuda.synchronize()
        seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
        if profiled and i == profiled[-1]:
            seen["prof"].stop()
        return out

    def grouped(self, group):
        if not seen["in_stage"]:
            return call(self, group)
        i, replays = len(seen["groups"]), self.replays
        before = dict(build.launch_counts)
        if i == profiled_group:
            seen["prof"].start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, group)
        torch.cuda.synchronize()
        seen["groups"].append(dict(
            k=self.k, ms=(time.perf_counter() - t0) * 1e3,
            replay=self.replays > replays,
            launches={n: c - before[n]
                      for n, c in build.launch_counts.items()}))
        if i == profiled_group:
            seen["prof"].stop()
            seen["profiled_group_ms"] = seen["groups"][-1]["ms"]
        return out

    def spliced(model, kind, spec):
        out = splice(model, kind, spec)
        record = record_splice(model, kind, spec)
        if record is not None:
            seen["spliced"].append(record)
        return out

    setattr(module, stage, ran)
    trainer_cls.step, PT.apply_pretrained = timed, spliced
    graphs.GroupedSteps.__call__ = grouped
    try:
        yield seen
    finally:
        setattr(module, stage, run)
        trainer_cls.step, PT.apply_pretrained = step, splice
        graphs.GroupedSteps.__call__ = call


def replayed_steps(seen) -> int:
    """The steps of a ``watch_stage`` run that ran inside graph replays."""
    return sum(g["k"] for g in seen["groups"] if g["replay"])


def replay_step_ms(seen) -> list:
    """Each replayed group's wall ms a step."""
    return [g["ms"] / g["k"] for g in seen["groups"] if g["replay"]]


def median(xs) -> float:
    """The upper median of ``xs`` (NaN when empty)."""
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def replay_launches(seen) -> dict:
    """The kernel launches made inside a ``watch_stage`` run's replays."""
    out = {}
    for g in seen["groups"]:
        for name, n in g["launches"].items():
            out[name] = out.get(name, 0) + (n if g["replay"] else 0)
    return out


def watch_mlm(torch, profiled: range = range(0), profiled_group=None):
    """``watch_stage`` over corpus MLM: ``first`` is the first step's key
    mask or segment ids, ``spliced`` the text checkpoint of each splice."""
    from mpmc_tpu_torch.train import pretrain as P
    return watch_stage(
        torch, P, "pretrain_and_save", P.MLMTrainer,
        lambda model, kind, spec: spec and spec.text,
        lambda ids, mask, sel, inp, segments=None, positions=None: (
            mask if segments is None else segments).float(), profiled,
        profiled_group)


def watch_simclr(torch, profiled: range = range(0), profiled_group=None):
    """``watch_stage`` over SimCLR: ``spliced`` holds each image checkpoint
    a splice read with the backbone it left (on the CPU)."""
    from mpmc_tpu_torch.models.pretrained import IMAGE_SUBMODULE
    from mpmc_tpu_torch.train import pretrain_image as PI

    def record(model, kind, spec):
        if spec and spec.image:
            backbone = model.get_submodule(IMAGE_SUBMODULE[kind])
            return spec.image, {k: v.detach().cpu().clone()
                                for k, v in backbone.state_dict().items()}
        return None

    return watch_stage(torch, PI, "simclr_pretrain", PI.SimCLRTrainer,
                       record, profiled=profiled,
                       profiled_group=profiled_group)


def profiled_share(torch, seen, what: str):
    """The profiled steps of a ``watch_stage`` run: their wall ms, kernel
    ms, and the kernels of this port in them (name -> count)."""
    events = [e for e in seen["prof"].key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ours = {e.key: e.count for e in events
            if "attention_" in e.key or "image_normalize" in e.key}
    wall_ms = (seen["profiled_group_ms"] if "profiled_group_ms" in seen
               else sum(seen["step_ms"][i] for i in seen["profiled"]))
    names = {re.search(r"(?:attention|image)_[a-z0-9_]*kernel(?:<[^>]*>)?",
                       k).group(0): n for k, n in ours.items()}
    print(f"  {what}: {wall_ms:.3f} ms wall, kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} % of wall) in "
          f"{sum(e.count for e in events)} launches; this port's kernels "
          f"{names}; top:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return wall_ms, busy_ms, ours


def train_2a_cli(torch, work: str, name: str, flags, checkpoint=True):
    """``train --subtask 2a`` through the command line on phase 5's
    manifests (folds over train+dev, fold 0, one epoch, batch 16, bf16, the
    given ``flags``), launch counts zeroed before and read after.  Checks
    the launches (12 forward and 12 backward a step of the fine-tune and of
    its MLM stage, if any; 12 forward per eval batch, two eval passes per
    check since the val split is the test split too; no image kernel), the
    finite losses, the three TSVs and the labels at 0.5.  Returns the
    argv, the launches, the metrics, the best eval's probabilities by id,
    the MLM watch and the wall time."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import build
    out_dir = os.path.join(work, f"{name}_out")
    argv = ["train", "--subtask", "2a",
            "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--fold", "0", "--epochs",
            "1", "--out-dir", out_dir, "--device", "cuda"] + flags
    if checkpoint:
        argv += ["--checkpoint-dir", os.path.join(work, f"{name}_ck")]
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with watch_mlm(torch) as mlm:
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train --subtask 2a {' '.join(flags)} returned {rc}")
    with open(os.path.join(out_dir, "task2A_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    steps = len(metrics["steps"])
    check(steps == metrics["steps_per_epoch"] > 0, "steps missing")
    evals = len(metrics["evals"])
    eval_batches = evals * (math.ceil(metrics["n_test"] / BATCH)
                            + math.ceil(metrics["n_val"] / BATCH))
    mlm_steps = sum(r.steps for r in mlm["runs"])
    check(mlm_steps == len(mlm["step_ms"]) + replayed_steps(mlm),
          "MLM steps miscounted")
    want = {"attention_fwd": 12 * (mlm_steps + steps + eval_batches),
            "attention_bwd": 12 * (mlm_steps + steps), "image_normalize": 0}
    check(launches == want, f"2A train launches {launches}, expected {want}")
    if mlm["runs"]:
        want = {"attention_fwd": 12 * mlm_steps,
                "attention_bwd": 12 * mlm_steps, "image_normalize": 0}
        check(mlm["launches"] == want, f"MLM stage launches "
                                       f"{mlm['launches']}, expected {want}")
        check(all(math.isfinite(x) for r in mlm["runs"]
                  for x in r.epoch_losses), "non-finite MLM loss")
    bad = [s for s in metrics["steps"]
           if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    check(not bad, f"non-finite loss or grad norm: {bad}")
    prefix = os.path.join(out_dir, "task2A_kevinmathew")
    paths = [prefix + ".tsv", prefix + "_probs_fold_0.tsv",
             prefix + "_val_fold_0.tsv"]
    probs = {}
    for i, path in enumerate(paths):
        rows = tsv_rows(path)
        if i:
            # check_format takes 3 columns: the TSV without its probability.
            check(rows[0] == ["id", "label", "propaganda_probability",
                              "run_id"], f"{path}: header {rows[0]}")
            probs = {r[0]: float(r[2]) for r in rows[1:]}
            three = path + ".3col"
            with open(three, "w", encoding="utf-8") as f:
                f.writelines("\t".join(r[:2] + r[3:]) + "\n" for r in rows)
            path = three
        check(check_format(path), f"{path} fails check_format")
    labels = {r[0]: r[1] for r in tsv_rows(paths[0])[1:]}
    check(labels == {i: "propaganda" if p > 0.5 else "not_propaganda"
                     for i, p in probs.items()},
          "2A labels are not the probabilities at 0.5")
    rows = (f"{metrics['row_budgets'][0]} packed rows of 128, 4 a step"
            if metrics["row_budgets"] else "unpacked")
    label = " ".join(["train --subtask 2a"] + flags)
    print(f"  {label} --fold 0 --epochs 1, "
          f"{metrics['n_train']} train / {metrics['n_val']} val memes (folds "
          f"over train+dev), batch {BATCH}, bf16, {rows}: rc 0, {wall:.3f} s "
          f"wall (model build, {evals} evals and first-call set-up included)")
    print(f"  {steps} steps; losses "
          f"{[round(s['loss'], 5) for s in metrics['steps']]}")
    print(f"  launches: attention_fwd {launches['attention_fwd']} = 12 x "
          f"({mlm_steps} MLM steps + {steps} steps + {eval_batches} eval "
          f"batches, test and val passes), attention_bwd "
          f"{launches['attention_bwd']} = 12 x ({mlm_steps} + {steps}), "
          f"image_normalize 0; the three TSVs pass check_format, labels at "
          f"0.5")
    return argv, launches, metrics, probs, mlm, wall


def phase_train_2a(torch, work: str):
    """Full-width 2A train (fast recipe) through the command line on phase
    5's manifests, and predict from the checkpoint over the fold's val
    memes."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    argv, launches, _, probs, _, _ = train_2a_cli(
        torch, work, "train_2a", ["--scan-steps", str(SCAN_K)])
    # predict on the best checkpoint, over the fold's val memes (from both
    # manifests), reproduces the best eval's probabilities.
    records = {}
    for name in ("train.json", "dev.json"):
        with open(os.path.join(work, name), encoding="utf-8") as f:
            records.update({r["id"]: r for r in json.load(f)})
    val_m = os.path.join(work, "val_2a.json")
    with open(val_m, "w", encoding="utf-8") as f:
        json.dump([records[i] for i in probs], f, ensure_ascii=False)
    pred_out, pred_probs = (os.path.join(work, n) for n in ("p2a.tsv",
                                                            "pp2a.tsv"))
    check(cli_main(["predict", "--subtask", "2a", "--manifest", val_m,
                    "--checkpoint", os.path.join(work, "train_2a_ck",
                                                 "fold_0"),
                    "--out", pred_out, "--probs-out", pred_probs, "--device",
                    "cuda"]) == 0, "predict --subtask 2a failed")
    got = read_probs(pred_probs)
    err = max(abs(a - b) for a, b in zip(got, probs.values()))
    check(len(got) == len(probs) and err <= 1e-4,
          f"2A predict from the checkpoint differs from the best eval by "
          f"{err}")
    print(f"  predict --subtask 2a --checkpoint on the {len(got)} val memes: "
          f"max |prob - best eval prob| {err:.3g} (tol 1e-4)")
    return argv, launches


def phase_warm_train_2a(torch, argv):
    """Warm packed 2A steps: ms per step, device and host profiles, and the
    attention pair checked and timed at the realized packed shape."""
    cfg, run, batches = _fold0(torch, argv, bf16=True, dropout_zero=False,
                               device=torch.device("cuda"))
    warm, wall_ms, busy_ms, to_dev = warm_steps(torch, run, batches, 12)
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape = time_attention_at(torch, to_dev[1]["t_segments"].float(),
                              "segments", torch.bfloat16, gen,
                              "the packed 2A shape")
    del run, to_dev
    torch.cuda.empty_cache()
    return dict(warm_ms=warm, profiled_wall_ms=wall_ms,
                profiled_kernel_ms=busy_ms, shape=shape)


def phase_mlm(torch, argv):
    """``pretrain_and_save`` at full width, 1 epoch, unpacked, on the 2A
    corpus (train+dev texts and their character-noise copies, the 2A vocab
    and bucket length): launch counts, finite losses, the npz spliced into
    a ``TextClassifier`` on the card equal to the MLM encoder bit for bit,
    the run's own steps timed (its steps 2 and 3 profiled), and the
    attention pair checked and timed at the MLM shape (f32, padding) with
    the run's first key mask."""
    import dataclasses
    from mpmc_tpu_torch.cli.experiments import prepare_2a
    from mpmc_tpu_torch.cli.main import build_parser, train_config
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.models.pretrained import (PretrainedSpec,
                                                  apply_pretrained)
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train import pretrain as P
    cfg, _ = train_config(build_parser().parse_args(argv))
    out = tempfile.mkdtemp(dir=os.getcwd())
    prep = prepare_2a(dataclasses.replace(cfg, checkpoint_dir=None), out)
    path = os.path.join(out, "mlm_encoder.npz")
    seq_len = prep.data["text_ids"].shape[1]
    dev = torch.device("cuda")
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with watch_mlm(torch, profiled=range(2, 4)) as seen:
        run = P.pretrain_and_save(prep.cfg.model.text, prep.corpus, prep.tok,
                                  path, P.MLMConfig(epochs=1, seed=cfg.seed),
                                  max_len=seq_len, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    n = (P.MLMConfig().char_noise_copies + 1) * len(prep.corpus)
    want = {"attention_fwd": 12 * run.steps, "attention_bwd": 12 * run.steps,
            "image_normalize": 0}
    check(run.steps > 3 and launches == want,
          f"MLM launches {launches} in {run.steps} steps, expected {want}")
    check(all(math.isfinite(x) for x in run.epoch_losses),
          f"non-finite MLM loss {run.epoch_losses}")
    model = build_model(prep.cfg.model, dev, seed=cfg.seed, kind="text")
    apply_pretrained(model, "text", PretrainedSpec(text=path))
    mlm_sd = run.encoder.state_dict()
    spliced = model.encoder.state_dict()
    check(set(spliced) == set(mlm_sd)
          and all(torch.equal(spliced[k], mlm_sd[k]) for k in mlm_sd),
          "the spliced encoder differs from the MLM encoder")
    print(f"  pretrain_and_save, {n} texts ({len(prep.corpus)} and their "
          f"noisy copies) at {seq_len} tokens, batch 64, f32, 1 epoch: "
          f"{run.steps} steps (whole groups of {P.MLMConfig().scan_steps} of "
          f"{n // 64} batches) in {wall:.3f} s wall (set-up, tokenization, "
          f"a synchronization around each step and 2 profiled steps "
          f"included); loss {run.epoch_losses[0]:.4f}; launches "
          f"attention_fwd {launches['attention_fwd']} and attention_bwd "
          f"{launches['attention_bwd']} = 12 x {run.steps}; the npz spliced "
          f"into a TextClassifier on the card equals the MLM encoder bit for "
          f"bit ({len(mlm_sd)} tensors)")
    # The run's own steps: warm ones (the first and the profiled excluded),
    # and the device's share of the 2 profiled ones.
    step_ms = seen["step_ms"]
    warm = sorted(step_ms[1:2] + step_ms[4:])
    print(f"  its steps at [64,{seq_len}] f32: "
          f"{[round(t, 3) for t in step_ms]} ms; warm median "
          f"{warm[len(warm) // 2]:.3f} ms/step of {len(warm)}")
    wall_ms, busy_ms, _ = profiled_share(torch, seen,
                                         "MLM steps 2 and 3 profiled")
    gen = torch.Generator(device="cuda").manual_seed(7)
    shape = time_attention_at(torch, seen["first"], "padding", torch.float32,
                              gen, "the MLM shape")
    result = dict(steps=run.steps, wall_s=wall, loss=run.epoch_losses[0],
                  launches=launches, shape=shape, step_ms=step_ms,
                  warm_step_ms_median=warm[len(warm) // 2],
                  profiled_wall_ms=wall_ms, profiled_kernel_ms=busy_ms,
                  npz=path)
    del run, model, seen
    torch.cuda.empty_cache()
    return result


def phase_train_2a_more(torch, work: str, npz: str):
    """The other 2A train paths through the command line: ``--recipe
    reference`` (unpacked, device-resident) after a packed corpus MLM stage
    (``--mlm-epochs 2 --mlm-pack``, its npz spliced into the fine-tune), and
    the fast recipe from ``--text-params`` (phase 8 (d)'s npz); launches
    checked as in (a), the splices' files, and the attention pair checked
    and timed at the packed MLM shape (f32, segments)."""
    _, launches, metrics, _, mlm, wall = train_2a_cli(
        torch, work, "train_2a_ref", ["--recipe", "reference",
                                      "--mlm-epochs", "2", "--mlm-pack"])
    mlm_npz = os.path.join(work, "train_2a_ref_out", "mlm_encoder.npz")
    check(metrics["row_budgets"] is None, "the reference recipe packed rows")
    check(len(mlm["runs"]) == 1 and mlm["spliced"] == [mlm_npz],
          f"the MLM stage's npz was not spliced: {mlm['spliced']}")
    rows = mlm["first"].shape[0]
    check(bool((mlm["first"] > 1).any()),
          "the packed MLM stage ran no row with two segments")
    mlm_steps = mlm["runs"][0].steps
    print(f"  its packed MLM stage: {mlm_steps} steps of [{rows},"
          f"{mlm['first'].shape[1]}] rows (up to {int(mlm['first'].max())} "
          f"texts a row), losses {mlm['runs'][0].epoch_losses}, step ms "
          f"{[round(t, 3) for t in mlm['step_ms']]}; its npz spliced into the "
          f"fine-tune")
    gen = torch.Generator(device="cuda").manual_seed(8)
    shape = time_attention_at(torch, mlm["first"], "segments", torch.float32,
                              gen, "the packed MLM shape")
    mlm_launches = mlm["launches"]
    ref_launches = {k: launches[k] - mlm_launches[k] for k in launches}
    _, tp_launches, _, _, tp, _ = train_2a_cli(
        torch, work, "train_2a_tp", ["--text-params", npz])
    check(not tp["runs"] and tp["spliced"] == [npz],
          f"--text-params: spliced {tp['spliced']}, MLM runs {tp['runs']}")
    print(f"  --text-params {os.path.basename(npz)} (phase 8 (d)'s npz) "
          f"spliced into the fine-tune")
    torch.cuda.empty_cache()
    return dict(reference=dict(steps=len(metrics["steps"]), wall_s=wall,
                               launches=ref_launches),
                mlm_pack=dict(steps=mlm_steps, batch_rows=rows,
                              launches=mlm_launches,
                              step_ms=mlm["step_ms"], shape=shape),
                text_params=dict(launches=tp_launches))


# Phase 7: the other predict kinds at full width (name, flags, attention
# forward launches per batch: one per encoder layer).
OTHER_KINDS = [
    ("predict_2a", ["--subtask", "2a"], 12),
    ("predict_2b", ["--subtask", "2b"], 0),
    ("predict_2b_resnet50", ["--subtask", "2b", "--image-arch", "resnet50",
                             "--binary-head"], 0),
    ("predict_simple", ["--subtask", "2c", "--simple"], 6),
]
# Phase 7 (d): each new model class, card vs CPU in f32 on a few memes.
KIND_CHECKS = [
    ("TextClassifier (AraBERT-base shape, attention pooling)",
     ["--subtask", "2a"], 12),
    ("ImageClassifier (ResNet-18, Linear head)", ["--subtask", "2b"], 0),
    ("ImageClassifier (SE-ResNeXt-50 32x4d, BinaryHead)",
     ["--subtask", "2b", "--image-arch", "seresnext50_32x4d",
      "--binary-head"], 0),
    ("SimpleMultimodalClassifier (distilbert shape, ResNet-50 logits)",
     ["--subtask", "2c", "--simple"], 6),
]
KIND_MEMES = 3


def predict_argv(work: str, manifest: str, name: str, flags):
    out = os.path.join(work, f"{name}.tsv")
    probs_out = os.path.join(work, f"{name}_probs.tsv")
    return ["predict", *flags, "--manifest", manifest, "--out", out,
            "--probs-out", probs_out, "--image-root", work, "--batch-size",
            str(BATCH), "--device", "cuda", "--run-id", name]


def phase_other_kinds(torch, work: str):
    """``predict`` for 2A, 2B (ResNet-18; ResNet-50 with BinaryHead) and the
    simple 2C model through the command line on phase 3's manifest, every
    launch count zeroed before and read after; then the warm eval pass and
    its device profile."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import build
    manifest = os.path.join(work, "memes.json")
    n_batches = math.ceil(N_MEMES / BATCH)
    results = {}
    for name, flags, per_batch in OTHER_KINDS:
        argv = predict_argv(work, manifest, name, flags)
        for key in build.launch_counts:
            build.launch_counts[key] = 0
        t0 = time.perf_counter()
        rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(build.launch_counts)
        check(rc == 0, f"{name}: predict returned {rc}")
        check(launches == {"attention_fwd": per_batch * n_batches,
                           "attention_bwd": 0, "image_normalize": 0},
              f"{name}: launches {launches}, expected attention_fwd "
              f"{per_batch} x {n_batches} batches and nothing else")
        probs = read_probs(argv[argv.index("--probs-out") + 1])
        check(len(probs) == N_MEMES and all(0.0 <= p <= 1.0 for p in probs),
              f"{name}: missing, non-finite or out-of-range probabilities")
        check(check_format(argv[argv.index("--out") + 1]),
              f"{name}: the label TSV fails check_format")
        memes_s, inputs, step = warm_eval(torch, argv)
        shapes = {k: list(v.shape) for k, v in inputs.data.items()}
        print(f"  {name} ({' '.join(flags)}), {N_MEMES} memes, batch {BATCH}, "
              f"bf16: rc 0, {wall:.3f} s wall (model build and first-call "
              f"set-up included), attention_fwd launches "
              f"{launches['attention_fwd']} = {per_batch} x {n_batches}, "
              f"probs in [{min(probs):.4f}, {max(probs):.4f}], TSV passes "
              f"check_format; inputs {shapes}")
        print(f"  warm eval pass: {memes_s:.2f} memes/s (median of 3)")
        wall_ms, busy_ms = profile_pass(torch, step, inputs.data, 5)
        results[name] = dict(launches=launches["attention_fwd"],
                             memes_s=memes_s, wall_s=wall,
                             profiled_wall_ms=wall_ms,
                             profiled_kernel_ms=busy_ms,
                             probs=argv[argv.index("--probs-out") + 1],
                             labels=argv[argv.index("--out") + 1])
        del step, inputs
        torch.cuda.empty_cache()
    return results


def phase_kinds_card_vs_cpu(torch, work: str):
    """Each new model class at full width, same weights, on the card
    (kernels) and the CPU (plain versions) in f32 with TF32 off, on the
    first memes of phase 3's manifest: logits within 1e-4 of the largest
    CPU logit (and absolutely below 1)."""
    from mpmc_tpu_torch.cli.main import build_parser, prepare_inputs
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = os.path.join(work, "memes.json")
    for label, flags, launches in KIND_CHECKS:
        args = build_parser().parse_args(
            predict_argv(work, manifest, "cmp", flags))
        inputs = prepare_inputs(args)
        v = inputs.variant
        gpu = build_model(v.model_cfg, torch.device("cuda"), seed=7,
                          kind=v.kind, binary_head=v.binary_head)
        cpu = build_model(v.model_cfg, torch.device("cpu"), kind=v.kind,
                          binary_head=v.binary_head)
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
        batch = {k: torch.from_numpy(a[:KIND_MEMES])
                 for k, a in inputs.data.items()}

        def run(model, device):
            b = {k: t.to(device) for k, t in batch.items()}
            xs = [eval_preprocess(b["image"]) if key == "image" else b[key]
                  for key in model.inputs]
            with torch.inference_mode():
                return model(*xs).float().cpu()

        before = A.launch_counts["attention_fwd"]
        on_card = run(gpu, torch.device("cuda"))
        check(A.launch_counts["attention_fwd"] - before == launches,
              f"{label}: the card forward launched attention_fwd "
              f"{A.launch_counts['attention_fwd'] - before} times, expected "
              f"{launches}")
        on_cpu = run(cpu, torch.device("cpu"))
        err = (on_card - on_cpu).abs().max().item()
        scale = max(1.0, on_cpu.abs().max().item())
        print(f"  f32 {label}, logits {tuple(on_cpu.shape)}: card vs CPU max "
              f"abs diff {err:.3g} (tol 1e-4 x max(1, max |logit| = "
              f"{on_cpu.abs().max().item():.4g}))")
        check(bool(torch.isfinite(on_card).all()),
              f"{label}: non-finite logits on the card")
        check(err <= 1e-4 * scale, f"{label}: card and CPU disagree in f32")
        del gpu, cpu
        torch.cuda.empty_cache()


def _capture(cli_main, argv):
    """(rc, stdout) of one command of the port's command line."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    print("    " + buf.getvalue().strip().replace("\n", "\n    "))
    return rc, buf.getvalue()


def phase_submission(work: str, prob_files, label_files):
    """``combine`` over the probability TSVs this run wrote (family-balanced
    by run id, the threshold that maximizes macro-F1), then ``check`` and ``score`` against a synthetic labelled
    manifest of the same memes; the ensemble's labels and the score are
    recomputed here in plain numpy."""
    import numpy as np
    from mpmc_tpu_torch.cli.main import main as cli_main
    with open(os.path.join(work, "memes.json"), encoding="utf-8") as f:
        rows = json.load(f)
    rng = np.random.default_rng(5)
    for row in rows:
        row["class_label"] = ("propaganda" if rng.random() < 0.35
                              else "not_propaganda")
    gold = os.path.join(work, "gold.json")
    with open(gold, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    ens = os.path.join(work, "ensemble.tsv")
    rc, _ = _capture(cli_main, ["combine", "--files", *prob_files, "--gold",
                                gold, "--out", ens, "--group-by-run-id",
                                "--metric", "macro"])
    check(rc == 0, f"combine returned {rc}")
    rc, out = _capture(cli_main, ["check", "-p", ens, *label_files])
    check(rc == 0 and out.strip() == "OK", "check refused a TSV")
    rc, out = _capture(cli_main, ["score", "-g", gold, "-p", ens])
    check(rc == 0 and out.startswith("acc: "), f"score returned {rc}")
    f1 = float(out.strip().rsplit("F1:", 1)[1])

    # The same ensemble in plain numpy: family means, their mean, the
    # macro-F1 threshold scan over 100 points, labels at prob > t.
    y = np.array([r["class_label"] == "propaganda" for r in rows], int)
    ids = [r["id"] for r in rows]
    families = {}
    for path in prob_files:
        with open(path) as f:
            next(f)
            cols = [line.rstrip("\n").split("\t") for line in f]
        check([c[0] for c in cols] == ids, f"{path}: ids out of order")
        families.setdefault(cols[0][3], []).append(
            [float(c[2]) for c in cols])
    avg = np.mean([np.mean(m, axis=0) for m in families.values()], axis=0)

    def f1_of(pred, cls):
        tp = np.sum((pred == cls) & (y == cls))
        p, r = tp / max(np.sum(pred == cls), 1), tp / max(np.sum(y == cls), 1)
        return 2 * p * r / (p + r) if p + r else 0.0

    def macro_of(pred):
        return (f1_of(pred, 0) + f1_of(pred, 1)) / 2

    grid = np.linspace(0, 1, 100)
    t = grid[int(np.argmax([macro_of((avg > g).astype(int)) for g in grid]))]
    want = (avg > t).astype(int)
    with open(ens) as f:
        check(next(f) == "id\tlabel\trun_id\n", "ensemble TSV header")
        got = [line.rstrip("\n").split("\t") for line in f]
    check([g[0] for g in got] == ids
          and [g[1] == "propaganda" for g in got] == list(want.astype(bool))
          and all(g[2] == "ensemble" for g in got),
          "the ensemble's labels differ from the plain recomputation")
    macro = macro_of(want)
    check(abs(f1 - macro) <= 1e-12, f"score F1 {f1} != plain {macro}")
    print(f"  combine over {len(prob_files)} probability TSVs in "
          f"{len(families)} run-id families, threshold {t:.4f}: labels equal "
          f"the plain recomputation; check OK; score macro-F1 {f1} equals "
          f"the plain {macro}")


# Phase 9: full-width 2B train (name, flags, attention layers; launches of
# each attention kernel a step and per eval batch).
TRAIN_2B = [("train_2b_resnet18", [], 0),
            ("train_2b_vit", ["--image-arch", "vit_base_16", "--image-size",
                              "384"], 12)]
# ViT's attention shapes at batch 16, mode none: [16, 1 + (size/patch)^2,
# heads, 64] (name, rows, S, heads).
VIT_SHAPES = [("vit_b16_224", 16, 197, 12), ("vit_b32_224", 16, 50, 12),
              ("vit_b16_384", 16, 577, 12), ("vit_l16_384", 16, 577, 16)]
IMAGE_SHAPE_384 = (16, 384, 384, 3)  # the ViT run's image batch
# Each new backbone class at full width, card vs CPU in f32: (label, arch,
# image size, images, attention launches of one forward).
BACKBONE_CHECKS = [("ViT-B/32", "vit_base_32", 224, 3, 12),
                   ("ViT-L/16", "vit_large_16", 224, 1, 24),
                   ("EfficientNet-B3", "efficientnet_b3", 384, 3, 0),
                   ("ConvNeXt-Tiny", "convnext_tiny", 224, 3, 0)]


def phase_vit_kernels(torch):
    """The attention pair at ViT's shapes: in f32 held against the plain
    versions; in bf16 (the train path's type) held and then timed beside
    the plain versions and SDPA (no mask) by ``time_attention_at``.  Then
    the image kernel at the ViT run's 384-pixel batch."""
    from mpmc_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(9)
    fwd_err = bwd_err = 0.0
    for name, rows, S, heads in VIT_SHAPES:
        q, k, v, do = (torch.randn(rows, S, heads, 64, device="cuda",
                                   generator=gen) for _ in range(4))
        out, lse = A.attention_forward_cuda(q, k, v, None, "none")
        got = A.attention_backward_cuda(q, k, v, None, "none", out, lse, do)
        torch.cuda.synchronize()
        tag = f"{name} none {tuple(q.shape)} float32"
        fwd_err = max(fwd_err, check_forward(A, q, k, v, None, "none", out,
                                             lse, tag))
        bwd_err = max(bwd_err, check_backward(A, q, k, v, None, "none", out,
                                              lse, do, got, tag))
        del q, k, v, do, out, lse, got
    shapes = {}
    for name, rows, S, heads in VIT_SHAPES:
        shapes[name] = time_attention_at(torch, None, "none", torch.bfloat16,
                                         gen, name, heads, (rows, S))
    torch.cuda.empty_cache()
    image = phase_image_kernel(torch, IMAGE_SHAPE_384)
    return shapes, dict(fwd_max_abs_err=fwd_err, max_abs_err=bwd_err), image


def train_2b_cli(torch, work: str, name: str, flags, layers: int):
    """``train --subtask 2b`` through the command line on phase 5's
    manifests (folds over train, dev as the test split, fold 0, one epoch,
    batch 16, bf16), launch counts zeroed before and read after: the image
    kernel once a step, and ``layers`` attention launches a step (forward
    and backward) and per eval batch (forward; test and val passes).
    Checks the finite losses, no packing, and the two TSVs."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import build
    out_dir = os.path.join(work, f"{name}_out")
    argv = ["train", "--subtask", "2b",
            "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--image-root", work,
            "--fold", "0", "--epochs", "1",
            "--checkpoint-dir", os.path.join(work, f"{name}_ck"),
            "--out-dir", out_dir, "--device", "cuda"] + flags
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train --subtask 2b {' '.join(flags)} returned {rc}")
    with open(os.path.join(out_dir, "task2B_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    steps = len(metrics["steps"])
    check(steps == metrics["steps_per_epoch"] > 0, "steps missing")
    check(metrics["row_budgets"] is None, "2B packed its batches")
    evals = len(metrics["evals"])
    eval_batches = evals * (math.ceil(metrics["n_test"] / BATCH)
                            + math.ceil(metrics["n_val"] / BATCH))
    want = {"attention_fwd": layers * (steps + eval_batches),
            "attention_bwd": layers * steps, "image_normalize": steps}
    check(launches == want, f"{name} launches {launches}, expected {want}")
    bad = [s for s in metrics["steps"]
           if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    check(not bad, f"non-finite loss or grad norm: {bad}")
    prefix = os.path.join(out_dir, "task2B_kevinmathew")
    check(check_format(prefix + ".tsv"), "the 2B label TSV fails check_format")
    probs = read_probs(prefix + "_probs_fold_0.tsv")
    check(len(probs) == N_DEV and all(0.0 <= p <= 1.0 for p in probs),
          "2B probabilities missing or out of range")
    print(f"  train --subtask 2b {' '.join(flags)} --fold 0 --epochs 1, "
          f"{metrics['n_train']} train / {metrics['n_val']} val / "
          f"{metrics['n_test']} test memes, batch {BATCH}, bf16, unpacked: rc "
          f"0, {wall:.3f} s wall (model build, image decode, {evals} evals "
          f"and first-call set-up included)")
    print(f"  {steps} steps; losses "
          f"{[round(s['loss'], 5) for s in metrics['steps']]}, grad norms "
          f"{[round(s['grad_norm'], 4) for s in metrics['steps']]}")
    print(f"  launches: attention_fwd {launches['attention_fwd']} = {layers} "
          f"x ({steps} steps + {eval_batches} eval batches), attention_bwd "
          f"{launches['attention_bwd']} = {layers} x {steps}, image_normalize "
          f"{launches['image_normalize']} = {steps}; TSVs pass check_format")
    return argv, launches, wall, prefix + "_probs_fold_0.tsv"


def phase_train_2b(torch, work: str):
    """Full-width 2B train through the command line, ResNet-18 at 224 and
    ViT-B/16 at 384: launch counts, TSVs, ``predict --checkpoint`` from the
    ViT run reproducing its best eval, and warm steps with device and host
    profiles."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    results = {}
    for name, flags, layers in TRAIN_2B:
        argv, launches, wall, probs_tsv = train_2b_cli(torch, work, name,
                                                       flags, layers)
        if layers:
            pred_out, pred_probs = (os.path.join(work, n)
                                    for n in ("p2b.tsv", "pp2b.tsv"))
            check(cli_main(["predict", "--subtask", "2b", "--manifest",
                            os.path.join(work, "dev.json"), "--checkpoint",
                            os.path.join(work, f"{name}_ck", "fold_0"),
                            "--image-root", work, "--out", pred_out,
                            "--probs-out", pred_probs, "--device",
                            "cuda"]) == 0, "predict --subtask 2b failed")
            got, best = read_probs(pred_probs), read_probs(probs_tsv)
            err = max(abs(a - b) for a, b in zip(got, best))
            check(len(got) == len(best) == N_DEV and err <= 1e-4,
                  f"2B predict from the checkpoint differs from the best "
                  f"eval by {err}")
            print(f"  predict --subtask 2b --checkpoint (ViT-B/16 at 384 "
                  f"from run_meta.json) on the dev manifest: max |prob - "
                  f"best eval prob| {err:.3g} (tol 1e-4)")
        _, run, batches = _fold0(torch, argv, bf16=True, dropout_zero=False,
                                 device=torch.device("cuda"))
        warm, wall_ms, busy_ms, _ = warm_steps(torch, run, batches, layers,
                                               bwd_kernels=BWD_LAUNCHES[
                                                   "bfloat16, S > 128"])
        results[name] = dict(launches=launches, wall_s=wall,
                             warm_step_ms_median=warm[len(warm) // 2],
                             warm_steps=len(warm), profiled_wall_ms=wall_ms,
                             profiled_kernel_ms=busy_ms)
        del run, batches
        torch.cuda.empty_cache()
    return results


def phase_backbones_card_vs_cpu(torch):
    """Each new backbone class at full width inside ``ImageClassifier``,
    same weights, on the card (kernels) and the CPU (plain versions) in f32
    with TF32 off, on random images through ``eval_preprocess``, in train
    mode (BatchNorm on the batch statistics: with the initial running
    statistics EfficientNet's features all but vanish): the backbone's
    features and the logits within 1e-4 of max(1, their largest CPU
    value)."""
    from mpmc_tpu_torch.config import ImageEncoderConfig, ModelConfig
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(10)
    for label, arch, size, n, launches in BACKBONE_CHECKS:
        cfg = ModelConfig(num_classes=2, image=ImageEncoderConfig(
            arch=arch, image_size=size))
        gpu = build_model(cfg, torch.device("cuda"), seed=7, kind="image")
        cpu = build_model(cfg, torch.device("cpu"), kind="image")
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
        u8 = torch.randint(0, 256, (n, size, size, 3), generator=gen,
                           dtype=torch.uint8)

        def run(model, device):
            feats = {}
            hook = model.backbone.register_forward_hook(
                lambda mod, inp, out: feats.__setitem__("x", out.cpu()))
            with torch.no_grad():
                logits = model.train()(eval_preprocess(u8.to(device))).cpu()
            hook.remove()
            return feats["x"], logits

        t0 = time.perf_counter()
        before = A.launch_counts["attention_fwd"]
        on_card = run(gpu, torch.device("cuda"))
        check(A.launch_counts["attention_fwd"] - before == launches,
              f"{label}: the card forward launched attention_fwd "
              f"{A.launch_counts['attention_fwd'] - before} times, expected "
              f"{launches}")
        on_cpu = run(cpu, torch.device("cpu"))
        errs = []
        for what, g, c in zip(("features", "logits"), on_card, on_cpu):
            err = (g - c).abs().max().item()
            scale = max(1.0, c.abs().max().item())
            errs.append(f"{what} {tuple(c.shape)} {err:.3g} (tol 1e-4 x "
                        f"{scale:.4g})")
            check(bool(torch.isfinite(g).all()),
                  f"{label}: non-finite {what} on the card")
            check(err <= 1e-4 * scale,
                  f"{label}: card and CPU disagree in f32 on the {what}")
        print(f"  f32 {label} at {size}, {n} image(s), card vs CPU max abs "
              f"diff: {'; '.join(errs)}; attention_fwd launches {launches}; "
              f"{time.perf_counter() - t0:.1f} s")
        del gpu, cpu
        torch.cuda.empty_cache()


# Phase 10: SimCLR and the 2C training variants.  The image kernel at the
# SimCLR batch (64 images a view, two views a step) and at small_2c's 64
# pixels; the f32 attention pair at ViT-B/16's SimCLR batch (both views:
# 128 rows of 197 tokens), mode none.
SIMCLR_IMAGE_SHAPE = (64, 224, 224, 3)
SMALL_IMAGE_SHAPE = (16, 64, 64, 3)
SIMCLR_VIT_ROWS = 128
# Full-width train runs on phase 5's manifests (name, subtask, flags,
# attention launches a forward, image kernel launches a train step, the
# SimCLR steps to profile).  The 2C SimCLR run takes the MCA fusion, so one
# flagship run covers both.
TRAIN_VARIANTS = [
    ("train_2b_simclr", "2b", ["--simclr-epochs", "2"], 0, 1, range(1, 2)),
    ("train_2c_simclr_mca", "2c", ["--simclr-epochs", "1", "--fusion",
                                    "mca"], 24, 1, range(0)),
    ("train_2c_simple", "2c", ["--simple"], 6, 0, range(0)),
    ("train_2c_small", "2c", ["--small"], 4, 1, range(0)),
]
FUSION_CHECKS = ["cross_modal", "self_attention"]
# Train mode normalizes over the batch: 8 memes keep the statistics well
# conditioned.
FUSION_MEMES = 8
SIMCLR_CARD_VS_CPU_IMAGES = 4


def phase_simclr_kernels(torch):
    """The image kernel at the SimCLR batch and at small_2c's, and the f32
    attention pair at ViT-B/16's SimCLR batch, each held against its plain
    version and then timed beside its bound (and SDPA for the pair)."""
    image_simclr = phase_image_kernel(torch, SIMCLR_IMAGE_SHAPE)
    image_small = phase_image_kernel(torch, SMALL_IMAGE_SHAPE)
    gen = torch.Generator(device="cuda").manual_seed(12)
    vit = time_attention_at(torch, None, "none", torch.float32, gen,
                            "SimCLR ViT-B/16", 12, (SIMCLR_VIT_ROWS, 197))
    torch.cuda.empty_cache()
    return image_simclr, image_small, vit


def train_variant_cli(torch, work: str, name: str, subtask: str, flags,
                      layers: int, images_per_step: int, profiled):
    """``train --subtask 2b|2c`` through the command line on phase 5's
    manifests (fold 0, one epoch, batch 16, bf16, the given ``flags``),
    launch counts zeroed before and read after: ``layers`` attention
    launches a step (forward and backward) and per eval batch (forward),
    the image kernel ``images_per_step`` times a step and twice a SimCLR
    step.  Checks the SimCLR stage (its npz is the backbone the fold
    starts from, bit for bit), the finite losses, the TSVs, and that
    ``predict --checkpoint`` reproduces the best eval.  Returns the argv
    and the launches, the wall time, the steps and the SimCLR stage's
    numbers."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.models.convert import from_jax_variables
    from mpmc_tpu_torch.models.pretrained import read_image_params
    from mpmc_tpu_torch.ops import build
    out_dir = os.path.join(work, f"{name}_out")
    ckpt = os.path.join(work, f"{name}_ck")
    dev_m = os.path.join(work, "dev.json")
    argv = ["train", "--subtask", subtask,
            "-tr", os.path.join(work, "train.json"), "-te", dev_m,
            "--image-root", work, "--fold", "0", "--epochs", "1",
            "--checkpoint-dir", ckpt, "--out-dir", out_dir,
            "--device", "cuda"] + flags
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with watch_simclr(torch, profiled) as sim:
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    label = f"train --subtask {subtask} {' '.join(flags)}"
    check(rc == 0, f"{label} returned {rc}")
    task = "task2B" if subtask == "2b" else "task2C"
    with open(os.path.join(out_dir, f"{task}_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    steps = len(metrics["steps"])
    check(steps == metrics["steps_per_epoch"] > 0, f"{label}: steps missing")
    evals = len(metrics["evals"])
    eval_batches = evals * (math.ceil(metrics["n_test"] / BATCH)
                            + math.ceil(metrics["n_val"] / BATCH))
    simclr_steps = sum(r.steps for r in sim["runs"])
    check(simclr_steps == len(sim["step_ms"]) + replayed_steps(sim),
          "SimCLR steps miscounted")
    want = {"attention_fwd": layers * (steps + eval_batches),
            "attention_bwd": layers * steps,
            "image_normalize": images_per_step * steps + 2 * simclr_steps}
    check(launches == want, f"{label} launches {launches}, expected {want}")
    result = dict(launches=launches, wall_s=wall, steps=steps,
                  eval_batches=eval_batches, row_budgets=metrics["row_budgets"])
    if "--simclr-epochs" in flags:
        want = {"attention_fwd": 0, "attention_bwd": 0,
                "image_normalize": 2 * simclr_steps}
        check(len(sim["runs"]) == 1 and sim["launches"] == want,
              f"SimCLR stage launches {sim['launches']}, expected {want}")
        check(all(math.isfinite(x) for x in sim["runs"][0].epoch_losses),
              f"non-finite SimCLR loss {sim['runs'][0].epoch_losses}")
        npz = os.path.join(out_dir, "simclr_backbone.npz")
        check([p for p, _ in sim["spliced"]] == [npz],
              f"the fold did not start from the SimCLR npz: "
              f"{[p for p, _ in sim['spliced']]}")
        tree = read_image_params(npz)
        in_file = from_jax_variables(tree["params"], tree["batch_stats"])
        got = sim["spliced"][0][1]
        check(set(got) == set(in_file)
              and all(torch.equal(got[k], in_file[k]) for k in in_file),
              "the fold's initial backbone differs from the SimCLR npz")
        # Warm steps: the eager ones after the first (the profiled one
        # excluded), and each graph replay's ms a step.
        step_ms = sim["step_ms"]
        warm = sorted((step_ms[1:profiled.start] if profiled
                       else step_ms[1:]) + replay_step_ms(sim))
        result["simclr"] = dict(steps=simclr_steps, step_ms=step_ms,
                                replayed_steps=replayed_steps(sim),
                                loss=sim["runs"][0].epoch_losses,
                                warm_step_ms_median=(warm[len(warm) // 2]
                                                     if warm else None))
        print(f"  its SimCLR stage: {simclr_steps} steps at batch "
              f"{min(4 * BATCH, N_TRAIN)} (two views a step, f32; "
              f"{replayed_steps(sim)} of them in graph replays, "
              f"{[round(t, 3) for t in replay_step_ms(sim)]} ms a step), "
              f"eager step ms {[round(t, 3) for t in step_ms]}, losses "
              f"{sim['runs'][0].epoch_losses}; the fold's initial backbone "
              f"equals the npz bit for bit ({len(in_file)} tensors)")
        if profiled:
            wall_ms, busy_ms, _ = profiled_share(
                torch, sim, f"SimCLR step {profiled.start} (ResNet-18) "
                            f"profiled")
            result["simclr"].update(profiled_wall_ms=wall_ms,
                                    profiled_kernel_ms=busy_ms)
    bad = [s for s in metrics["steps"]
           if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    check(not bad, f"{label}: non-finite loss or grad norm: {bad}")
    prefix = os.path.join(out_dir, f"{task}_kevinmathew")
    check(check_format(prefix + ".tsv"), f"{label}: the TSV fails check_format")
    pred_out, pred_probs = (os.path.join(work, f"{name}_{n}")
                            for n in ("p.tsv", "pp.tsv"))
    check(cli_main(["predict", "--subtask", subtask, "--manifest", dev_m,
                    "--checkpoint", os.path.join(ckpt, "fold_0"),
                    "--image-root", work, "--out", pred_out, "--probs-out",
                    pred_probs, "--device", "cuda"]) == 0,
          f"predict after {label} failed")
    got, best = read_probs(pred_probs), read_probs(prefix + "_probs_fold_0.tsv")
    err = max(abs(a - b) for a, b in zip(got, best))
    check(len(got) == len(best) == N_DEV and err <= 1e-4,
          f"{label}: predict from the checkpoint differs from the best eval "
          f"by {err}")
    with open(os.path.join(ckpt, "run_meta.json")) as f:
        meta = json.load(f)
    rows = (f"packed row budgets {tuple(metrics['row_budgets'])}"
            if metrics["row_budgets"] else "unpacked")
    print(f"  {label} --fold 0 --epochs 1 ({meta['kind']} model, fusion "
          f"{meta['model']['fusion']}, {rows}): rc 0, {wall:.3f} s wall "
          f"(model build, image decode, {evals} evals and first-call set-up "
          f"included); {steps} steps, losses "
          f"{[round(s['loss'], 5) for s in metrics['steps']]}")
    print(f"  launches: attention_fwd {launches['attention_fwd']} = {layers} "
          f"x ({steps} steps + {eval_batches} eval batches), attention_bwd "
          f"{launches['attention_bwd']} = {layers} x {steps}, image_normalize "
          f"{launches['image_normalize']} = {images_per_step} x {steps} + 2 x "
          f"{simclr_steps} SimCLR steps; predict --checkpoint: max |prob - "
          f"best eval prob| {err:.3g} (tol 1e-4)")
    torch.cuda.empty_cache()
    return argv, result


def phase_simclr_vit(torch):
    """``simclr_pretrain`` over ViT-B/16 at 224 for two steps (64 images,
    batch 64, f32): launches (12 forward and 12 backward calls a step at
    ``[128,197,12,64]``, two f32 backward kernels a call; the image
    kernel twice a step), finite losses, the warm step's time and device
    share."""
    import numpy as np
    from mpmc_tpu_torch.config import ImageEncoderConfig
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train import pretrain_image as PI
    images = np.random.default_rng(11).integers(
        0, 256, (SIMCLR_VIT_ROWS // 2, 224, 224, 3), dtype=np.uint8)
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with watch_simclr(torch, profiled=range(1, 2)) as sim:
        run = PI.simclr_pretrain(
            ImageEncoderConfig(arch="vit_base_16", image_size=224), images,
            PI.SimCLRConfig(epochs=2, batch_size=SIMCLR_VIT_ROWS // 2),
            device=torch.device("cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    want = {"attention_fwd": 12 * run.steps, "attention_bwd": 12 * run.steps,
            "image_normalize": 2 * run.steps}
    check(run.steps == 2 and launches == want,
          f"ViT SimCLR launches {launches} in {run.steps} steps, expected "
          f"{want}")
    check(all(math.isfinite(x) for x in run.epoch_losses),
          f"non-finite ViT SimCLR loss {run.epoch_losses}")
    print(f"  simclr_pretrain ViT-B/16 at 224, 64 images, batch 64 (attention "
          f"at [128,197,12,64] f32), 2 epochs of 1 step: {wall:.3f} s wall "
          f"(model build included), step ms "
          f"{[round(t, 3) for t in sim['step_ms']]}, losses "
          f"{run.epoch_losses}; launches attention_fwd "
          f"{launches['attention_fwd']} and attention_bwd "
          f"{launches['attention_bwd']} = 12 x {run.steps}, image_normalize "
          f"{launches['image_normalize']} = 2 x {run.steps}")
    wall_ms, busy_ms, ours = profiled_share(
        torch, sim, "SimCLR step 1 (ViT-B/16) profiled")
    # The f32 backward: dQ then dK/dV, each once a call.
    bwd = [n for k, n in ours.items() if "attention_bwd" in k]
    want = BWD_LAUNCHES["float32"]
    check(len(bwd) == want and all(n == 12 for n in bwd),
          f"the f32 ViT backward should be {want} kernels launched 12 times "
          f"a step, got {ours}")
    del run, sim
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, step_ms=wall_ms,
                profiled_kernel_ms=busy_ms)


def phase_simclr_card_vs_cpu(torch):
    """Two SimCLR steps of ResNet-18 at 224 on a few images in f32 (TF32
    off), on the card (kernels) and the CPU (plain versions): the same
    weights, and the same two views (the card's, after holding them
    against the CPU's own from the same draws).  The first step runs at lr
    0 (warmup), the second at the peak: losses, BatchNorm statistics and
    parameters after both."""
    import numpy as np
    from mpmc_tpu_torch.config import ImageEncoderConfig
    from mpmc_tpu_torch.train import pretrain_image as PI
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = SIMCLR_CARD_VS_CPU_IMAGES
    cfg = PI.SimCLRConfig(batch_size=n)
    icfg = ImageEncoderConfig()
    rng = np.random.default_rng(13)
    u8 = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
    draws = [(rng.random(n) < 0.5, rng.uniform(0.9, 1.1, n).astype(np.float32),
              (rng.uniform(-15, 15, n) * math.pi / 180).astype(np.float32))
             for _ in range(2)]
    trainers, views, losses = {}, {}, {}
    for where in ("cuda", "cpu"):
        dev = torch.device(where)
        with torch.device(dev):
            model = PI.SimCLRModel(icfg, cfg.proj_dim)
        if where == "cuda":
            PI.init_weights(model, torch.Generator(device=dev).manual_seed(3))
            init = {k: v.cpu().clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        trainers[where] = PI.SimCLRTrainer(model, 2, cfg)
        views[where] = trainers[where].views(
            torch.from_numpy(u8).to(dev),
            *([torch.from_numpy(x).to(dev) for x in d] for d in draws))
    img_err, _ = within(views["cuda"].cpu(), views["cpu"], 0, 0)
    same = float((views["cuda"].cpu() == views["cpu"]).float().mean())
    check(img_err <= 1.6e-2 and same >= 0.99, "SimCLR views: card and CPU "
                                              "disagree")
    shared = {"cuda": views["cuda"], "cpu": views["cuda"].cpu()}
    for where, trainer in trainers.items():
        trainer.views = lambda *args, v=shared[where]: v
        dev = torch.device(where)
        u8_dev = torch.from_numpy(u8).to(dev)
        losses[where] = [float(trainer.step(u8_dev, None, None))
                         for _ in range(2)]
    lr = trainers["cpu"].optimizer.schedule(1)
    gpu_sd = {k: v.cpu() for k, v in trainers["cuda"].model.state_dict().items()}
    cpu_sd = trainers["cpu"].model.state_dict()
    p_max = s_max = 0.0
    off = count = 0
    for name, w in cpu_sd.items():
        d = (gpu_sd[name] - w).abs()
        if "running_" in name:
            s_max = max(s_max, d.max().item())
            continue
        p_max = max(p_max, d.max().item())
        off += int((d > 0.1 * lr).sum())
        count += d.numel()
    print(f"  two SimCLR steps, ResNet-18 at 224, {n} images (views "
          f"[{2 * n},224,224,3]), f32, TF32 off: views card vs CPU max |diff| "
          f"{img_err:.3g} (tol 1.6e-2), {100 * same:.3f} % identical, then "
          f"the card's views on both; losses card {losses['cuda']} cpu "
          f"{losses['cpu']} (tol 1e-4 relative); after step 2 (lr {lr:.3g}) "
          f"parameters max |diff| {p_max:.3g} (bound {2 * 3.17 * lr:.3g}), "
          f"{off} of {count} entries beyond 0.1 lr (tol 1 %), batch "
          f"statistics max |diff| {s_max:.3g} (tol 1e-5)")
    for lg, lc in zip(losses["cuda"], losses["cpu"]):
        check(abs(lg - lc) <= 1e-4 * abs(lc), "SimCLR loss: card and CPU "
                                              "disagree")
    check(p_max <= 2 * 3.17 * lr and off <= 0.01 * count,
          "SimCLR parameters: card and CPU disagree")
    check(s_max <= 1e-5, "SimCLR batch statistics: card and CPU disagree")
    del trainers, views, shared
    torch.cuda.empty_cache()


def phase_fusions_card_vs_cpu(torch, work: str):
    """The flagship 2C model with the cross-modal and the self-attention
    fusion at full width (dropout 0), same weights, card (kernels) vs CPU
    (plain versions) in f32 with TF32 off, on the first memes of phase 3's
    manifest: in eval mode the logits, in train mode the fusion's output
    (its BatchNorm on the batch statistics), each within 1e-4 of max(1,
    its largest CPU value)."""
    import dataclasses
    from mpmc_tpu_torch.cli.main import build_parser, prepare_inputs
    from mpmc_tpu_torch.config import FusionMethod
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.ops import attention as A
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = build_parser().parse_args(predict_argv(
        work, os.path.join(work, "memes.json"), "cmp", ["--subtask", "2c"]))
    inputs = prepare_inputs(args)
    batch = {k: torch.from_numpy(a[:FUSION_MEMES])
             for k, a in inputs.data.items()}
    m = inputs.variant.model_cfg
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    base = dataclasses.replace(
        m, dropout=0.0, text=dataclasses.replace(m.text, **enc),
        caption=dataclasses.replace(m.caption, **enc),
        image=dataclasses.replace(m.image, finetune_dropout=0.0))
    from mpmc_tpu_torch.models.norm import BatchNorm

    def run(model, device, train):
        """Logits (eval) or the fusion's output (train), and in train mode
        the input and output of every BatchNorm over ``[B, F]`` features
        (the modality FCs', the fusion's), by module name."""
        seen, bns = {}, {}

        def keep(name):
            return lambda mod, inp, out: bns.__setitem__(
                name, (inp[0].float().cpu(), out.float().cpu()))

        hooks = [model.fusion.register_forward_hook(
            lambda mod, inp, out: seen.__setitem__("x", out))]
        hooks += [mod.register_forward_hook(keep(name))
                  for name, mod in model.named_modules()
                  if isinstance(mod, BatchNorm) and "image_model" not in name]
        b = {k: t.to(device) for k, t in batch.items()}
        xs = [eval_preprocess(b["image"]) if key == "image" else b[key]
              for key in model.inputs]
        with torch.no_grad():
            logits = model.train(train)(*xs)
        for hook in hooks:
            hook.remove()
        return (seen["x"] if train else logits).float().cpu(), bns

    def bn_chain(card, cpu):
        """Each BatchNorm's input and output difference, card vs CPU, beside
        the input's scale and its smallest batch standard deviation over
        the memes (the division that amplifies an input difference)."""
        out = {}
        for name, (x_cpu, y_cpu) in cpu.items():
            x_card, y_card = card[name]
            out[name] = dict(
                input=(x_card - x_cpu).abs().max().item(),
                input_scale=x_cpu.abs().max().item(),
                min_batch_std=x_cpu.double().std(0, unbiased=False)
                .min().item(),
                output=(y_card - y_cpu).abs().max().item(),
                output_scale=y_cpu.abs().max().item())
        return out

    def pair(cfg):
        gpu = build_model(cfg, torch.device("cuda"), seed=7)
        cpu = build_model(cfg, torch.device("cpu"))
        cpu.load_state_dict({k: t.cpu() for k, t in gpu.state_dict().items()})
        return gpu, cpu

    chains = {}
    for fusion in FUSION_CHECKS:
        cfg = dataclasses.replace(base, fusion=FusionMethod(fusion))
        gpu, cpu = pair(cfg)
        errs, results = [], []
        for train in (False, True):
            before = A.launch_counts["attention_fwd"]
            on_card, bn_card = run(gpu, torch.device("cuda"), train)
            launched = A.launch_counts["attention_fwd"] - before
            on_cpu, bn_cpu = run(cpu, torch.device("cpu"), train)
            err = (on_card - on_cpu).abs().max().item()
            scale = max(1.0, on_cpu.abs().max().item())
            results.append((train, on_card, err, scale, launched))
            errs.append(f"{'train, fusion output' if train else 'eval, logits'}"
                        f" {tuple(on_cpu.shape)} {err:.3g} (tol 1e-4 x "
                        f"{scale:.4g})")
            if train:
                chains[f"{fusion}_12_layers"] = bn_chain(bn_card, bn_cpu)
        print(f"  f32 MultimodalClassifier with {fusion} fusion, card vs CPU "
              f"max abs diff: {'; '.join(errs)}; 24 attention_fwd launches a "
              f"forward")
        print_bn_chain(f"{fusion}_12_layers", chains[f"{fusion}_12_layers"])
        for train, on_card, err, scale, launched in results:
            check(launched == 24, f"{fusion}: the card forward launched "
                                  f"attention_fwd {launched} times, expected "
                                  f"24")
            check(bool(torch.isfinite(on_card).all()),
                  f"{fusion}: non-finite output on the card")
            check(err <= 1e-4 * scale,
                  f"{fusion}: card and CPU disagree in f32 (train={train})")
        del gpu, cpu
        torch.cuda.empty_cache()
    # The cross-modal flagship also with the encoders cut to 4 layers, where
    # its output check failed once: where the difference arises, printed,
    # not a check.
    m4 = dataclasses.replace(base, fusion=FusionMethod("cross_modal"),
                             text=dataclasses.replace(base.text,
                                                      num_layers=4),
                             caption=dataclasses.replace(base.caption,
                                                         num_layers=4))
    gpu, cpu = pair(m4)
    chains["cross_modal_4_layers"] = bn_chain(
        run(gpu, torch.device("cuda"), True)[1],
        run(cpu, torch.device("cpu"), True)[1])
    print_bn_chain("cross_modal_4_layers", chains["cross_modal_4_layers"])
    del gpu, cpu
    torch.cuda.empty_cache()
    return chains


def print_bn_chain(name, chain):
    print(f"  {name}, train mode, card vs CPU in f32 on {FUSION_MEMES} "
          f"memes, each BatchNorm's max abs diff (input, then output):")
    for bn, d in chain.items():
        print(f"    {bn}: input {d['input']:.3g} (max |input| "
              f"{d['input_scale']:.4g}, smallest batch std "
              f"{d['min_batch_std']:.3g}), output {d['output']:.3g} (max "
              f"|output| {d['output_scale']:.4g})")


def phase_small_attention(torch, argv):
    """The attention pair at the ``--small`` run's own packed text shape
    (bf16, segments, 4 heads of D = 32): the segment ids of its fold's
    second packed batch, rebuilt from its command line, held against the
    plain versions and timed."""
    _, run, batches = _fold0(torch, argv, bf16=True, dropout_zero=False,
                             device=torch.device("cuda"))
    del run
    seg = torch.from_numpy(batches[1]["t_segments"]).to("cuda").float()
    gen = torch.Generator(device="cuda").manual_seed(14)
    shape = time_attention_at(torch, seg, "segments", torch.bfloat16, gen,
                              "the packed --small 2C shape", heads=4,
                              head_dim=32)
    torch.cuda.empty_cache()
    return shape


def phase_train_variants(torch, work: str):
    """The full-width train runs of ``TRAIN_VARIANTS`` through the command
    line, the attention pair at the ``--small`` run's shape, then SimCLR
    over ViT-B/16, one SimCLR step pair card vs CPU, and the attention
    fusions card vs CPU.  Returns the runs' numbers, the ``--small``
    attention shape's, and the flagships' BatchNorm differences."""
    results, argvs = {}, {}
    for name, subtask, flags, layers, images, profiled in TRAIN_VARIANTS:
        stamp(f"  {name}:")
        argvs[name], results[name] = train_variant_cli(
            torch, work, name, subtask, flags, layers, images, profiled)
    small = phase_small_attention(torch, argvs["train_2c_small"])
    stamp("  SimCLR over ViT-B/16:")
    results["simclr_vit"] = phase_simclr_vit(torch)
    stamp("  SimCLR steps card vs CPU:")
    phase_simclr_card_vs_cpu(torch)
    stamp("  the attention fusions card vs CPU:")
    chains = phase_fusions_card_vs_cpu(torch, work)
    return results, small, chains


# Phase 11: the scratch captioner, exact-state resume and the Trainer
# wrapper.  The captioner's f32 attention forward at its caption batch of 64
# (``precompute_captions`` batches): its ViT encoder, [64,197,4,32], and the
# decoder's cross-attention, 24 queries over the 197 image tokens in 6 heads
# of the odd D = 21 (name, [B, Sq, H, D], Sk); both mode none.
CAPTION_BATCH = 64
CAPTION_SHAPES = [("caption_encoder", (CAPTION_BATCH, 197, 4, 32), 197),
                  ("caption_cross", (CAPTION_BATCH, 24, 6, 21), 197)]
# Forward calls of one ``generate``: the encoder's 2 layers once, then the
# decoder's 2 cross-attentions at each of the 23 positions after the first.
GENERATE_FWD = 2 + 23 * 2
CAPTION_TAG = "scratch-captioner-torch-42-224"
CAPTION_CARD_VS_CPU = 8            # images generated on the card and the CPU
CAPTION_LOGIT_TOL = 1e-3           # f32 card vs CPU, TF32 off
# The resumed 2A run against the uninterrupted one on the card: bf16 steps
# whose gradients are summed with atomics (the embedding and the packed
# gathers' backward) in another order, so the probabilities agree to this
# tolerance, not bit for bit; ids and labels must be equal.
RESUME_PROB_TOL = 1e-2
# The Trainer over clip_style_2c at full width: memes of phase 5's
# manifests (1 step of 16, one eval batch, evaluated once, at the end),
# the text cut to 128 tokens.
CLIP_TRAIN, CLIP_EVAL, CLIP_TEXT_LEN = 16, 16, 128


def time_forward_at(torch, what: str, shape, sk: int, mode: str = "none",
                    dtype=None):
    """The attention forward kernel (f32 unless ``dtype``) at ``shape`` =
    [B, Sq, H, D] over ``sk`` keys in ``mode`` (none, or padding with
    ``attention_inputs``' ragged lengths and a fully masked sample): held
    against the plain version on the same inputs, then timed beside the
    plain version, SDPA (TF32 off; the padding as an additive bias) and
    the bound."""
    import torch.nn.functional as F
    from mpmc_tpu_torch.ops import attention as A
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32
    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(21)
    q, k, v, mask = attention_inputs(torch, shape, mode, dtype, gen, sk)
    tag = f"{what} {mode} {tuple(q.shape)}x{sk} {dtype_name(dtype)}"
    bias = (None if mask is None
            else ((1.0 - mask) * -1e9)[:, None, None, :])
    with ieee_f32():
        out, lse = A.attention_forward_cuda(q, k, v, mask, mode)
        torch.cuda.synchronize()
        err = check_forward(A, q, k, v, mask, mode, out, lse, tag)
        ms = graph_ms(torch, lambda: A.attention_forward_cuda(q, k, v, mask,
                                                              mode))
        plain_ms = graph_ms(torch, lambda: A.attention_forward_reference(
            q, k, v, mask, mode))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=bias))
    bound_ms, bound_by = attention_bound_ms(q, k, mode)
    print(f"  attention_fwd {tag}: kernel {ms:.5f} ms, plain {plain_ms:.5f} "
          f"ms, sdpa (TF32 off) {library_ms:.5f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})")
    return dict(shape=list(shape), sk=sk, mode=mode, dtype=str(dtype),
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)


def phase_caption_generate(torch, work: str):
    """``make_scratch_caption_fn`` over phase 5's 224 images at 224 pixels
    through ``precompute_captions`` (batches of 64): launches (48 forward
    calls a batch), ms per ``generate`` batch, the device's busy share in a
    profiled warm batch, and the card against the CPU in f32 on a few
    images (the same weights: they come from a CPU generator): the logits
    on the card's ids and how many greedy ids differ."""
    from torch.profiler import ProfilerActivity, profile
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.image.decode import decode_batch
    from mpmc_tpu_torch.io.manifest import read_manifest
    from mpmc_tpu_torch.models.captioner import (PROMPT,
                                                 make_scratch_caption_fn,
                                                 precompute_captions)
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32
    dev = torch.device("cuda")
    train = read_manifest(os.path.join(work, "train.json"))
    paths = train.img_paths + read_manifest(
        os.path.join(work, "dev.json")).img_paths
    images = decode_batch(paths, 224, False, work)
    corpus = [preprocess_arabic_tweet(t) for t in train.texts]
    gen_fn, tok = make_scratch_caption_fn(corpus, image_size=224, seed=42,
                                          device=dev)
    # This phase measures the eager loop; phase 16 runs the same batches
    # through the decode graph beside these numbers.
    gen_fn.captioner.generate = gen_fn.captioner.generate_eager
    batch_ms = []

    def timed(images_u8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen_fn(images_u8)             # ends in a copy to the host
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    timed.cache_tag = gen_fn.cache_tag
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    caps = precompute_captions(paths, images, generate_fn=timed)
    launches = dict(build.launch_counts)
    batches = math.ceil(len(paths) / CAPTION_BATCH)
    want = {"attention_fwd": GENERATE_FWD * batches, "attention_bwd": 0,
            "image_normalize": 0}
    check(launches == want, f"captioning launches {launches}, expected {want}")
    placeholder = re.compile(r"^a meme of [0-9a-f]{8}$")
    check(len(caps) == len(paths) and all(
        c and not placeholder.match(c) for c in caps),
        f"captions missing or placeholders: {caps[:3]}")
    words = {w for c in caps for w in c.split()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_fn(images[:CAPTION_BATCH])
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"  scratch captioner over {len(paths)} images at 224 (ViT 2 x "
          f"128, 4 heads; decoder 2 x 128, 6 heads of 21; 24 tokens; vocab "
          f"{len(tok.vocab)}), f32: {batches} generate batches, ms "
          f"{[round(t, 3) for t in batch_ms]}; launches attention_fwd "
          f"{launches['attention_fwd']} = {GENERATE_FWD} x {batches}; "
          f"{len(words)} distinct words, e.g. {caps[0]!r}")
    print(f"  profiled warm batch of {CAPTION_BATCH}: {wall_ms:.3f} ms wall, "
          f"kernels {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} % of "
          f"wall) in {sum(e.count for e in events)} launches; top:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    cpu_fn, _ = make_scratch_caption_fn(corpus, image_size=224, seed=42,
                                        device=torch.device("cpu"))
    card, host = gen_fn.captioner, cpu_fn.captioner
    few = torch.from_numpy(images[:CAPTION_CARD_VS_CPU])
    prompt = torch.tensor([tok.tokenize_to_ids(PROMPT)]).expand(len(few), -1)
    with ieee_f32(), torch.inference_mode():
        x = eval_preprocess(few.to(dev))
        ids = card.generate(x, prompt.to(dev), eos_id=tok.sep_id)
        logits = card(x, ids).cpu()
        x_cpu = eval_preprocess(few)
        ids_cpu = host.generate(x_cpu, prompt, eos_id=tok.sep_id)
        logits_cpu = host(x_cpu, ids.cpu())
    diff = (logits - logits_cpu).abs().max().item()
    ids_differ = int((ids.cpu() != ids_cpu).sum())
    check(diff <= CAPTION_LOGIT_TOL, f"captioner logits card vs CPU differ "
                                     f"by {diff}")
    print(f"  card vs CPU, {len(few)} images in f32 (TF32 off): max |logit "
          f"diff| {diff:.3g} (tol {CAPTION_LOGIT_TOL}) over "
          f"{tuple(logits.shape)}; greedy ids differing: {ids_differ} of "
          f"{ids.numel()}")
    del card, host, gen_fn, cpu_fn
    torch.cuda.empty_cache()
    return dict(launches=launches, batches=batches, batch_ms=batch_ms,
                profiled_wall_ms=wall_ms, profiled_kernel_ms=busy_ms,
                logits_max_abs_diff=diff, ids_differ=ids_differ,
                ids=ids.numel(), distinct_words=len(words))


def _caption_cache(work: str, manifest: str):
    """The captions the port's scratch captioner cached for a manifest's
    paths (seed 42, 224 pixels) under ``work/.cache``."""
    import hashlib
    with open(os.path.join(work, manifest), encoding="utf-8") as f:
        paths = [r["img_path"] for r in json.load(f)]
    key = hashlib.sha256(("\n".join(paths) + "a meme of" + "\x00"
                          + CAPTION_TAG).encode()).hexdigest()[:16]
    with open(os.path.join(work, ".cache", f"captions_{key}.json")) as f:
        cache = json.load(f)
    return [cache[p] for p in paths]


def phase_train_scratch_captioner(torch, work: str):
    """``train --subtask 2c --scratch-captioner`` at full width on phase
    5's manifests (fold 0, one epoch, bf16, the fast recipe), launch counts
    zeroed before and read after: 48 forward calls per caption batch (3
    train and 1 dev batch of at most 64), then 24 forward and 24 backward a
    step, 24 forward per eval batch and the image kernel once a step.
    Checks the cached captions (words, not placeholders, under the port's
    tag), the caption vocab over them, the finite losses and the TSV;
    reports the size of a checkpoint's whole state and the seconds each
    save held the run (the copy to host memory, and any wait for the write
    before it; the write runs behind)."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train.checkpoint import STATE_FILE, Checkpointer
    out_dir, ckpt = (os.path.join(work, n) for n in ("scratch_out",
                                                     "scratch_ck"))
    argv = ["train", "--subtask", "2c",
            "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--image-root", work,
            "--fold", "0", "--epochs", "1", "--checkpoint-dir", ckpt,
            "--out-dir", out_dir, "--scratch-captioner", "--device", "cuda"]
    real_save, save_s = Checkpointer.save, []

    def timed_save(self, state, step, metrics=None):
        t = time.perf_counter()
        real_save(self, state, step, metrics)
        save_s.append(time.perf_counter() - t)

    Checkpointer.save = timed_save
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    finally:
        Checkpointer.save = real_save
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train --scratch-captioner returned {rc}")
    kept = Checkpointer(os.path.join(ckpt, "fold_0"))
    state_mb = os.path.getsize(os.path.join(
        kept.directory, str(kept.latest_step()), STATE_FILE)) / 2 ** 20
    with open(os.path.join(out_dir, "task2C_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    steps, evals = len(metrics["steps"]), len(metrics["evals"])
    check(steps == metrics["steps_per_epoch"] > 0, "steps missing")
    eval_batches = evals * (math.ceil(metrics["n_test"] / BATCH)
                            + math.ceil(metrics["n_val"] / BATCH))
    caption_batches = (math.ceil(N_TRAIN / CAPTION_BATCH)
                       + math.ceil(N_DEV / CAPTION_BATCH))
    want = {"attention_fwd": 24 * (steps + eval_batches)
            + GENERATE_FWD * caption_batches,
            "attention_bwd": 24 * steps, "image_normalize": steps}
    check(launches == want, f"scratch-captioner train launches {launches}, "
                            f"expected {want}")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              for s in metrics["steps"]), "non-finite loss or grad norm")
    check(check_format(os.path.join(out_dir, "task2C_kevinmathew.tsv")),
          "the TSV fails check_format")
    caps = _caption_cache(work, "train.json") + _caption_cache(work,
                                                               "dev.json")
    placeholder = re.compile(r"^a meme of [0-9a-f]{8}$")
    check(all(c and not placeholder.match(c) for c in caps),
          "the run's captions are placeholders")
    with open(os.path.join(out_dir, "caption_vocab.txt"),
              encoding="utf-8") as f:
        vocab = set(f.read().split())
    check({w for c in caps for w in c.split()} <= vocab,
          "caption words missing from caption_vocab.txt")
    print(f"  train --subtask 2c --scratch-captioner --fold 0 --epochs 1 "
          f"(default ModelConfig, bf16, fast recipe): rc 0, {wall:.3f} s "
          f"wall (captioning, model build, {evals} evals included); {steps} "
          f"steps, losses {[round(s['loss'], 5) for s in metrics['steps']]}")
    print(f"  launches: attention_fwd {launches['attention_fwd']} = 48 x "
          f"{caption_batches} caption batches + 24 x ({steps} steps + "
          f"{eval_batches} eval batches), attention_bwd "
          f"{launches['attention_bwd']} = 24 x {steps}, image_normalize "
          f"{launches['image_normalize']} = {steps}; {len(caps)} word "
          f"captions cached under {CAPTION_TAG}, caption vocab "
          f"{len(vocab)} tokens; checkpoints {len(save_s)}, each "
          f"{state_mb:.1f} MiB of state, holding the run "
          f"{[round(t, 3) for t in save_s]} s")
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, steps=steps,
                eval_batches=eval_batches, caption_batches=caption_batches,
                checkpoint_mib=state_mb, checkpoint_save_s=save_s)


def phase_resume_2a(torch, work: str):
    """Phase 8's full-width ``train --subtask 2a`` again, killed right after
    its first checkpoint (inside the epoch), then ``--resume``d: launches
    of the resumed part (12 forward and 12 backward a step, 12 forward per
    eval batch, test and val), and its three TSVs against phase 8's
    uninterrupted run: the same ids and labels, probabilities within
    ``RESUME_PROB_TOL``."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train.checkpoint import Checkpointer
    out_dir = os.path.join(work, "resume_2a_out")
    argv = ["train", "--subtask", "2a", "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--fold", "0", "--epochs",
            "1", "--checkpoint-dir", os.path.join(work, "resume_2a_ck"),
            "--out-dir", out_dir, "--scan-steps", str(SCAN_K),
            "--device", "cuda"]

    class Crash(Exception):
        pass

    real_save, saved = Checkpointer.save, []

    def crashing_save(self, state, step, metrics=None):
        real_save(self, state, step, metrics)
        self.wait()                     # the write committed, then the crash
        saved.append(step)
        raise Crash(f"crash after the checkpoint at step {step}")

    Checkpointer.save = crashing_save
    t0 = time.perf_counter()
    try:
        cli_main(argv)
    except Crash:
        pass
    finally:
        Checkpointer.save = real_save
    crash_wall = time.perf_counter() - t0
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    rc = cli_main(argv + ["--resume"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train --subtask 2a --resume returned {rc}")
    with open(os.path.join(out_dir, "task2A_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    per_epoch, steps = metrics["steps_per_epoch"], len(metrics["steps"])
    check(len(saved) == 1 and 0 < saved[0] < per_epoch
          and steps == per_epoch - saved[0],
          f"crash at {saved}, then {steps} of {per_epoch} steps")
    eval_batches = len(metrics["evals"]) * (
        math.ceil(metrics["n_test"] / BATCH)
        + math.ceil(metrics["n_val"] / BATCH))
    want = {"attention_fwd": 12 * (steps + eval_batches),
            "attention_bwd": 12 * steps, "image_normalize": 0}
    check(launches == want, f"resumed 2A launches {launches}, expected {want}")
    cmp = compare_runs(os.path.join(work, "train_2a_out"), out_dir,
                       "task2A", "2A resume")
    worst = cmp["max_prob_diff"]
    check(worst <= RESUME_PROB_TOL, f"resumed probabilities differ by "
                                    f"{worst}")
    print(f"  train --subtask 2a --scan-steps {SCAN_K} killed after the "
          f"checkpoint at step {saved[0]} of {per_epoch} ({crash_wall:.3f} "
          f"s), --resume: rc 0, {wall:.3f} s, {steps} steps; launches "
          f"attention_fwd {launches['attention_fwd']} = 12 x ({steps} + "
          f"{eval_batches} eval batches), attention_bwd "
          f"{launches['attention_bwd']} = 12 x {steps}; the three TSVs "
          f"against phase 8's uninterrupted K = {SCAN_K} run: identical "
          f"{cmp['tsvs_identical']}, max |prob diff| {worst:.3g} (tol "
          f"{RESUME_PROB_TOL})")
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, crash_step=saved[0],
                steps=steps, max_prob_diff=worst,
                tsvs_identical=cmp["tsvs_identical"])


def phase_trainer_clip(torch, work: str):
    """The ``Trainer`` over ``clip_style_2c`` at full width (BERT-base text,
    ViT-B/32 at 224, concat fusion, one logit, bf16) on phase 5's memes:
    ``train`` (one epoch at batch 16, launch counts zeroed before and read
    after: 24 forward and 24 backward a step, 24 forward per eval batch,
    the image kernel once a step), ``evaluate``, ``predict``,
    ``save_model``, and a second ``Trainer`` with ``resume`` whose
    ``evaluate`` equals the first's."""
    import dataclasses
    from mpmc_tpu_torch.cli.experiments import build_tokenizer, prepare_text
    from mpmc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from mpmc_tpu_torch.image.decode import decode_batch
    from mpmc_tpu_torch.io.manifest import read_manifest
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
    from mpmc_tpu_torch.train.trainer import Trainer
    dev = torch.device("cuda")
    train = read_manifest(os.path.join(work, "train.json"))
    test = read_manifest(os.path.join(work, "dev.json"))
    tok = build_tokenizer([preprocess_arabic_tweet(t) for t in train.texts],
                          None)
    base = ModelConfig.clip_style_2c()
    mcfg = dataclasses.replace(base, text=dataclasses.replace(
        base.text, vocab_size=max(tok.vocab.values()) + 1))

    def split(m, n):
        ids, mask = prepare_text(m, tok, CLIP_TEXT_LEN)
        return {"text_ids": ids[:n], "text_mask": mask[:n],
                "image": decode_batch(m.img_paths[:n], 224, False, work),
                "label": m.labels[:n]}

    train_d, eval_d = split(train, CLIP_TRAIN), split(test, CLIP_EVAL)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=BATCH), epochs=1,
                      eval_per_epoch=1, bf16=True,
                      checkpoint_dir=os.path.join(work, "clip_ck"))
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    trainer = Trainer(build_model(mcfg, dev, seed=42), cfg, train_d,
                      eval_data=eval_d, device=dev)
    result = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    steps, evals = len(result.steps), len(result.history)
    eval_batches = evals * math.ceil(CLIP_EVAL / BATCH)
    want = {"attention_fwd": 24 * (steps + eval_batches),
            "attention_bwd": 24 * steps, "image_normalize": steps}
    check(steps == CLIP_TRAIN // BATCH and launches == want,
          f"Trainer launches {launches} in {steps} steps, expected {want}")
    check(all(math.isfinite(s["loss"]) for s in result.steps),
          "non-finite Trainer loss")
    ev = trainer.evaluate()
    probs = trainer.predict({k: v for k, v in eval_d.items()
                             if k != "label"})
    check(probs.shape == (CLIP_EVAL,) and bool((probs == ev.probs).all()),
          "predict differs from evaluate")
    trainer.save_model(step=steps, metrics={"test_f1": ev.macro_f1})
    del trainer
    torch.cuda.empty_cache()
    again = Trainer(build_model(mcfg, dev, seed=0),
                    dataclasses.replace(cfg, resume=True), train_d,
                    eval_data=eval_d, device=dev)
    ev2 = again.evaluate()
    diff = float(abs(ev2.probs - ev.probs).max())
    check(diff <= 1e-6 and ev2.macro_f1 == ev.macro_f1,
          f"the resumed Trainer's evaluate differs by {diff}")
    print(f"  Trainer over clip_style_2c (BERT-base + ViT-B/32 at 224, bf16), "
          f"{CLIP_TRAIN} memes at batch {BATCH}, text {CLIP_TEXT_LEN} tokens: "
          f"{steps} steps in {wall:.3f} s (model build and {evals} evals "
          f"included), losses {[round(s['loss'], 5) for s in result.steps]}; "
          f"launches attention_fwd {launches['attention_fwd']} = 24 x "
          f"({steps} + {eval_batches} eval batches), attention_bwd "
          f"{launches['attention_bwd']} = 24 x {steps}, image_normalize "
          f"{launches['image_normalize']}; evaluate F1 {ev.macro_f1:.4f}, "
          f"predict equal, resumed evaluate max |prob diff| {diff:.3g} (tol "
          f"1e-6)")
    del again
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, steps=steps,
                eval_batches=eval_batches, resumed_max_prob_diff=diff)


def phase_captioner_resume_trainer(torch, work: str):
    """Phase 11: (a) the attention forward at the captioner's shapes and
    the scratch captioner over phase 5's images, (b) ``train
    --scratch-captioner``, (c) crash and ``--resume`` of phase 8's 2A run,
    (d) the ``Trainer`` over ``clip_style_2c``."""
    shapes = {name: time_forward_at(torch, name, shape, sk)
              for name, shape, sk in CAPTION_SHAPES}
    torch.cuda.empty_cache()
    out = dict(shapes=shapes)
    for name, run in (("caption_generate", phase_caption_generate),
                      ("train_2c_scratch_captioner",
                       phase_train_scratch_captioner),
                      ("train_2a_resume", phase_resume_2a),
                      ("trainer_clip_style", phase_trainer_clip)):
        stamp(f"  {name}:")
        out[name] = run(torch, work)
    return out


# Phase 12: offline pretrained weights, the classic side and distillation.
# Random checkpoints in the exact Hugging Face and torchvision key layouts
# come from this seed (no weights are in the repository).
CKPT_SEED = 12
EXTRACT_SHAPE = (32, 128, 12, 64)   # extract-features' f32 text batch
EXTRACT_MEMES = 72                  # 3 batches of 32, the last 24 zero rows
FEATURE_CARD_VS_CPU = 8             # memes extracted on the card and the CPU
FEATURE_TOL = 1e-4                  # x max(1, largest CPU value), f32
SMOKE_SHAPE = (8, 32, 4, 16)        # smoke's bf16 text batch
PRETRAINED_MEMES = (64, 16)         # phase 5's train and dev memes used


def _normal(rng, shape, std=0.02):
    return (rng.standard_normal(shape, dtype="float32") * std)


def random_hf_text(rng, cfg, prefix: str = "", pooler: bool = True):
    """A BERT or RoBERTa state dict of ``cfg``'s shapes in the Hugging Face
    layout (``prefix`` "roberta." as a RoBERTa head model saves it),
    normal(0, 0.02) weights, LayerNorm scales near 1."""
    import numpy as np
    H, inter = cfg.hidden_size, cfg.intermediate_size
    sd = {"embeddings.word_embeddings.weight": _normal(rng, (cfg.vocab_size,
                                                             H)),
          "embeddings.position_embeddings.weight": _normal(
              rng, (cfg.max_position_embeddings, H)),
          "embeddings.token_type_embeddings.weight": _normal(
              rng, (cfg.type_vocab_size, H))}

    def ln(name, dim):
        sd[f"{name}.weight"] = 1 + _normal(rng, (dim,), 0.1)
        sd[f"{name}.bias"] = _normal(rng, (dim,))

    def dense(name, n_out, n_in):
        sd[f"{name}.weight"] = _normal(rng, (n_out, n_in))
        sd[f"{name}.bias"] = _normal(rng, (n_out,))

    ln("embeddings.LayerNorm", H)
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        for name in ("query", "key", "value"):
            dense(pre + f"attention.self.{name}", H, H)
        dense(pre + "attention.output.dense", H, H)
        ln(pre + "attention.output.LayerNorm", H)
        dense(pre + "intermediate.dense", inter, H)
        dense(pre + "output.dense", H, inter)
        ln(pre + "output.LayerNorm", H)
    if pooler:
        dense("pooler.dense", H, H)
    return {prefix + k: np.ascontiguousarray(v) for k, v in sd.items()}


def _bn(rng, sd, name, dim):
    import numpy as np
    sd[f"{name}.weight"] = 1 + _normal(rng, (dim,), 0.1)
    sd[f"{name}.bias"] = _normal(rng, (dim,), 0.05)
    sd[f"{name}.running_mean"] = _normal(rng, (dim,), 0.1)
    sd[f"{name}.running_var"] = (0.5 + rng.random(dim)).astype(np.float32)
    sd[f"{name}.num_batches_tracked"] = np.asarray(100, np.int64)


def _conv(rng, shape):
    fan_out = shape[0] * shape[2] * shape[3]
    return _normal(rng, shape, (2.0 / fan_out) ** 0.5)


def random_torchvision_resnet18(rng):
    """torchvision's ResNet-18 state dict (``conv1``, ``bn1``,
    ``layer{1..4}.{0,1}``, ``downsample.{0,1}``, ``fc`` of 1000 classes)
    with random BatchNorm statistics."""
    sd = {"conv1.weight": _conv(rng, (64, 3, 7, 7))}
    _bn(rng, sd, "bn1", 64)
    cin = 64
    for li, cout in enumerate((64, 128, 256, 512), 1):
        for bi in range(2):
            pre = f"layer{li}.{bi}"
            stride_in = cin if bi == 0 else cout
            sd[f"{pre}.conv1.weight"] = _conv(rng, (cout, stride_in, 3, 3))
            _bn(rng, sd, f"{pre}.bn1", cout)
            sd[f"{pre}.conv2.weight"] = _conv(rng, (cout, cout, 3, 3))
            _bn(rng, sd, f"{pre}.bn2", cout)
            if bi == 0 and li > 1:
                sd[f"{pre}.downsample.0.weight"] = _conv(rng,
                                                         (cout, cin, 1, 1))
                _bn(rng, sd, f"{pre}.downsample.1", cout)
        cin = cout
    sd["fc.weight"] = _normal(rng, (1000, 512))
    sd["fc.bias"] = _normal(rng, (1000,))
    return sd


def random_hf_convnext_tiny(rng):
    """The Hugging Face ``ConvNextModel`` state dict of ConvNeXt-Tiny
    (``embeddings``, ``encoder.stages.S.{downsampling_layer,layers}``, the
    final ``layernorm``), layer scales drawn in [0, 1)."""
    import numpy as np
    dims, depths = (96, 192, 384, 768), (3, 3, 9, 3)
    sd = {"embeddings.patch_embeddings.weight": _conv(rng, (96, 3, 4, 4)),
          "embeddings.patch_embeddings.bias": _normal(rng, (96,))}

    def ln(name, dim):
        sd[f"{name}.weight"] = 1 + _normal(rng, (dim,), 0.1)
        sd[f"{name}.bias"] = _normal(rng, (dim,))

    ln("embeddings.layernorm", 96)
    for si, (depth, dim) in enumerate(zip(depths, dims)):
        pre = f"encoder.stages.{si}"
        if si:
            ln(f"{pre}.downsampling_layer.0", dims[si - 1])
            sd[f"{pre}.downsampling_layer.1.weight"] = _conv(
                rng, (dim, dims[si - 1], 2, 2))
            sd[f"{pre}.downsampling_layer.1.bias"] = _normal(rng, (dim,))
        for bi in range(depth):
            b = f"{pre}.layers.{bi}"
            sd[f"{b}.dwconv.weight"] = _conv(rng, (dim, 1, 7, 7))
            sd[f"{b}.dwconv.bias"] = _normal(rng, (dim,))
            ln(f"{b}.layernorm", dim)
            sd[f"{b}.pwconv1.weight"] = _normal(rng, (4 * dim, dim))
            sd[f"{b}.pwconv1.bias"] = _normal(rng, (4 * dim,))
            sd[f"{b}.pwconv2.weight"] = _normal(rng, (dim, 4 * dim))
            sd[f"{b}.pwconv2.bias"] = _normal(rng, (dim,))
            sd[f"{b}.layer_scale_parameter"] = rng.random(
                dim, dtype=np.float32)
    ln("layernorm", 768)
    return sd


def write_state_dict(torch, path: str, sd) -> None:
    """``torch.save`` of the numpy state dict as CPU tensors, as a torch
    checkpoint is distributed."""
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)


def write_checkpoints(torch, work: str):
    """An HF BERT-base directory (the text encoder), an HF RoBERTa-base one
    with the ``roberta.`` prefix and no pooler (the caption encoder), a
    torchvision ResNet-18 ``.pt`` and an HF ConvNeXt-Tiny ``.bin``.  Each
    text directory holds the ``vocab.txt`` its embedding rows fit: phase
    5's text and caption vocabularies."""
    import numpy as np
    from mpmc_tpu_torch.config import TextEncoderConfig
    from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
    rng = np.random.default_rng(CKPT_SEED)
    t0 = time.perf_counter()
    paths = {}
    for name, vocab, cfg, prefix, pooler in (
            ("bert", "vocab.txt", TextEncoderConfig(), "", True),
            ("roberta", "caption_vocab.txt", TextEncoderConfig.roberta_base(),
             "roberta.", False)):
        d = os.path.join(work, f"hf_{name}")
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(work, "train_out", vocab),
                    os.path.join(d, "vocab.txt"))
        size = max(WordPieceTokenizer.from_file(
            os.path.join(d, "vocab.txt")).vocab.values()) + 1
        write_state_dict(torch, os.path.join(d, "pytorch_model.bin"),
                         random_hf_text(rng, dataclasses.replace(
                             cfg, vocab_size=size), prefix, pooler))
        paths[name] = d
    paths["resnet18"] = os.path.join(work, "resnet18.pt")
    write_state_dict(torch, paths["resnet18"],
                     random_torchvision_resnet18(rng))
    paths["convnext_tiny"] = os.path.join(work, "convnext_tiny.bin")
    write_state_dict(torch, paths["convnext_tiny"],
                     random_hf_convnext_tiny(rng))
    sizes = {k: sum(os.path.getsize(os.path.join(p, f))
                    for f in (os.listdir(p) if os.path.isdir(p) else [""]))
             if os.path.isdir(p) else os.path.getsize(p)
             for k, p in paths.items()}
    print(f"  random checkpoints from numpy seed {CKPT_SEED} in "
          f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
              f"{k} {v / 2**20:.1f} MiB" for k, v in sizes.items()))
    return paths


def _spliced_equal(model, kind, spec, trees) -> dict:
    """Each part the splice loaded against the tree converted from its
    checkpoint (``trees``: path -> the tree the splice read): the leaves
    compared and how many differ in any bit (on the host, f32)."""
    import numpy as np
    from mpmc_tpu_torch.models import pretrained as PT
    from mpmc_tpu_torch.models.convert import to_jax_params, to_jax_variables
    out = {}

    def count(own, tree):
        own, tree = PT.flatten_params(own), PT.flatten_params(tree)
        return len(tree), sum(not np.array_equal(own[k], v)
                              for k, v in tree.items())

    for part, where in (("text", PT.TEXT_SUBMODULE.get(kind)),
                        ("caption", PT.CAPTION_SUBMODULE)):
        path = getattr(spec, part)
        if path:
            out[part] = count(to_jax_params(model.get_submodule(where)),
                              trees[path])
    if spec.image:
        params, stats = to_jax_variables(
            model.get_submodule(PT.IMAGE_SUBMODULE[kind]))
        n1, d1 = count(params, trees[spec.image]["params"])
        n2, d2 = count(stats, trees[spec.image]["batch_stats"])
        out["image"] = (n1 + n2, d1 + d2)
    return out


def phase_train_2c_pretrained(torch, work: str, ckpts):
    """``train --subtask 2c --text-params --caption-params --image-params``
    (with the checkpoints' own vocab files) on the first
    ``PRETRAINED_MEMES`` memes of phase 5's manifests (its shapes, fewer
    steps and eval batches), fold 0, one epoch: each spliced part equal to
    the tree converted from its checkpoint bit for bit before the first
    step, launches as in phase 5."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.models import pretrained as PT
    from mpmc_tpu_torch.ops import build
    subsets = {}
    for name, n in zip(("train.json", "dev.json"), PRETRAINED_MEMES):
        with open(os.path.join(work, name), encoding="utf-8") as f:
            rows = json.load(f)[:n]
        subsets[name] = os.path.join(work, "pretrained_" + name)
        with open(subsets[name], "w", encoding="utf-8") as f:
            json.dump(rows, f, ensure_ascii=False)
    out_dir = os.path.join(work, "pretrained_2c_out")
    argv = ["train", "--subtask", "2c", "-tr", subsets["train.json"],
            "-te", subsets["dev.json"], "--image-root", work,
            "--fold", "0", "--epochs", "1", "--out-dir", out_dir,
            "--text-params", ckpts["bert"],
            "--vocab", os.path.join(ckpts["bert"], "vocab.txt"),
            "--caption-params", ckpts["roberta"],
            "--caption-vocab", os.path.join(ckpts["roberta"], "vocab.txt"),
            "--image-params", ckpts["resnet18"], "--device", "cuda"]
    splice, reads, seen, trees = (PT.apply_pretrained, (
        PT.read_text_params, PT.read_image_params), [], {})

    def read_text(path, *args):
        trees[path] = reads[0](path, *args)
        return trees[path]

    def read_image(path, *args):
        trees[path] = reads[1](path, *args)
        return trees[path]

    def spliced(model, kind, spec):
        out = splice(model, kind, spec)
        seen.append(_spliced_equal(model, kind, spec, trees))
        return out

    for key in build.launch_counts:
        build.launch_counts[key] = 0
    PT.apply_pretrained, PT.read_text_params, PT.read_image_params = (
        spliced, read_text, read_image)
    t0 = time.perf_counter()
    try:
        rc = cli_main(argv)
    finally:
        PT.apply_pretrained, (PT.read_text_params, PT.read_image_params) = (
            splice, reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train with converted checkpoints returned {rc}")
    check(len(seen) == 1 and set(seen[0]) == {"text", "caption", "image"},
          f"splices {seen}")
    check(all(d == 0 for _, d in seen[0].values()),
          f"spliced weights differ from the converted checkpoints: {seen}")
    with open(os.path.join(out_dir, "task2C_train_metrics_fold_0.json")) as f:
        metrics = json.load(f)
    steps = len(metrics["steps"])
    eval_batches = len(metrics["evals"]) * (
        math.ceil(metrics["n_test"] / BATCH)
        + math.ceil(metrics["n_val"] / BATCH))
    want = {"attention_fwd": 24 * (steps + eval_batches),
            "attention_bwd": 24 * steps, "image_normalize": steps}
    check(steps > 0 and launches == want,
          f"launches {launches}, expected {want}")
    check(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
              for s in metrics["steps"]), "non-finite loss or grad norm")
    print(f"  train --subtask 2c from the converted BERT-base, RoBERTa-base "
          f"and ResNet-18 checkpoints, {metrics['n_train']} train / "
          f"{metrics['n_val']} val / {metrics['n_test']} test memes: rc 0, "
          f"{wall:.3f} s wall; spliced "
          f"leaves equal to the converted files bit for bit (leaves, "
          f"differing): {seen[0]}; {steps} steps, losses "
          f"{[round(s['loss'], 5) for s in metrics['steps']]}")
    print(f"  launches: attention_fwd {launches['attention_fwd']} = 24 x "
          f"({steps} steps + {eval_batches} eval batches), attention_bwd "
          f"{launches['attention_bwd']} = 24 x {steps}, image_normalize "
          f"{launches['image_normalize']} = {steps}")
    return dict(launches=launches, wall_s=wall, steps=steps,
                spliced=seen[0])


def phase_extract_features(torch, work: str, ckpts):
    """``extract-features`` over the first ``EXTRACT_MEMES`` train memes
    with the HF BERT-base directory and the HF ConvNeXt-Tiny checkpoint:
    launches (12 forward calls a text batch of 32, no other kernel), the
    JSON, then warm images/s and texts/s, the busy share of a profiled
    pass, and the card against the CPU on a few memes."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from mpmc_tpu_torch.baselines import extract_features as EF
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.ops import build
    with open(os.path.join(work, "train.json"), encoding="utf-8") as f:
        rows = json.load(f)
    for name, n in (("feats_m.json", EXTRACT_MEMES),
                    ("feats_few.json", FEATURE_CARD_VS_CPU)):
        with open(os.path.join(work, name), "w", encoding="utf-8") as f:
            json.dump(rows[:n], f, ensure_ascii=False)
    flags = ["--text-vocab", os.path.join(ckpts["bert"], "vocab.txt"),
             "--text-params", ckpts["bert"],
             "--image-params", ckpts["convnext_tiny"], "--image-root", work]
    feats_dir = os.path.join(work, "features")
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    rc, _ = _capture(cli_main, ["extract-features", "-d", work, "-f",
                                "feats_m.json", "-o", "feats.json",
                                "--features-dir", feats_dir, *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"extract-features returned {rc}")
    batches = math.ceil(EXTRACT_MEMES / 32)
    want = {"attention_fwd": 12 * batches, "attention_bwd": 0,
            "image_normalize": 0}
    check(launches == want, f"extract-features launches {launches}, "
                            f"expected {want}")
    with open(os.path.join(feats_dir, "feats.json")) as f:
        feats = json.load(f)
    ids = [r["id"] for r in rows[:EXTRACT_MEMES]]
    for kind in ("imgfeats", "textfeats"):
        x = np.asarray([feats[kind][i] for i in ids])
        check(list(feats[kind]) == ids and x.shape == (EXTRACT_MEMES, 768)
              and bool(np.isfinite(x).all()), f"{kind}: wrong JSON")
    # warm throughput and the busy share, through the command's functions
    dev = torch.device("cuda")
    manifest, images, tok_ids, mask, cfg, _ = EF.prepare(
        work, "feats_m.json", work, flags[1], flags[3])
    net = EF.image_encoder(ckpts["convnext_tiny"], dev)
    enc = EF.text_encoder(cfg, ckpts["bert"], None, dev)
    EF.encode_images(net, images[:32], 32, dev)
    EF.encode_texts(enc, tok_ids[:32], mask[:32], 32, dev)
    rates = {}
    for what, fn in (("images", lambda: EF.encode_images(net, images, 32,
                                                         dev)),
                     ("texts", lambda: EF.encode_texts(enc, tok_ids, mask,
                                                       32, dev))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn()
        rates[what] = EXTRACT_MEMES / (time.perf_counter() - t1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        EF.encode_images(net, images, 32, dev)
        EF.encode_texts(enc, tok_ids, mask, 32, dev)
        pass_ms = (time.perf_counter() - t1) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    del net, enc
    torch.cuda.empty_cache()
    print(f"  extract-features, {EXTRACT_MEMES} memes ({batches} batches of "
          f"32, the last {32 * batches - EXTRACT_MEMES} rows zero), f32, "
          f"ConvNeXt-Tiny at 224 and BERT-base at 128 tokens (vocab "
          f"{cfg.vocab_size}): rc 0, {wall:.3f} s wall (checkpoint loads "
          f"and decode included); launches attention_fwd "
          f"{launches['attention_fwd']} = 12 x {batches}")
    print(f"  warm: {rates['images']:.2f} images/s, {rates['texts']:.2f} "
          f"texts/s; profiled pass {pass_ms:.3f} ms wall, kernels "
          f"{busy_ms:.3f} ms ({100 * busy_ms / pass_ms:.1f} % of wall) in "
          f"{sum(e.count for e in events)} launches; top:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    # the card against the CPU (plain versions), f32, on a few memes
    t1 = time.perf_counter()
    cpu_path = EF.extract_features(
        work, "feats_few.json", "feats_cpu.json", image_root=work,
        batch_size=FEATURE_CARD_VS_CPU, text_vocab_path=flags[1],
        text_params_path=ckpts["bert"],
        image_params_path=ckpts["convnext_tiny"],
        features_dir=feats_dir, device="cpu")
    with open(cpu_path) as f:
        on_cpu = json.load(f)
    errs = {}
    for kind in ("imgfeats", "textfeats"):
        c = np.asarray(list(on_cpu[kind].values()))
        g = np.asarray([feats[kind][i] for i in on_cpu[kind]])
        scale = max(1.0, float(np.abs(c).max()))
        errs[kind] = float(np.abs(g - c).max())
        check(errs[kind] <= FEATURE_TOL * scale,
              f"{kind}: card and CPU differ by {errs[kind]} (tol "
              f"{FEATURE_TOL} x {scale:.4g})")
    print(f"  card vs CPU, {FEATURE_CARD_VS_CPU} memes in f32 (TF32 off): "
          f"max |diff| images {errs['imgfeats']:.3g}, texts "
          f"{errs['textfeats']:.3g} (tol {FEATURE_TOL} x max(1, largest CPU "
          f"value)); CPU run {time.perf_counter() - t1:.1f} s")
    return dict(launches=launches, wall_s=wall, memes=EXTRACT_MEMES,
                images_s=rates["images"], texts_s=rates["texts"],
                profiled_wall_ms=pass_ms, profiled_kernel_ms=busy_ms,
                card_vs_cpu_max_abs_diff=errs)


def phase_distill_2a(torch, work: str):
    """``train --subtask 2a --corpus-vocab subword --distill-lambda 0.5``
    under the fast recipe from a synthetic teacher cache: the cache file
    the port keys for phase 5's train+dev manifests and the folds it
    computes where it runs, holding seeded uniform probabilities (0.5 on
    each fold's validation rows).  Launches as ``train_2a_cli`` checks
    them, a cache hit (no other file written) and the ``_distill`` run
    id."""
    import numpy as np
    from mpmc_tpu_torch.cv.kfold import stratified_kfold
    from mpmc_tpu_torch.io.manifest import read_manifest
    from mpmc_tpu_torch.io.tsv import read_run_id
    from mpmc_tpu_torch.train.distill import cache_path
    combined = read_manifest(os.path.join(work, "train.json")).concat(
        read_manifest(os.path.join(work, "dev.json")))
    labels = np.asarray(combined.labels)
    splits = stratified_kfold(labels, 5, 42)
    cache = os.path.join(work, "distill_cache")
    os.makedirs(cache, exist_ok=True)
    path = cache_path(cache, list(combined.texts), labels, splits)
    rng = np.random.default_rng(CKPT_SEED + 1)
    soft = np.full((len(splits), len(labels)), 0.5, np.float32)
    for k, (tr, _) in enumerate(splits):
        soft[k, tr] = rng.random(len(tr), dtype=np.float32)
    np.savez_compressed(path, soft=soft)
    try:
        import sklearn  # noqa: F401
        why = ("the SVM's own fit is held to the JAX package's by the CPU "
               "tests")
    except ImportError:
        why = "sklearn is not installed, so the SVM cannot be fitted"
    print(f"  synthetic teacher: {os.path.basename(path)} holds seeded "
          f"uniform probabilities, not the char-n-gram SVM's ({why}); the "
          f"run reads it as a cache hit, so what it exercises is the soft "
          f"column, the packed maps, the mixed loss and the kernels")
    argv, launches, metrics, _, _, wall = train_2a_cli(
        torch, work, "train_2a_distill",
        ["--corpus-vocab", "subword", "--distill-lambda", "0.5",
         "--cache-dir", cache])
    run_id = read_run_id(os.path.join(work, "train_2a_distill_out",
                                      "task2A_kevinmathew.tsv"))
    check(run_id.endswith("_distill"), f"run id {run_id!r}")
    # The cache dir also holds the tokenizer's corpus vocab and token
    # cache; a refit teacher would add a second distill_ file.
    teacher = sorted(f for f in os.listdir(cache) if f.startswith("distill_"))
    check(teacher == [os.path.basename(path)],
          f"the teacher cache was not hit: {os.listdir(cache)}")
    with open(os.path.join(work, "train_2a_distill_out", "vocab.txt"),
              encoding="utf-8") as f:
        vocab = sum(1 for _ in f)
    print(f"  run id {run_id!r}; subword vocab {vocab} pieces")
    return dict(launches=launches, wall_s=wall, steps=len(metrics["steps"]),
                run_id=run_id, vocab=vocab)


def phase_smoke(torch):
    """The attention pair at ``smoke``'s shape (bf16, padding) held against
    the plain versions, then ``smoke`` on the card: exit 0, its F1 and
    launches."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.ops import attention as A
    from mpmc_tpu_torch.ops import build
    gen = torch.Generator(device="cuda").manual_seed(31)
    q, k, v, mask = attention_inputs(torch, SMOKE_SHAPE, "padding",
                                     torch.bfloat16, gen)
    tag = f"smoke padding {SMOKE_SHAPE} bfloat16"
    out, lse = A.attention_forward_cuda(q, k, v, mask, "padding")
    fwd_err = check_forward(A, q, k, v, mask, "padding", out, lse, tag)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(q.dtype)
    got = A.attention_backward_cuda(q, k, v, mask, "padding", out, lse, do)
    bwd_err = check_backward(A, q, k, v, mask, "padding", out, lse, do, got,
                             tag)
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    rc, text = _capture(cli_main, ["smoke"])
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"smoke returned {rc}")
    f1 = json.loads(text.strip().splitlines()[-1])["smoke_best_macro_f1"]
    check(all(launches[k] > 0 for k in launches), f"smoke launches {launches}")
    print(f"  smoke on the card: rc 0, best macro-F1 {f1}, {wall:.3f} s "
          f"wall; launches {launches}")
    return dict(launches=launches, wall_s=wall, best_macro_f1=f1,
                shape=list(SMOKE_SHAPE), fwd_max_abs_err=fwd_err,
                bwd_max_abs_err=bwd_err)


def phase_offline_classic(torch, work: str):
    """Phase 12: (a) the converted checkpoints into ``train --subtask 2c``,
    (b) ``extract-features`` and the f32 forward at its text shape, (c)
    ``train --subtask 2a --corpus-vocab subword --distill-lambda``, (d)
    ``smoke``."""
    ckpts = write_checkpoints(torch, work)
    out = dict(extract_shape=time_forward_at(torch, "extract_features",
                                             EXTRACT_SHAPE, EXTRACT_SHAPE[1],
                                             "padding"))
    torch.cuda.empty_cache()
    for name, run in (("train_2c_pretrained",
                       lambda: phase_train_2c_pretrained(torch, work, ckpts)),
                      ("extract_features",
                       lambda: phase_extract_features(torch, work, ckpts)),
                      ("train_2a_distill", lambda: phase_distill_2a(torch,
                                                                    work)),
                      ("smoke", lambda: phase_smoke(torch))):
        stamp(f"  {name}:")
        out[name] = run()
        torch.cuda.empty_cache()
    return out


# Phase 13: the host runtime.  The committed decode fixtures and the
# expected pixels (the JAX package's native decode; regenerated by
# tests/test_torch_native.py's write_fixtures): file, key, size, grayscale.
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "torch_data")
FIXTURES = [("hf.png", "hf_png_224", 224, False),
            ("hf.jpg", "hf_jpg_224", 224, False),
            ("hf.jpg", "hf_jpg_gray_128", 128, True),
            ("gray.png", "gray_png_96", 96, False),
            ("rgba.png", "rgba_png_96", 96, False)]
# A JPEG decoded by another libjpeg release may differ in its IDCT
# rounding; the difference is printed with the library versions and held
# to this many levels.  PNGs are held bit-equal.
JPEG_LEVEL_TOL = 2
PIPELINE_THREADS = 16
TOKENIZER_REPEAT = 20               # phase 5's corpus repeated for texts/s
SPARSE_VOCAB = 64000                # AraBERT's vocab rows (a shape only)
SPARSE_FLAGS = ["--recipe", "reference", "--embedding-optimizer", "sparse"]
OPTIMIZER_STEPS = 4                 # timed steps a turn (after 1 untimed)


def native_build_report(status):
    """Phase 1's report of the C++ host runtime's build (``status``:
    ``native_lib.build``'s result, the route each library came from): each
    library's route and file, the compiler's or loader's error of a route
    that failed, the libjpeg API version and the libpng loaded."""
    from mpmc_tpu_torch import native_lib
    from mpmc_tpu_torch.image import native
    for name, route in sorted(status.items()):
        err = native_lib.errors.get(name)
        if route is None:
            print(f"  {name}: NOT BUILT:\n{err}")
            continue
        how = ("the system's libraries" if route == "system" else
               "Pillow's bundled libjpeg/libpng (" + ", ".join(
                   os.path.basename(p) for p in native_lib._pillow_libs())
               + ") through native/include")
        print(f"  {name}: built by g++ against {how}: "
              f"{os.path.relpath(native_lib.load(name)._name)}")
        if err:
            print("    a route before it failed:\n    "
                  + "\n    ".join(err.splitlines()[:6]))
    versions = native.lib_versions()
    print(f"  libjpeg JPEG_LIB_VERSION "
          f"{versions[0] if versions else 'n/a'}, libpng "
          f"{versions[1] if versions else 'n/a'}")
    import numpy
    import PIL
    cxx = shutil.which("g++")
    cxx_version = (subprocess.run([cxx, "--version"], capture_output=True,
                                  text=True, timeout=60).stdout.splitlines()
                   [0] if cxx else "none")
    print(f"  host: {cxx_version}; Pillow {PIL.__version__}; numpy "
          f"{numpy.__version__}; {os.cpu_count()} CPUs")
    return status


def phase_decode_fixtures():
    """The committed fixtures through the port's native decoder against
    the committed expected pixels: PNGs bit-equal, JPEGs within
    ``JPEG_LEVEL_TOL`` levels (0 expected), the difference printed."""
    import numpy as np
    from mpmc_tpu_torch import native_lib
    from mpmc_tpu_torch.image import decode, native
    check(decode._load_native() is not None,
          "the native image decoder is absent: "
          f"{native_lib.errors.get('image_decode')}")
    want = np.load(os.path.join(FIXTURE_DIR, "expected.npz"))
    diffs = {}
    with decoded_by("native", len(FIXTURES), "the committed fixtures"):
        for name, key, size, gray in FIXTURES:
            got = decode.decode_image(name, size, gray, FIXTURE_DIR)
            diff = int(np.abs(got.astype(np.int32) - want[key]).max())
            diffs[key] = diff
            tol = 0 if name.endswith(".png") else JPEG_LEVEL_TOL
            check(got.shape == want[key].shape and diff <= tol,
                  f"{key}: the native decode differs from the expected "
                  f"pixels by {diff} levels (tol {tol}; libjpeg/libpng "
                  f"{native.lib_versions()})")
    print(f"  native decode of the committed fixtures, max level "
          f"difference from the expected pixels: {diffs} (PNG tol 0, JPEG "
          f"tol {JPEG_LEVEL_TOL}); route "
          f"{native_lib.routes.get('image_decode')}, versions "
          f"{native.lib_versions()}")
    return diffs


def phase_pipeline_rate(work: str):
    """``ImagePipeline.preload`` over phase 5's 224 images at 224 pixels,
    ``PIPELINE_THREADS`` threads: images/s (median of 3) on the native path
    and, for comparison, on the PIL path."""
    from mpmc_tpu_torch.image import decode
    from mpmc_tpu_torch.image.pipeline import ImagePipeline
    from mpmc_tpu_torch.io.manifest import read_manifest
    paths = []
    for name in ("train.json", "dev.json"):
        paths += read_manifest(os.path.join(work, name)).img_paths
    rates = {}
    saved = (decode._native, decode._native_checked)
    for backend in ("native", "pil"):
        if backend == "pil":
            decode._native, decode._native_checked = None, True
        times = []
        try:
            for _ in range(3):
                with decoded_by(backend, len(paths), f"preload ({backend})"):
                    t0 = time.perf_counter()
                    ImagePipeline(paths, root=work, size=224,
                                  decode_threads=PIPELINE_THREADS).preload()
                    times.append(time.perf_counter() - t0)
        finally:
            decode._native, decode._native_checked = saved
        rates[backend] = len(paths) / sorted(times)[1]
    print(f"  ImagePipeline.preload, {len(paths)} PNGs of 240 to 400 pixels "
          f"to 224, {PIPELINE_THREADS} threads: native "
          f"{rates['native']:.1f} images/s, PIL {rates['pil']:.1f} images/s "
          f"(median of 3 each)")
    return rates


def phase_tokenizer_rate(work: str):
    """Phase 5's corpus (train and dev texts, normalized) through the
    native and the Python WordPiece tokenizer at 128 tokens under a corpus
    vocab: 0 differing rows, and texts/s of each over the corpus repeated
    ``TOKENIZER_REPEAT`` times; the backend ``build_tokenizer`` picks."""
    import numpy as np
    from mpmc_tpu_torch.cli.experiments import (build_tokenizer,
                                                corpus_wordpiece_vocab)
    from mpmc_tpu_torch.io.manifest import read_manifest
    from mpmc_tpu_torch.text.native import NativeWordPieceTokenizer
    from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
    from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
    texts = []
    for name in ("train.json", "dev.json"):
        texts += [preprocess_arabic_tweet(t) for t in
                  read_manifest(os.path.join(work, name)).texts]
    py = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
    path = os.path.join(work, "tok_vocab.txt")
    py.save(path)
    nat = NativeWordPieceTokenizer(path)
    n_ids, n_mask = nat.encode_batch(texts, 128)
    p_ids, p_mask = py.encode_batch(texts, 128)
    differ = int(((n_ids != p_ids) | (n_mask != p_mask)).any(axis=1).sum())
    check(differ == 0, f"native and Python tokenizers differ on {differ} "
                       f"rows")
    many = texts * TOKENIZER_REPEAT
    rates = {}
    for name, tok in (("native", nat), ("python", py)):
        t0 = time.perf_counter()
        tok.encode_batch(many, 128)
        rates[name] = len(many) / (time.perf_counter() - t0)
    backend = type(build_tokenizer(texts, None,
                                   cache_dir=os.path.join(work, ".tok"))
                   ).__name__
    check(backend == "HybridWordPieceTokenizer",
          f"build_tokenizer picked {backend}, not the native tokenizer")
    print(f"  tokenizer: native and Python give 0 differing rows of "
          f"{len(texts)} at 128 tokens ({int(np.sum(n_mask))} tokens); "
          f"{len(many)} texts: native {rates['native']:.0f} texts/s, Python "
          f"{rates['python']:.0f} texts/s; build_tokenizer picks {backend} "
          f"(the C++ backend)")
    return dict(differing_rows=differ, texts_s=rates, backend=backend)


def phase_sparse_2a(torch, work: str):
    """``train --subtask 2a --recipe reference --embedding-optimizer sparse
    --profile-dir D`` at full width on phase 5's manifests (launches as
    phase 8's formula; the trace written names both attention kernels);
    then one batch through a sparse and a dense (adam) step from the same
    weights, the dense run's base LR set to the sparse tables' encoder LR
    (2A's embeddings are in the head group under dense Adam, as in the JAX
    package): touched rows within Adam's first-step bound of dense (0
    expected), the other rows unchanged bit for bit."""
    import glob
    trace_dir = os.path.join(work, "sparse_trace")
    argv, launches, metrics, _, _, wall = train_2a_cli(
        torch, work, "train_2a_sparse", SPARSE_FLAGS + ["--profile-dir",
                                                         trace_dir])
    traces = glob.glob(os.path.join(trace_dir, "*.json"))
    check(len(traces) == 1, f"--profile-dir wrote {traces}")
    with open(traces[0], encoding="utf-8") as f:
        text = f.read()
    named = {k: text.count(f"{k}_") for k in ("attention_fwd",
                                               "attention_bwd")}
    check(all(named.values()), f"the trace names no attention kernel: "
                               f"{named}")
    print(f"  --profile-dir: {os.path.basename(traces[0])}, "
          f"{len(text) / 1e6:.1f} MB, names the kernels {named} times")
    argv = [a for a in argv if a not in ("--profile-dir", trace_dir)]
    dense_argv = list(argv)
    dense_argv[dense_argv.index("sparse")] = "adam"
    from mpmc_tpu_torch.cli.main import build_parser
    from mpmc_tpu_torch.config import TrainConfig
    lr = build_parser().parse_args(argv).lr * TrainConfig.encoder_lr_scale
    dense_argv += ["--lr", repr(lr)]
    dev = torch.device("cuda")
    runs = {}
    for mode, a in (("sparse", argv), ("adam", dense_argv)):
        _, run, batches = _fold0(torch, a, bf16=True, dropout_zero=False,
                                 device=dev)
        runs[mode] = run
    emb = "encoder.word_embeddings.weight"
    table0 = runs["sparse"].model.state_dict()[emb].clone()
    check(bool((runs["adam"].model.state_dict()[emb] == table0).all()),
          "the two folds start from different weights")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batches[0].items()}
    for run in runs.values():
        run.train_step(dict(batch))
    touched = torch.unique(runs["sparse"].train_step.store["text_ids"]
                           [batch["idx"].long()])
    untouched = torch.ones(table0.shape[0], dtype=torch.bool, device=dev)
    untouched[touched] = False
    sparse = runs["sparse"].model.state_dict()[emb]
    dense = runs["adam"].model.state_dict()[emb]
    bound = 2 * lr
    err = (sparse[touched] - dense[touched]).abs().max().item()
    frozen = bool((sparse[untouched] == table0[untouched]).all())
    moved = int(((sparse != table0).any(dim=1)).sum())
    check(err <= bound and frozen,
          f"sparse vs dense Adam: touched rows differ by {err} (bound "
          f"{bound}), untouched rows unchanged: {frozen}")
    k = runs["sparse"].train_step.optimizer.support_rows
    print(f"  one batch, sparse vs dense Adam on the card: {len(touched)} "
          f"touched rows of {table0.shape[0]} (support bound K = {k}), "
          f"{moved} moved; touched max |sparse - dense| {err:.3g} (bound 2 "
          f"x lr {bound:.3g}); untouched rows unchanged bit for bit")
    del runs, batch
    torch.cuda.empty_cache()
    return dict(launches=launches, wall_s=wall, steps=len(metrics["steps"]),
                trace_kernel_mentions=named, touched_rows=len(touched),
                support_rows=k, touched_max_abs_diff=err)


def phase_optimizer_steps(torch, argv):
    """Warm 2A reference-recipe steps (unpacked, batch 16, bf16) under each
    embedding optimizer, at the corpus vocab and at ``SPARSE_VOCAB`` rows:
    one fold per vocab, each optimizer a train step of its own over that
    fold's model (the support bound as the driver sets it), timed in turns
    (adam, factored, sparse, sparse, factored, adam), each turn one untimed
    step and ``OPTIMIZER_STEPS`` timed; the median ms of each optimizer's
    timed steps.  The step is host-paced, so the turns spread the host's
    drift over the three."""
    import dataclasses
    from mpmc_tpu_torch.train.step import build_train_step
    dev = torch.device("cuda")
    argv = [a for a in argv if not a.startswith("--profile")]
    modes = ("adam", "factored", "sparse")
    out = {}
    for vocab in (None, SPARSE_VOCAB):
        cfg, run, batches = _fold0(torch, argv, bf16=True, dropout_zero=False,
                                   device=dev, vocab=vocab)
        store = run.train_step.store
        to_dev = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                  for b in batches[:OPTIMIZER_STEPS + 1]]
        steps = {mode: build_train_step(
            run.model, dataclasses.replace(cfg, embedding_optimizer=mode),
            run.steps_per_epoch, store,
            torch.Generator(device=dev).manual_seed(cfg.seed),
            embed_support=cfg.data.batch_size * store["text_ids"].shape[1])
            for mode in modes}
        times = {mode: [] for mode in modes}
        for mode in modes + modes[::-1]:
            for i, b in enumerate(to_dev):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                steps[mode](b)
                torch.cuda.synchronize()
                if i:
                    times[mode].append((time.perf_counter() - t0) * 1e3)
        rows = cfg.model.text.vocab_size
        for mode, ts in times.items():
            out[f"{mode}_{rows}"] = sorted(ts)[len(ts) // 2]
        del run, to_dev, store, steps
        torch.cuda.empty_cache()
    print(f"  warm 2A reference-recipe step, median ms of "
          f"{2 * OPTIMIZER_STEPS} in turns, by embedding optimizer and vocab "
          f"rows: " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    return out


def phase_host_runtime(torch, work: str, build_routes):
    """Phase 13: the committed fixtures through the native decoder, the
    image pipeline's and the tokenizers' rates, the 2A sparse run with
    ``--profile-dir``, sparse against dense Adam on one batch, and warm
    steps under each embedding optimizer."""
    out = dict(build_routes=build_routes)
    out["decode_level_diff"] = phase_decode_fixtures()
    out["preload_images_s"] = phase_pipeline_rate(work)
    out["tokenizer"] = phase_tokenizer_rate(work)
    stamp("  the 2A sparse run:")
    out["train_2a_sparse"] = phase_sparse_2a(torch, work)
    stamp("  warm steps by embedding optimizer:")
    argv = ["train", "--subtask", "2a",
            "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--fold", "0",
            "--epochs", "1", "--device", "cuda"] + SPARSE_FLAGS
    out["step_ms"] = phase_optimizer_steps(torch, argv)
    return out


SCAN_K = 4                          # phase 5's --scan-steps: 2 groups
PREDICT_SCAN_K = 8                  # phase 3's 8 batches: one group
# Folds of phase 14's fold-parallel run: 4, so that the whole script keeps
# its time with phase 15's second process; fewer would leave each fold
# fewer than 8 steps of 16, hence no full group of SCAN_K between evals
# and no graph to replay.
FOLDS = 4


@contextlib.contextmanager
def watch_fit(torch):
    """While active, record every ``GroupedSteps`` made (its captures,
    replays and per-graph launch tallies) and, after each ``fit`` returns,
    its train step's final model state on the host."""
    from mpmc_tpu_torch.train import graphs, loop
    seen = dict(groups=[], final=[])
    init, fit = graphs.GroupedSteps.__init__, loop.fit

    def made(self, *args, **kwargs):
        init(self, *args, **kwargs)
        seen["groups"].append(self)

    def fitted(train_step, *args, **kwargs):
        res = fit(train_step, *args, **kwargs)
        seen["final"].append({k: v.detach().cpu().clone() for k, v in
                              train_step.model.state_dict().items()})
        return res

    graphs.GroupedSteps.__init__, loop.fit = made, fitted
    try:
        yield seen
    finally:
        graphs.GroupedSteps.__init__, loop.fit = init, fit


def graph_launches(groups) -> dict:
    """Kernel launches that ran inside graph replays, by kernel."""
    out = {}
    for g in groups:
        for entry in g.graphs.values():
            for name, n in entry.tally.items():
                out[name] = out.get(name, 0) + n * entry.replays
    return out


def replays_by_kind(groups) -> dict:
    """Graph captures and replays of the train and eval groups."""
    out = {}
    for g in groups:
        kind = "train" if g.counter is not None else "eval"
        c, r = out.get(kind, (0, 0))
        out[kind] = (c + g.captures, r + g.replays)
    return out


def max_state_diff(a: dict, b: dict) -> float:
    return max((a[k].float() - b[k].float()).abs().max().item() for k in a)


def compare_runs(out_a: str, out_b: str, prefix: str, what: str):
    """Two runs' TSVs byte for byte, or ids and labels equal and the
    probabilities' max |diff|; and their per-step metrics."""
    import glob
    names = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out_a, "*.tsv")))
    check(names and names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(out_b, "*.tsv"))), f"{what}: TSV files differ")
    same, worst = True, 0.0
    for name in names:
        ra, rb = (tsv_rows(os.path.join(d, name)) for d in (out_a, out_b))
        same &= ra == rb
        check([r[:2] for r in ra] == [r[:2] for r in rb],
              f"{what}: {name} ids or labels differ")
        if len(ra[0]) > 3:
            worst = max([worst] + [abs(float(x[2]) - float(y[2]))
                                   for x, y in zip(ra[1:], rb[1:])])
    with open(os.path.join(out_a, f"{prefix}_train_metrics_fold_0.json")) as f:
        ma = json.load(f)
    with open(os.path.join(out_b, f"{prefix}_train_metrics_fold_0.json")) as f:
        mb = json.load(f)
    loss = max(abs(x["loss"] - y["loss"]) for x, y in zip(ma["steps"],
                                                         mb["steps"]))
    return dict(tsvs_identical=bool(same), max_prob_diff=worst,
                steps_identical=ma["steps"] == mb["steps"],
                max_step_loss_diff=loss, steps=len(ma["steps"]), tsvs=names)


def phase_scan_2c(torch, work: str, argv, launches_k4, watch_k4):
    """Phase 5's ``--scan-steps 4`` run against the same command line at
    ``--scan-steps 1``: graphs captured and replayed (train and eval) at
    K = 4, the three kernels' launches equal, the TSVs, the per-step
    losses, the final weights (the warm steps at K = 1 and K = 4 are phase
    5's, ``scan_turns``)."""
    import numpy as np
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.ops import build
    k1 = list(argv)
    k1[k1.index("--scan-steps") + 1] = "1"
    k1[k1.index("--out-dir") + 1] = os.path.join(work, "train_out_k1")
    # No checkpoints: the weights come from the run itself (``watch_fit``),
    # and every checkpoint of a full-width run is gigabytes of writes.
    i = k1.index("--checkpoint-dir")
    del k1[i:i + 2]
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with watch_fit(torch) as watch_k1:
        check(cli_main(k1) == 0, "train --scan-steps 1 failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_k1 = dict(build.launch_counts)
    check(launches_k1 == launches_k4, f"launches at K = 1 {launches_k1} and "
                                      f"K = {SCAN_K} {launches_k4} differ")
    reps = replays_by_kind(watch_k4["groups"])
    check(reps.get("train", (0, 0))[1] > 0 and reps.get("eval", (0, 0))[1] > 0,
          f"K = {SCAN_K}: graphs (captures, replays) {reps}")
    in_graphs = graph_launches(watch_k4["groups"])
    cmp = compare_runs(os.path.join(work, "train_out"),
                       os.path.join(work, "train_out_k1"), "task2C",
                       "2C K = 4 vs 1")
    params = max_state_diff(watch_k4["final"][0], watch_k1["final"][0])
    bitwise = params == 0 and cmp["tsvs_identical"] and cmp["steps_identical"]
    # Expected bit for bit (the kernels are deterministic, the generator
    # is registered with the graph); else within Adam's bound over the
    # run's steps and the predict check's 1e-3 on probabilities.
    lr = 1e-5
    bound = 2 * 3.17 * lr * cmp["steps"]
    check(params <= bound and cmp["max_prob_diff"] <= 1e-3,
          f"K = {SCAN_K} vs 1: weights differ by {params}, probabilities by "
          f"{cmp['max_prob_diff']}")
    print(f"  train --scan-steps 1 beside phase 5's --scan-steps {SCAN_K}: "
          f"{wall:.3f} s wall; launches equal {launches_k1}; at K = {SCAN_K} "
          f"graphs (captures, replays) {reps}, launches inside graph replays "
          f"{in_graphs}; bit for bit: {bitwise} (TSVs {cmp['tsvs_identical']}"
          f", per-step losses {cmp['steps_identical']}, final weights max "
          f"|diff| {params:.3g}; probabilities max |diff| "
          f"{cmp['max_prob_diff']:.3g}, tol 1e-3; weights bound {bound:.3g})")

    torch.cuda.empty_cache()
    return dict(launches=launches_k1, graphs=reps,
                launches_in_graphs=in_graphs,
                bitwise=bitwise, final_weights_max_abs_diff=params,
                max_prob_diff=cmp["max_prob_diff"],
                max_step_loss_diff=cmp["max_step_loss_diff"], wall_s=wall)


def phase_scan_predict(torch, work: str, argv):
    """``predict --scan-steps 8`` against ``--scan-steps 1`` on phase 3's
    128 memes (one full group): the same launches and probabilities bit
    for bit; then warm memes/s of K = 1 passes and K = 8 replays in turns,
    the replays' probabilities bit-equal to K = 1's."""
    import numpy as np
    from mpmc_tpu_torch.cli.main import (build_parser, load_model,
                                         main as cli_main, prepare_inputs)
    from mpmc_tpu_torch.config import TrainConfig
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train.graphs import graph_pool, make_scan_eval_step
    from mpmc_tpu_torch.train.loop import run_eval
    from mpmc_tpu_torch.train.step import make_eval_step
    got = {}
    for k in (PREDICT_SCAN_K, 1):
        a = list(argv)
        for flag, name in (("--out", f"pred_k{k}.tsv"),
                           ("--probs-out", f"probs_k{k}.tsv")):
            a[a.index(flag) + 1] = os.path.join(work, name)
        for key in build.launch_counts:
            build.launch_counts[key] = 0
        check(cli_main(a + ["--scan-steps", str(k)]) == 0,
              f"predict --scan-steps {k} failed")
        torch.cuda.synchronize()
        got[k] = (read_probs(os.path.join(work, f"probs_k{k}.tsv")),
                  dict(build.launch_counts))
    check(got[1] == got[PREDICT_SCAN_K], "predict --scan-steps 8 and 1 "
                                         "differ (probabilities or launches)")
    args = build_parser().parse_args(argv)
    inputs = prepare_inputs(args)
    dev = torch.device("cuda")
    model = load_model(args, inputs.variant, dev, 42)
    step = make_eval_step(model, TrainConfig(bf16=True))
    scan = make_scan_eval_step(step, PREDICT_SCAN_K, dev, graph_pool(dev))
    ref = run_eval(step, inputs.data, BATCH, dev).probs
    first = run_eval(step, inputs.data, BATCH, dev, scan).probs
    times = {1: [], PREDICT_SCAN_K: []}
    same = bool(np.array_equal(first, ref))
    for _ in range(3):
        for k in (1, PREDICT_SCAN_K, PREDICT_SCAN_K, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p = run_eval(step, inputs.data, BATCH, dev,
                         scan if k > 1 else None).probs
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
            same &= bool(np.array_equal(p, ref))
    check(scan.replays == 6 and same, f"K = 8 replays {scan.replays}, "
                                      f"probabilities equal to K = 1: {same}")
    rate = {k: N_MEMES / sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  predict --scan-steps {PREDICT_SCAN_K} vs 1 on {N_MEMES} memes: "
          f"probabilities and launches {got[1][1]} equal; warm, in turns: "
          f"K = 1 {rate[1]:.2f} memes/s, K = {PREDICT_SCAN_K} "
          f"{rate[PREDICT_SCAN_K]:.2f} memes/s (median of 6 passes each; "
          f"{scan.replays} replays, probabilities bit-equal to K = 1)")
    in_graphs = graph_launches([scan])
    del model, step, scan
    torch.cuda.empty_cache()
    return dict(launches=got[1][1], launches_in_graphs=in_graphs,
                memes_s={str(k): v for k, v in rate.items()})


def phase_scan_2a_sparse(torch, work: str, k1_launches, k1_watch):
    """Phase 13's ``train --subtask 2a --recipe reference
    --embedding-optimizer sparse`` (K = 1) again at ``--scan-steps 4`` (12
    steps an epoch, an eval every 6: groups 4, 2, 4, 2): launches, TSVs,
    per-step losses and final weights against phase 13's run (the sparse
    optimizer's device count and tables inside the graph)."""
    with watch_fit(torch) as w:
        _, launches, _, _, _, wall = train_2a_cli(
            torch, work, f"train_2a_sparse_k{SCAN_K}",
            SPARSE_FLAGS + ["--scan-steps", str(SCAN_K)], checkpoint=False)
    check(launches == k1_launches,
          f"sparse 2A launches at K = 4 {launches}, K = 1 {k1_launches}")
    reps = replays_by_kind(w["groups"])
    check(reps.get("train", (0, 0))[1] > 0, f"sparse 2A graphs {reps}")
    cmp = compare_runs(os.path.join(work, f"train_2a_sparse_k{SCAN_K}_out"),
                       os.path.join(work, "train_2a_sparse_out"),
                       "task2A", "sparse 2A K = 4 vs 1")
    params = max_state_diff(w["final"][0], k1_watch["final"][0])
    bound = 2 * 3.17 * 1e-5 * cmp["steps"]
    check(params <= bound and cmp["max_prob_diff"] <= 1e-3,
          f"sparse 2A K = 4 vs 1: weights {params}, probs "
          f"{cmp['max_prob_diff']}")
    print(f"  train --subtask 2a sparse at K = {SCAN_K} against phase 13's "
          f"K = 1: {wall:.3f} s wall, launches equal {launches}, graphs "
          f"(captures, replays) {reps}, TSVs identical "
          f"{cmp['tsvs_identical']}, per-step losses identical "
          f"{cmp['steps_identical']}, final weights max |diff| {params:.3g}, "
          f"probabilities max |diff| {cmp['max_prob_diff']:.3g} (tol 1e-3; "
          f"weights bound {bound:.3g})")
    torch.cuda.empty_cache()
    return dict(launches=launches, graphs=reps,
                launches_in_graphs=graph_launches(w["groups"]),
                tsvs_identical=cmp["tsvs_identical"],
                steps_identical=cmp["steps_identical"],
                final_weights_max_abs_diff=params, wall_s=wall)


@contextlib.contextmanager
def attention_shapes(torch):
    """The ``[B, S, H, D]`` shapes the attention kernels were launched at
    while active."""
    from mpmc_tpu_torch.ops import attention as A
    seen = set()
    fwd = A.attention_forward_cuda

    def recording(q, *args, **kwargs):
        seen.add(tuple(q.shape))
        return fwd(q, *args, **kwargs)

    A.attention_forward_cuda = recording
    try:
        yield seen
    finally:
        A.attention_forward_cuda = fwd


def phase_fold_parallel(torch, work: str):
    """``train --subtask 2c --fold-parallel --scan-steps 4`` on phase 5's
    manifests (``FOLDS`` folds at once, one epoch, unpacked): launches a
    step of 24 attention forwards and 24 backwards at ``[FOLDS*16, S, 12,
    64]`` and one
    image kernel (one fold's count), 24 forwards per eval batch; 5
    per-fold probability TSVs and checkpoints; ``predict --checkpoint
    <dir>/fold_2`` reproduces fold 2's best eval."""
    # Each fold that improves writes its whole training state at full
    # width: the folds' checkpoints go to memory (/dev/shm) where there
    # is one, to keep the script's writes to disk within what a card host
    # with a small disk takes beside the other phases.
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    ckpt = tempfile.mkdtemp(prefix="fp_ck_", dir=shm or work)
    try:
        return _fold_parallel_run(torch, work, ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _fold_parallel_run(torch, work: str, ckpt: str):
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.ops import build
    out_dir = os.path.join(work, "fp_out")
    argv = ["train", "--subtask", "2c",
            "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--image-root", work,
            "--epochs", "1", "--fold-parallel", "--scan-steps", str(SCAN_K),
            "--num-folds", str(FOLDS), "--checkpoint-dir", ckpt,
            "--out-dir", out_dir, "--device", "cuda"]
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    t0 = time.perf_counter()
    with watch_fit(torch) as w, attention_shapes(torch) as shapes:
        rc = cli_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    check(rc == 0, f"train --fold-parallel returned {rc}")
    metrics = []
    for k in range(FOLDS):
        with open(os.path.join(out_dir,
                               f"task2C_train_metrics_fold_{k}.json")) as f:
            metrics.append(json.load(f))
    steps = len(metrics[0]["steps"])
    evals = len(metrics[0]["evals"])
    eval_batches = evals * math.ceil(N_DEV / BATCH)
    want = {"attention_fwd": 24 * (steps + eval_batches),
            "attention_bwd": 24 * steps, "image_normalize": steps}
    check(launches == want, f"fold-parallel launches {launches}, expected "
                            f"{want} (one fold's count)")
    reps = replays_by_kind(w["groups"])
    check(reps.get("train", (0, 0))[1] > 0, f"fold-parallel graphs {reps}")
    want_shapes = {(FOLDS * BATCH, 128, 12, 64), (FOLDS * BATCH, 64, 12, 64)}
    check(shapes == want_shapes, f"fold-parallel attention shapes {shapes}")
    bad = [s for m in metrics for s in m["steps"]
           if not (math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]))]
    check(not bad, f"non-finite fold-parallel loss or grad norm: {bad}")
    prefix = os.path.join(out_dir, "task2C_kevinmathew")
    for k in range(FOLDS):
        check(os.path.exists(f"{prefix}_probs_fold_{k}.tsv")
              and os.path.exists(os.path.join(ckpt, f"fold_{k}", "model.pt")),
              f"fold {k}: TSV or checkpoint missing")
    pred = os.path.join(work, "fp_pred.tsv")
    pred_probs = os.path.join(work, "fp_pred_probs.tsv")
    check(cli_main(["predict", "--subtask", "2c", "--manifest",
                    os.path.join(work, "dev.json"), "--checkpoint",
                    os.path.join(ckpt, "fold_2"), "--image-root", work,
                    "--out", pred, "--probs-out", pred_probs, "--device",
                    "cuda"]) == 0, "predict from fold 2 failed")
    got, best = (read_probs(p) for p in (pred_probs,
                                         f"{prefix}_probs_fold_2.tsv"))
    err = max(abs(a - b) for a, b in zip(got, best))
    check(len(got) == len(best) == N_DEV and err <= 1e-4,
          f"predict from fold 2 differs from its best eval by {err}")
    best_f1 = [round(max(h["test_f1"] for h in m["evals"]), 4)
               for m in metrics]
    print(f"  train --subtask 2c --fold-parallel --scan-steps {SCAN_K}, "
          f"{FOLDS} folds, one epoch, unpacked: rc 0, {wall:.3f} s wall; "
          f"{steps} steps, {evals} evals; launches {launches} = one fold's "
          f"count (24 x ({steps} steps + {eval_batches} eval batches), 24 x "
          f"{steps}, {steps}); attention shapes {sorted(shapes)}; graphs "
          f"(captures, replays) {reps}; best F1 per fold "
          f"{best_f1}"
          f"; predict --checkpoint fold_2: max |prob - best eval| {err:.3g} "
          f"(tol 1e-4)")
    torch.cuda.empty_cache()
    return dict(launches=launches, shapes=sorted(shapes), graphs=reps,
                launches_in_graphs=graph_launches(w["groups"]), wall_s=wall,
                steps=steps)


def phase_fold_parallel_card_vs_single(torch, work: str):
    """One fold-parallel step of ``FOLDS`` replicas in f32 (TF32 off,
    dropout 0, encoders cut to ``CARD_VS_CPU_LAYERS`` layers at full
    width) against
    each replica's own step on the same rows and augmentation draws, on
    the card, at phase 6's tolerances.  Gain 1: a gain above 1 clips pixels
    to exactly 1.0, whose ties in the stem's max-pool vmap's batched
    convolutions (other rounding) may break elsewhere."""
    import numpy as np
    from mpmc_tpu_torch.cli.experiments import prepare_2c, resident_store
    from mpmc_tpu_torch.cli.main import build_parser, train_config
    from mpmc_tpu_torch.cv.kfold import stratified_kfold
    from mpmc_tpu_torch.image.augment import augment_with_draws
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.parallel.fold_parallel import (
        build_fold_parallel_steps)
    from mpmc_tpu_torch.train.step import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    argv = ["train", "--subtask", "2c",
            "-tr", os.path.join(work, "train.json"),
            "-te", os.path.join(work, "dev.json"), "--image-root", work,
            "--fold-parallel", "--device", "cuda"]
    cfg, _ = train_config(build_parser().parse_args(argv))
    prep = prepare_2c(cfg, tempfile.mkdtemp(dir=os.getcwd()))
    cfg = _cut_cfg(prep.cfg, bf16=False, dropout_zero=True,
                   layers=CARD_VS_CPU_LAYERS)
    store = resident_store(cfg, prep.data, dev)
    rng = np.random.default_rng(14)
    n = FOLDS * BATCH
    draws = [torch.from_numpy(x).to(dev) for x in (
        rng.random(n) < 0.5, np.ones(n, np.float32),
        (rng.uniform(-15, 15, n) * math.pi / 180).astype(np.float32))]
    splits = stratified_kfold(prep.data["label"], FOLDS, cfg.data.fold_seed)
    idx = torch.from_numpy(np.stack([rng.permutation(tr)[:BATCH]
                                     for tr, _ in splits])).to(dev)
    total = 8                            # warmup 0: lr > 0 at the step
    models = [build_model(cfg.model, dev, seed=cfg.seed + k)
              for k in range(FOLDS)]
    init = [{k: v.clone() for k, v in m.state_dict().items()}
            for m in models]
    fp, _ = build_fold_parallel_steps(
        models, cfg, total, store, store, torch.Generator(device=dev),
        augment=lambda u8, gen: augment_with_draws(u8, *draws))
    del models
    m = fp({"idx": idx, "valid": torch.ones(FOLDS, BATCH, device=dev)})
    worst = dict(loss=0.0, grad_norm=0.0, params=0.0, stats=0.0)
    off = count = 0
    lr = fp.optimizer.schedules["head"](0)
    for k in range(FOLDS):
        single = build_model(cfg.model, dev)
        single.load_state_dict(init[k])
        step = build_train_step(
            single, cfg, total, store, torch.Generator(device=dev),
            augment=lambda u8, gen, k=k: augment_with_draws(
                u8, *(d[k * BATCH:(k + 1) * BATCH] for d in draws)))
        ms = step({"idx": idx[k], "valid": torch.ones(BATCH, device=dev)})
        worst["loss"] = max(worst["loss"], abs(float(m["loss"][k])
                                               - float(ms["loss"]))
                            / abs(float(ms["loss"])))
        worst["grad_norm"] = max(worst["grad_norm"],
                                 abs(float(m["grad_norm"][k])
                                     - float(ms["grad_norm"]))
                                 / float(ms["grad_norm"]))
        got = fp.model.fold_state(k)
        for name, w in single.state_dict().items():
            d = (got[name] - w).abs()
            if "running_" in name:
                worst["stats"] = max(worst["stats"], d.max().item())
                continue
            worst["params"] = max(worst["params"], d.max().item())
            off += int((d > 0.1 * lr).sum())
            count += d.numel()
        del single, step
    print(f"  one fold-parallel f32 step of {FOLDS} replicas "
          f"({CARD_VS_CPU_LAYERS} layers) vs each replica's own step on the "
          f"card: loss max rel diff {worst['loss']:.3g} (tol 1e-4), grad "
          f"norm {worst['grad_norm']:.3g}"
          f" (tol 1e-3), parameters max |diff| {worst['params']:.3g} (bound "
          f"{2 * 3.17 * lr:.3g}), {off} of {count} beyond 0.1 lr (tol 1 %), "
          f"batch statistics {worst['stats']:.3g} (tol 1e-5)")
    check(worst["loss"] <= 1e-4 and worst["grad_norm"] <= 1e-3
          and worst["params"] <= 2 * 3.17 * lr and off <= 0.01 * count
          and worst["stats"] <= 1e-5,
          "fold-parallel step and single-fold steps disagree")
    del fp
    torch.cuda.empty_cache()
    return dict(worst, params_beyond_tenth_lr=off, params_count=count)


def phase_scan_and_folds(torch, work: str, predict_argv, train_argv,
                         launches_k4, watch_k4, p13, p13_watch):
    """Phase 14: one dispatch for K steps, and fold-parallel training."""
    stamp("  2C train at K = 4 vs K = 1:")
    out = dict(train_2c=phase_scan_2c(torch, work, train_argv, launches_k4,
                                      watch_k4))
    stamp("  predict at K = 8 vs K = 1:")
    out["predict"] = phase_scan_predict(torch, work, predict_argv)
    stamp("  sparse 2A at K = 4 vs phase 13's K = 1:")
    out["train_2a_sparse"] = phase_scan_2a_sparse(
        torch, work, p13["train_2a_sparse"]["launches"], p13_watch)
    stamp("  fold-parallel 2C:")
    out["fold_parallel"] = phase_fold_parallel(torch, work)
    stamp("  fold-parallel f32 step vs single-fold steps:")
    out["fold_parallel_f32"] = phase_fold_parallel_card_vs_single(torch, work)
    return out


T_START = time.perf_counter()


# Phase 15: the multi-GPU layouts at world size 1.  Each sharded encoder
# against the plain one in bf16, each path at its own limit:
# * Ulysses runs the plain encoder's operations (an all-to-all of one rank
#   moves nothing): logits and every gradient bit for bit;
# * PP at S = 1 runs each microbatch's forward as the plain one does row
#   for row: logits bit for bit; its gradients sum four microbatches'
#   bf16 GEMMs in another order;
# * ring (its own f32 online softmax on bf16 inputs, as the JAX package's
#   is XLA) and TP (the row-parallel layers' separate bias add): logits
#   and gradients rounded in other places.
# Those three are held per leaf: ||g - plain|| / ||plain|| (L2 over the
# leaf) within the path's LAYOUT_LEAF_TOL, and the logits the same way:
# above the sound readings and below planted faults of 0.25 (one of four
# microbatches' gradient lost from a leaf) and 1 (a leaf's gradient
# dropped or doubled); the script plants both and checks that they fail.
# Measured worst leaves (H100, PERF.md PR 13): ring 5.4e-2 (the pooling's
# first bias, which bf16 rounding alone moves by 3.5e-2), TP 1.8e-2, PP
# 4.2e-3.
# The bf16 control (the plain encoder in bf16 against the same weights in
# f32) shows what bf16 rounding alone does to each leaf.  Leaves whose
# gradient is zero in exact arithmetic (every key bias and the attention
# pooling's score bias: softmax is shift-invariant) are all rounding; they
# are held to a hundredth of the largest gradient entry instead.
LAYOUT_LEAF_TOL = {"sp_ring": 0.1, "tp_1": 0.1, "pp_s1_m4": 0.02}
LAYOUT_EXACT = {"sp_ulysses": ("logits", "grads"), "pp_s1_m4": ("logits",)}
ZERO_GRAD_LEAVES = ("attention.key.bias", "attn_fc2.bias")
LAYOUT_SHAPE = (16, 128)


def leaf_errors(torch, names, grads, ref_grads):
    """Per leaf of ``names``: ||g - r|| / ||r|| (``rel``), and for the
    leaves whose gradient is zero in exact arithmetic max |g - r| over the
    largest entry of any gradient (``zero``); the leaves without a
    gradient are skipped."""
    largest = max(r.float().abs().max().item() for r in ref_grads
                  if r is not None)
    rel, zero = {}, {}
    for n, g, r in zip(names, grads, ref_grads):
        if r is None:
            continue
        d = g.float() - r.float()
        if n.endswith(ZERO_GRAD_LEAVES):
            zero[n] = d.abs().max().item() / largest
        else:
            rel[n] = (d.norm() / r.float().norm().clamp_min(1e-30)).item()
    return rel, zero


def layout_encoders(torch):
    """In a launched world of one process: the full-width 2A text
    classifier sequence-parallel (ring, Ulysses), pipelined (S = 1, M = 4)
    and tensor-parallel (one shard: the vocabulary-parallel lookup and the
    row-parallel layers' separate bias add) against the plain classifier
    on the same bf16 weights and batch,
    forward and backward (eval mode: no dropout), with each path's kernel
    launches and a warm forward-and-backward time."""
    from torch.func import functional_call
    from mpmc_tpu_torch.config import ModelConfig, PoolingType
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.parallel.pp import PipelineText
    from mpmc_tpu_torch.parallel.sp import SequenceParallelText
    from mpmc_tpu_torch.parallel.tp import tensor_parallel
    dev = torch.device("cuda", torch.cuda.current_device())
    mcfg = dataclasses.replace(ModelConfig(), num_classes=2,
                               pooling=PoolingType.ATTENTION)
    plain = build_model(mcfg, dev, seed=0, kind="text")
    weights = {n: p.detach().to(torch.bfloat16).requires_grad_()
               for n, p in plain.named_parameters()}
    gen = torch.Generator(device=dev).manual_seed(15)
    B, S = LAYOUT_SHAPE
    ids = torch.randint(5, mcfg.text.vocab_size, (B, S), generator=gen,
                        device=dev)
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device=dev)
    mask = (torch.arange(S, device=dev)[None] < lens[:, None]).long()
    w = torch.randn(B, 2, generator=gen, device=dev)
    names = list(weights)

    def run(model):
        model.eval()
        for key in build.launch_counts:
            build.launch_counts[key] = 0
        out = functional_call(model, weights, (ids, mask)).float()
        grads = torch.autograd.grad((out * w).sum(), list(weights.values()),
                                    allow_unused=True)
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        t0 = time.perf_counter()
        again = functional_call(model, weights, (ids, mask)).float()
        torch.autograd.grad((again * w).sum(), list(weights.values()),
                            allow_unused=True)
        torch.cuda.synchronize()
        return out, grads, launches, (time.perf_counter() - t0) * 1e3

    ref_out, ref_grads, ref_launches, ref_ms = run(plain)
    check(ref_launches["attention_fwd"] == 12
          and ref_launches["attention_bwd"] == 12,
          f"plain encoder launches {ref_launches}")
    # The bf16 control: the plain encoder on the same weights in f32.
    bf16_weights = weights
    weights = {n: p.detach().float().requires_grad_()
               for n, p in bf16_weights.items()}
    f32_out, f32_grads, _, _ = run(plain)
    weights = bf16_weights
    ctl_rel, ctl_zero = leaf_errors(torch, names, ref_grads, f32_grads)
    control = dict(
        logits_rel_err=((ref_out - f32_out).norm()
                        / f32_out.norm()).item(),
        grad_rel_err=max(ctl_rel.values()),
        worst_grad=max(ctl_rel, key=ctl_rel.get),
        zero_grad_err=max(ctl_zero.values()))
    del f32_out, f32_grads
    world = torch.distributed.group.WORLD
    res = {"plain": dict(launches=ref_launches, fwd_bwd_ms=ref_ms,
                         bf16_control=control)}
    expect = {"sp_ring": (0, 0), "sp_ulysses": (12, 12),
              "pp_s1_m4": (48, 48), "tp_1": (12, 12)}
    for name, model in (
            ("sp_ring", SequenceParallelText.wrap(plain, world, "ring")),
            ("sp_ulysses", SequenceParallelText.wrap(plain, world,
                                                     "ulysses")),
            ("pp_s1_m4", PipelineText.wrap(plain, world, 4)),
            ("tp_1", tensor_parallel(
                build_model(mcfg, dev, seed=0, kind="text"), world,
                lambda: build_model(mcfg, torch.device("meta"),
                                    kind="text")))):
        out, grads, launches, ms = run(model)
        logits = ((out - ref_out).norm() / ref_out.norm()).item()
        rel, zero = leaf_errors(torch, names, grads, ref_grads)
        where = max(rel, key=rel.get)
        worst, zero_worst = rel[where], max(zero.values())
        exact = LAYOUT_EXACT.get(name, ())
        tol = LAYOUT_LEAF_TOL.get(name, 0.0)
        check(logits <= (0.0 if "logits" in exact else tol),
              f"{name}: logits {logits:.3g} relative to the plain encoder "
              f"(limit {0.0 if 'logits' in exact else tol})")
        if "grads" in exact:
            check(worst == 0 and zero_worst == 0,
                  f"{name}: gradients differ from the plain encoder's "
                  f"({where} {worst:.3g}), expected bit for bit")
        else:
            check(worst <= tol and zero_worst <= 1e-2,
                  f"{name}: gradient {where} {worst:.3g} relative to the "
                  f"plain encoder (limit {tol}), zero-gradient "
                  f"leaves {zero_worst:.3g} of the largest entry (limit "
                  f"1e-2)")
            # Planted faults, which the limit must catch: the leaf with
            # the largest gradient missing one of four microbatches, and
            # dropped.
            big = max(rel, key=lambda n: ref_grads[names.index(n)].norm())
            i = names.index(big)
            planted = {}
            for fault, scale in (("quarter_lost", 0.75), ("dropped", 0.0)):
                bad = list(grads)
                bad[i] = grads[i] * scale
                planted[fault] = leaf_errors(torch, [big], [bad[i]],
                                             [ref_grads[i]])[0][big]
                check(planted[fault] > tol,
                      f"{name}: the planted fault {fault} on {big} reads "
                      f"{planted[fault]:.3g}, within the limit")
        fwd, bwd = expect[name]
        check(launches["attention_fwd"] == fwd
              and launches["attention_bwd"] == bwd,
              f"{name}: launches {launches}, expected {expect[name]}")
        res[name] = dict(launches=launches, logits_rel_err=logits,
                         grad_rel_err=worst, worst_grad=where,
                         zero_grad_err=zero_worst, fwd_bwd_ms=ms,
                         bitwise=bool(logits == 0 and worst == 0
                                      and zero_worst == 0))
        if "grads" not in exact:
            res[name]["planted"] = planted
        del model
    del plain, weights
    torch.cuda.empty_cache()
    return res


def layouts_worker(argv, final_path: str):
    """Phase 15 on the one rank of a launched world: phase 5's command line
    through the data-parallel path (its launches and collectives, its
    final weights saved to ``final_path``, its train group replays timed),
    then :func:`layout_encoders`."""
    import torch
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train import graphs
    replays = []
    call = graphs.GroupedSteps.__call__

    def timed(self, group):
        before = self.replays
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, group)
        torch.cuda.synchronize()
        if self.counter is not None and self.replays > before:
            replays.append((time.perf_counter() - t0) * 1e3 / self.k)
        return out

    graphs.GroupedSteps.__call__ = timed
    try:
        with watch_fit(torch) as seen:
            rc = cli_main(argv)
    finally:
        graphs.GroupedSteps.__call__ = call
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    collectives = dict(build.collective_calls)
    torch.save(seen["final"][0], final_path)
    graphs_run = replays_by_kind(seen["groups"])
    del seen
    torch.cuda.empty_cache()
    return dict(rc=rc, launches=launches, collectives=collectives,
                replay_ms=replays, graphs=graphs_run,
                encoders=layout_encoders(torch))


def phase_layouts(torch, work: str, argv, launches_k4, watch_k4, turns):
    """Phase 15: phase 5's run through the data-parallel path in a world of
    one process over NCCL, against phase 5's own run; the sharded 2A
    encoders against the plain one (:func:`layouts_worker`)."""
    from mpmc_tpu_torch.parallel.dist_worker import launch_processes
    dp = list(argv)
    dp[dp.index("--out-dir") + 1] = os.path.join(work, "train_out_dp")
    i = dp.index("--checkpoint-dir")
    del dp[i:i + 2]
    final = os.path.join(work, "dp_final.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    [line] = launch_processes(
        1, device="cuda", target="chip_smoke:layouts_worker",
        kwargs={"argv": dp, "final_path": final}, timeout=600)
    wall = time.perf_counter() - t0
    res = line["result"]
    check(res["rc"] == 0, f"train in a world of one returned {res['rc']}")
    check(res["launches"] == launches_k4,
          f"launches in a world of one {res['launches']}, phase 5 "
          f"{launches_k4}")
    check(res["graphs"].get("train", (0, 0))[1] > 0,
          f"no train graph replayed in a world of one: {res['graphs']}")
    cmp = compare_runs(os.path.join(work, "train_out"),
                       os.path.join(work, "train_out_dp"), "task2C",
                       "2C world 1 vs phase 5")
    params = max_state_diff(watch_k4["final"][0],
                            torch.load(final, weights_only=True))
    bitwise = params == 0 and cmp["tsvs_identical"] and cmp["steps_identical"]
    # Expected bit for bit: in a world of one every collective sums one
    # term, and the BatchNorm statistics are divided by 1.  Else within
    # Adam's bound over the run's steps and 1e-3 on probabilities.
    bound = 2 * 3.17 * 1e-5 * cmp["steps"]
    check(params <= bound and cmp["max_prob_diff"] <= 1e-3,
          f"world 1 vs phase 5: weights differ by {params}, probabilities "
          f"by {cmp['max_prob_diff']}")
    per_step = {k: v / cmp["steps"] for k, v in res["collectives"].items()
                if k == "all_reduce"}
    warm = sorted(res["replay_ms"])
    print(f"  train --subtask 2c in a world of one over NCCL: {wall:.3f} s "
          f"wall (process start included); launches {res['launches']} equal "
          f"phase 5's; collectives {res['collectives']} ({per_step} a step; "
          f"the all-gathers are the evals'); bit for bit: {bitwise} (TSVs "
          f"{cmp['tsvs_identical']}, per-step losses {cmp['steps_identical']}"
          f", final weights max |diff| {params:.3g}, probabilities max "
          f"|diff| {cmp['max_prob_diff']:.3g}); train group replays "
          f"{[round(x, 3) for x in warm]} ms/step beside phase 5's warm K = "
          f"{SCAN_K} {turns['warm_step_ms'][str(SCAN_K)]:.3f} ms/step")
    control = res["encoders"]["plain"]["bf16_control"]
    print(f"  2A encoder bf16 against f32 (the control): logits "
          f"{control['logits_rel_err']:.3g}, worst leaf "
          f"{control['grad_rel_err']:.3g} ({control['worst_grad']}), "
          f"zero-gradient leaves {control['zero_grad_err']:.3g} of the "
          f"largest entry")
    for name, r in res["encoders"].items():
        print(f"  2A encoder {name}: launches {r['launches']}, forward and "
              f"backward {r['fwd_bwd_ms']:.3f} ms warm"
              + ("" if name == "plain" else
                 f", logits {r['logits_rel_err']:.3g}, worst leaf "
                 f"{r['grad_rel_err']:.3g} ({r['worst_grad']}), "
                 f"zero-gradient leaves {r['zero_grad_err']:.3g} relative "
                 f"to plain, bit for bit {r['bitwise']}"
                 + (f", planted faults {r['planted']}" if "planted" in r
                    else "")))
    return dict(dp_world1=dict(
        launches=res["launches"], collectives=res["collectives"],
        all_reduce_per_step=per_step.get("all_reduce"), bitwise=bitwise,
        final_weights_max_abs_diff=params,
        max_prob_diff=cmp["max_prob_diff"],
        max_step_loss_diff=cmp["max_step_loss_diff"],
        replay_ms_per_step=warm, graphs=res["graphs"], wall_s=wall,
        phase5_warm_k4_ms=turns["warm_step_ms"][str(SCAN_K)]),
        encoders=res["encoders"])


# Phase 16: BLIP-large with greedy decode as one CUDA graph, the scratch
# captioner's decode graphed, and K steps a dispatch for the MLM and SimCLR
# stages.  BLIP's weights are random from this seed in the Hugging Face key
# layout (no weights are in the repository); the prompt ids after BOS are
# synthetic.
BLIP_SEED = 16
BLIP_BATCH = 64
BLIP_MAX_LEN = 32
BLIP_PROMPT = (1037, 3861, 1997)
# Forward-kernel calls of one BLIP generate: the 24 vision layers once,
# then the 12 decoder cross-attentions at each of the 31 positions.
BLIP_FWD = 24 + 12 * (BLIP_MAX_LEN - 1)
BLIP_CROSS_SHAPE = (BLIP_BATCH, BLIP_MAX_LEN, 12, 64)   # over 577 keys
BLIP_CUT = dict(v_layers=4, t_layers=2)   # card vs CPU, full width
BLIP_CPU_IMAGES = 2
BLIP_LOGIT_TOL = 1e-3               # x max(1, largest CPU |logit|), f32
# BLIP's image processor's normalization (the OpenAI CLIP statistics).
BLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
BLIP_STD = (0.26862954, 0.26130258, 0.27577711)
MLM_GROUP_STEPS = 16                # an MLM epoch of two groups of 8
SIMCLR_GROUP_IMAGES = 256           # 4 steps of 64 an epoch: one group of 4


def random_hf_blip(rng, cfg):
    """A state dict in ``BlipForConditionalGeneration``'s key layout for
    ``cfg``: weights and embeddings uniform with standard deviation 0.02
    (uniform draws are 4x faster than normal ones at 470 M values), unit
    LayerNorm scales, zero biases (f32 numpy)."""
    import numpy as np
    sd = {}
    half = np.float32(0.02 * math.sqrt(3.0))

    def normal(key, shape):
        x = rng.random(shape, dtype=np.float32)
        x -= np.float32(0.5)
        x *= 2 * half
        sd[key] = x

    def lin(key, n_in, n_out):
        normal(key + ".weight", (n_out, n_in))
        sd[key + ".bias"] = np.zeros(n_out, np.float32)

    def ln(key, n):
        sd[key + ".weight"] = np.ones(n, np.float32)
        sd[key + ".bias"] = np.zeros(n, np.float32)

    Hv, Ht, p = cfg.v_hidden, cfg.t_hidden, cfg.patch_size
    emb = "vision_model.embeddings."
    normal(emb + "class_embedding", (1, 1, Hv))
    normal(emb + "position_embedding",
           (1, (cfg.image_size // p) ** 2 + 1, Hv))
    normal(emb + "patch_embedding.weight", (Hv, 3, p, p))
    sd[emb + "patch_embedding.bias"] = np.zeros(Hv, np.float32)
    for i in range(cfg.v_layers):
        pre = f"vision_model.encoder.layers.{i}."
        ln(pre + "layer_norm1", Hv)
        ln(pre + "layer_norm2", Hv)
        lin(pre + "self_attn.qkv", Hv, 3 * Hv)
        lin(pre + "self_attn.projection", Hv, Hv)
        lin(pre + "mlp.fc1", Hv, cfg.v_mlp)
        lin(pre + "mlp.fc2", cfg.v_mlp, Hv)
    ln("vision_model.post_layernorm", Hv)
    te = "text_decoder.bert.embeddings."
    normal(te + "word_embeddings.weight", (cfg.vocab_size, Ht))
    normal(te + "position_embeddings.weight", (cfg.max_positions, Ht))
    ln(te + "LayerNorm", Ht)
    for i in range(cfg.t_layers):
        pre = f"text_decoder.bert.encoder.layer.{i}."
        for part, n_kv in (("attention", Ht), ("crossattention", Hv)):
            lin(pre + part + ".self.query", Ht, Ht)
            lin(pre + part + ".self.key", n_kv, Ht)
            lin(pre + part + ".self.value", n_kv, Ht)
            lin(pre + part + ".output.dense", Ht, Ht)
            ln(pre + part + ".output.LayerNorm", Ht)
        lin(pre + "intermediate.dense", Ht, cfg.t_mlp)
        lin(pre + "output.dense", cfg.t_mlp, Ht)
        ln(pre + "output.LayerNorm", Ht)
    head = "text_decoder.cls.predictions."
    lin(head + "transform.dense", Ht, Ht)
    ln(head + "transform.LayerNorm", Ht)
    normal(head + "decoder.weight", (cfg.vocab_size, Ht))
    sd[head + "bias"] = np.zeros(cfg.vocab_size, np.float32)
    return sd


def build_blip(torch, sd, cfg, device, dtype):
    """The port's ``BlipCaptioner`` for ``cfg`` from an HF-keyed state dict
    through ``convert_blip_state_dict`` and the weight bridge, on
    ``device`` in ``dtype``, in eval mode."""
    from mpmc_tpu_torch.models.blip import (BlipCaptioner,
                                            convert_blip_state_dict)
    from mpmc_tpu_torch.models.convert import load_blip_params
    with torch.device("meta"):
        model = BlipCaptioner(cfg)
    load_blip_params(model, convert_blip_state_dict(sd, cfg))
    return model.to(device=device, dtype=dtype).eval()


def blip_pixels(images_u8, dtype):
    """uint8 ``[B, H, W, 3]`` normalized as BLIP's image processor does."""
    from mpmc_tpu_torch.image.augment import normalize
    return normalize(images_u8, BLIP_MEAN, BLIP_STD).to(dtype)


def synced(torch, fn):
    """``(fn(), wall ms)`` with the device synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def profiled_call(torch, fn, what: str):
    """One synchronized call of ``fn`` under the device profiler (device
    activity only: an eager BLIP batch makes 13,000 launches, and the host
    events beside them cost seconds to collect): its wall ms, kernel ms and
    launches, printed with the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_ms = synced(torch, fn)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    print(f"  {what}: {wall_ms:.3f} ms wall, kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} % of wall) in {launches} "
          f"launches; top:")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:4]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
    return dict(wall_ms=wall_ms, kernel_ms=busy_ms,
                busy_pct=100 * busy_ms / wall_ms, launches=launches)


def caption_paths(work: str):
    from mpmc_tpu_torch.io.manifest import read_manifest
    train = read_manifest(os.path.join(work, "train.json"))
    return train, train.img_paths + read_manifest(
        os.path.join(work, "dev.json")).img_paths


def phase_blip(torch, work: str):
    """BLIP-large (``BlipConfig()``: ViT-L/16 at 384, a 12-layer decoder,
    vocab 30,524) at full width from random HF-keyed weights through the
    port's converter and bridge, in bf16: the new cross-attention shape
    held and timed; ``generate`` over phase 5's images at 384 through
    ``precompute_captions`` in batches of 64 (launches, graph captures and
    replays, launches inside replays); a warm batch eager and graphed
    (ids bit-equal, images/s, busy share of a profiled one each); and the
    card against the CPU in f32 at 4 vision and 2 decoder layers on 2
    images (logits, differing greedy ids)."""
    import dataclasses
    import numpy as np
    from mpmc_tpu_torch.image.decode import decode_batch
    from mpmc_tpu_torch.models.blip import BlipConfig
    from mpmc_tpu_torch.models.captioner import precompute_captions
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32
    dev = torch.device("cuda")
    cfg = BlipConfig()
    tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    cross = time_forward_at(torch, "BLIP cross-attention", BLIP_CROSS_SHAPE,
                            tokens, dtype=torch.bfloat16)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sd = random_hf_blip(np.random.default_rng(BLIP_SEED), cfg)
    model = build_blip(torch, sd, cfg, dev, torch.bfloat16)
    build_s = time.perf_counter() - t0
    stamp("  BLIP built:")
    n_params = sum(p.numel() for p in model.parameters())
    _, paths = caption_paths(work)
    t0 = time.perf_counter()
    images = decode_batch(paths, cfg.image_size, False, work)
    decode_s = time.perf_counter() - t0
    prompt = torch.tensor([[cfg.bos_token_id, *BLIP_PROMPT]], device=dev)
    batch_ms = []

    def blip_fn(images_u8):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x = blip_pixels(torch.as_tensor(images_u8, device=dev),
                        torch.bfloat16)
        ids = model.generate(x, prompt.expand(len(x), -1),
                             max_len=BLIP_MAX_LEN)
        rows = ids.cpu().tolist()
        batch_ms.append((time.perf_counter() - t1) * 1e3)
        return [" ".join(str(t) for t in r) for r in rows]

    blip_fn.cache_tag = f"blip-large-random-{BLIP_SEED}"
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    caps = precompute_captions(paths, images, batch_size=BLIP_BATCH,
                               generate_fn=blip_fn)
    launches = dict(build.launch_counts)
    batches = math.ceil(len(paths) / BLIP_BATCH)
    full = len(paths) // BLIP_BATCH
    want = {"attention_fwd": BLIP_FWD * batches, "attention_bwd": 0,
            "image_normalize": 0}
    check(launches == want, f"BLIP generate launches {launches}, expected "
                            f"{want}")
    graph = model.decode_graph
    captures, replays = graph.captures, graph.replays
    tallies = [e.tally for e in graph.graphs.values()]
    check(graph.captures == 1 and graph.replays == full - 1
          and [t["attention_fwd"] for t in tallies] == [BLIP_FWD],
          f"BLIP decode graph: {graph.captures} captures, {graph.replays} "
          f"replays, tallies {tallies}")
    head = " ".join(str(t) for t in [cfg.bos_token_id, *BLIP_PROMPT])
    check(len(caps) == len(paths) and all(
        c.startswith(head + " ") and len(c.split()) == BLIP_MAX_LEN
        for c in caps), f"BLIP captions malformed: {caps[:2]}")
    # Random weights must still give a decode that varies, or the
    # eager-vs-graphed comparison below would not exercise the writes.
    tails = [c.split()[1 + len(BLIP_PROMPT):] for c in caps]
    distinct = len(set(caps))
    tail_ids = len({t for tail in tails for t in tail})
    ended = sum(str(cfg.eos_token_id) in tail for tail in tails)
    check(distinct > 1 and tail_ids > 1,
          f"BLIP decode degenerate: {distinct} distinct captions, "
          f"{tail_ids} distinct ids after the prompt")
    print(f"  BLIP-large ({n_params / 1e6:.1f} M parameters, built from "
          f"random HF-keyed weights in {build_s:.1f} s) over {len(paths)} "
          f"images at {cfg.image_size}, bf16, batches of {BLIP_BATCH}, "
          f"{BLIP_MAX_LEN} tokens: ms {[round(t, 3) for t in batch_ms]}; "
          f"launches attention_fwd {launches['attention_fwd']} = "
          f"{BLIP_FWD} x {batches}; decode graph: {captures} capture, "
          f"{replays} replays ({replays * BLIP_FWD} forward launches "
          f"inside them); {distinct} distinct captions, {tail_ids} "
          f"distinct ids after the prompt, {ended} ended by EOS (images "
          f"decoded at {cfg.image_size} in {decode_s:.1f} s)")
    stamp("  BLIP warm batches:")
    x = blip_pixels(torch.as_tensor(images[:BLIP_BATCH], device=dev),
                    torch.bfloat16)
    p64 = prompt.expand(BLIP_BATCH, -1)
    eager_ids, eager_ms = synced(
        torch, lambda: model.generate_eager(x, p64, BLIP_MAX_LEN))
    graph_ids, graph_ms_ = synced(
        torch, lambda: model.generate(x, p64, max_len=BLIP_MAX_LEN))
    check(torch.equal(eager_ids, graph_ids),
          "BLIP: graphed ids differ from the eager loop's")
    eager_prof = profiled_call(
        torch, lambda: model.generate_eager(x, p64, BLIP_MAX_LEN),
        "BLIP eager generate batch of 64, profiled")
    graph_prof = profiled_call(
        torch, lambda: model.generate(x, p64, max_len=BLIP_MAX_LEN),
        "BLIP graphed generate batch of 64, profiled")
    print(f"  warm batch of {BLIP_BATCH}: eager {eager_ms:.3f} ms "
          f"({1e3 * BLIP_BATCH / eager_ms:.2f} images/s), graphed "
          f"{graph_ms_:.3f} ms ({1e3 * BLIP_BATCH / graph_ms_:.2f} "
          f"images/s); ids bit-equal")
    del model, x, eager_ids, graph_ids
    gc.collect()                    # the model and its decode graph
    torch.cuda.empty_cache()
    stamp("  BLIP card vs CPU:")
    cut = dataclasses.replace(cfg, **BLIP_CUT)
    card = build_blip(torch, sd, cut, dev, torch.float32)
    host = build_blip(torch, sd, cut, torch.device("cpu"), torch.float32)
    del sd
    few = torch.from_numpy(images[:BLIP_CPU_IMAGES])
    pr = prompt.cpu().expand(len(few), -1)
    with ieee_f32(), torch.inference_mode():
        xc = blip_pixels(few.to(dev), torch.float32)
        ids = card.generate(xc, pr.to(dev), max_len=BLIP_MAX_LEN)
        logits = card(xc, ids).cpu()
        xh = blip_pixels(few, torch.float32)
        ids_cpu = host.generate(xh, pr, max_len=BLIP_MAX_LEN)
        logits_cpu = host(xh, ids.cpu())
    scale = max(1.0, logits_cpu.abs().max().item())
    diff = (logits - logits_cpu).abs().max().item()
    ids_differ = int((ids.cpu() != ids_cpu).sum())
    check(diff <= BLIP_LOGIT_TOL * scale,
          f"BLIP logits card vs CPU differ by {diff} (scale {scale})")
    print(f"  card vs CPU, f32 (TF32 off), {cut.v_layers} vision and "
          f"{cut.t_layers} decoder layers at full width, {len(few)} images: "
          f"max |logit diff| {diff:.3g} (tol {BLIP_LOGIT_TOL} x {scale:.3g}) "
          f"over {tuple(logits.shape)}; greedy ids differing: {ids_differ} "
          f"of {ids.numel()}")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, batches=batches, batch_ms=batch_ms,
                captures=captures, replays=replays,
                launches_in_graphs={"attention_fwd": replays * BLIP_FWD},
                build_s=build_s, decode_s=decode_s, n_params=n_params,
                distinct_captions=distinct, distinct_tail_ids=tail_ids,
                ended_by_eos=ended, eager_ms=eager_ms, graph_ms=graph_ms_,
                eager_images_s=1e3 * BLIP_BATCH / eager_ms,
                graph_images_s=1e3 * BLIP_BATCH / graph_ms_,
                eager_profile=eager_prof, graph_profile=graph_prof,
                ids_bit_equal=True, card_vs_cpu_logits=diff,
                card_vs_cpu_scale=scale, ids_differ=ids_differ,
                ids=ids.numel(), cross=cross)


def phase_scratch_graphed(torch, work: str, p11: dict):
    """Phase 11's ``generate`` over phase 5's images again, through the
    decode graph: launches (48 a batch) and those inside replays, ms a
    batch and the busy share of a profiled replayed batch beside phase
    11's eager numbers, and the graphed ids of a batch equal to the eager
    loop's."""
    from mpmc_tpu_torch.image.augment import eval_preprocess
    from mpmc_tpu_torch.image.decode import decode_batch
    from mpmc_tpu_torch.models.captioner import (PROMPT,
                                                 make_scratch_caption_fn,
                                                 precompute_captions)
    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.text.normalize import preprocess_arabic_tweet
    from mpmc_tpu_torch.train.pretrain_image import ieee_f32
    dev = torch.device("cuda")
    train, paths = caption_paths(work)
    images = decode_batch(paths, 224, False, work)
    corpus = [preprocess_arabic_tweet(t) for t in train.texts]
    gen_fn, tok = make_scratch_caption_fn(corpus, image_size=224, seed=42,
                                          device=dev)
    batch_ms = []

    def timed(images_u8):
        out, ms = synced(torch, lambda: gen_fn(images_u8))
        batch_ms.append(ms)
        return out

    timed.cache_tag = gen_fn.cache_tag
    for key in build.launch_counts:
        build.launch_counts[key] = 0
    caps = precompute_captions(paths, images, generate_fn=timed)
    launches = dict(build.launch_counts)
    batches = math.ceil(len(paths) / CAPTION_BATCH)
    graph = gen_fn.captioner.decode_graph
    captures, replays = graph.captures, graph.replays
    want = {"attention_fwd": GENERATE_FWD * batches, "attention_bwd": 0,
            "image_normalize": 0}
    check(launches == want and len(caps) == len(paths),
          f"graphed captioning launches {launches}, expected {want}")
    check(graph.captures == 1
          and graph.replays == len(paths) // CAPTION_BATCH - 1,
          f"scratch decode graph: {graph.captures} captures, "
          f"{graph.replays} replays")
    prof = profiled_call(torch, lambda: gen_fn(images[:CAPTION_BATCH]),
                         "scratch captioner graphed batch of 64, profiled")
    cap = gen_fn.captioner
    x = eval_preprocess(torch.from_numpy(images[:CAPTION_BATCH]).to(dev))
    prompt = torch.tensor([tok.tokenize_to_ids(PROMPT)], device=dev).expand(
        CAPTION_BATCH, -1)
    with ieee_f32():
        eager = cap.generate_eager(x, prompt, eos_id=tok.sep_id)
        graphed = cap.generate(x, prompt, eos_id=tok.sep_id)
    check(torch.equal(eager, graphed),
          "scratch captioner: graphed ids differ from the eager loop's")
    eager_11 = p11["caption_generate"]
    print(f"  scratch captioner graphed over {len(paths)} images: ms "
          f"{[round(t, 3) for t in batch_ms]} (phase 11 eager: "
          f"{[round(t, 3) for t in eager_11['batch_ms']]}); launches "
          f"attention_fwd {launches['attention_fwd']} = {GENERATE_FWD} x "
          f"{batches}, {replays * GENERATE_FWD} inside {replays} replays; "
          f"busy {prof['busy_pct']:.1f} % (phase 11 "
          f"eager {100 * eager_11['profiled_kernel_ms'] / eager_11['profiled_wall_ms']:.1f} %); "
          f"ids of a batch bit-equal to eager")
    del gen_fn, cap
    gc.collect()
    torch.cuda.empty_cache()
    return dict(launches=launches, batches=batches, batch_ms=batch_ms,
                captures=captures, replays=replays,
                launches_in_graphs={"attention_fwd": replays * GENERATE_FWD},
                profile=prof, ids_bit_equal=True,
                phase_11_eager_batch_ms=eager_11["batch_ms"])


def same_npz(a: str, b: str) -> bool:
    import numpy as np
    with np.load(a) as fa, np.load(b) as fb:
        return (sorted(fa.files) == sorted(fb.files)
                and all(np.array_equal(fa[k], fb[k]) for k in fa.files))


def grouped_vs_single(torch, what: str, k: int, run_at, npz_of,
                      profile: bool = True):
    """A pretraining stage at ``scan_steps`` k and at 1 (``run_at(k,
    watch)`` runs it under ``watch(profiled=..., profiled_group=...)``):
    its first group eager and its second a graph replay at k, profiled
    under ``profile`` (at 1, steps 2 and 3).  Checks the per-step losses
    and the saved npz (``npz_of(run, k)``) bit for bit; returns each run's
    launches, those inside replays, warm ms a step and busy share."""
    from mpmc_tpu_torch.ops import build
    res = {}
    for kk in (k, 1):
        stamp(f"  {what} at K = {kk}:")
        for key in build.launch_counts:
            build.launch_counts[key] = 0
        watch = (dict(profiled=range(2, 4) if kk == 1 else range(0),
                      profiled_group=1 if kk > 1 else None) if profile
                 else {})
        run, seen = run_at(kk, watch)
        torch.cuda.synchronize()
        launches = dict(build.launch_counts)
        if kk > 1:
            check(replayed_steps(seen) == run.steps - kk,
                  f"{what} K = {kk}: {replayed_steps(seen)} of {run.steps} "
                  f"steps replayed")
            warm = replay_step_ms(seen)
        else:
            warm = seen["step_ms"][1:2] + seen["step_ms"][4:]
        res[kk] = dict(run=run, npz=npz_of(run, kk), launches=launches,
                       launches_in_graphs=replay_launches(seen),
                       warm_step_ms_median=median(warm))
        if profile:
            wall_ms, busy_ms, _ = profiled_share(
                torch, seen, f"{what} at K = {kk}: "
                + ("group 1 (a replay)" if kk > 1 else "steps 2 and 3")
                + " profiled")
            res[kk].update(busy_pct=100 * busy_ms / wall_ms,
                           profiled_wall_ms=wall_ms,
                           profiled_kernel_ms=busy_ms)
    a, b = res[k]["run"], res[1]["run"]
    differ = [i for i, (x, y) in enumerate(zip(a.step_losses, b.step_losses))
              if x != y]
    same_file = same_npz(res[k]["npz"], res[1]["npz"])
    print(f"  {what}: K = {k} and K = 1 per-step losses "
          f"{'equal' if not differ else 'differ at steps ' + str(differ)} "
          f"({len(a.step_losses)} and {len(b.step_losses)}), npz "
          f"{'bit for bit' if same_file else 'DIFFERENT'}; launches "
          f"{res[k]['launches']} and {res[1]['launches']}, inside replays "
          f"{res[k]['launches_in_graphs']}; warm ms a step K = {k} "
          f"{res[k]['warm_step_ms_median']:.3f}, K = 1 "
          f"{res[1]['warm_step_ms_median']:.3f}"
          + (f"; busy K = {k} {res[k]['busy_pct']:.1f} %, K = 1 "
             f"{res[1]['busy_pct']:.1f} %" if profile else ""))
    check(not differ and a.steps == b.steps and a.epoch_losses
          == b.epoch_losses, f"{what}: losses differ between K = {k} and 1: "
          f"{[(a.step_losses[i], b.step_losses[i]) for i in differ[:4]]}")
    check(same_file, f"{what}: the npz differs between K = {k} and K = 1")
    check(res[k]["launches"] == res[1]["launches"],
          f"{what}: launches differ between K = {k} and 1")
    return {f"k{kk}": {m: v for m, v in r.items() if m not in ("run", "npz")}
            | dict(steps=r["run"].steps, loss=r["run"].epoch_losses)
            for kk, r in res.items()}


def phase_mlm_groups(torch, argv):
    """``pretrain_and_save`` on phase 8's 2A corpus at full width, f32, one
    epoch of 16 steps (two groups of 8: batch n // 16), at ``scan_steps``
    8 and 1: per-step losses and the saved npz bit for bit, 12 forward and
    12 backward calls a step, those inside the replay, warm ms a step and
    busy share at both K."""
    import dataclasses
    from mpmc_tpu_torch.cli.experiments import prepare_2a
    from mpmc_tpu_torch.cli.main import build_parser, train_config
    from mpmc_tpu_torch.train import pretrain as P
    cfg, _ = train_config(build_parser().parse_args(argv))
    out = tempfile.mkdtemp(dir=os.getcwd())
    prep = prepare_2a(dataclasses.replace(cfg, checkpoint_dir=None), out)
    seq_len = prep.data["text_ids"].shape[1]
    n = (P.MLMConfig().char_noise_copies + 1) * len(prep.corpus)
    bs = n // MLM_GROUP_STEPS

    def run_at(k, watch):
        with watch_mlm(torch, **watch) as seen:
            run = P.pretrain_and_save(
                prep.cfg.model.text, prep.corpus, prep.tok,
                os.path.join(out, f"mlm_k{k}.npz"),
                P.MLMConfig(epochs=1, seed=cfg.seed, batch_size=bs,
                            scan_steps=k), max_len=seq_len,
                device=torch.device("cuda"))
        want = {"attention_fwd": 12 * run.steps,
                "attention_bwd": 12 * run.steps, "image_normalize": 0}
        check(run.steps == MLM_GROUP_STEPS and seen["launches"] == want,
              f"MLM K = {k}: {run.steps} steps, launches "
              f"{seen['launches']}, expected {want}")
        return run, seen

    print(f"  MLM over {n} texts at [{bs},{seq_len}] f32, one epoch of "
          f"{MLM_GROUP_STEPS} steps:")
    out_ = grouped_vs_single(torch, "MLM", P.MLMConfig().scan_steps, run_at,
                             lambda run, k: os.path.join(out,
                                                         f"mlm_k{k}.npz"))
    for r in out_.values():
        r["shape"] = [bs, seq_len]
    return out_


def phase_simclr_groups(torch):
    """``simclr_pretrain`` over ResNet-18 at 224 (phase 10's backbone) on
    256 seeded images, batch 64, two epochs of one group of 4, at
    ``scan_steps`` 4 and 1: per-step losses and the backbone npz bit for
    bit, the image kernel twice a step and inside the replay, warm ms a
    step (phase 10 profiles the SimCLR step)."""
    import numpy as np
    from mpmc_tpu_torch.config import ImageEncoderConfig
    from mpmc_tpu_torch.train import pretrain_image as PI
    images = np.random.default_rng(SIMCLR_GROUP_IMAGES).integers(
        0, 256, (SIMCLR_GROUP_IMAGES, 224, 224, 3), dtype=np.uint8)
    out = tempfile.mkdtemp(dir=os.getcwd())

    def run_at(k, watch):
        with watch_simclr(torch, **watch) as seen:
            run = PI.simclr_pretrain(
                ImageEncoderConfig(arch="resnet18", image_size=224), images,
                PI.SimCLRConfig(epochs=2, batch_size=64, scan_steps=k),
                device=torch.device("cuda"))
        want = {"attention_fwd": 0, "attention_bwd": 0,
                "image_normalize": 2 * run.steps}
        check(run.steps == 8 and seen["launches"] == want,
              f"SimCLR K = {k}: {run.steps} steps, launches "
              f"{seen['launches']}, expected {want}")
        return run, seen

    def npz_of(run, k):
        path = os.path.join(out, f"simclr_k{k}.npz")
        PI.save_image_encoder_params(run.backbone, path)
        return path

    print(f"  SimCLR ResNet-18 at 224, {SIMCLR_GROUP_IMAGES} images, batch "
          f"64, two epochs of 4 steps:")
    res = grouped_vs_single(torch, "SimCLR", PI.SimCLRConfig().scan_steps,
                            run_at, npz_of, profile=False)
    check(res["k4"]["launches_in_graphs"].get("image_normalize") == 8,
          f"SimCLR: image kernel inside the replay "
          f"{res['k4']['launches_in_graphs']}, expected 2 x 4")
    torch.cuda.empty_cache()
    return res


def phase_blip_and_groups(torch, work: str, argv_2a, p11: dict):
    """Phase 16: (a) BLIP-large, (b) the scratch captioner graphed, (c)
    MLM at K = 8 against 1, (d) SimCLR at K = 4 against 1."""
    out = {}
    for name, run in (("blip", lambda: phase_blip(torch, work)),
                      ("scratch_graphed",
                       lambda: phase_scratch_graphed(torch, work, p11)),
                      ("mlm_groups", lambda: phase_mlm_groups(torch, argv_2a)),
                      ("simclr_groups", lambda: phase_simclr_groups(torch))):
        stamp(f"  {name}:")
        out[name] = run()
    return out


def stamp(title: str) -> None:
    """A phase's heading with the seconds since the script started."""
    print(f"{title} (at {time.perf_counter() - T_START:.1f} s)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from mpmc_tpu_torch.ops import build
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    from concurrent.futures import ThreadPoolExecutor
    from mpmc_tpu_torch import native_lib
    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:     # g++ beside the nvcc builds
        native = pool.submit(native_lib.build, list(native_lib.SOURCES))
        reports = build.build(names)
        native_status = native.result()
    print(f"phase 1 build: {names} and the C++ host runtime "
          f"{sorted(native_lib.SOURCES)} in {time.perf_counter() - t0:.2f} s")
    build_routes = native_build_report(native_status)
    for name, report in reports.items():
        kernel = name
        for line in report.splitlines():
            if "Compiling entry function" in line:
                kernel = kernel_name(line)
            if "Used" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"  {kernel}: {line.strip()}")
    tensor_core = {}
    with ThreadPoolExecutor(2) as pool:     # two cuobjdump processes at once
        sass = dict(zip(("attention_fwd", "attention_bwd"), pool.map(
            lambda n: tensor_core_instructions(build._lib_path(n)),
            ("attention_fwd", "attention_bwd"))))
    for name, counts in sass.items():
        if counts is None:
            tensor_core[name] = None
            print(f"  {name}: tensor-core instructions not measured "
                  f"(no cuobjdump)")
            continue
        tensor_core[name] = sum(mma for mma, _ in counts.values())
        print(f"  {name}: {tensor_core[name]} tensor-core instructions "
              f"(HMMA/HGMMA in cuobjdump -sass); per kernel, of all its "
              f"instructions: " + ", ".join(
                  f"{k} {mma}/{n}" for k, (mma, n) in sorted(counts.items())))
        check(tensor_core[name] > 0, f"{name}: no tensor-core instruction")

    stamp("phase 2 kernels vs plain versions on the card:")
    timings, err_main = phase_kernels(torch)
    bwd_timings, bwd_err = phase_kernels_bwd(torch)
    image = phase_image_kernel(torch)

    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        os.chdir(work)                  # the caption cache goes to ./.cache
        try:
            stamp("phase 3 full-width 2C predict:")
            argv, launches = phase_predict(torch, work)
            inputs = phase_warm_eval(torch, argv)
            stamp("phase 4 card vs CPU:")
            phase_card_vs_cpu(torch, inputs)
            stamp("phase 5 full-width 2C train:")
            with watch_fit(torch) as watch_k4:
                train_argv, train_launches, _ = phase_train(torch, work)
            packed_shapes, warm_ms, turns = phase_warm_train(torch,
                                                             train_argv)
            stamp("phase 6 packed train step, card vs CPU in f32:")
            phase_train_card_vs_cpu(torch, train_argv)
            stamp("phase 7 full-width predict for 2A, 2B and simple 2C:")
            kinds = phase_other_kinds(torch, work)
            stamp("  each new model class card vs CPU, then the tools:")
            phase_kinds_card_vs_cpu(torch, work)
            phase_submission(
                work, [os.path.join(work, "probs.tsv")]
                + [r["probs"] for r in kinds.values()],
                [os.path.join(work, "pred.tsv")]
                + [r["labels"] for r in kinds.values()])
            stamp("phase 8 full-width 2A train and corpus MLM:")
            argv_2a, launches_2a = phase_train_2a(torch, work)
            warm_2a = phase_warm_train_2a(torch, argv_2a)
            stamp("  packed 2A train step, card vs CPU in f32:")
            phase_train_card_vs_cpu(torch, argv_2a)
            stamp("  corpus MLM:")
            mlm = phase_mlm(torch, argv_2a)
            stamp("  the reference recipe with packed MLM, and --text-params:")
            more_2a = phase_train_2a_more(torch, work, mlm["npz"])
            stamp("phase 9 full-width 2B train and the image zoo:")
            vit_shapes, vit_f32, image_384 = phase_vit_kernels(torch)
            stamp("  the 2B train runs:")
            train_2b = phase_train_2b(torch, work)
            stamp("  the new backbones card vs CPU:")
            phase_backbones_card_vs_cpu(torch)
            stamp("phase 10 SimCLR pretraining and the 2C training variants:")
            image_simclr, image_small, simclr_vit = phase_simclr_kernels(torch)
            variants, small_2c, bn_chains = phase_train_variants(torch,
                                                                 work)
            stamp("phase 11 the scratch captioner, crash and --resume, and "
                  "the Trainer over clip_style_2c:")
            p11 = phase_captioner_resume_trainer(torch, work)
            stamp("phase 12 converted checkpoints, extract-features, "
                  "distillation and smoke:")
            p12 = phase_offline_classic(torch, work)
            stamp("phase 13 the host runtime: native decode and tokenizer, "
                  "the image pipeline, --embedding-optimizer sparse and "
                  "--profile-dir:")
            with watch_fit(torch) as p13_watch:
                p13 = phase_host_runtime(torch, work, build_routes)
            stamp("phase 14 one dispatch for K steps (CUDA graphs) and "
                  "fold-parallel training:")
            p14 = phase_scan_and_folds(torch, work, argv, train_argv,
                                       train_launches, watch_k4, p13,
                                       p13_watch)
            p14["train_2c"].update(turns)
            stamp("phase 15 the multi-GPU layouts at world size 1:")
            p15 = phase_layouts(torch, work, train_argv, train_launches,
                                watch_k4, turns)
            stamp("phase 16 BLIP-large with one decode graph, the scratch "
                  "captioner graphed, and K steps a dispatch for MLM and "
                  "SimCLR:")
            p16 = phase_blip_and_groups(torch, work, argv_2a, p11)
        finally:
            os.chdir(cwd)

    text, bwd = timings["text"], bwd_timings["text"]
    paths_11 = {k: v["launches"] for k, v in p11.items() if k != "shapes"}
    paths_12 = {k: v["launches"] for k, v in p12.items()
                if k != "extract_shape"}
    p14_paths = [("train_2c_k4_vs_k1", p14["train_2c"]),
                 ("predict_k8", p14["predict"]),
                 ("train_2a_sparse_k4", p14["train_2a_sparse"]),
                 ("fold_parallel", p14["fold_parallel"])]
    p15_paths = [("train_2c_world1", p15["dp_world1"]),
                 *((f"text_{k}", v) for k, v in p15["encoders"].items()
                   if k != "plain")]
    p16_paths = [("blip_generate", p16["blip"]),
                 ("scratch_generate_graphed", p16["scratch_graphed"]),
                 *((f"mlm_{k}", v) for k, v in p16["mlm_groups"].items()),
                 *((f"simclr_{k}", v)
                   for k, v in p16["simclr_groups"].items())]
    kernels = [{
        "name": "attention_fwd", "route": "cuda",
        "source": "mpmc_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "mpmc_tpu/ops/attention.py:97",
        "launches": launches["attention_fwd"], "max_abs_err": err_main,
        "ms": text["ms"], "plain_ms": text["plain_ms"],
        "bound_ms": text["bound_ms"], "bound_by": text["bound_by"],
        "library_ms": text["library_ms"], "shape": text["shape"],
        "dtype": text["dtype"], "caption_shape": timings["caption"],
        "tensor_core_instructions": tensor_core["attention_fwd"],
        "launches_by_path": {
            "predict": launches["attention_fwd"],
            "train": train_launches["attention_fwd"],
            "predict_2a": kinds["predict_2a"]["launches"],
            "predict_simple": kinds["predict_simple"]["launches"],
            "train_2a": launches_2a["attention_fwd"],
            "mlm": mlm["launches"]["attention_fwd"],
            "train_2a_reference": more_2a["reference"]["launches"][
                "attention_fwd"],
            "mlm_pack": more_2a["mlm_pack"]["launches"]["attention_fwd"],
            "train_2a_text_params": more_2a["text_params"]["launches"][
                "attention_fwd"],
            **{k: v["launches"]["attention_fwd"]
               for k, v in train_2b.items()},
            **{k: v["launches"]["attention_fwd"]
               for k, v in variants.items()},
            **{k: v["attention_fwd"] for k, v in paths_11.items()},
            **{k: v["attention_fwd"] for k, v in paths_12.items()},
            "train_2a_sparse": p13["train_2a_sparse"]["launches"][
                "attention_fwd"],
            **{k: v["launches"]["attention_fwd"] for k, v in p14_paths},
            **{k: v["launches"]["attention_fwd"] for k, v in p15_paths},
            **{k: v["launches"]["attention_fwd"] for k, v in p16_paths}},
        "launches_in_graphs": {k: v["launches_in_graphs"].get(
            "attention_fwd", 0) for k, v in p14_paths + p16_paths},
        "fold_parallel_shapes": p14["fold_parallel"]["shapes"],
        "captioner_shapes": p11["shapes"],
        "blip_cross_shape": p16["blip"]["cross"],
        "extract_features_shape": p12["extract_shape"],
        "packed_train_shapes": {
            k: {"shape": v["shape"], "ms": v["fwd_ms"],
                "library_ms": v["library_fwd_ms"],
                "bound_ms": v["fwd_bound_ms"]}
            for k, v in packed_shapes.items()},
        **{f"{name}_shape": {m: shape[m] for m in (
            "shape", "mode", "dtype", "fwd_max_abs_err", "fwd_ms",
            "fwd_plain_ms", "library_fwd_ms", "fwd_bound_ms")}
           for name, shape in (("train_2a", warm_2a["shape"]),
                               ("mlm", mlm["shape"]),
                               ("mlm_pack", more_2a["mlm_pack"]["shape"]),
                               ("simclr_vit", simclr_vit),
                               ("small_2c", small_2c))},
        "vit_shapes": {name: {m: shape[m] for m in (
            "shape", "mode", "dtype", "fwd_max_abs_err", "fwd_ms",
            "fwd_plain_ms", "library_fwd_ms", "fwd_bound_ms")}
            for name, shape in vit_shapes.items()},
        "vit_f32_max_abs_err": vit_f32["fwd_max_abs_err"]}, {
        "name": "attention_bwd", "route": "cuda",
        "source": "mpmc_tpu_torch/csrc/attention_bwd.cu",
        "replaces": "mpmc_tpu/ops/attention.py:182",
        "launches": train_launches["attention_bwd"], "max_abs_err": bwd_err,
        "ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"], "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"], "library": bwd["library"],
        "fwd_bwd_pair_ms": bwd["fwd_bwd_pair_ms"],
        "library_pair_ms": bwd["library_pair_ms"],
        "launches_per_call": BWD_LAUNCHES,
        "tensor_core_instructions": tensor_core["attention_bwd"],
        "shape": bwd["shape"],
        "dtype": bwd["dtype"], "caption_shape": bwd_timings["caption"],
        "launches_by_path": {
            "train": train_launches["attention_bwd"],
            "train_2a": launches_2a["attention_bwd"],
            "mlm": mlm["launches"]["attention_bwd"],
            "train_2a_reference": more_2a["reference"]["launches"][
                "attention_bwd"],
            "mlm_pack": more_2a["mlm_pack"]["launches"]["attention_bwd"],
            "train_2a_text_params": more_2a["text_params"]["launches"][
                "attention_bwd"],
            **{k: v["launches"]["attention_bwd"]
               for k, v in train_2b.items()},
            **{k: v["launches"]["attention_bwd"]
               for k, v in variants.items()},
            **{k: v["attention_bwd"] for k, v in paths_11.items()},
            **{k: v["attention_bwd"] for k, v in paths_12.items()},
            "train_2a_sparse": p13["train_2a_sparse"]["launches"][
                "attention_bwd"],
            **{k: v["launches"]["attention_bwd"] for k, v in p14_paths},
            **{k: v["launches"]["attention_bwd"] for k, v in p15_paths},
            **{k: v["launches"]["attention_bwd"] for k, v in p16_paths}},
        "launches_in_graphs": {k: v["launches_in_graphs"].get(
            "attention_bwd", 0) for k, v in p14_paths + p16_paths},
        "fold_parallel_shapes": p14["fold_parallel"]["shapes"],
        "packed_train_shapes": packed_shapes,
        "train_2a_shape": warm_2a["shape"], "mlm_shape": mlm["shape"],
        "mlm_pack_shape": more_2a["mlm_pack"]["shape"],
        "vit_shapes": vit_shapes,
        "vit_f32_max_abs_err": vit_f32["max_abs_err"],
        "simclr_vit_shape": simclr_vit, "small_2c_shape": small_2c}, {
        "name": "image_normalize", "route": "cuda",
        "source": "mpmc_tpu_torch/csrc/image_normalize.cu",
        "replaces": "mpmc_tpu/ops/image_ops.py:20",
        "launches": train_launches["image_normalize"],
        "max_abs_err": image["max_abs_err"], "ms": image["ms"],
        "plain_ms": image["plain_ms"], "bound_ms": image["bound_ms"],
        "bound_by": image["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call flips, scales, clips and "
                   "normalizes",
        "shape": image["shape"], "dtype": image["dtype"],
        "shape_384": image_384, "shape_simclr": image_simclr,
        "shape_small_2c": image_small,
        "launches_by_path": {
            "train": train_launches["image_normalize"],
            **{k: v["launches"]["image_normalize"]
               for k, v in train_2b.items()},
            **{k: v["launches"]["image_normalize"]
               for k, v in variants.items()},
            **{k: v["image_normalize"] for k, v in paths_11.items()},
            **{k: v["image_normalize"] for k, v in paths_12.items()},
            **{k: v["launches"]["image_normalize"] for k, v in p14_paths},
            **{k: v["launches"].get("image_normalize", 0)
               for k, v in p15_paths},
            **{k: v["launches"]["image_normalize"] for k, v in p16_paths}},
        "launches_in_graphs": {k: v["launches_in_graphs"].get(
            "image_normalize", 0) for k, v in p14_paths + p16_paths},
        "fold_parallel_shape": [FOLDS * BATCH, 224, 224, 3]}]
    print(json.dumps({"predict_kinds": {
        k: {m: v[m] for m in ("launches", "memes_s", "wall_s",
                              "profiled_wall_ms", "profiled_kernel_ms")}
        for k, v in kinds.items()}}))
    w2a = warm_2a["warm_ms"]
    print(json.dumps({"train_2a": {
        "warm_step_ms_median": w2a[len(w2a) // 2], "warm_steps": len(w2a),
        "profiled_wall_ms": warm_2a["profiled_wall_ms"],
        "profiled_kernel_ms": warm_2a["profiled_kernel_ms"],
        "launches": launches_2a}, "mlm": {
        k: mlm[k] for k in ("steps", "wall_s", "loss", "launches", "step_ms",
                            "warm_step_ms_median", "profiled_wall_ms",
                            "profiled_kernel_ms")},
        "train_2a_reference": more_2a["reference"],
        "mlm_pack": {k: v for k, v in more_2a["mlm_pack"].items()
                     if k != "shape"},
        "train_2a_text_params": more_2a["text_params"]}))
    print(json.dumps({"train_2b": train_2b}))
    print(json.dumps({"train_variants": variants}))
    print(json.dumps({"fusion_batchnorms": bn_chains}))
    print(json.dumps({"phase_11": {k: v for k, v in p11.items()
                                   if k != "shapes"}}))
    print(json.dumps({"phase_12": p12}))
    print(json.dumps({"phase_13": p13}))
    print(json.dumps({"phase_14": p14}))
    print(json.dumps({"phase_15": p15}))
    print(json.dumps({"phase_16": p16}))
    print(f"warm train step {warm_ms[len(warm_ms) // 2]:.3f} ms (median), 2A "
          f"{w2a[len(w2a) // 2]:.3f} ms, 2B ResNet-18 "
          f"{train_2b['train_2b_resnet18']['warm_step_ms_median']:.3f} ms, 2B "
          f"ViT-B/16 at 384 "
          f"{train_2b['train_2b_vit']['warm_step_ms_median']:.3f} ms; SimCLR "
          f"ResNet-18 "
          f"{variants['train_2b_simclr']['simclr']['warm_step_ms_median']:.3f}"
          f" ms, ViT-B/16 {variants['simclr_vit']['step_ms']:.3f} ms; "
          f"whole run {time.perf_counter() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
