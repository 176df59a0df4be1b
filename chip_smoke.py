"""Smoke run of the PyTorch port (mpmc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the CUDA
toolkit.  Phases, each of which raises on failure:

1. build every CUDA kernel from ``mpmc_tpu_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card at the
   serving path's shapes (attention: padding, segments and Sq != Sk, bf16
   and f32, fully masked rows included), and time kernel, plain version,
   one PyTorch library call computing the same function, and the bound;
3. drive the 2C ``predict`` command line at full model width (AraBERT-base
   text and RoBERTa-base caption encoders, ResNet-18 at 224x224, random
   weights from a seed) on a synthetic manifest, with every kernel's launch
   count zeroed before and read after; then time the eval pass again warm;
4. compare the card with the CPU on one full-width batch in f32 (TF32 off).

Prints the card's name and power limit, each phase's result, a ``kernels``
JSON line, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a CUDA device or outside the repository.
"""

from __future__ import annotations

import json
import math
import os
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
ARABIC_LETTERS = "ابتثجحخدذرزسشصضطظعغفقكلمنهوي"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def graph_ms(torch, fn, reps: int = 20, trials: int = 5) -> float:
    """Median device time of ``fn`` in ms: ``reps`` calls captured in a CUDA
    graph, replayed ``trials`` times between CUDA events (the host's
    per-call overhead is not in the number)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def phase_kernels(torch):
    """Attention kernel vs plain version on the card; timings."""
    import torch.nn.functional as F
    from mpmc_tpu_torch.ops import attention as A
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (name, shape, mode, Sk override)
    cases = [("text", TEXT_SHAPE, "padding", None),
             ("caption", CAPTION_SHAPE, "padding", None),
             ("packed-text", TEXT_SHAPE, "segments", None),
             ("cross", TEXT_SHAPE, "none", CAPTION_SHAPE[1])]
    tol = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-3)}
    timed = {}
    err_main = 0.0
    for name, shape, mode, sk in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, mask = attention_inputs(torch, shape, mode, dtype, gen, sk)
            out, lse = A.attention_forward_cuda(q, k, v, mask, mode)
            torch.cuda.synchronize()
            ref_out, ref_lse = A.attention_forward_reference(q, k, v, mask,
                                                             mode)
            err = (out.float() - ref_out.float()).abs().max().item()
            lerr = (lse - ref_lse).abs().max().item()
            tag = f"{name} {mode} {tuple(q.shape)}x{k.shape[1]} {dtype}"
            print(f"  attention_fwd {tag}: max|out-plain| {err:.3g} "
                  f"(tol {tol[dtype][0]}), max|lse-plain| {lerr:.3g} "
                  f"(tol {tol[dtype][1]})")
            check(bool(torch.isfinite(out.float()).all()), f"{tag}: non-finite")
            check(err <= tol[dtype][0] and lerr <= tol[dtype][1],
                  f"{tag}: kernel disagrees with the plain version")
            if mode == "padding" and dtype == torch.bfloat16:
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


def synthetic_manifest(path: str, n: int, seed: int = 0) -> None:
    """Arabic texts of 3..110 words (the text bucket is 128 tokens); the
    image files are missing, so decode substitutes synthetic pixels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        n_words = 110 if i == 0 else int(rng.integers(3, 60))
        words = ["".join(rng.choice(list(ARABIC_LETTERS),
                                    int(rng.integers(2, 7))))
                 for _ in range(n_words)]
        rows.append({"id": f"memes/img_{i}.jpg",
                     "img_path": f"memes/img_{i}.jpg",
                     "text": " ".join(words)})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def phase_predict(torch, work: str):
    """Full-width predict through the command line, with launch counts."""
    from mpmc_tpu_torch.cli.main import main as cli_main
    from mpmc_tpu_torch.io.tsv import check_format
    from mpmc_tpu_torch.ops import attention as A
    manifest = os.path.join(work, "memes.json")
    synthetic_manifest(manifest, N_MEMES)
    out, probs_out = (os.path.join(work, n) for n in ("pred.tsv", "probs.tsv"))
    argv = ["predict", "--subtask", "2c", "--manifest", manifest, "--out",
            out, "--probs-out", probs_out, "--image-root", work,
            "--batch-size", str(BATCH), "--device", "cuda"]
    for key in A.launch_counts:
        A.launch_counts[key] = 0
    t0 = time.perf_counter()
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


def phase_warm_eval(torch, argv):
    """The eval pass again on a warm model: memes/s of the serving loop."""
    from mpmc_tpu_torch.cli.main import build_parser, load_model, prepare_inputs
    from mpmc_tpu_torch.config import TrainConfig
    from mpmc_tpu_torch.train.loop import run_eval
    from mpmc_tpu_torch.train.step import make_eval_step
    args = build_parser().parse_args(argv)
    inputs = prepare_inputs(args)
    cfg = TrainConfig(bf16=True)
    model = load_model(args, inputs.model_cfg, torch.device("cuda"), cfg.seed)
    step = make_eval_step(model, cfg)
    run_eval(step, inputs.data, BATCH, torch.device("cuda"))
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_eval(step, inputs.data, BATCH, torch.device("cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = sorted(times)[1]
    print(f"  warm eval pass: {N_MEMES} memes in {t:.4f} s (median of 3) = "
          f"{N_MEMES / t:.2f} memes/s, text {inputs.data['text_ids'].shape}, "
          f"caption {inputs.data['caption_ids'].shape}")
    # Where the device time of one warm pass goes.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_eval(step, inputs.data, BATCH, torch.device("cuda"))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"  profiled pass: {wall_us / 1e3:.3f} ms wall, kernels "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f} % of wall; "
          f"device idle otherwise, counting no overlap)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")
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
    gpu = build_model(inputs.model_cfg, torch.device("cuda"), seed=7)
    cpu = build_model(inputs.model_cfg, torch.device("cpu"))
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

    names = sorted(f[:-3] for f in os.listdir(build.CSRC_DIR)
                   if f.endswith(".cu"))
    t0 = time.perf_counter()
    reports = build.build(names)
    print(f"phase 1 build: {names} in {time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "Used" in line or "spill" in line and " 0 bytes spill" not in line:
                print(f"  {name}: {line.strip()}")

    print("phase 2 kernels vs plain versions on the card:")
    timings, err_main = phase_kernels(torch)

    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        os.chdir(work)                  # the caption cache goes to ./.cache
        try:
            print("phase 3 full-width 2C predict:")
            argv, launches = phase_predict(torch, work)
            inputs = phase_warm_eval(torch, argv)
        finally:
            os.chdir(cwd)
    print("phase 4 card vs CPU:")
    phase_card_vs_cpu(torch, inputs)

    text = timings["text"]
    kernels = [{
        "name": "attention_fwd", "route": "cuda",
        "source": "mpmc_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "mpmc_tpu/ops/attention.py:97",
        "launches": launches["attention_fwd"], "max_abs_err": err_main,
        "ms": text["ms"], "plain_ms": text["plain_ms"],
        "bound_ms": text["bound_ms"], "bound_by": text["bound_by"],
        "library_ms": text["library_ms"], "shape": text["shape"],
        "dtype": text["dtype"], "caption_shape": timings["caption"]}]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
