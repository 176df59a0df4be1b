"""Time the f32 attention pair of several checkouts of this repository on
one CUDA card, in turns, at the f32 shapes of the port's main paths.

    python3 attention_f32_compare.py TREE_A TREE_B [--rounds 2]

Each TREE is a directory that holds ``mpmc_tpu_torch/`` (a checkout, or a
``git archive`` of a commit).  The runs go A, B, B, A (and so on for more
rounds), each in its own process with its tree first on ``sys.path``, so
each builds and loads that tree's kernels into that tree's ``_build/``;
all trees are built first, in parallel.  A run holds the forward and
backward kernels against the plain versions at ``chip_smoke.py``'s
tolerances, then times the kernels, the plain versions, SDPA and the
forward+backward pairs with ``chip_smoke.time_attention_at`` (CUDA-graph
replays between CUDA events), and counts the kernels one backward call
launches with ``torch.profiler``.  Shapes: corpus MLM ``[64,128,12,64]``
in padding and segments modes (``--mlm-pack``) and SimCLR over ViT-B/16
``[128,197,12,64]`` in mode none.  Prints the card, one JSON line per run
and a table of means per tree.  Needs one CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = [("mlm", (64, 128, 12, 64), "padding"),
          ("mlm_pack", (64, 128, 12, 64), "segments"),
          ("simclr_vit", (128, 197, 12, 64), "none")]
KEYS = ("fwd_ms", "ms", "fwd_bwd_pair_ms", "fwd_plain_ms", "plain_ms",
        "library_fwd_ms", "library_ms", "library_pair_ms", "fwd_bound_ms",
        "bound_ms", "fwd_max_abs_err", "max_abs_err")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _use_tree(tree: str) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    for name in [m for m in sys.modules if m.startswith("mpmc_tpu_torch")]:
        del sys.modules[name]


def build_only(tree: str) -> int:
    _use_tree(tree)
    from mpmc_tpu_torch.ops import build
    reports = build.build(["attention_fwd", "attention_bwd"])
    print(f"{tree}: built {sorted(reports)}")
    return 0


def run_one(tree: str) -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    _use_tree(tree)
    C = _chip_smoke()
    from mpmc_tpu_torch.ops import attention as A
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"tree": tree}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, (B, S, H, D), mode in SHAPES:
        _, _, _, mask = C.attention_inputs(torch, (B, S, H, D), mode,
                                           torch.float32, gen)
        timed = C.time_attention_at(torch, mask, mode, torch.float32, gen,
                                    name, H, (B, S), D)
        q, k, v, do = (torch.randn(B, S, H, D, device="cuda", generator=gen)
                       for _ in range(4))
        out, lse = A.attention_forward_cuda(q, k, v, mask, mode)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            A.attention_backward_cuda(q, k, v, mask, mode, out, lse, do)
            torch.cuda.synchronize()
        launches = sum(e.count for e in prof.key_averages()
                       if "attention_bwd" in e.key)
        result[name] = {**{k: timed[k] for k in KEYS},
                        "bwd_launches_per_call": launches}
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(result), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("trees", nargs="+")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--build", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        return run_one(args.trees[0])
    if args.build:
        return build_only(args.trees[0])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    me = os.path.abspath(__file__)
    builds = [subprocess.Popen([sys.executable, me, "--build", t])
              for t in args.trees]
    if any(p.wait() != 0 for p in builds):
        return 1
    order = []
    for r in range(args.rounds):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    runs = {t: [] for t in args.trees}
    for tree in order:
        proc = subprocess.run([sys.executable, me, "--one", tree],
                              capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return proc.returncode
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")][-1]
        runs[tree].append(json.loads(line[7:]))
    print(f"means over {args.rounds} runs a tree, ms:")
    for name, _, _ in SHAPES:
        for tree in args.trees:
            mean = {k: sum(r[name][k] for r in runs[tree]) / len(runs[tree])
                    for k in KEYS + ("bwd_launches_per_call",)}
            print(f"  {name:10s} {tree}: " + ", ".join(
                f"{k} {mean[k]:.5f}" for k in KEYS[:8])
                + f", bwd launches a call {mean['bwd_launches_per_call']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
