"""Multi-process worker and launcher (port of
``mpmc_tpu/parallel/dist_worker.py``).

:func:`launch_processes` starts N local processes as ``torchrun`` would
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``
on a free localhost port), each running this module::

    python -m mpmc_tpu_torch.parallel.dist_worker [--device cuda|cpu] \\
        [--steps 3] [--target module:function --kwargs JSON]

The device is CUDA unless the caller asks for the CPU, and a run on CUDA
raises when CUDA is absent.

Every process joins the world (``parallel/distributed.py``: gloo on the
CPU, NCCL on CUDA) and prints ONE json line: ``{"rank", "world",
"result", "launches", "collectives"}``.  The default target, :func:`run`,
is the data-parallel step on a fixed GLOBAL batch: the tiny 2C multimodal
model (BatchNorm heads) trains ``steps`` steps on this rank's rows of
every global batch, fed from the host (``device_resident=False``, as the
JAX worker's config), whose last one holds fewer valid rows than rows, and
reports the losses and grad norms; one process runs the same steps on the
whole batch, and a world of N must match it.  Any other ``--target``
(``"mpmc_tpu_torch.cli.main:main"`` with ``{"argv": [...]}`` runs the
command line) is called as ``function(**kwargs)``.

A rank that fails, or is killed, fails the launch: the error names each
rank that ended badly with its return code and the tail of its stderr,
and the ranks still running are killed.  So does a timeout, naming the
ranks that had not finished.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(steps: int = 3, device: str = "cuda") -> Dict:
    """The DP step on this rank's rows of a fixed global batch (module
    docstring); ``{"losses", "grad_norms", "running_mean"}``."""
    import numpy as np
    import torch

    from mpmc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.models.norm import set_data_shard
    from mpmc_tpu_torch.parallel import distributed
    from mpmc_tpu_torch.parallel.distributed import host_local_batch_slice
    from mpmc_tpu_torch.parallel.mesh import make_layout
    from mpmc_tpu_torch.train.step import GradSync, build_train_step

    dev = distributed.device_for(device)
    mcfg = ModelConfig.tiny_2c()
    B, n = 8, 20                         # the last batch: 4 valid of 8
    cfg = TrainConfig(model=mcfg,
                      data=DataConfig(batch_size=B, device_resident=False),
                      learning_rate=1e-3, bf16=dev.type == "cuda")
    rng = np.random.default_rng(0)
    size = mcfg.image.image_size
    data = {"text_ids": rng.integers(5, 512, (n, mcfg.max_text_len)),
            "text_mask": np.ones((n, mcfg.max_text_len), np.int64),
            "caption_ids": rng.integers(5, 512, (n, mcfg.max_caption_len)),
            "caption_mask": np.ones((n, mcfg.max_caption_len), np.int64),
            "image": rng.integers(0, 256, (n, size, size, 3), np.uint8),
            "label": rng.integers(0, 2, n)}
    model = build_model(mcfg, dev, seed=0)
    layout = make_layout(cfg.mesh, dev)
    sync = None
    if layout is not None:
        set_data_shard(model, layout.data_group)
        sync = GradSync(layout, [k for k, _ in model.named_parameters()])
    step = build_train_step(model, cfg, steps, {},
                            torch.Generator(dev).manual_seed(1), sync=sync)
    losses, norms = [], []
    for i in range(steps):
        idx = np.resize(np.arange(i * B, i * B + B) % n, B)
        valid = (np.arange(i * B, i * B + B) < n).astype(np.float32)
        rows = host_local_batch_slice(B)
        batch = {k: v[idx[rows]] for k, v in data.items()}
        batch["valid"] = valid[rows]
        m = step({k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "running_mean": float(sum(
                b.double().sum() for k, b in model.state_dict().items()
                if k.endswith("running_mean")))}


def _require_device(device: str) -> None:
    """Raise when CUDA is asked for and absent."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' (--device cpu) to "
                           "run on the CPU")


def _call(target: str, kwargs: Dict):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)(**kwargs)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="dist_worker")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--target", default=None)
    ap.add_argument("--kwargs", default="{}")
    args = ap.parse_args(argv)

    import torch

    from mpmc_tpu_torch.ops import build
    from mpmc_tpu_torch.parallel import distributed

    _require_device(args.device)
    if not distributed.initialize(args.device):
        raise RuntimeError("dist_worker runs in a launched world "
                           "(launch_processes or torchrun)")
    if args.target is None:
        result = run(args.steps, args.device)
    else:
        result = _call(args.target, json.loads(args.kwargs))
    line = {"rank": distributed.rank(), "world": distributed.world_size(),
            "result": result, "launches": dict(build.launch_counts),
            "collectives": dict(build.collective_calls)}
    torch.distributed.destroy_process_group()
    print(json.dumps(line), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _describe(rc: int) -> str:
    if rc < 0:
        try:
            return f"{rc} ({signal.Signals(-rc).name})"
        except ValueError:
            return str(rc)
    return str(rc)


def launch_processes(nproc: int, device: str = "cuda", steps: int = 3,
                     target: Optional[str] = None,
                     kwargs: Optional[Dict] = None, timeout: float = 300.0,
                     env: Optional[Dict[str, str]] = None) -> List[Dict]:
    """Run ``nproc`` worker processes as one world on this machine and
    return their JSON lines in rank order.  ``env`` adds to each process's
    environment.  Raises on the first rank that fails (naming every rank
    that ended badly, its return code and stderr tail, after killing the
    rest) or at ``timeout`` seconds (naming the ranks still running), and
    before starting any when ``device`` is CUDA and CUDA is absent."""
    _require_device(device)
    base = dict(os.environ)
    base.update(env or {})
    base["PYTHONPATH"] = REPO + os.pathsep + base.get("PYTHONPATH", "")
    base.update(WORLD_SIZE=str(nproc), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()))
    cmd = [sys.executable, "-m", "mpmc_tpu_torch.parallel.dist_worker",
           "--device", device, "--steps", str(steps)]
    if target is not None:
        cmd += ["--target", target, "--kwargs", json.dumps(kwargs or {})]
    procs = [subprocess.Popen(cmd, env=dict(base, RANK=str(r),
                                            LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for r in range(nproc)]
    # Drain every pipe on its own thread: a rank blocked on a full pipe
    # would hold the others in their collectives.
    outs: List = [None] * nproc

    def drain(r: int) -> None:
        outs[r] = procs[r].communicate()

    threads = [threading.Thread(target=drain, args=(r,), daemon=True)
               for r in range(nproc)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    killed: List[int] = []
    timed_out = False
    try:
        while any(t.is_alive() for t in threads):
            if any(p.poll() not in (None, 0) for p in procs):
                break                   # a rank failed: stop the others
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                killed.append(r)
        for t in threads:
            t.join()
    failed = [r for r, p in enumerate(procs)
              if r not in killed and p.returncode != 0]
    if failed or killed:
        lines = [f"rank {r} exited with {_describe(procs[r].returncode)}; "
                 f"its stderr ends:\n{(outs[r][1] or '')[-2000:]}"
                 for r in failed]
        if killed:
            why = (f"still running after {timeout:.0f}s" if timed_out
                   else "still running when a rank failed")
            lines.append(f"ranks {killed} of {nproc} {why}: killed")
        raise RuntimeError("\n".join(lines))
    return [json.loads(outs[r][0].strip().splitlines()[-1])
            for r in range(nproc)]


if __name__ == "__main__":
    main()
