"""Cases that the multi-process tests run on every rank of a gloo world
(``mpmc_tpu_torch.parallel.dist_worker.launch_processes(target=
"torch_dist_cases:<name>")``).  Port-only imports: the ranks never load
JAX; the tests compare what the cases save with the JAX package in their
own process.  Each case first puts its rank on one CPU thread.
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from mpmc_tpu_torch.config import (DataConfig, LossType, MeshConfig,
                                   ModelConfig, TrainConfig)
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.norm import set_data_shard
from mpmc_tpu_torch.parallel.mesh import Layout, make_layout, make_mesh
from mpmc_tpu_torch.train.loop import batch_iter
from mpmc_tpu_torch.train.packed import PackedMultimodalPlan
from mpmc_tpu_torch.train.step import GradSync, build_train_step

CPU = torch.device("cpu")


def zero_dropout(mcfg: ModelConfig) -> ModelConfig:
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        mcfg, dropout=0.0,
        text=dataclasses.replace(mcfg.text, **enc),
        caption=dataclasses.replace(mcfg.caption, **enc),
        image=dataclasses.replace(mcfg.image, finetune_dropout=0.0))


def _save(out: str, obj) -> str:
    path = f"{out}.rank{dist.get_rank()}.pt"
    torch.save(obj, path)
    return path


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

def dp_steps(case: str, out: str) -> str:
    """Three train steps of the tiny 2C model (dropout 0, the case's
    weights and augmentation draws) on this rank's rows of each global
    batch, unpacked (``batch_iter``) and packed (``PackedMultimodalPlan``),
    batches from ``np.random.default_rng(case["order_seed"])``.  Saves per
    mode the losses, grad norms and final state dict."""
    torch.set_num_threads(1)
    c = torch.load(case, weights_only=False)
    B, data = c["batch"], c["data"]
    mcfg = zero_dropout(ModelConfig.tiny_2c())
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B),
                      learning_rate=1e-4, adam_mu_dtype="bfloat16",
                      embedding_optimizer="factored", bf16=False)
    layout = make_layout(MeshConfig(), CPU)
    res: Dict = {}
    for packed in (False, True):
        model = build_model(mcfg, CPU, packed=packed)
        model.load_state_dict(c["state"])
        set_data_shard(model, layout.data_group)
        sync = GradSync(layout, [n for n, _ in model.named_parameters()])
        rows = sync.rows(B)
        draws = [torch.from_numpy(d[rows]) for d in c["draws"]]
        step = build_train_step(
            model, cfg, 3, {}, torch.Generator().manual_seed(0),
            augment=lambda u8, gen, draws=draws: augment_with_draws(
                u8, *draws), sync=sync)
        rng = np.random.default_rng(c["order_seed"])
        if packed:
            batches = PackedMultimodalPlan(
                data, B, shard=(layout.data_rank,
                                layout.data_size)).epoch_iter(rng)
        else:
            batches = (({k: v[rows] for k, v in b.items()}, n)
                       for b, n in batch_iter(data, B, shuffle=True, rng=rng,
                                              with_valid=True))
        losses, norms = [], []
        for batch, _ in batches:
            m = step({k: torch.from_numpy(np.asarray(v))
                      for k, v in batch.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res["packed" if packed else "unpacked"] = {
            "loss": losses, "grad_norm": norms,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}
    res["fold_parallel"] = fold_parallel_steps(c, mcfg, cfg)
    return _save(out, res)


def fold_parallel_steps(c: Dict, mcfg: ModelConfig, cfg: TrainConfig) -> Dict:
    """Three fold-parallel steps of two replicas (the case's weights, then
    seed 1's) on this rank's rows of each fold's global batch (a ``(fold
    1, data P)`` mesh), the augmentation's own draws, after one eval batch
    of each fold's rows, gathered."""
    from mpmc_tpu_torch.parallel.fold_parallel import (
        build_fold_parallel_steps)
    layout = make_layout(MeshConfig(fold_parallel=True), CPU)
    B, data = c["batch"], c["data"]
    models = [build_model(mcfg, CPU), build_model(mcfg, CPU, seed=1)]
    models[0].load_state_dict(c["state"])
    sync = GradSync(layout, [n for n, _ in models[0].named_parameters()])
    store = {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}
    step, evaluate = build_fold_parallel_steps(
        models, cfg, 3, store, store, torch.Generator().manual_seed(0),
        sync=sync)
    rng = np.random.default_rng(c["order_seed"])
    n = len(data["label"])
    # Before training, on the weights every world starts from.
    probs, _ = evaluate({"idx": torch.from_numpy(
        np.stack([np.arange(B), np.arange(n - B, n)]))})
    losses, norms = [], []
    for _ in range(3):
        idx = np.stack([rng.permutation(n)[:B] for _ in range(2)])
        m = step({"idx": torch.from_numpy(idx[:, sync.rows(B)]),
                  "valid": torch.ones(2, B // layout.data_size)})
        losses.append(m["loss"].tolist())
        norms.append(m["grad_norm"].tolist())
    return {"loss": losses, "grad_norm": norms, "probs": probs.numpy(),
            "state": {k: v.detach().clone() for k, v in
                      step.model.params.items()}}


def crash(rank: int) -> None:
    """Rank ``rank`` is killed; the others wait at a barrier for it."""
    torch.set_num_threads(1)
    if dist.get_rank() == rank:
        os.kill(os.getpid(), signal.SIGKILL)
    dist.barrier()


# ---------------------------------------------------------------------------
# Sequence parallelism
# ---------------------------------------------------------------------------

def _qkvm(seed: int = 0, B=4, S=16, H=4, D=8):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, S), np.float32)
    for i in range(B):                  # ragged: every block's routing
        mask[i, S - 3 - i:] = 0.0
    return q, k, v, mask, w


def sp_attention(impl: str, group, seed: int = 0) -> Dict:
    """``impl`` attention over ``group`` on this rank's sequence block of
    fixed inputs, the gradients of ``sum(out * w)``, all gathered back to
    full arrays."""
    from mpmc_tpu_torch.ops.attention import dot_product_attention
    from mpmc_tpu_torch.parallel.collectives import gather_rows
    q, k, v, mask, w = _qkvm(seed)
    P, r = dist.get_world_size(group), dist.get_rank(group)
    S = q.shape[1]
    sl = slice(r * S // P, (r + 1) * S // P)
    qkv = [torch.from_numpy(x[:, sl].copy()).requires_grad_()
           for x in (q, k, v)]
    out = dot_product_attention(*qkv, torch.from_numpy(mask[:, sl].copy()),
                                impl=impl, group=group)
    (out * torch.from_numpy(w[:, sl].copy())).sum().backward()

    def full(x):
        return gather_rows(x.detach().transpose(0, 1).contiguous(),
                           group).transpose(0, 1).numpy()

    return {"out": full(out), "dq": full(qkv[0].grad),
            "dk": full(qkv[1].grad), "dv": full(qkv[2].grad)}


def sp_forward(state: Dict, mcfg: ModelConfig, impl: str, group,
               ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
    from mpmc_tpu_torch.parallel.sp import make_sp_forward
    fwd = make_sp_forward(mcfg, group, impl)
    with torch.no_grad():
        return fwd(state, torch.from_numpy(ids),
                   torch.from_numpy(mask)).numpy()


def sp_cases(case: str, out: str, argv) -> str:
    """On a world of 4: ring and Ulysses attention over all 4 ranks,
    Ulysses over the 2-rank ``seq`` groups of a ``(data 2, seq 2)`` mesh,
    ``make_sp_forward`` over 4, then the command line ``argv`` (``train
    --seq-shards 2`` on this world: data 2 x seq 2)."""
    torch.set_num_threads(1)
    from mpmc_tpu_torch.cli.main import main
    c = torch.load(case, weights_only=False)
    world = dist.group.WORLD
    res = {"ring4": sp_attention("ring", world),
           "ulysses4": sp_attention("ulysses", world)}
    mesh = Layout(MeshConfig(num_seq_shards=2),
                  make_mesh(MeshConfig(num_seq_shards=2)))
    res["ulysses2"] = sp_attention("ulysses", mesh.group("seq"))
    res["forward"] = {impl: sp_forward(c["state"], c["mcfg"], impl, world,
                                       c["ids"], c["mask"])
                      for impl in ("ring", "ulysses")}
    res["rc"] = main(argv)
    return _save(out, res)


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------

def pp_cases(case: str, out: str, argv) -> str:
    """On a world of 2: the pipelined text classifier (S = 2, M = 4, the
    case's weights) forward and the gradients of the summed logits,
    gathered to the plain layout; the train step's state round trip; then
    the command line ``argv`` (``train --pipeline-stages 2``)."""
    torch.set_num_threads(1)
    from mpmc_tpu_torch.cli.main import main
    from mpmc_tpu_torch.parallel.pp import PipelineText, gather_stages
    from mpmc_tpu_torch.train.checkpoint import to_host
    c = torch.load(case, weights_only=False)
    mcfg = c["mcfg"]
    plain = build_model(mcfg, CPU, kind="text")
    plain.load_state_dict(c["state"])
    world = dist.group.WORLD
    model = PipelineText.wrap(plain, world, 4).eval()
    logits = model(torch.from_numpy(c["ids"]), torch.from_numpy(c["mask"]))
    # Every rank computes the same logits: 1/S of the loss each.
    (logits.sum() / dist.get_world_size()).backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    for n, g in grads.items():
        if n not in model.sharded_params:
            dist.all_reduce(g)          # the shared weights' terms
    own = {n: g for n, g in grads.items() if n in model.sharded_params}
    for part in gather_stages(own, world):
        grads.update(part)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=8),
                      loss=LossType.CROSS_ENTROPY, bf16=False)
    layout = make_layout(MeshConfig(num_stage_shards=2), CPU)
    from mpmc_tpu_torch.parallel.pp import PipelineTrainStep
    sync = GradSync(layout, [n for n, _ in model.named_parameters()],
                    model.sharded_params)
    step = build_train_step(model.train(), cfg, 4, {},
                            torch.Generator().manual_seed(0), sync=sync,
                            step_cls=PipelineTrainStep)
    ids, mask = (torch.from_numpy(c[k][:8]) for k in ("ids", "mask"))
    batch = {"text_ids": ids, "text_mask": mask,
             "label": torch.zeros(8, dtype=torch.long),
             "valid": torch.ones(8)}
    step(batch)
    full = to_host(step.state_dict())   # as the checkpointer keeps it
    local = {k: v.clone() for k, v in model.state_dict().items()}
    step(batch)
    step.load_state_dict(full)
    restored = all(torch.equal(local[k], v)
                   for k, v in model.state_dict().items())
    res = {"logits": logits.detach().numpy(),
           "grads": {n: g.numpy() for n, g in grads.items()},
           "full_keys": sorted(full["model"]),
           "opt_keys": sorted(full["optimizer"]["state"]),
           "restored": restored, "sharded_params": model.sharded_params,
           "rc": main(argv)}
    return _save(out, res)


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

def tp_cases(case: str, out: str, argv) -> str:
    """On a world of 2 (model 2): three 2A train steps of the case's text
    classifier split over the model group, under the ``adam`` and the
    ``factored`` embedding optimizers (the losses, grad norms and the
    gathered final state); the state's restore; a model whose heads and
    vocabulary do not divide the group (what stays whole, the warnings);
    then the command line ``argv`` (``train --model-shards 2``)."""
    torch.set_num_threads(1)
    import logging
    from mpmc_tpu_torch.cli.main import main
    from mpmc_tpu_torch.parallel.tp import (TensorParallelTrainStep,
                                            count_sharded, tensor_parallel)
    from mpmc_tpu_torch.train.checkpoint import to_host
    c = torch.load(case, weights_only=False)
    mcfg = c["mcfg"]
    layout = make_layout(MeshConfig(num_model_shards=2), CPU)
    group = layout.group("model")

    def build(cfg_model, state=None):
        model = build_model(cfg_model, CPU, seed=0, kind="text")
        if state is not None:
            model.load_state_dict(state)
        return tensor_parallel(model, group, lambda: build_model(
            cfg_model, torch.device("meta"), kind="text"))

    res: Dict = {}
    for opt in ("adam", "factored"):
        model = build(mcfg, c["state"])
        cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=8),
                          learning_rate=1e-3, loss=LossType.CROSS_ENTROPY,
                          lr_schedule="constant", embedding_optimizer=opt,
                          bf16=False)
        set_data_shard(model, layout.data_group)
        sync = GradSync(layout, [n for n, _ in model.named_parameters()],
                        model.sharded_params)
        step = build_train_step(model.train(), cfg, 3, {},
                                torch.Generator().manual_seed(0), sync=sync,
                                step_cls=TensorParallelTrainStep)
        losses, norms = [], []
        for b in c["batches"]:
            m = step({k: torch.from_numpy(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        full = to_host(step.state_dict())
        local = {k: v.clone() for k, v in model.state_dict().items()}
        local_opt = to_host(step.optimizer.state_dict())
        step({k: torch.from_numpy(v) for k, v in c["batches"][0].items()})
        step.load_state_dict(full)
        restored = (all(torch.equal(local[k], v)
                        for k, v in model.state_dict().items())
                    and all(torch.equal(local_opt["state"][n][k], v)
                            for n, st in step.optimizer.state_dict()[
                                "state"].items() for k, v in st.items()))
        res[opt] = {"loss": losses, "grad_norm": norms,
                    "state": full["model"], "restored": restored,
                    "slots": {n: sorted((k, tuple(v.shape))
                                        for k, v in st.items())
                              for n, st in full["optimizer"]["state"]
                              .items()},
                    "sharded": dict((n, d) for n, (d, _) in
                                    model.tp_shards.items()),
                    "local_shapes": {n: tuple(p.shape) for n, p in
                                     model.named_parameters()}}
    warnings: list = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger("mpmc_tpu_torch.parallel.tp").addHandler(handler)
    odd = dataclasses.replace(mcfg, text=dataclasses.replace(
        mcfg.text, num_heads=1, vocab_size=511))
    model = build(odd)
    res["odd"] = {"sharded": sorted(model.tp_shards),
                  "count": count_sharded(model), "warnings": warnings}
    res["rc"] = main(argv)
    return _save(out, res)


# ---------------------------------------------------------------------------
# Fold shards
# ---------------------------------------------------------------------------

def cli(argvs) -> list:
    """The command lines ``argvs`` one after another; their return
    codes."""
    torch.set_num_threads(1)
    from mpmc_tpu_torch.cli.main import main
    return [main(argv) for argv in argvs]


# ---------------------------------------------------------------------------
# Tensor parallelism inside the fold-parallel step
# ---------------------------------------------------------------------------

def tp_fold_cases(case: str, out: str) -> str:
    """On a world of 8, JAX's 3-D ``(fold 2, data 2, model 2)`` layout:
    each fold group holds two of the case's four folds (``fold_slice``),
    splits each fold's transformer weights over its ``model`` group and
    each fold's batch over ``data``, and runs three fold-parallel steps of
    every run of the case (each replica loads its fold's JAX tree through
    ``from_jax_variables`` before it is split), then one eval batch.  Saves per run the
    losses, grad norms, the stacked leaves' local shapes, the gathered
    stacked state, each of its folds' gathered state and the eval
    probabilities; and whether the command line's mesh still refuses
    fold parallelism with model shards inside the world."""
    torch.set_num_threads(1)
    from mpmc_tpu_torch.models.convert import from_jax_variables
    from mpmc_tpu_torch.parallel.fold_parallel import (
        build_fold_parallel_steps)
    from mpmc_tpu_torch.parallel.mesh import fold_data_model_layout
    from mpmc_tpu_torch.parallel.tp import tensor_parallel
    c = torch.load(case, weights_only=False)
    layout = fold_data_model_layout(2, 2, CPU)
    group = layout.group("model")
    total = len(c["idx"][0])
    per = total // layout.size("fold")
    lo = layout.coord("fold") * per
    mine = list(range(lo, lo + per))
    store = {k: torch.from_numpy(v) for k, v in c["store"].items()}
    res: Dict = {"coords": {ax: layout.coord(ax)
                            for ax in ("fold", "data", "model")},
                 "folds": mine}
    for name, run in c["runs"].items():
        mcfg, cfg = run["cfg"].model, run["cfg"]
        models = []
        for k in mine:
            model = build_model(mcfg, CPU, seed=k, kind="text")
            model.load_state_dict(from_jax_variables(run["trees"][k]))
            models.append(tensor_parallel(
                model, group,
                lambda: build_model(mcfg, torch.device("meta"), kind="text")))
        sync = GradSync(layout, [n for n, _ in models[0].named_parameters()],
                        models[0].sharded_params)
        dims = {n: d for n, (d, _) in models[0].tp_shards.items()}
        step, evaluate = build_fold_parallel_steps(
            models, cfg, len(c["idx"]), store, store,
            torch.Generator().manual_seed(0), sync=sync,
            fold_slice=(lo, total), model_group=group)
        del models
        rows = sync.rows(cfg.data.batch_size)
        losses, norms = [], []
        for idx in c["idx"]:
            m = step({"idx": torch.from_numpy(np.ascontiguousarray(
                idx[mine][:, rows])),
                      "valid": torch.ones(per, rows.stop - rows.start)})
            losses.append(m["loss"].tolist())
            norms.append(m["grad_norm"].tolist())
        probs, _ = evaluate({"idx": torch.from_numpy(c["eval_idx"][mine])})
        res[name] = {
            "loss": losses, "grad_norm": norms, "probs": probs.numpy(),
            "split": dims,
            "local_shapes": {n: tuple(p.shape)
                             for n, p in step.model.params.items()},
            "state": step.state_dict()["model"],
            "fold_states": [step.fold_state(j)["model"]
                            for j in range(per)]}
    try:
        make_layout(MeshConfig(fold_parallel=True, num_model_shards=2), CPU)
        res["refused"] = None
    except ValueError as e:
        res["refused"] = str(e)
    return _save(out, res)
