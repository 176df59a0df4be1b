"""The single-step CUDA graphs of ``train/graphs.py`` on the card
(``GroupedSteps.single``): a packed 2C fold at K = 4, whose eval intervals
leave steps outside full groups, against the same fold at K = 1 bit for
bit under deterministic algorithms; and a resident and a host-fed
``run_eval`` of 20 batches at K = 8 against the per-batch pass.  Both need
a CUDA device and skip without one; the port alone is imported."""

import dataclasses

import numpy as np
import pytest
import torch

from mpmc_tpu_torch.cli.experiments import _select, build_fold, resident_store
from mpmc_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.train.graphs import graph_pool, make_scan_eval_step
from mpmc_tpu_torch.train.loop import DeviceData, fit, run_eval
from mpmc_tpu_torch.train.pretrain import deterministic_algorithms
from mpmc_tpu_torch.train.step import make_eval_step


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _memes(seed: int, n: int, mcfg: ModelConfig) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for name, S in (("text", mcfg.max_text_len),
                    ("caption", mcfg.max_caption_len)):
        lens = rng.integers(3, S, n)
        mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
        out[f"{name}_ids"] = (rng.integers(5, 512, (n, S)) * mask).astype(
            np.int32)
        out[f"{name}_mask"] = mask
    size = mcfg.image.image_size
    out["image"] = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    out["label"] = rng.integers(0, 2, n).astype(np.int32)
    return out


def _config(k: int) -> TrainConfig:
    """tiny 2C on the fast recipe (packed rows, factored embeddings, the
    bf16 first moment), dropout on; 2 epochs, 2 evals an epoch."""
    return TrainConfig(model=ModelConfig.tiny_2c(),
                       data=DataConfig(batch_size=4, pack_rows=2),
                       epochs=2, eval_per_epoch=2, scan_steps=k,
                       embedding_optimizer="factored",
                       adam_mu_dtype="bfloat16", learning_rate=1e-4,
                       seed=3)


def run_fold(k: int, device: torch.device):
    """A fold of 52 train memes (13 steps) and 9 val memes of 61, the 18
    test memes (5 eval batches), all resident; what ``fit`` returned, the
    final weights and the run."""
    cfg = _config(k)
    data, test = _memes(1, 61, cfg.model), _memes(2, 18, cfg.model)
    tr_idx, va_idx = np.arange(52), np.arange(52, 61)
    store = resident_store(cfg, data, device)
    test_store = resident_store(cfg, test, device)
    run = build_fold(cfg, _select(data, tr_idx), tr_idx, store, device, 0)
    res = fit(run.train_step, run.eval_step, cfg, _select(data, tr_idx),
              device, test_data=test, val_data=_select(data, va_idx),
              packed_plan=run.plan, train_rows=tr_idx,
              scan_train_step=run.scan_train_step,
              scan_eval_step=run.scan_eval_step,
              dev_test=DeviceData(test_store, np.arange(18)),
              dev_val=DeviceData(store, va_idx))
    state = {n: v.detach().cpu().clone()
             for n, v in run.train_step.model.state_dict().items()}
    return res, state, run


@pytest.mark.cuda
def test_fit_k4_with_single_step_graphs_equals_k1_bit_for_bit():
    device = _card()
    with deterministic_algorithms():
        got = {k: run_fold(k, device) for k in (1, 4)}
    (res1, state1, _), (res4, state4, run) = got[1], got[4]
    assert res4.steps == res1.steps and len(res4.steps) == 26
    assert res4.history == res1.history and len(res4.history) == 6
    for name, v in state1.items():
        assert torch.equal(v, state4[name]), name
    grouped = run.scan_train_step
    # Each epoch, evals after steps 6, 12 and 13: a group of 4, 2 single
    # steps, a group, 2 single steps, 1 single step.  Each group and each
    # single step either warms and captures its shape's graph or replays
    # it (a packed plan may give the second epoch other shapes).
    assert grouped.replays >= 1 and grouped.single_replays >= 1
    assert grouped.replays + grouped.single_replays + grouped.captures == 14
    # The test split's 5 batches: a group and a single batch; the val
    # split's 3: single batches.
    evals = list(run.scan_eval_step._stores.values())
    assert len(evals) == 2
    assert all(e.single_replays >= 5 for e in evals)


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True],
                         ids=["host-fed", "resident"])
def test_run_eval_at_k8_equals_the_per_batch_pass(resident):
    """80 memes at batch 4: 2 groups of 8 and 4 single batches a pass;
    three passes, the first warming and capturing both graphs."""
    device = _card()
    cfg = dataclasses.replace(_config(8), bf16=True)
    data = _memes(5, 80, cfg.model)
    torch.manual_seed(0)
    model = build_model(cfg.model, device)
    step = make_eval_step(model, cfg, cast_in_place=False)
    scan = make_scan_eval_step(step, 8, device, graph_pool(device))
    dev = None
    if resident:
        dev = DeviceData(resident_store(cfg, data, device), np.arange(80))
    with torch.no_grad():
        ref = run_eval(step, data, 4, device, dev=dev).probs
        passes = [run_eval(step, data, 4, device, scan_eval_step=scan,
                           dev=dev).probs for _ in range(3)]
    for probs in passes:
        np.testing.assert_array_equal(probs, ref)
    used = scan.with_store(dev.data) if resident else scan
    assert (used.replays, used.single_replays, used.captures) == (5, 11, 2)
