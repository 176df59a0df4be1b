"""The host side of the port's training loop against the JAX package's:
the non-finite failure dump (``nonfinite_fold<k>_epoch<e>_batch<b>.npz``,
the keys and arrays of the JAX device-resident loop's dump), the
``profile_dir`` trace and ``seed_everything``."""

import glob
import os
import random
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.train.loop import DeviceData
from mpmc_tpu.train.loop import fit as j_fit
from mpmc_tpu.train.step import GatherSteps, TrainState
from mpmc_tpu_torch.config import DataConfig, TrainConfig
from mpmc_tpu_torch.train.loop import fit
from mpmc_tpu_torch.utils import profiling
from mpmc_tpu_torch.utils.profiling import trace
from mpmc_tpu_torch.utils.seed import seed_everything


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.int32)
    x = ((y * 2.0 - 1.0) + rng.standard_normal(n) * 0.3).astype(np.float32)
    return {"x": x, "label": y,
            "tok": rng.integers(0, 99, (n, 5)).astype(np.int32)}


class _Step:
    """A stand-in train step of the port's interface: a loss of 0.5, and
    NaN from call ``bad_at`` (1-based) on."""

    def __init__(self, bad_at=None):
        self.optimizer = types.SimpleNamespace(count=0)
        self.bad_at, self.calls, self.batches = bad_at, 0, []

    def __call__(self, batch):
        self.calls += 1
        self.batches.append({k: v.clone() for k, v in batch.items()})
        bad = self.bad_at is not None and self.calls >= self.bad_at
        return {"loss": torch.tensor(float("nan") if bad else 0.5),
                "grad_norm": torch.tensor(2.0 if bad else 1.0)}


def _eval_step(batch):
    p = torch.sigmoid(2.0 * batch["x"])
    return p, torch.zeros_like(p)


def _jax_dump(tmp_path, data, rows, bad_at):
    """The JAX loop over a device-resident split (DeviceData at ``rows``),
    its train step NaN from call ``bad_at``: the dump it writes."""
    calls = []

    def train(state, dev_data, idx, valid, key):
        calls.append(1)
        bad = len(calls) >= bad_at
        return (state.replace(step=state.step + 1),
                {"loss": jnp.asarray(float("nan") if bad else 0.5),
                 "grad_norm": jnp.asarray(2.0 if bad else 1.0)})

    state = TrainState(step=jnp.zeros((), jnp.int32), params={},
                       batch_stats={}, opt_state=())
    steps = GatherSteps(train=train, eval=None)
    store = {k: jnp.zeros((int(rows.max()) + 1,) + v.shape[1:], v.dtype)
             for k, v in data.items()}
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(FloatingPointError, match="non-finite"):
            j_fit(state, None, None,
                  JTrainConfig(data=JDataConfig(batch_size=8), epochs=1),
                  data, gather_steps=steps,
                  dev_train=DeviceData(store, rows))
    finally:
        os.chdir(cwd)
    dumps = glob.glob(str(tmp_path / "nonfinite_*.npz"))
    assert len(dumps) == 1
    return dumps[0]


@pytest.mark.parametrize("bad_at", [1, 3])
def test_nonfinite_loss_dumps_the_jax_file(tmp_path, monkeypatch, bad_at):
    data = _data(20)
    rows = np.arange(100, 120)[::-1].copy()     # the fold's resident rows
    (tmp_path / "jax").mkdir()
    want = _jax_dump(tmp_path / "jax", data, rows, bad_at)
    port_dir = tmp_path / "port"
    port_dir.mkdir()
    monkeypatch.chdir(port_dir)
    step = _Step(bad_at)
    with pytest.raises(FloatingPointError, match="dumped to nonfinite_"):
        fit(step, _eval_step, TrainConfig(data=DataConfig(batch_size=8),
                                          epochs=1),
            data, torch.device("cpu"), train_rows=rows)
    got = glob.glob(str(port_dir / "nonfinite_*.npz"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(want)]
    assert os.path.basename(want) == (
        f"nonfinite_fold0_epoch0_batch{bad_at}.npz")
    g, w = np.load(got[0]), np.load(want)
    assert sorted(g.files) == sorted(w.files) == sorted(
        ["idx", "valid", "x", "label", "tok", "grad_norm"])
    for k in w.files:
        np.testing.assert_array_equal(g[k], w[k])
    # The dump is the batch the step was given: its rows, resolved.
    bad = step.batches[bad_at - 1]
    np.testing.assert_array_equal(g["idx"], bad["idx"].numpy())
    local = {r: i for i, r in enumerate(rows)}
    np.testing.assert_array_equal(
        g["x"], data["x"][[local[r] for r in g["idx"]]])
    assert float(g["grad_norm"]) == 2.0


def test_nonfinite_packed_batch_dumps_as_given(tmp_path, monkeypatch):
    """A packed plan's batch carries its own arrays: dumped as they are."""
    monkeypatch.chdir(tmp_path)
    batch = {"packed_ids": np.arange(12).reshape(3, 4),
             "label": np.array([1, 0, 1]), "valid": np.ones(3, np.float32)}
    plan = types.SimpleNamespace(
        steps_per_epoch=1, epoch_iter=lambda rng: iter([(batch, 3)]))
    with pytest.raises(FloatingPointError):
        fit(_Step(1), _eval_step, TrainConfig(data=DataConfig(batch_size=3),
                                              epochs=1),
            {"label": batch["label"]}, torch.device("cpu"),
            packed_plan=plan)
    z = np.load(tmp_path / "nonfinite_fold0_epoch0_batch1.npz")
    assert sorted(z.files) == sorted(list(batch) + ["grad_norm"])
    for k, v in batch.items():
        np.testing.assert_array_equal(z[k], v)


def test_fit_profile_dir_writes_a_trace_of_dispatches_3_to_5(tmp_path,
                                                           monkeypatch):
    data = _data(80)              # 10 dispatches > the window [3, 6)
    seen = []
    step = _Step()

    def watched(logdir):
        seen.append(step.calls)
        return trace(logdir)

    monkeypatch.setattr(profiling, "trace", watched)
    res = fit(step, _eval_step,
              TrainConfig(data=DataConfig(batch_size=8), epochs=1,
                          profile_dir=str(tmp_path / "trace")),
              data, torch.device("cpu"))
    assert seen == [2]            # started before the third dispatch
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert res.input_pipeline["gets"] == 10
    assert set(res.input_pipeline) == {"gets", "empty_gets", "wait_s"}


def test_trace_context_writes_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "t" / "*.json"))
    assert len(files) == 1
    assert any("mm" in e.key for e in prof.key_averages())


def test_seed_everything_repeats_draws():
    def draws():
        g = seed_everything(123)
        return (random.random(), np.random.rand(3).tolist(),
                torch.rand(3, generator=g).tolist(),
                os.environ["PYTHONHASHSEED"])

    a, b = draws(), draws()
    assert a == b and a[-1] == "123"
    g = seed_everything(124)
    assert torch.rand(3, generator=g).tolist() != a[2]
    assert isinstance(g, torch.Generator)
