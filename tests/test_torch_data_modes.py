"""The port's ``DataConfig`` against the JAX package's, and its two data
modes (``device_resident``) against each other: batches gathered on the
device from resident arrays, or copied from the host, must train and
evaluate alike bit for bit (``fit`` at K = 1 and 3, ``run_eval``, the
packed 2C plan and step, the fold-parallel steps, the drivers with soft
targets).  Also ``strict_images`` in ``prepare_2b``/``prepare_2c`` beside
the JAX drivers, and the 2B ``--pack-rows`` warning beside the JAX
driver's.  The JAX ``fit``, ``run_eval`` and driver comparisons are in
``tests/test_torch_data_modes_jax.py``."""

import dataclasses
import enum
import json
import logging
import os

import numpy as np
import pytest
import torch

import mpmc_tpu.config as jconfig
import mpmc_tpu_torch.config as tconfig
from mpmc_tpu.train.packed import PackedMultimodalPlan as JPlan
from mpmc_tpu_torch.cli.experiments import (_run_folds, prepare_2b,
                                            prepare_2c)
from mpmc_tpu_torch.config import (DataConfig, MeshConfig, ModelConfig,
                                   TrainConfig)
from mpmc_tpu_torch.cv.fold_driver import fit_folds_parallel
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.parallel.fold_parallel import build_fold_parallel_steps
from mpmc_tpu_torch.train.graphs import (make_scan_eval_step,
                                         make_scan_train_step)
from mpmc_tpu_torch.train.loop import DeviceData, fit, run_eval
from mpmc_tpu_torch.train.packed import PackedMultimodalPlan
from mpmc_tpu_torch.train.step import build_train_step, make_eval_step

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread (a pool of threads
    per process waits at its barrier on a loaded machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The config dataclasses
# ---------------------------------------------------------------------------

def _config_classes(mod):
    return sorted(n for n, c in vars(mod).items()
                  if isinstance(c, type) and dataclasses.is_dataclass(c)
                  and c.__module__ == mod.__name__)


def _plain(v):
    """A default as plain data: enums by value, dataclasses field by
    field."""
    if isinstance(v, enum.Enum):
        return v.value
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = _plain(f.default)
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = _plain(f.default_factory())
    return out


def test_config_modules_have_the_same_dataclasses():
    assert _config_classes(jconfig) == _config_classes(tconfig)


@pytest.mark.parametrize("name", _config_classes(jconfig))
def test_config_dataclass_fields_and_defaults_match_jax(name):
    """No field missing or extra in either package, each default equal;
    ``DataConfig`` in JAX's order too."""
    j, t = getattr(jconfig, name), getattr(tconfig, name)
    j_names = [f.name for f in dataclasses.fields(j)]
    t_names = [f.name for f in dataclasses.fields(t)]
    assert sorted(j_names) == sorted(t_names)
    if name == "DataConfig":
        assert j_names == t_names
    assert _defaults(j) == _defaults(t)


# ---------------------------------------------------------------------------
# fit and run_eval: resident against host-fed
# ---------------------------------------------------------------------------

def _ragged(rng, n, S, vocab=512):
    lens = rng.integers(2, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _mm_data(seed, n, mcfg):
    rng = np.random.default_rng(seed)
    t_ids, t_mask = _ragged(rng, n, mcfg.max_text_len)
    c_ids, c_mask = _ragged(rng, n, mcfg.max_caption_len)
    size = mcfg.image.image_size
    return {"text_ids": t_ids, "text_mask": t_mask, "caption_ids": c_ids,
            "caption_mask": c_mask,
            "image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def _tensors(data):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in data.items()}


def _select(data, idx):
    return {k: v[idx] for k, v in data.items()}


def _tsvs(d):
    return {p: open(os.path.join(d, p), "rb").read()
            for p in sorted(os.listdir(d)) if p.endswith(".tsv")}


def _fit_run(tmp_path, k: int, resident: bool):
    """tiny 2C, unpacked, f32, dropout and the random augmentation on: 24
    manifest rows (16 train, 8 val; 4 steps an epoch, 2 epochs, an eval
    at each epoch's end: at K = 3 a group of 3 and a single step) and a
    12-row test split (3 eval batches: one group at K = 3)."""
    mcfg = ModelConfig.tiny_2c()
    cfg = TrainConfig(model=mcfg, data=DataConfig(
        batch_size=4, device_resident=resident), epochs=2, bf16=False,
        learning_rate=1e-3, scan_steps=k, eval_per_epoch=1)
    full, test = _mm_data(1, 24, mcfg), _mm_data(2, 12, mcfg)
    order = np.random.default_rng(0).permutation(24)
    tr_idx, va_idx = np.sort(order[:16]), np.sort(order[16:])
    model = build_model(mcfg, CPU, seed=0)
    store = _tensors(full) if resident else {}
    step = build_train_step(model, cfg, 8, store,
                            torch.Generator().manual_seed(7))
    evals = make_eval_step(model, cfg, cast_in_place=False)
    dev = {}
    if resident:
        dev = dict(dev_test=DeviceData(_tensors(test), np.arange(12)),
                   dev_val=DeviceData(store, va_idx))
    out = tmp_path / f"k{k}_{resident}"
    os.makedirs(out)
    res = fit(step, evals, cfg, _select(full, tr_idx), CPU, test_data=test,
              val_data=_select(full, va_idx),
              test_ids=[f"d/t{i}.jpg" for i in range(12)],
              tsv_prefix=str(out / "task2C_x"),
              train_rows=tr_idx if resident else None,
              scan_train_step=make_scan_train_step(step, k) if k > 1
              else None,
              scan_eval_step=make_scan_eval_step(evals, k, CPU) if k > 1
              else None, **dev)
    return res, model.state_dict(), _tsvs(out)


@pytest.mark.parametrize("k", [1, 3])
def test_fit_host_fed_equals_resident_bit_for_bit(tmp_path, monkeypatch, k):
    """The same shuffles, dropout masks and augmentation draws: every
    step's loss and grad norm, every eval, the TSVs and the weights and
    BatchNorm statistics equal; at K = 3 both modes ran whole groups of
    train steps and of eval batches."""
    from mpmc_tpu_torch.train.graphs import GroupedSteps
    groups = []
    real_call = GroupedSteps.__call__

    def counting(self, group):
        groups.append(sorted(group))
        return real_call(self, group)

    monkeypatch.setattr(GroupedSteps, "__call__", counting)
    (r_res, r_sd, r_tsv), (h_res, h_sd, h_tsv) = (
        _fit_run(tmp_path, k, resident) for resident in (True, False))
    if k > 1:
        host = sorted(_mm_data(2, 1, ModelConfig.tiny_2c()))
        # Per mode: a train group an epoch, a test-eval group an eval.
        assert groups == [["idx", "valid"], ["idx"]] * 2 + [
            sorted(host + ["valid"]), host] * 2
    assert len(r_res.steps) == 8 and len(r_res.history) == 2
    assert r_res.steps == h_res.steps
    assert r_res.history == h_res.history
    assert r_tsv == h_tsv and len(r_tsv) == 2
    for name, v in r_sd.items():
        assert torch.equal(v, h_sd[name]), name


def test_run_eval_resident_equals_host_fed_and_grouped():
    """13 rows at batch 4 (a short last batch): resident ``idx`` batches,
    host-fed batches and resident groups of 2 give the same result."""
    mcfg = ModelConfig.tiny_2c()
    cfg = TrainConfig(model=mcfg, bf16=False)
    data = _mm_data(3, 13, mcfg)
    model = build_model(mcfg, CPU, seed=1)
    evals = make_eval_step(model, cfg, cast_in_place=False)
    rows = np.arange(20, 33)
    store = _tensors({k: np.concatenate([_mm_data(9, 20, mcfg)[k], v])
                      for k, v in data.items()})
    host = run_eval(evals, data, 4, CPU)
    resident = run_eval(evals, data, 4, CPU, dev=DeviceData(store, rows))
    calls = []

    def counted(batch):
        calls.append(sorted(batch))
        return evals(batch)

    grouped = run_eval(counted, data, 4, CPU,
                       scan_eval_step=make_scan_eval_step(counted, 2, CPU),
                       dev=DeviceData(store, rows))
    for res in (resident, grouped):
        np.testing.assert_array_equal(res.probs, host.probs)
        assert (res.loss, res.accuracy, res.macro_f1, res.threshold) == (
            host.loss, host.accuracy, host.macro_f1, host.threshold)
    assert len(calls) == 4 and all(c == sorted(data) for c in calls)
    with pytest.raises(ValueError, match="rows"):
        run_eval(evals, data, 4, CPU, dev=DeviceData(store, rows[:5]))


# ---------------------------------------------------------------------------
# The packed 2C plan and step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resident", [False, True],
                         ids=["host-fed", "resident"])
def test_packed_plan_arrays_equal_jax(resident):
    """Two epochs of the port's ``PackedMultimodalPlan`` and the JAX
    plan's: the same keys and arrays (host-fed: the pixels; resident:
    ``img_idx`` into the store) and row budgets."""
    data = _mm_data(4, 23, ModelConfig.tiny_2c())
    abs_idx = np.arange(100, 123) if resident else None
    plan = PackedMultimodalPlan(data, 6, abs_idx=abs_idx,
                                resident_images=resident)
    jplan = JPlan(data, 6, abs_idx=abs_idx, resident_images=resident)
    for epoch in range(2):
        pairs = list(zip(plan.epoch_iter(np.random.default_rng(epoch)),
                         jplan.epoch_iter(np.random.default_rng(epoch))))
        assert len(pairs) == 4
        for (b, k), (jb, jk) in pairs:
            assert k == jk and set(b) == set(jb)
            assert ("image" in b) == (not resident) == ("img_idx" not in b)
            for key in b:
                np.testing.assert_array_equal(b[key], jb[key])
    assert plan.row_budgets == (jplan._budget_t, jplan._budget_c)


def test_packed_step_host_fed_equals_resident():
    """Three packed 2C steps with dropout and the random augmentation: the
    host-fed batches (pixels, empty store) against the resident ones
    (``img_idx`` into the store): losses, grad norms, weights equal."""
    mcfg = ModelConfig.tiny_2c()
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=6,
                                                  pack_rows=8),
                      bf16=False, learning_rate=1e-3)
    full = _mm_data(5, 30, mcfg)
    tr_idx = np.arange(3, 27)
    train_d = _select(full, tr_idx)
    out = []
    for resident in (True, False):
        plan = PackedMultimodalPlan(train_d, 6,
                                    abs_idx=tr_idx if resident else None,
                                    resident_images=resident)
        model = build_model(mcfg, CPU, seed=0, packed=True)
        step = build_train_step(model, cfg, 4, _tensors(full) if resident
                                else {}, torch.Generator().manual_seed(3))
        metrics = [step(_tensors(b)) for b, _ in
                   list(plan.epoch_iter(np.random.default_rng(1)))[:3]]
        out.append((metrics, model.state_dict()))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a["loss"], b["loss"])
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for name, v in out[0][1].items():
        assert torch.equal(v, out[1][1][name]), name


# ---------------------------------------------------------------------------
# Fold-parallel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2])
def test_fold_parallel_host_fed_equals_resident(tmp_path, k):
    """tiny 2C, 2 folds at once, dropout and augmentation on: each fold's
    best probabilities, steps and evals, the TSVs and the stacked state
    equal in both modes (the same wrap-around rows)."""
    mcfg = ModelConfig.tiny_2c()
    full, test = _mm_data(6, 22, mcfg), _mm_data(7, 6, mcfg)
    test_ids = [f"d/t{i}.jpg" for i in range(6)]
    out = []
    for resident in (True, False):
        cfg = TrainConfig(model=mcfg, data=DataConfig(
            batch_size=4, num_folds=2, device_resident=resident),
            mesh=MeshConfig(fold_parallel=True), epochs=1, bf16=False,
            learning_rate=1e-3, scan_steps=k)
        models = [build_model(mcfg, CPU, seed=f) for f in range(2)]
        store = _tensors(full) if resident else {}
        eval_store = _tensors(test) if resident else {}
        train, evals = build_fold_parallel_steps(
            models, cfg, 6, store, eval_store, torch.Generator().manual_seed(2))
        d = tmp_path / f"{resident}"
        os.makedirs(d)
        res = fit_folds_parallel(
            cfg, train, evals, full, test, test_ids, CPU,
            tsv_prefix=str(d / "task2C_x"),
            scan_train_step=make_scan_train_step(train, k) if k > 1
            else None)
        out.append((res, train.state_dict(), _tsvs(d)))
    (ra, sa, ta), (rb, sb, tb) = out
    for a, b in zip(ra, rb):
        np.testing.assert_array_equal(a["probs"], b["probs"])
        assert a["steps"] == b["steps"] and a["history"] == b["history"]
        assert len(a["steps"]) == 3
    assert ta == tb and len(ta) == 3
    for name, v in sa["model"].items():
        assert torch.equal(v, sb["model"][name]), name


# ---------------------------------------------------------------------------
# The drivers with soft targets, packed and unpacked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack_rows", [0, 8], ids=["unpacked", "packed"])
def test_run_folds_host_fed_equals_resident_with_soft_targets(tmp_path,
                                                              pack_rows):
    """``_run_folds`` (2C, fold 0 of 2, distillation on): resident, the
    soft targets index the store (unpacked) or ride the plan's batches
    (packed); host-fed, they ride every batch.  The TSVs, the per-step
    metrics and the best weights equal."""
    mcfg = ModelConfig.tiny_2c()
    full, test = _mm_data(8, 20, mcfg), _mm_data(9, 6, mcfg)
    soft = np.random.default_rng(3).random((2, 20)).astype(np.float32)
    got = []
    for resident in (True, False):
        d = tmp_path / f"{resident}"
        cfg = TrainConfig(model=mcfg, data=DataConfig(
            batch_size=4, num_folds=2, pack_rows=pack_rows,
            device_resident=resident), epochs=1, bf16=False,
            learning_rate=1e-3, distill_lambda=0.5,
            checkpoint_dir=str(d / "ck"))
        _run_folds(cfg, full, [f"d/x{i}.jpg" for i in range(20)], test,
                   [f"d/t{i}.jpg" for i in range(6)], str(d / "out"),
                   "task2C", CPU, folds=[0], soft_targets=soft)
        metrics = json.loads((d / "out" / "task2C_train_metrics_fold_0.json"
                              ).read_text())
        got.append((_tsvs(d / "out"), metrics, torch.load(
            d / "ck" / "fold_0" / "model.pt", weights_only=True)))
    (ta, ma, wa), (tb, mb, wb) = got
    assert ta == tb and ma == mb and len(ma["steps"]) == 3
    assert "_distill" in next(iter(ta.values())).decode().splitlines()[1]
    for name, v in wa.items():
        assert torch.equal(v, wb[name]), name


# ---------------------------------------------------------------------------
# strict_images and the 2B --pack-rows warning
# ---------------------------------------------------------------------------

def _manifests(tmp_path, with_images: int):
    """train.json (6 memes) and dev.json (3); the first ``with_images``
    train memes have a PNG under ``tmp_path``, the rest none."""
    from PIL import Image
    rng = np.random.default_rng(0)
    os.makedirs(tmp_path / "d", exist_ok=True)
    paths = {}
    for name, n, off in (("train.json", 6, 0), ("dev.json", 3, 100)):
        rows = []
        for i in range(n):
            img = f"d/m{off + i}.png"
            if off + i < with_images or off:
                Image.fromarray(rng.integers(0, 256, (40, 40, 3),
                                             dtype=np.uint8)).save(
                    tmp_path / img)
            rows.append({"id": img, "img_path": img,
                         "text": "بتث جحخ سشص" if i % 2 else "ضطظ عغف",
                         "class_label": ("propaganda" if i % 2
                                         else "not_propaganda")})
        paths[name] = str(tmp_path / name)
        with open(paths[name], "w", encoding="utf-8") as f:
            json.dump(rows, f, ensure_ascii=False)
    return paths


def _image_cfgs(paths, root, strict, cls_model, cls_data, cls_train,
                **data_kw):
    mcfg = dataclasses.replace(cls_model.tiny_2c(), image=dataclasses.replace(
        cls_model.tiny_2c().image, image_size=32))
    return cls_train(model=mcfg, data=cls_data(
        train_manifest=paths["train.json"], dev_manifest=paths["dev.json"],
        image_root=str(root), strict_images=strict,
        cache_dir=str(root / "cache"), **data_kw), epochs=1, bf16=False)


@pytest.mark.parametrize("subtask", ["2b", "2c"])
def test_strict_images_raises_as_jax(tmp_path, monkeypatch, caplog,
                                     subtask):
    """One train image missing: with ``strict_images`` the port's
    ``prepare_2b``/``prepare_2c`` and the JAX ``run_subtask_2b``/
    ``run_subtask_2c`` raise ``FileNotFoundError`` naming it; without, the
    port logs the missing count and prepares the data."""
    from mpmc_tpu.cli import experiments as jexp
    monkeypatch.chdir(tmp_path)
    paths = _manifests(tmp_path, with_images=5)
    prepare = (prepare_2b if subtask == "2b"
               else lambda c: prepare_2c(c, str(tmp_path / "out")))
    run_jax = getattr(jexp, f"run_subtask_{subtask}")
    cfg = _image_cfgs(paths, tmp_path, True, ModelConfig, DataConfig,
                      TrainConfig)
    jcfg = _image_cfgs(paths, tmp_path, True, jconfig.ModelConfig,
                       jconfig.DataConfig, jconfig.TrainConfig)
    with pytest.raises(FileNotFoundError, match="1/6 images") as got:
        prepare(cfg)
    with pytest.raises(FileNotFoundError, match="1/6 images") as want:
        run_jax(jcfg, out_dir=str(tmp_path / "jout"))
    assert str(got.value) == str(want.value)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        prep = prepare(dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, strict_images=False)))
    assert prep.data["image"].shape == (6, 32, 32, 3)
    assert [r.getMessage() for r in caplog.records
            if "missing" in r.getMessage()] == [str(got.value)]


class _Stop(Exception):
    pass


def test_2b_pack_rows_warns_as_jax(tmp_path, monkeypatch, caplog):
    """``pack_rows`` 8 for 2B: the port's ``prepare_2b`` logs the JAX
    driver's warning, word for word, and trains unpacked."""
    from mpmc_tpu.cli import experiments as jexp
    monkeypatch.chdir(tmp_path)
    paths = _manifests(tmp_path, with_images=6)
    kw = dict(pack_rows=8, num_folds=2)
    cfg = _image_cfgs(paths, tmp_path, False, ModelConfig, DataConfig,
                      TrainConfig, **kw)
    jcfg = _image_cfgs(paths, tmp_path, False, jconfig.ModelConfig,
                       jconfig.DataConfig, jconfig.TrainConfig, **kw)

    def stop(*args, **kwargs):
        raise _Stop

    # The JAX driver warns before its first fold; stop it there.
    monkeypatch.setattr(jexp, "_init_and_steps", stop)
    with caplog.at_level(logging.WARNING):
        with pytest.raises(_Stop):
            jexp.run_subtask_2b(jcfg, out_dir=str(tmp_path / "jout"))
        want = [r.getMessage() for r in caplog.records
                if "--pack-rows" in r.getMessage()]
        caplog.clear()
        prep = prepare_2b(cfg)
        got = [r.getMessage() for r in caplog.records
               if "--pack-rows" in r.getMessage()]
    assert len(want) == 1 and got == want
    assert "image driver" in got[0] and "UNPACKED" in got[0]
    assert prep.cfg.data.pack_rows == 0


class _NanStep:
    """A stand-in train step: a loss of 0.5, NaN on call ``bad_at``."""

    def __init__(self, bad_at):
        import types
        self.optimizer = types.SimpleNamespace(count=0, device=CPU)
        self.generator = torch.Generator()
        self.bad_at, self.batches = bad_at, []

    def __call__(self, batch):
        self.batches.append({k: v.clone() for k, v in batch.items()})
        bad = len(self.batches) == self.bad_at
        return {"loss": torch.tensor(float("nan") if bad else 0.5),
                "grad_norm": torch.tensor(2.0 if bad else 1.0)}


def test_host_fed_failure_dump_holds_the_rows(tmp_path, monkeypatch):
    """Host-fed, 12 steps of 4 rows in groups of 4, NaN on step 6: the
    dump holds that step's rows themselves (no ``idx``), its ``valid``
    and grad norm, and names batch 6."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    data = {"x": rng.standard_normal(48).astype(np.float32),
            "label": rng.integers(0, 2, 48).astype(np.int32)}
    step = _NanStep(bad_at=6)
    cfg = TrainConfig(data=DataConfig(batch_size=4, device_resident=False),
                      epochs=1, scan_steps=4)
    with pytest.raises(FloatingPointError, match="batch 6 "):
        fit(step, lambda b: (b["x"], b["x"]), cfg, data, CPU,
            scan_train_step=make_scan_train_step(step, 4))
    z = np.load("nonfinite_fold0_epoch0_batch6.npz")
    bad = step.batches[5]
    assert sorted(z.files) == ["grad_norm", "label", "valid", "x"]
    for key in ("x", "label", "valid"):
        np.testing.assert_array_equal(z[key], bad[key].numpy())
    assert set(z["x"]) <= set(data["x"]) and float(z["grad_norm"]) == 2.0
