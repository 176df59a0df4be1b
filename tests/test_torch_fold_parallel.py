"""Fold-parallel training in the port (``--fold-parallel``, one device):
``stack_states``/``unstack_state``, the attention op's ``vmap`` rule, a
training BatchNorm under ``vmap``, the per-fold optimizer against F
separate ones, one fold-parallel step against F single-fold steps, and
``fit_folds_parallel`` against the JAX package's on the same replicas
(shared test split and 2A per-fold held-out eval)."""

import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call, vmap

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import MeshConfig as JMeshConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.cv.fold_driver import fit_folds_parallel as j_fit_folds
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.classifier import TextClassifier as JText
from mpmc_tpu.parallel.mesh import make_mesh
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_eval_step as j_make_eval_step,
                                 make_optimizer)
from mpmc_tpu_torch.config import (DataConfig, LossType, MeshConfig,
                                   ModelConfig, PoolingType, TrainConfig)
from mpmc_tpu_torch.cv.fold_driver import fit_folds_parallel
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import (from_jax_variables,
                                           stack_jax_variables,
                                           unstack_to_jax_variables)
from mpmc_tpu_torch.models.norm import BatchNorm
from mpmc_tpu_torch.ops.attention import dot_product_attention
from mpmc_tpu_torch.parallel.fold_parallel import (build_fold_parallel_steps,
                                                   stack_states,
                                                   unstack_state)
from mpmc_tpu_torch.train.graphs import make_scan_train_step
from mpmc_tpu_torch.train.step import Optimizer, build_train_step

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread.  On a loaded machine
    (the suite's parallel workers) a pool of threads per process turns each
    small op into a wait at the pool's barrier, many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _ragged(rng, n, S, vocab=512):
    lens = rng.integers(2, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


# ---------------------------------------------------------------------------
# State stacking, the attention rule, BatchNorm, the optimizer
# ---------------------------------------------------------------------------

def _text_cfgs():
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    out = []
    for cls, pool in ((ModelConfig, PoolingType), (JModelConfig,
                                                   JPoolingType)):
        m = cls.tiny_2c()
        out.append(dataclasses.replace(
            m, pooling=pool("attention"), num_classes=2, dropout=0.0,
            text=dataclasses.replace(m.text, **enc)))
    return out


def test_stack_and_unstack_states_round_trip():
    """Three single-fold train states after one step each (weights,
    Adam's moments, count): stacked, then each fold's picked back out
    equal to its own; the generator is fold 0's; counts must agree."""
    mcfg, _ = _text_cfgs()
    rng = np.random.default_rng(0)
    ids, mask = _ragged(rng, 12, 16)
    data = {"text_ids": ids, "text_mask": mask,
            "label": rng.integers(0, 2, 12).astype(np.int32)}
    store = {k: torch.from_numpy(v) for k, v in data.items()}
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=4), bf16=False,
                      loss=LossType.CROSS_ENTROPY)
    states = []
    for k in range(3):
        step = build_train_step(build_model(mcfg, CPU, seed=k, kind="text"),
                                cfg, 4, store,
                                torch.Generator().manual_seed(k))
        step({"idx": torch.arange(4 * k, 4 * k + 4),
              "valid": torch.ones(4)})
        states.append(step.state_dict())
    stacked = stack_states(states)
    assert torch.equal(stacked["generator"], states[0]["generator"])
    for k, st in enumerate(states):
        back = unstack_state(stacked, k)
        for name, v in st["model"].items():
            assert torch.equal(back["model"][name], v), name
        assert back["optimizer"]["count"] == 1
        for name, slots in st["optimizer"]["state"].items():
            for s, v in slots.items():
                assert torch.equal(back["optimizer"]["state"][name][s], v)
    states[2]["optimizer"]["count"] = 5
    with pytest.raises(ValueError, match="disagree"):
        stack_states(states)


@pytest.mark.parametrize("mode", ["padding", "segments", "none"])
def test_attention_vmap_rule_equals_a_loop_over_folds(mode):
    """``vmap`` over a fold axis folds it into the batch (one call of the
    plain version here, one launch on the card): output and the gradients
    of q, k, v equal a loop of per-fold calls; an unbatched mask is
    repeated for every fold."""
    F, B, S, H, D = 3, 2, 7, 2, 8
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(F, B, S, H, D, generator=g, requires_grad=True)
               for _ in range(3))
    if mode == "padding":
        mask = (torch.rand(F, B, S, generator=g) > 0.3).float()
        mask[:, :, 0] = 1
        call = lambda q_, k_, v_, m_: dot_product_attention(  # noqa: E731
            q_, k_, v_, m_)
    elif mode == "segments":
        mask = torch.tensor([[1, 1, 2, 2, 2, 0, 0], [1, 1, 1, 1, 2, 2, 3]]
                            ).expand(F, B, S).contiguous()
        call = lambda q_, k_, v_, m_: dot_product_attention(  # noqa: E731
            q_, k_, v_, segments=m_)
    else:
        mask = None
        call = lambda q_, k_, v_, m_: dot_product_attention(  # noqa: E731
            q_, k_, v_)
    dims = (0, 0, 0, None if mask is None else 0)
    out = vmap(call, in_dims=dims)(q, k, v, mask)
    ref = torch.stack([call(q[f], k[f], v[f],
                            None if mask is None else mask[f])
                       for f in range(F)])
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    do = torch.randn(out.shape, generator=g)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    if mask is not None:
        shared = vmap(call, in_dims=(0, 0, 0, None))(q, k, v, mask[0])
        torch.testing.assert_close(shared, torch.stack(
            [call(q[f], k[f], v[f], mask[0]) for f in range(F)]),
            atol=1e-6, rtol=1e-6)


def test_training_batchnorm_under_vmap_keeps_per_fold_statistics():
    """Each fold normalizes by its own batch statistics and updates its
    own slice of the stacked running statistics, as F separate modules."""
    F, C = 3, 5
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((F, 6, C)).astype(np.float32)
                         * 2 + 1)
    mods = [BatchNorm(C) for _ in range(F)]
    for f, m in enumerate(mods):
        m.weight.data.uniform_(0.5, 1.5, generator=torch.Generator()
                               .manual_seed(f))
        m.running_mean.fill_(0.1 * f)
    params = {n: torch.stack([dict(m.named_parameters())[n] for m in mods]
                             ).detach() for n in ("weight", "bias")}
    bufs = {n: torch.stack([dict(m.named_buffers())[n] for m in mods])
            for n in ("running_mean", "running_var")}
    skel = BatchNorm(C).train()
    out = vmap(lambda p, b, x_: functional_call(skel, {**p, **b}, (x_,)))(
        params, bufs, x)
    for f, m in enumerate(mods):
        m.train()
        torch.testing.assert_close(out[f], m(x[f]), atol=0, rtol=0)
        for n in ("running_mean", "running_var"):
            torch.testing.assert_close(bufs[n][f], getattr(m, n), atol=0,
                                       rtol=0)


@pytest.mark.parametrize("mode", ["adam", "factored", "sparse"])
def test_per_fold_optimizer_equals_separate_optimizers(mode):
    """One optimizer over stacked ``[F, ...]`` parameters against F
    optimizers over each fold's: the global norm, the clip (above the
    clip on some folds only), factored dims of the per-fold shape (a
    stacked bias ``[F, 256]`` stays unfactored), the sparse rows per fold;
    parameters and slots equal after 4 steps."""
    F = 3
    rng = np.random.default_rng(3)
    shapes = {"text_model.word_embeddings.weight": (130, 140),
              "caption_text_model.word_embeddings.weight": (40, 8),
              "text_model.dense.weight": (6, 5), "output.bias": (256,)}
    init = {n: rng.standard_normal((F,) + s).astype(np.float32)
            for n, s in shapes.items()}
    cfg = TrainConfig(learning_rate=1e-2, lr_schedule="linear_warmup",
                      embedding_optimizer=mode,
                      adam_mu_dtype="bfloat16" if mode == "factored"
                      else None)
    stacked = {n: torch.from_numpy(v.copy()) for n, v in init.items()}
    single = [{n: torch.from_numpy(v[f].copy()) for n, v in init.items()}
              for f in range(F)]
    opt = Optimizer(cfg, 4, stacked, embed_support=16, folds=F)
    opts = [Optimizer(cfg, 4, p, embed_support=16) for p in single]
    if mode == "factored":
        assert set(opt.state["output.bias"]) == {"mu", "nu"}
        assert set(opt.state["text_model.word_embeddings.weight"]) == {
            "v_row", "v_col"}
    for step in range(4):
        grads = {}
        for n, s in shapes.items():
            g = rng.standard_normal((F,) + s).astype(np.float32)
            g *= np.array([0.5, 0.001, 0.01])[:, None] if len(s) == 1 \
                else np.array([0.5, 0.001, 0.01])[:, None, None]
            if "word_embeddings" in n:
                g[rng.random((F, s[0])) < 0.7] = 0
            grads[n] = torch.from_numpy(g)
        norm = Optimizer.global_norm(list(grads.values()), F)
        opt.step(grads, norm)
        for f in range(F):
            gf = {n: g[f].clone() for n, g in grads.items()}
            want = Optimizer.global_norm(list(gf.values()))
            assert torch.equal(norm[f], want)
            opts[f].step(gf, want)
    assert (norm > 1).tolist() == [True, False, False]
    for f in range(F):
        for n in shapes:
            assert torch.equal(stacked[n][f], single[f][n]), (f, n)
            for k, v in opts[f].state[n].items():
                if k != "mu_f32":
                    assert torch.equal(opt.state[n][k][f], v), (f, n, k)


def _zero_dropout_2c(mcfg):
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        mcfg, dropout=0.0, text=dataclasses.replace(mcfg.text, **enc),
        caption=dataclasses.replace(mcfg.caption, **enc),
        image=dataclasses.replace(mcfg.image, finetune_dropout=0.0))


def test_fold_parallel_steps_equal_single_fold_steps():
    """tiny 2C (image through the augmentation, BatchNorm, both text
    encoders), f32, dropout 0: two fold-parallel steps over 3 replicas
    against two steps of each replica alone on the same rows and
    augmentation draws (flips and rotations; gain 1, below): losses, grad
    norms, weights and batch statistics; then one eval batch, each fold
    on its own rows, against each replica's eval step on that fold's
    weights."""
    F, B = 3, 4
    mcfg = _zero_dropout_2c(ModelConfig.tiny_2c())
    rng = np.random.default_rng(4)
    n = 24
    t_ids, t_mask = _ragged(rng, n, mcfg.max_text_len)
    c_ids, c_mask = _ragged(rng, n, mcfg.max_caption_len)
    size = mcfg.image.image_size
    data = {"text_ids": t_ids, "text_mask": t_mask, "caption_ids": c_ids,
            "caption_mask": c_mask,
            "image": rng.integers(0, 256, (n, size, size, 3), np.uint8),
            "label": rng.integers(0, 2, n).astype(np.int32)}
    store = {k: torch.from_numpy(v) for k, v in data.items()}
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B), bf16=False,
                      learning_rate=1e-3, embedding_optimizer="factored",
                      adam_mu_dtype="bfloat16")
    # Brightness gain 1: a gain above 1 clips pixels to exactly 1.0, and
    # the max-pool after the stem then has ties among equal values, whose
    # gradient vmap's batched pooling may route to another (equally valid)
    # position than the single-fold pooling.
    draws = [torch.from_numpy(x) for x in (
        rng.random(F * B) < 0.5, np.ones(F * B, np.float32),
        (rng.uniform(-15, 15, F * B) * math.pi / 180).astype(np.float32))]
    models = [build_model(mcfg, CPU, seed=10 + f) for f in range(F)]
    singles = [build_model(mcfg, CPU) for _ in range(F)]
    for m, s in zip(models, singles):
        s.load_state_dict(m.state_dict())
    train, evals = build_fold_parallel_steps(
        models, cfg, 4, store, store, torch.Generator(),
        augment=lambda u8, gen: augment_with_draws(u8, *draws))
    steps = [build_train_step(
        s, cfg, 4, store, torch.Generator(),
        augment=lambda u8, gen, f=f: augment_with_draws(
            u8, *(d[f * B:(f + 1) * B] for d in draws)))
        for f, s in enumerate(singles)]
    idx = [torch.from_numpy(rng.permutation(n)[:F * B].reshape(F, B))
           for _ in range(2)]
    for i in idx:
        m = train({"idx": i, "valid": torch.ones(F, B)})
        for f, step in enumerate(steps):
            ms = step({"idx": i[f], "valid": torch.ones(B)})
            torch.testing.assert_close(m["loss"][f], ms["loss"], atol=1e-6,
                                       rtol=1e-6)
            # Batched convolutions and products (vmap's rules) sum in
            # other orders than the single-fold ones.
            torch.testing.assert_close(m["grad_norm"][f], ms["grad_norm"],
                                       atol=0, rtol=1e-4)
    # Adam scales every gradient entry, rounding noise too, to a step of
    # about lr: an entry whose gradient is at the noise floor may move
    # another way (at most 2 x 3.17 lr a step).  Every entry is held to
    # that bound, all but 1 % of them to 1e-5.
    bound = 2 * 3.17 * cfg.learning_rate * len(idx)
    off = count = 0
    for f, s in enumerate(singles):
        got = train.model.fold_state(f)
        for name, w in s.state_dict().items():
            d = (got[name] - w).abs()
            assert d.max() <= bound, (name, float(d.max()))
            off += int((d > 1e-5).sum())
            count += d.numel()
    assert off <= 0.01 * count, (off, count)
    probs, _ = evals({"idx": idx[0]})
    from mpmc_tpu_torch.train.step import make_eval_step
    for f, s in enumerate(singles):
        s.load_state_dict(train.model.fold_state(f))     # the same weights
        p, _ = make_eval_step(s, cfg, cast_in_place=False)(
            {k: v[idx[0][f]] for k, v in store.items()})
        torch.testing.assert_close(probs[f], p, atol=1e-6, rtol=1e-5)


def test_stacked_weight_bridge_round_trip():
    mcfg, jmcfg = _text_cfgs()
    rng = np.random.default_rng(5)
    ids, mask = _ragged(rng, 2, 16)
    trees = [(_np(JText(jmcfg).init(jax.random.key(k), ids, mask)["params"]),
              None) for k in range(3)]
    stacked = stack_jax_variables(trees)
    back = unstack_to_jax_variables(build_model(mcfg, CPU, kind="text"),
                                    stacked)
    for (want, _), (got, _) in zip(trees, back):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    for k, (p, _) in enumerate(trees):
        for name, v in from_jax_variables(p).items():
            assert torch.equal(stacked[name][k], v)


# ---------------------------------------------------------------------------
# The driver against the JAX package's
# ---------------------------------------------------------------------------

def _leaky_data(rng, n, vocab):
    y = (rng.random(n) > 0.5).astype(np.int32)
    ids = rng.integers(5, vocab, (n, 16)).astype(np.int32)
    ids[:, 0] = y * 3 + 1              # the label leaks into the first token
    return {"text_ids": ids, "text_mask": np.ones_like(ids), "label": y}


@pytest.mark.parametrize("per_fold", [False, True],
                         ids=["shared-test", "2a-held-out"])
def test_fit_folds_parallel_matches_jax(tmp_path, per_fold):
    """Text model, 3 folds, batch 8, dropout 0, f32, the JAX replicas'
    weights bridged: the same TSV files, ids and labels; each fold's best
    probabilities within 1e-4 of the JAX driver's (f32 sums in other
    orders, a few Adam steps apart); the port at K = 2 equal to K = 1."""
    mcfg, jmcfg = _text_cfgs()
    rng = np.random.default_rng(6)
    n = 56
    data = _leaky_data(rng, n, mcfg.text.vocab_size)
    test = _leaky_data(rng, 20, mcfg.text.vocab_size)
    ids = [f"d/i_{i}.jpg" for i in range(n)]
    test_ids = [f"d/t_{i}.jpg" for i in range(20)]
    extra = dict(emit_threshold=0.5, emit_val_tsv=True) if per_fold else {}
    kw = dict(epochs=1, learning_rate=1e-4, lr_schedule="constant",
              bf16=False, **extra)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=8,
                                                      num_folds=3),
                        mesh=JMeshConfig(fold_parallel=True),
                        loss=JLossType.CROSS_ENTROPY, **kw)
    model = JText(jmcfg)
    apply_fn = make_apply_fn(model, "text")
    total = ((n + 7) // 8) * kw["epochs"]
    tx = make_optimizer(jcfg, total)
    variables = [model.init(jax.random.key(k), data["text_ids"][:2],
                            data["text_mask"][:2]) for k in range(3)]
    eval_raw = j_make_eval_step(apply_fn, jcfg)
    jprefix = str(tmp_path / "jax" / "task2X_kevinmathew")
    os.makedirs(tmp_path / "jax")
    jres = j_fit_folds(jcfg, lambda k: create_train_state(variables[k],
                                                          tx)[0],
                       build_train_step_fn(apply_fn, jcfg, tx),
                       lambda s, b: eval_raw(s, b), data,
                       None if per_fold else test,
                       None if per_fold else test_ids, make_mesh(jcfg.mesh),
                       tsv_prefix=jprefix, run_id="kevinmathew_mpmc_tpu",
                       ids=ids)

    results = []
    for k_scan in (1, 2):
        cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=8,
                                                      num_folds=3),
                          mesh=MeshConfig(fold_parallel=True),
                          loss=LossType.CROSS_ENTROPY, scan_steps=k_scan,
                          **kw)
        models = []
        for v in variables:
            m = build_model(mcfg, CPU, kind="text")
            m.load_state_dict(from_jax_variables(_np(v["params"])))
            models.append(m)
        store = {k: torch.from_numpy(v) for k, v in data.items()}
        eval_store = store if per_fold else {
            k: torch.from_numpy(v) for k, v in test.items()}
        train, evals = build_fold_parallel_steps(models, cfg, total, store,
                                                 eval_store,
                                                 torch.Generator())
        out = tmp_path / f"port{k_scan}"
        os.makedirs(out)
        results.append(fit_folds_parallel(
            cfg, train, evals, data, None if per_fold else test,
            None if per_fold else test_ids, CPU,
            tsv_prefix=str(out / "task2X_kevinmathew"),
            run_id="kevinmathew_mpmc_tpu", ids=ids,
            scan_train_step=(make_scan_train_step(train, k_scan)
                             if k_scan > 1 else None)))
    for a, b in zip(*results):
        np.testing.assert_array_equal(a["probs"], b["probs"])
        assert a["steps"] == b["steps"] and a["history"] == b["history"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port1")) == sorted(
        os.listdir(tmp_path / "port2"))
    assert len([x for x in names if "_probs_fold_" in x]) == 3
    for got, want in zip(results[0], jres):
        np.testing.assert_allclose(got["probs"], np.asarray(want["probs"]),
                                   atol=1e-4, rtol=0)
    for name in names:
        rows = [open(tmp_path / d / name).read().splitlines()
                for d in ("jax", "port1")]
        assert [r.split("\t")[0] for r in rows[0]] == [
            r.split("\t")[0] for r in rows[1]], name
        if "_probs_" not in name and "_val_" not in name:
            assert rows[0] == rows[1], name


def _meme_rows(n, off, seed):
    rng = np.random.default_rng(seed)
    letters = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
    return [{"id": f"d/x{off + k}.jpg", "img_path": f"d/x{off + k}.jpg",
             "text": ("بتث جحخ " if k % 2 else "سشص ضطظ ") + " ".join(
                 "".join(rng.choice(letters, 3)) for _ in range(4)),
             "class_label": "propaganda" if k % 2 else "not_propaganda"}
            for k in range(n)]


def test_train_fold_parallel_cli_checkpoints_and_predict(tmp_path,
                                                         monkeypatch):
    """``train --subtask 2c --fold-parallel --scan-steps 2`` on the CPU: a
    probability TSV and a ``fold_k/model.pt`` per fold, each holding only
    its fold's weights (no view of the stacked storage) at the single
    model's shapes; ``predict
    --checkpoint DIR/fold_1`` reproduces fold 1's best eval."""
    import json
    from mpmc_tpu_torch.cli.main import main
    monkeypatch.chdir(tmp_path)
    for name, n, off in (("tr.json", 36, 0), ("dv.json", 8, 100)):
        (tmp_path / name).write_text(json.dumps(
            _meme_rows(n, off, off), ensure_ascii=False), encoding="utf-8")
    out, ck = tmp_path / "out", tmp_path / "ck"
    assert main(["train", "--subtask", "2c", "--tiny", "--epochs", "1",
                 "--num-folds", "3", "--batch-size", "4", "--lr", "1e-3",
                 "-tr", "tr.json", "-te", "dv.json", "-o", str(out),
                 "--checkpoint-dir", str(ck), "--cache-dir", "cache",
                 "--fold-parallel", "--scan-steps", "2",
                 "--device", "cpu"]) == 0
    single = build_model(ModelConfig.tiny_2c(), CPU).state_dict()
    for k in range(3):
        assert (out / f"task2C_kevinmathew_probs_fold_{k}.tsv").exists()
        sd = torch.load(ck / f"fold_{k}" / "model.pt", weights_only=True)
        assert set(sd) == set(single)
        for name, v in sd.items():
            if "word_embeddings" not in name:      # vocab-sized rows
                assert v.shape == single[name].shape, name
            # Its own storage, not a view of every fold's stacked weights.
            assert v.untyped_storage().nbytes() == (v.numel()
                                                    * v.element_size()), name
    assert main(["predict", "--subtask", "2c", "--manifest", "dv.json",
                 "--checkpoint", str(ck / "fold_1"), "--out", "p.tsv",
                 "--probs-out", "pp.tsv", "--batch-size", "4",
                 "--device", "cpu"]) == 0
    rows = lambda p: [r.split("\t") for r in  # noqa: E731
                      p.read_text().splitlines()[1:]]
    got = rows(tmp_path / "pp.tsv")
    want = rows(out / "task2C_kevinmathew_probs_fold_1.tsv")
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([float(r[2]) for r in got],
                               [float(r[2]) for r in want], atol=1e-6)
