"""The port's 2C training path (mpmc_tpu_torch) against the JAX package at
tiny sizes: training-mode BatchNorm, the folds, the packing plan, the
packed classifier, the optimizer, three train steps, and ``train`` end to
end on the CPU.  Inputs, weights and draws come from numpy seeds; the
parity checks run in f32 with dropout 0."""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.cv.kfold import stratified_kfold as j_kfold
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.classifier import \
    PackedMultimodalClassifier as JPackedClassifier
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.ops.packing import pack_sequences as j_pack
from mpmc_tpu.train.packed import PackedMultimodalPlan as JPlan
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.packed import make_packed_multimodal_apply_fn
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (DataConfig, ModelConfig, TrainConfig,
                                   model_config_from_dict)
from mpmc_tpu_torch.config import model_config_to_dict
from mpmc_tpu_torch.cv.kfold import stratified_kfold
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.models.norm import BatchNorm, Dropout
from mpmc_tpu_torch.ops.packing import pack_sequences
from mpmc_tpu_torch.train.loop import batch_iter
from mpmc_tpu_torch.train.packed import (PackedMultimodalPlan,
                                         packed_model_inputs)
from mpmc_tpu_torch.train.step import (Optimizer, build_train_step,
                                       make_eval_step)

# f32 on both sides; layers summed in different orders by XLA and PyTorch.
TOL = 1e-5


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


# ---------------------------------------------------------------------------
# Training-mode BatchNorm and dropout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 5), (3, 4, 5, 3)],
                         ids=["features", "nhwc"])
def test_training_batchnorm_matches_flax(shape):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
    F = shape[-1]
    params = {"scale": rng.uniform(0.5, 1.5, F).astype(np.float32),
              "bias": rng.normal(0, 0.5, F).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, F).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, F).astype(np.float32)}
    y, upd = fnn.BatchNorm(use_running_average=False).apply(
        {"params": params, "batch_stats": stats}, x,
        mutable=["batch_stats"])
    bn = BatchNorm(F)
    sd = from_jax_variables({"bn": params}, {"bn": stats})
    bn.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    tx = torch.from_numpy(x)
    if len(shape) == 4:
        tx = tx.permute(0, 3, 1, 2)                # NHWC -> NCHW view
    got = bn.train()(tx)
    if len(shape) == 4:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6, rtol=0)
    # Eval reads the updated running statistics.
    y_eval = fnn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": upd["batch_stats"]}, x)
    got_eval = bn.eval()(tx)
    if len(shape) == 4:
        got_eval = got_eval.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got_eval.detach().numpy(), np.asarray(y_eval),
                               atol=TOL, rtol=0)


def test_dropout_keeps_and_scales_like_flax():
    x = torch.ones(200_000)
    drop = Dropout(0.3)
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop.eval()(x), x)
    y = drop.train()(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)                # the generator decides
    assert torch.equal(Dropout(0.0).train()(x), x)


# ---------------------------------------------------------------------------
# Folds, packing, the packed classifier
# ---------------------------------------------------------------------------

def test_stratified_kfold_matches_jax():
    labels = (np.random.default_rng(1).random(53) > 0.65).astype(np.int32)
    for use_sklearn in (True, False):
        got = stratified_kfold(labels, 5, 42, use_sklearn=use_sklearn)
        want = j_kfold(labels, 5, 42, use_sklearn=use_sklearn)
        for (gt, gv), (wt, wv) in zip(got, want):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gv, wv)


def test_shuffled_batches_match_jax():
    """The unpacked recipe's batch order: the same rng gives the JAX
    package's batches, valid masks and replicated tail."""
    data = {"idx": np.arange(37, dtype=np.int64)}
    got = batch_iter(data, 8, shuffle=True, rng=np.random.default_rng(3),
                     with_valid=True)
    want = j_batch_iter(data, 8, shuffle=True, rng=np.random.default_rng(3),
                        with_valid=True)
    for (gb, gn), (wb, wn) in zip(got, want):
        assert gn == wn and set(gb) == set(wb)
        for key in gb:
            np.testing.assert_array_equal(gb[key], wb[key])


def _ragged(rng, n, S, vocab=512, min_len=2):
    lens = rng.integers(min_len, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _data(seed, n=20, mcfg=None):
    mcfg = mcfg or ModelConfig.tiny_2c()
    rng = np.random.default_rng(seed)
    t_ids, t_mask = _ragged(rng, n, mcfg.max_text_len)
    c_ids, c_mask = _ragged(rng, n, mcfg.max_caption_len)
    size = mcfg.image.image_size
    return {"text_ids": t_ids, "text_mask": t_mask, "caption_ids": c_ids,
            "caption_mask": c_mask,
            "image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "label": rng.integers(0, 2, n).astype(np.int32)}


def test_pack_sequences_and_plan_match_jax():
    data = _data(2, n=23)
    got = pack_sequences(data["text_ids"], data["text_mask"], 32, num_rows=16,
                         max_segments=5)
    want = j_pack(data["text_ids"], data["text_mask"], 32, num_rows=16,
                  max_segments=5)
    for f in ("ids", "segments", "positions", "row_of", "slot_of",
              "start_of"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    abs_idx = np.arange(100, 123)
    plan = PackedMultimodalPlan(data, 6, abs_idx=abs_idx,
                                resident_images=True)
    jplan = JPlan(data, 6, abs_idx=abs_idx, resident_images=True)
    assert plan.steps_per_epoch == jplan.steps_per_epoch == 4
    for epoch in range(2):
        pairs = zip(plan.epoch_iter(np.random.default_rng(epoch)),
                    jplan.epoch_iter(np.random.default_rng(epoch)))
        for (b, k), (jb, jk) in pairs:
            assert k == jk and set(b) == set(jb)
            assert "image" not in b and b["img_idx"].min() >= 100
            for key in b:
                np.testing.assert_array_equal(b[key], jb[key])
    assert plan.row_budgets == (jplan._budget_t, jplan._budget_c)


def _jax_weights(data, seed=3):
    """tiny_2c weights from the flax init (the same tree for every dropout
    rate), BatchNorm statistics from the init (0 and 1)."""
    jm = JClassifier(JModelConfig.tiny_2c())
    # The PRNG named, not the process default: the JAX command line's main
    # switches the default to rbg for the rest of the process, and the
    # weights would then depend on which tests ran before.
    variables = jm.init(jax.random.key(seed, impl="threefry2x32"),
                        data["text_ids"][:2],
                        data["text_mask"][:2],
                        data["image"][:2].astype(np.float32) / 255.0,
                        data["caption_ids"][:2], data["caption_mask"][:2])
    return _np(variables["params"]), _np(variables["batch_stats"])


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_packed_classifier_equals_unpacked_per_sample(train):
    mcfg = _zero_dropout(ModelConfig.tiny_2c())
    data = _data(4, n=6)
    params, stats = _jax_weights(data)
    model = build_model(mcfg, torch.device("cpu"), packed=True)
    model.load_state_dict(from_jax_variables(params, stats))
    plan = PackedMultimodalPlan(data, 6)
    batch, _ = next(plan.epoch_iter(np.random.default_rng(0)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    image = torch.from_numpy(batch["image"]).float() / 255.0
    text, caption = packed_model_inputs(tb)
    model.train(train)
    with torch.no_grad():
        packed = model(text, image, caption)
    # Rebuild the unpacked rows of this batch's samples (their order is the
    # plan's shuffle) and run the plain forward on them.
    perm = np.random.default_rng(0).permutation(6)
    unpacked = [torch.from_numpy(data[k][perm]) for k in
                ("text_ids", "text_mask")]
    cap = [torch.from_numpy(data[k][perm]) for k in
           ("caption_ids", "caption_mask")]
    ref = build_model(mcfg, torch.device("cpu"))
    ref.load_state_dict(from_jax_variables(params, stats))
    ref.train(train)
    with torch.no_grad():
        plain = ref(*unpacked, image, *cap)
    np.testing.assert_allclose(packed.numpy(), plain.numpy(), atol=TOL,
                               rtol=0)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

# Names reach every group: encoder (text_model, caption_text_model,
# image_model), head, and the word-embedding tables (one factored: its
# second-largest dim is 128; one not).
_TREE = {
    ("text_model", "word_embeddings", "embedding"): (300, 128),
    ("text_model", "layer_0", "query", "kernel"): (16, 8),
    ("caption_text_model", "word_embeddings", "embedding"): (50, 16),
    ("image_model", "finetune_fc1", "bias"): (8,),
    ("output_fc", "kernel"): (8, 1),
    ("output_bn", "scale"): (1,),
}


def _nest(flat):
    tree = {}
    for path, x in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = x
    return tree


@pytest.mark.parametrize("recipe", ["fast", "reference"])
def test_optimizer_matches_optax(recipe):
    fast = recipe == "fast"
    kw = dict(learning_rate=1e-3,
              adam_mu_dtype="bfloat16" if fast else None,
              embedding_optimizer="factored" if fast else "adam")
    total = 12                                     # warmup 1 step: lr 0 first
    rng = np.random.default_rng(5)
    init = {p: rng.standard_normal(s).astype(np.float32)
            for p, s in _TREE.items()}
    tx = make_optimizer(JTrainConfig(**kw), total)
    params = _nest({p: jnp.asarray(x) for p, x in init.items()})
    opt_state = tx.init(params)
    names = {p: ".".join(p) for p in _TREE}
    tparams = {names[p]: torch.from_numpy(x.copy()) for p, x in init.items()}
    opt = Optimizer(TrainConfig(**kw), total, tparams)
    assert opt.label["text_model.word_embeddings.embedding"] == (
        "embed" if fast else "encoder")
    assert opt.label["output_fc.kernel"] == "head"
    if fast:
        assert set(opt.state["text_model.word_embeddings.embedding"]) == {
            "v_row", "v_col"}
        assert set(opt.state[
            "caption_text_model.word_embeddings.embedding"]) == {"v"}
    for step in range(5):
        # Steps 0-2 have a global norm above 1 (clipped), 3-4 below.
        scale = 0.3 if step < 3 else 0.01
        grads = {p: (rng.standard_normal(s) * scale).astype(np.float32)
                 for p, s in _TREE.items()}
        updates, opt_state = tx.update(
            _nest({p: jnp.asarray(g) for p, g in grads.items()}), opt_state,
            params)
        params = jax.tree_util.tree_map(lambda a, u: a + u, params, updates)
        tg = {names[p]: torch.from_numpy(g) for p, g in grads.items()}
        opt.step(tg, Optimizer.global_norm(list(tg.values())))
        for p in _TREE:
            np.testing.assert_allclose(tparams[names[p]].numpy(),
                                       np.asarray(_get(params, p)),
                                       atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {p}")
    if fast:
        # The bf16 first moment itself, bit for bit.
        adam_state = opt_state[1].inner_states["encoder"].inner_state[0]
        want = np.asarray(_get(adam_state.mu, ("text_model", "layer_0",
                                               "query", "kernel"))
                          .astype(jnp.float32))
        got = opt.state["text_model.layer_0.query.kernel"]["mu"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _zero_dropout(mcfg):
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        mcfg, dropout=0.0,
        text=dataclasses.replace(mcfg.text, **enc),
        caption=dataclasses.replace(mcfg.caption, **enc),
        image=dataclasses.replace(mcfg.image, finetune_dropout=0.0))


# Weights whose gradient is zero in exact arithmetic: a Linear bias that
# feeds a training-mode BatchNorm (the batch mean removes it), and so the
# last encoder layer's LayerNorm bias (it shifts every CLS feature alike),
# and the key bias of attention (it adds the same q.b to every score of a
# query row).
ZERO_GRAD = ("text_fc.fc.bias", "caption_text_fc.fc.bias",
             "fusion.gated.gate_fc.bias", "fusion.gated.reduce_fc.bias",
             "output_fc.bias", "attention.key.bias")


def test_three_train_steps_match_build_train_step_fn():
    mcfg = _zero_dropout(ModelConfig.tiny_2c())
    jmcfg = _zero_dropout(JModelConfig.tiny_2c())
    data = _data(6, n=20)
    params, stats = _jax_weights(data)
    B, total = 8, 3                                # warmup 0: lr > 0 at once
    kw = dict(learning_rate=1e-4, adam_mu_dtype="bfloat16",
              embedding_optimizer="factored", bf16=False)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B), **kw)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B), **kw)
    rng = np.random.default_rng(7)
    flip = rng.random(B) < 0.5
    bright = rng.uniform(0.9, 1.1, B).astype(np.float32)
    angle = (rng.uniform(-15, 15, B) * math.pi / 180).astype(np.float32)

    # JAX: the test's own augmentation with the fixed draws, then the
    # packed apply without augmentation.
    base = make_packed_multimodal_apply_fn(JPackedClassifier(jmcfg),
                                           augment_images=False)

    def apply_fn(variables, batch, train, rngs, mutable):
        img = j_rotate_shear(j_fused(batch["image"], jnp.asarray(flip),
                                     jnp.asarray(bright), interpret=True),
                             jnp.asarray(angle), 15.0)
        return base(variables, dict(batch, image=img), train, rngs, mutable)

    tx = make_optimizer(jcfg, total)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params), "batch_stats": stats}, tx)
    j_step = jax.jit(build_train_step_fn(apply_fn, jcfg, tx))

    model = build_model(mcfg, torch.device("cpu"), packed=True)
    model.load_state_dict(from_jax_variables(params, stats))
    draws = [torch.from_numpy(x) for x in (flip, bright, angle)]
    step = build_train_step(model, cfg, total, {},
                            torch.Generator().manual_seed(0),
                            augment=lambda u8, gen: augment_with_draws(
                                u8, *draws))
    batches = [b for b, _ in JPlan(data, B).epoch_iter(
        np.random.default_rng(8))]
    assert len(batches) == 3
    for i, batch in enumerate(batches):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jax.random.key(i))
        m = step({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TOL,
                                   rtol=1e-4)
    want = from_jax_variables(_np(state.params), _np(state.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    # Adam's step per entry is at most (1 - b1) / sqrt(1 - b2) ~ 3.17 lr;
    # the two packages may step in opposite directions.
    bound = 2 * 3.17 * kw["learning_rate"] * total
    zero_grad = ZERO_GRAD + tuple(
        f"{enc}.layer_{mcfg.text.num_layers - 1}.output_ln.bias"
        for enc in ("text_model", "caption_text_model"))
    off, count = 0, 0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        if "running_" in name:
            # Batch statistics of activations whose weights already differ
            # within Adam's noise (below) after the first step.
            assert d.max() <= 5 * TOL, (name, d.max())
            continue
        # Adam scales every gradient entry, rounding noise too, to a step
        # of about lr.  An entry whose gradient is near zero (a dead ReLU
        # channel; exactly zero for the names in zero_grad) can therefore
        # move differently in the two packages, within Adam's bound.  Every
        # entry is held to that bound, and all but 1 % of the others to
        # TOL, a tenth of one step's move.
        assert d.max() <= bound, (name, d.max())
        if not name.endswith(zero_grad):
            off += int(np.sum(d > TOL))
            count += d.size
    assert off <= 0.01 * count, (off, count)


def test_eval_step_leaves_training_weights_alone():
    """A model that is still training is evaluated on bf16 copies; its f32
    master weights are neither cast nor changed."""
    model = build_model(ModelConfig.tiny_2c(), torch.device("cpu"), seed=0,
                        packed=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    data = _data(9, n=4)
    step = make_eval_step(model, TrainConfig(bf16=True), cast_in_place=False)
    probs, _ = step({k: torch.from_numpy(v) for k, v in data.items()})
    assert probs.shape == (4,) and torch.isfinite(probs).all()
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k
    # The same numbers as a bf16 copy of the weights evaluated in place.
    served = build_model(ModelConfig.tiny_2c(), torch.device("cpu"))
    served.load_state_dict(before)
    want, _ = make_eval_step(served, TrainConfig(bf16=True))(
        {k: torch.from_numpy(v) for k, v in data.items()})
    torch.testing.assert_close(probs, want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# train end to end
# ---------------------------------------------------------------------------

def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    letters = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg",
             "text": " ".join("".join(rng.choice(letters,
                                                 int(rng.integers(2, 6))))
                              for _ in range(int(rng.integers(2, 12)))),
             "class_label": ("propaganda" if rng.random() < 0.35
                             else "not_propaganda")} for i in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def _probs(path):
    with open(path) as f:
        next(f)
        return np.array([float(line.split("\t")[2]) for line in f])


@pytest.mark.parametrize("recipe", ["fast", "reference"])
def test_train_cli_end_to_end_on_cpu(tmp_path, monkeypatch, recipe):
    monkeypatch.chdir(tmp_path)
    _write_manifest("train.json", 40, 0)
    _write_manifest("dev.json", 12, 1, off=1000)
    out = tmp_path / "out"
    assert main(["train", "--subtask", "2c", "-tr", "train.json", "-te",
                 "dev.json", "--tiny", "--device", "cpu", "--fold", "0",
                 "--epochs", "1", "--batch-size", "8", "--recipe", recipe,
                 "--checkpoint-dir", "ck", "--out-dir", str(out)]) == 0
    label_tsv = out / "task2C_kevinmathew.tsv"
    probs_tsv = out / "task2C_kevinmathew_probs_fold_0.tsv"
    assert check_format(str(label_tsv))
    with open(out / "task2C_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert len(metrics["steps"]) == metrics["steps_per_epoch"] == 4
    assert all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
               for s in metrics["steps"])
    assert (metrics["row_budgets"] is None) == (recipe == "reference")
    with open("ck/run_meta.json") as f:
        meta = json.load(f)
    assert model_config_from_dict(meta["model"]).text.vocab_size > 5
    assert model_config_to_dict(model_config_from_dict(meta["model"])) == \
        meta["model"]
    # predict on the best checkpoint gives the best eval's probabilities.
    assert main(["predict", "--subtask", "2c", "--manifest", "dev.json",
                 "--checkpoint", "ck/fold_0", "--out", "p.tsv",
                 "--probs-out", "pp.tsv", "--batch-size", "8", "--device",
                 "cpu"]) == 0
    np.testing.assert_allclose(_probs("pp.tsv"), _probs(str(probs_tsv)),
                               atol=1e-6, rtol=0)
