"""``--embedding-optimizer sparse`` (``mpmc_tpu_torch/train/sparse_opt.py``
through ``train.step.Optimizer``): lazy row-Adam on the word-embedding
tables.

Mirrors ``tests/test_sparse_opt.py`` against the port's own dense Adam:
with every row touched it equals dense Adam; a touched row is bit-equal to
dense Adam's and an untouched one frozen; a row touched once then never
again stays where dense Adam keeps moving it; an overflow of the support
bound drops only the smallest rows.  Against the JAX package: the state
after a sequence of updates within 1e-6 relative of
``with_sparse_embeddings``, and three train steps (2A unpacked, 2C packed,
tiny) beside ``build_train_step_fn`` with ``make_optimizer(...,
embed_support=...)`` at the existing train-step tests' tolerances; and the
sparse state through ``Checkpointer``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.classifier import \
    PackedMultimodalClassifier as JPackedClassifier
from mpmc_tpu.models.classifier import TextClassifier as JText
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.packed import PackedMultimodalPlan as JPlan
from mpmc_tpu.train.packed import make_packed_multimodal_apply_fn
from mpmc_tpu.train.sparse_opt import apply_updates, with_sparse_embeddings
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu_torch.config import (DataConfig, LossType, ModelConfig,
                                   PoolingType, TrainConfig)
from mpmc_tpu_torch.image.augment import augment_with_draws
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.train.checkpoint import Checkpointer
from mpmc_tpu_torch.train.loop import batch_iter
from mpmc_tpu_torch.train.step import (Optimizer, build_train_step,
                                       sparse_support_rows)

TOL = 1e-5
# The JAX initializers' PRNG, named: the JAX command line's main switches
# the process default to rbg, and the weights would then depend on which
# tests ran before.
PRNG = "threefry2x32"
EMB = "text_model.word_embeddings.weight"
DENSE = "text_model.dense.weight"


def _params(v=12, h=8, seed=0):
    rng = np.random.default_rng(seed)
    return {EMB: rng.normal(size=(v, h)).astype(np.float32),
            DENSE: rng.normal(size=(h, h)).astype(np.float32)}


def _grads(params, touched, seed):
    """Gradients whose embedding rows outside ``touched`` are 0."""
    rng = np.random.default_rng(100 + seed)
    g = np.zeros_like(params[EMB])
    g[touched] = rng.normal(size=(len(touched), g.shape[1]))
    return {EMB: g, DENSE: rng.normal(size=params[DENSE].shape)
            .astype(np.float32)}


def _cfg(mode, lr, support=0):
    return TrainConfig(learning_rate=lr, lr_schedule="constant",
                       encoder_lr_scale=1.0, grad_clip_norm=1e9,
                       embedding_optimizer=mode,
                       embedding_support_rows=support)


def _run(mode, params, grads_seq, lr, support=0):
    p = {k: torch.tensor(v) for k, v in params.items()}
    opt = Optimizer(_cfg(mode, lr, support), 10, p,
                    embed_support=support or None)
    for g in grads_seq:
        tg = {k: torch.tensor(v) for k, v in g.items()}
        opt.step(tg, Optimizer.global_norm(list(tg.values())))
    return {k: v.numpy() for k, v in p.items()}, opt


def test_all_rows_touched_equals_dense_adam():
    params = _params()
    v = params[EMB].shape[0]
    grads = [_grads(params, list(range(v)), s) for s in range(4)]
    dense, _ = _run("adam", params, grads, 1e-2)
    sparse, opt = _run("sparse", params, grads, 1e-2, support=v)
    assert opt.label[EMB] == "embed" and opt.label[DENSE] == "encoder"
    for key in params:
        np.testing.assert_array_equal(sparse[key], dense[key])


def test_touched_rows_bit_equal_untouched_frozen():
    params = _params(v=16)
    touched = [1, 4, 5, 9]
    grads = [_grads(params, touched, s) for s in range(3)]
    dense, _ = _run("adam", params, grads, 5e-3)
    sparse, opt = _run("sparse", params, grads, 5e-3, support=6)
    np.testing.assert_array_equal(sparse[EMB][touched], dense[EMB][touched])
    untouched = [i for i in range(16) if i not in touched]
    np.testing.assert_array_equal(sparse[EMB][untouched],
                                  params[EMB][untouched])
    np.testing.assert_array_equal(sparse[DENSE], dense[DENSE])
    # The masked slots (6 selected, 4 touched) wrote nothing.
    assert not opt.state[EMB]["mu"][untouched].any()
    assert not opt.state[EMB]["nu"][untouched].any()


def test_lazy_freezes_a_row_dense_keeps_moving():
    params = _params(v=10)
    grads = [_grads(params, [2], 0), _grads(params, [7], 1),
             _grads(params, [7], 2)]
    dense, _ = _run("adam", params, grads, 1e-2)
    sparse, _ = _run("sparse", params, grads, 1e-2, support=4)
    after_one, _ = _run("sparse", params, grads[:1], 1e-2, support=4)
    np.testing.assert_array_equal(sparse[EMB][2], after_one[EMB][2])
    assert np.abs(dense[EMB][2] - sparse[EMB][2]).max() > 1e-6
    np.testing.assert_array_equal(sparse[EMB][7], dense[EMB][7])


def test_support_overflow_drops_only_the_smallest_rows():
    params = _params(v=12)
    g = _grads(params, [3, 6, 8], 0)
    g[EMB][6] *= 0.01                   # distinct norms: row 6 smallest
    norms = np.abs(g[EMB]).sum(axis=1)
    keep = set(np.argsort(-norms)[:2].tolist())
    assert keep == {3, 8}
    sparse, opt = _run("sparse", params, [g], 1e-2, support=2)
    moved = set(np.nonzero(np.abs(sparse[EMB] - params[EMB]).sum(axis=1)
                           > 0)[0].tolist())
    assert moved == keep
    assert not opt.state[EMB]["mu"][6].any()


def test_state_matches_jax_with_sparse_embeddings():
    """Five updates, rows touched per step varying: parameters, mu and nu
    within 1e-6 relative of the JAX wrapper, and the step count."""
    params = _params(v=20, h=8, seed=4)
    lr, support = 3e-3, 7
    touched = [[0, 3, 4], [3, 9, 11, 19], [1], [0, 4, 5, 6, 7, 8, 9],
               list(range(0, 20, 3))[:7]]
    grads = [_grads(params, t, s) for s, t in enumerate(touched)]
    sched = optax.constant_schedule(lr)

    def label(tree):
        return {k: "embed" if k == EMB else "rest" for k in tree}

    inner = optax.multi_transform({"rest": optax.adam(sched),
                                   "embed": optax.identity()}, label)
    tx = with_sparse_embeddings(inner, sched, support_rows=support,
                                is_embed=lambda p: "word_embeddings" in p)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = apply_updates(jp, updates)
    got, opt = _run("sparse", params, grads, lr, support=support)
    for key in params:
        np.testing.assert_allclose(got[key], np.asarray(jp[key]), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(opt.state[EMB]["mu"].numpy(),
                               np.asarray(state.mu[EMB]), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(opt.state[EMB]["nu"].numpy(),
                               np.asarray(state.nu[EMB]), rtol=1e-6,
                               atol=1e-12)
    assert opt.count == int(state.count) == 5


def test_support_rows_follow_make_optimizer():
    m = ModelConfig.tiny_2c()
    cfg = TrainConfig(model=m, data=DataConfig(batch_size=8, pack_rows=0),
                      embedding_optimizer="sparse")
    assert sparse_support_rows(cfg) == 8 * max(m.max_text_len,
                                               m.max_caption_len)
    packed = dataclasses.replace(cfg, data=DataConfig(batch_size=8,
                                                      pack_rows=12))
    assert sparse_support_rows(packed) == 12 * max(m.max_text_len,
                                                   m.max_caption_len)
    assert sparse_support_rows(cfg, 96) == 96
    floor = dataclasses.replace(cfg, embedding_support_rows=500)
    assert sparse_support_rows(floor, 96) == 500
    with pytest.raises(ValueError, match="embedding_optimizer"):
        Optimizer(dataclasses.replace(cfg, embedding_optimizer="lazy"), 3,
                  {"w": torch.zeros(2)})


# ---------------------------------------------------------------------------
# Train steps against build_train_step_fn
# ---------------------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _ragged(rng, n, S, vocab=512, min_len=2):
    lens = rng.integers(min_len, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _check_weights(got, want, lr, steps, zero_grad):
    """The train-step tests' rule: every entry within Adam's bound, all but
    1 % of those with a nonzero gradient within TOL; the batch statistics
    within 5 TOL."""
    assert set(got) == set(want)
    bound = 2 * 3.17 * lr * steps
    off, count = 0, 0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        if "running_" in name:
            assert d.max() <= 5 * TOL, (name, d.max())
            continue
        assert d.max() <= bound, (name, d.max())
        if not name.endswith(zero_grad):
            off += int(np.sum(d > TOL))
            count += d.size
    assert off <= 0.01 * count, (off, count)


def _embedding_rows_moved(before, after, touched):
    moved = np.nonzero(np.abs(after - before).sum(axis=1) > 0)[0]
    assert len(moved) and set(moved.tolist()) <= set(touched.tolist())


def test_three_unpacked_2a_steps_sparse_match_jax():
    """The 2A text model, unpacked (batches index the resident arrays), f32
    Adam elsewhere, the driver's exact support bound (batch x length)."""
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    mcfg, jmcfg = [dataclasses.replace(
        m, pooling=pool("attention"), num_classes=2, dropout=0.0,
        text=dataclasses.replace(m.text, **enc))
        for m, pool in ((ModelConfig.tiny_2c(), PoolingType),
                        (JModelConfig.tiny_2c(), JPoolingType))]
    rng = np.random.default_rng(7)
    ids, mask = _ragged(rng, 40, 32)
    data = {"text_ids": ids, "text_mask": mask,
            "label": rng.integers(0, 2, 40).astype(np.int32)}
    params = _np(JText(jmcfg).init(jax.random.key(3, impl=PRNG), ids[:2],
                                   mask[:2])["params"])
    B, support = 16, 16 * 32
    kw = dict(learning_rate=1e-4, lr_schedule="constant", bf16=False,
              embedding_optimizer="sparse")
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B),
                      loss=LossType.CROSS_ENTROPY, **kw)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B),
                        loss=JLossType.CROSS_ENTROPY, **kw)
    tx = make_optimizer(jcfg, 3, embed_support=support)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params)}, tx)
    j_step = jax.jit(build_train_step_fn(
        make_apply_fn(JText(jmcfg), "text"), jcfg, tx))
    model = build_model(mcfg, torch.device("cpu"), kind="text")
    model.load_state_dict(from_jax_variables(params))
    store = {k: torch.from_numpy(v) for k, v in data.items()}
    step = build_train_step(model, cfg, 3, store, torch.Generator(),
                            embed_support=support)
    assert step.optimizer.support_rows == support
    emb = "encoder.word_embeddings.weight"
    assert [k for k, lab in step.optimizer.label.items()
            if lab == "embed"] == [emb]
    table0 = model.state_dict()[emb].clone()
    jbatches = j_batch_iter(data, B, shuffle=True,
                            rng=np.random.default_rng(9), with_valid=True)
    batches = batch_iter({"idx": np.arange(40)}, B, shuffle=True,
                         rng=np.random.default_rng(9), with_valid=True)
    for i, ((jb, _), (b, _)) in enumerate(zip(jbatches, batches)):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in jb.items()},
                           jax.random.key(i))
        m = step({k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), atol=TOL,
                                   rtol=1e-4)
    assert step.optimizer.count == 3
    _check_weights(model.state_dict(), from_jax_variables(_np(state.params)),
                   1e-4, 3, ("attention.key.bias", "pooler.attn_fc2.bias"))
    _embedding_rows_moved(table0.numpy(), model.state_dict()[emb].numpy(),
                          np.unique(ids))


def test_three_packed_2c_steps_sparse_match_jax():
    """The 2C flagship, packed text and caption rows, the config's support
    bound (rows x the longer length), the augmentation draws passed."""
    def zero(m):
        enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
        return dataclasses.replace(
            m, dropout=0.0, text=dataclasses.replace(m.text, **enc),
            caption=dataclasses.replace(m.caption, **enc),
            image=dataclasses.replace(m.image, finetune_dropout=0.0))

    mcfg, jmcfg = zero(ModelConfig.tiny_2c()), zero(JModelConfig.tiny_2c())
    rng = np.random.default_rng(6)
    n, size = 20, mcfg.image.image_size
    t_ids, t_mask = _ragged(rng, n, mcfg.max_text_len)
    c_ids, c_mask = _ragged(rng, n, mcfg.max_caption_len)
    data = {"text_ids": t_ids, "text_mask": t_mask, "caption_ids": c_ids,
            "caption_mask": c_mask,
            "image": rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            "label": rng.integers(0, 2, n).astype(np.int32)}
    variables = JClassifier(jmcfg).init(
        jax.random.key(3, impl=PRNG), t_ids[:2], t_mask[:2],
        data["image"][:2].astype(np.float32) / 255.0, c_ids[:2], c_mask[:2])
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    B, total = 8, 3
    kw = dict(learning_rate=1e-4, adam_mu_dtype="bfloat16",
              embedding_optimizer="sparse", bf16=False)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B,
                                                      pack_rows=B), **kw)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B, pack_rows=B),
                      **kw)
    draw = np.random.default_rng(7)
    flip = draw.random(B) < 0.5
    bright = draw.uniform(0.9, 1.1, B).astype(np.float32)
    angle = (draw.uniform(-15, 15, B) * math.pi / 180).astype(np.float32)
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
    assert step.optimizer.support_rows == B * max(mcfg.max_text_len,
                                                  mcfg.max_caption_len)
    embeds = [k for k, lab in step.optimizer.label.items() if lab == "embed"]
    assert embeds == [EMB, "caption_text_model.word_embeddings.weight"]
    before = {k: model.state_dict()[k].clone() for k in embeds}
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
    zero_grad = ("text_fc.fc.bias", "caption_text_fc.fc.bias",
                 "fusion.gated.gate_fc.bias", "fusion.gated.reduce_fc.bias",
                 "output_fc.bias", "attention.key.bias") + tuple(
        f"{enc}.layer_{mcfg.text.num_layers - 1}.output_ln.bias"
        for enc in ("text_model", "caption_text_model"))
    _check_weights(model.state_dict(),
                   from_jax_variables(_np(state.params),
                                      _np(state.batch_stats)),
                   1e-4, total, zero_grad)
    for k, ids_ in zip(embeds, (t_ids, c_ids)):
        _embedding_rows_moved(before[k].numpy(),
                              model.state_dict()[k].numpy(), np.unique(ids_))


def test_sparse_state_round_trips_through_checkpointer(tmp_path):
    """Two steps, a checkpoint, a third step; a fresh step restored from the
    checkpoint takes the same third step: weights and the sparse moments
    equal bit for bit."""
    mcfg = dataclasses.replace(ModelConfig.tiny_2c(), pooling=PoolingType(
        "attention"), num_classes=2)
    rng = np.random.default_rng(2)
    ids, mask = _ragged(rng, 24, 16)
    data = {"text_ids": ids, "text_mask": mask,
            "label": rng.integers(0, 2, 24).astype(np.int32)}
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=8),
                      loss=LossType.CROSS_ENTROPY, bf16=False,
                      learning_rate=1e-3, lr_schedule="constant",
                      embedding_optimizer="sparse")
    store = {k: torch.from_numpy(v) for k, v in data.items()}
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b, _ in
               batch_iter({"idx": np.arange(24)}, 8, shuffle=True,
                          rng=np.random.default_rng(1), with_valid=True)]

    def fresh():
        model = build_model(mcfg, torch.device("cpu"), seed=5, kind="text")
        return build_train_step(model, cfg, 3, store,
                                torch.Generator().manual_seed(4),
                                embed_support=8 * 16)

    a = fresh()
    a(batches[0])
    a(batches[1])
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(a.state_dict(), 2, {"test_f1": 0.5})
    ck.wait()
    a(batches[2])
    b = fresh()
    ck.restore_latest(b)
    assert b.optimizer.count == 2
    emb = "encoder.word_embeddings.weight"
    assert b.optimizer.label[emb] == "embed"
    assert set(b.optimizer.state[emb]) == {"mu", "nu"}
    b(batches[2])
    for k, v in a.model.state_dict().items():
        np.testing.assert_array_equal(b.model.state_dict()[k].numpy(),
                                      v.numpy())
    for slot in ("mu", "nu"):
        np.testing.assert_array_equal(b.optimizer.state[emb][slot].numpy(),
                                      a.optimizer.state[emb][slot].numpy())
    assert a.optimizer.state[emb]["mu"].dtype == torch.float32
