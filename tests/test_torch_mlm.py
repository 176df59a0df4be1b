"""The port's corpus MLM pretraining (mpmc_tpu_torch.train.pretrain) and
text-encoder checkpoints (models/pretrained.py) against the JAX package at
tiny sizes: the character noise, the MLM model's logits, MLM steps with
explicit masking, AdamW and its schedule against optax, the steps an epoch
runs, the npz both ways, and ``train --mlm-epochs`` on the CPU.  Weights
come from the JAX package's init; f32, dropout 0."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TextEncoderConfig as JTextEncoderConfig
from mpmc_tpu.models.classifier import TextClassifier as JText
from mpmc_tpu.models.pretrained import PretrainedSpec as JSpec
from mpmc_tpu.models.pretrained import apply_pretrained as j_apply_pretrained
from mpmc_tpu.text.wordpiece import WordPieceTokenizer as JTokenizer
from mpmc_tpu.train.pretrain import MLMConfig as JMLMConfig
from mpmc_tpu.train.pretrain import _build_mlm_model
from mpmc_tpu.train.pretrain import char_noise as j_char_noise
from mpmc_tpu.train.pretrain import mlm_pretrain as j_mlm_pretrain
from mpmc_tpu.train.pretrain import save_encoder_params as j_save
from mpmc_tpu_torch.cli.experiments import corpus_wordpiece_vocab
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import ModelConfig, PoolingType, TextEncoderConfig
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables, to_jax_params
from mpmc_tpu_torch.models.pretrained import (PretrainedSpec,
                                              apply_pretrained,
                                              read_text_params)
from mpmc_tpu_torch.ops.packing import pack_sequences
from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
from mpmc_tpu_torch.train.pretrain import (AdamW, MLMConfig, MLMModel,
                                           MLMTrainer, char_noise,
                                           mlm_epoch_rows, mlm_pretrain,
                                           pretrain_and_save,
                                           warmup_cosine_decay_schedule)

TOL = 1e-5
LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _texts(seed, n):
    rng = np.random.default_rng(seed)
    return [" ".join("".join(rng.choice(LETTERS, int(rng.integers(1, 7))))
                     for _ in range(int(rng.integers(1, 14))))
            for _ in range(n)]


def _text_cfgs(vocab=512):
    """The tiny encoder with dropout 0: the port's and the JAX package's."""
    kw = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return (dataclasses.replace(TextEncoderConfig.tiny(vocab), **kw),
            dataclasses.replace(JTextEncoderConfig.tiny(vocab), **kw))


def _corpus_arrays(seed, n=24, L=24):
    """Corpus ids and masks, the tokenizer, and its special ids."""
    texts = _texts(seed, n)
    tok = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
    ids, mask = tok.encode_batch(texts, L)
    return texts, tok, ids, mask


def _jax_mlm(jcfg, ids, mask, seed=1):
    model = _build_mlm_model(jcfg)
    return model, _np(model.init(jax.random.key(seed), ids[:2],
                                 mask[:2])["params"])


def _port_mlm(cfg, params):
    model = MLMModel(cfg)
    model.load_state_dict(from_jax_variables(params))
    return model


def test_char_noise_matches_jax():
    texts = _texts(0, 40) + ["", "a", "ab"]
    for copies, prob in ((3, 0.15), (2, 0.9)):
        got = char_noise(texts, np.random.default_rng(7), copies, prob)
        want = j_char_noise(texts, np.random.default_rng(7), copies, prob)
        assert got == want and len(got) == len(texts) * (copies + 1)
        assert got != texts * (copies + 1)


@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_mlm_model_matches_flax(packed):
    cfg, jcfg = _text_cfgs()
    _, tok, ids, mask = _corpus_arrays(1)
    jmodel, params = _jax_mlm(jcfg, ids, mask)
    kw, jkw = {}, {}
    if packed:
        p = pack_sequences(ids, mask, ids.shape[1])
        ids, mask = p.ids, (p.segments > 0).astype(np.int32)
        kw = {"segments": torch.from_numpy(p.segments),
              "positions": torch.from_numpy(p.positions)}
        jkw = {"segments": jnp.asarray(p.segments),
               "positions": jnp.asarray(p.positions)}
    with torch.no_grad():
        got = _port_mlm(cfg, params)(torch.from_numpy(ids),
                                     torch.from_numpy(mask), **kw).numpy()
    want = np.asarray(jmodel.apply({"params": params}, ids, mask, **jkw))
    assert got.shape == ids.shape + (cfg.vocab_size,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _masking(tok, ids, mask, seed):
    """Explicit selection and corrupted ids (the draws cannot match across
    frameworks)."""
    rng = np.random.default_rng(seed)
    special = [tok.cls_id, tok.vocab["[SEP]"], tok.vocab["[PAD]"],
               tok.vocab["[MASK]"]]
    real = (mask == 1) & ~np.isin(ids, special)
    sel = (rng.random(ids.shape) < 0.3) & real
    kind = rng.random(ids.shape)
    rand = rng.integers(0, 512, ids.shape)
    corrupted = np.where(kind < 0.8, tok.vocab["[MASK]"],
                         np.where(kind < 0.9, rand, ids))
    return sel, np.where(sel, corrupted, ids).astype(np.int32)


def test_mlm_steps_match_jax_value_and_grad_and_adamw():
    """Two packed MLM steps (the first at lr 0, the second at the peak) from
    the same weights and masking: the loss within 1e-5 and every parameter
    within 1e-6, but the attention key bias, whose gradient is zero in
    exact arithmetic and so at the noise floor, within Adam's bound."""
    cfg, jcfg = _text_cfgs()
    _, tok, ids, mask = _corpus_arrays(2, n=30)
    p = pack_sequences(ids, mask, ids.shape[1])
    ids, seg, pos = p.ids, p.segments, p.positions
    mask = (seg > 0).astype(np.int32)
    jmodel, params = _jax_mlm(jcfg, ids, mask)
    mlm_cfg = MLMConfig(learning_rate=3e-4)
    total = 20
    warmup = max(int(mlm_cfg.warmup_fraction * total), 1)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, mlm_cfg.learning_rate,
                                           warmup, total),
        weight_decay=mlm_cfg.weight_decay))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)

    def loss_fn(p_, inp, sel):
        logits = jmodel.apply({"params": p_}, inp, mask, train=True,
                              rngs={"dropout": jax.random.key(0)},
                              segments=seg, positions=pos)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, ids[..., None], axis=-1)[..., 0]
        w = sel.astype(jnp.float32)
        return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)

    model = _port_mlm(cfg, params)
    trainer = MLMTrainer(model, total, mlm_cfg)
    t = {k: torch.from_numpy(v) for k, v in (("ids", ids), ("mask", mask),
                                             ("seg", seg), ("pos", pos))}
    for step in range(2):
        sel, inp = _masking(tok, ids, mask, step)
        jloss, grads = jax.value_and_grad(loss_fn)(jparams, inp, sel)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        loss = trainer.step(t["ids"], t["mask"], torch.from_numpy(sel),
                            torch.from_numpy(inp), t["seg"], t["pos"])
        np.testing.assert_allclose(float(loss), float(jloss), atol=TOL,
                                   rtol=0)
    assert trainer.optimizer.schedule(1) == np.float32(mlm_cfg.learning_rate)
    want = from_jax_variables(_np(jparams))
    got = model.state_dict()
    assert set(got) == set(want)
    moved = 0.0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy()).max()
        moved = max(moved, np.abs(w.numpy() - from_jax_variables(params)[
            name].numpy()).max())
        limit = (2 * 3.17 * mlm_cfg.learning_rate
                 if name.endswith("attention.key.bias") else 1e-6)
        assert d <= limit, (name, d)
    assert moved > 1e-4                      # the second step moved weights


def _tree(shapes, rng, scale=1.0):
    return {name: (rng.standard_normal(s) * scale).astype(np.float32)
            for name, s in shapes.items()}


def test_adamw_matches_optax():
    """clip_by_global_norm(1) then adamw under the warmup-cosine schedule,
    weight decay on every parameter, over steps with and without
    clipping."""
    shapes = {"a": (30, 16), "b": (16,), "c": (3, 5, 7)}
    rng = np.random.default_rng(3)
    init = _tree(shapes, rng)
    total, warmup, peak = 12, 2, 1e-2
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total),
        weight_decay=0.01))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    opt = AdamW(params, warmup_cosine_decay_schedule(peak, warmup, total),
                0.01)
    for step in range(8):
        grads = _tree(shapes, rng, 0.3 if step % 2 else 0.01)
        updates, state = tx.update({k: jnp.asarray(g) for k, g in
                                    grads.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = opt.step([torch.from_numpy(grads[k]) for k in params])
        np.testing.assert_allclose(float(norm), float(optax.global_norm(
            grads)), rtol=1e-6)
        for k in params:
            np.testing.assert_allclose(params[k].numpy(),
                                       np.asarray(jparams[k]), atol=1e-6,
                                       rtol=0, err_msg=f"step {step} {k}")


@pytest.mark.parametrize("peak,warmup,total", [(3e-4, 1, 20), (1e-3, 5, 100),
                                               (3e-4, 42, 840)])
def test_warmup_cosine_schedule_matches_optax(peak, warmup, total):
    got = warmup_cosine_decay_schedule(peak, warmup, total)
    want = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, total)
    steps = np.arange(total + 3)
    w = np.asarray(jax.vmap(want)(jnp.asarray(steps)), np.float32)
    g = np.array([got(int(s)) for s in steps], np.float32)
    # The warmup is exact; XLA's f32 cosine differs from numpy's by a few
    # ulps, which 1 + cos(.) near the end of the decay magnifies.
    np.testing.assert_array_equal(g[:warmup + 1], w[:warmup + 1])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * peak)
    assert g[0] == 0.0 and g[warmup] == np.float32(peak)
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(peak, 1, 1)


SCAN_STEPS = MLMConfig().scan_steps          # JAX's default, 8


@pytest.mark.parametrize("batches,scan_steps,steps", [(14, SCAN_STEPS, 8),
                                                      (3, SCAN_STEPS, 3)])
def test_mlm_epoch_steps_match_jax(monkeypatch, batches, scan_steps, steps):
    """The JAX loop runs whole scan groups: an epoch of ``batches`` batches
    runs ``steps`` steps.  The rows of every step the JAX loop dispatched
    (read from its jitted scan's arguments, two epochs) equal the port's,
    and the port's ``mlm_pretrain`` runs as many steps."""
    bs = 4
    n = batches * bs + 2
    texts = _texts(4, n)
    tok = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
    cfg, jcfg = _text_cfgs(max(tok.vocab.values()) + 1)
    # Each row unique: its first token is its index.
    ids, mask = tok.encode_batch(texts, 16)
    ids[:, 1] = 5 + np.arange(n)
    mask[:, :2] = 1
    seen = []
    real_jit = jax.jit

    def spy_jit(fn, *args, **kw):
        jitted = real_jit(fn, *args, **kw)
        if getattr(fn, "__name__", "") != "scan_step":
            return jitted

        def run(*a):
            seen.append(np.asarray(a[2]))
            return jitted(*a)
        return run

    monkeypatch.setattr(jax, "jit", spy_jit)
    j_mlm_pretrain(jcfg, ids, mask, JTokenizer(tok.vocab),
                   JMLMConfig(epochs=2, batch_size=bs, scan_steps=scan_steps))
    monkeypatch.setattr(jax, "jit", real_jit)
    got_steps = np.concatenate(seen).reshape(-1, bs, 16)
    rng = np.random.default_rng(42)
    want = [ids[r] for _ in range(2)
            for r in mlm_epoch_rows(rng.permutation(n), bs, batches,
                                    scan_steps)]
    assert len(want) == len(got_steps) == 2 * steps
    for g, w in zip(got_steps, want):
        np.testing.assert_array_equal(g, w)
    run = mlm_pretrain(cfg, ids, mask, tok,
                       MLMConfig(epochs=2, batch_size=bs), CPU)
    assert run.steps == 2 * steps and np.isfinite(run.epoch_losses).all()


# ---------------------------------------------------------------------------
# The encoder npz, both ways
# ---------------------------------------------------------------------------

def _classifier_cfgs(vocab):
    m, jm = ModelConfig.tiny_2c(), JModelConfig.tiny_2c()
    return (dataclasses.replace(
        m, pooling=PoolingType.ATTENTION, num_classes=2,
        text=dataclasses.replace(m.text, vocab_size=vocab)),
        dataclasses.replace(
            jm, pooling=JPoolingType.ATTENTION, num_classes=2,
            text=dataclasses.replace(jm.text, vocab_size=vocab)))


def _both_spliced(path, ids, mask, vocab):
    """TextClassifier logits with the encoder spliced from ``path``: the
    JAX package's (its init and ``apply_pretrained``) and the port's (the
    same init weights, its ``apply_pretrained``), and the port's model."""
    mcfg, jmcfg = _classifier_cfgs(vocab)
    jmodel = JText(jmcfg)
    variables = jmodel.init(jax.random.key(5), ids[:2], mask[:2])
    spliced = j_apply_pretrained(variables, jmcfg, "text", JSpec(text=path))
    want = np.asarray(jmodel.apply(spliced, ids, mask))
    model = build_model(mcfg, CPU, kind="text")
    model.load_state_dict(from_jax_variables(_np(variables["params"])))
    apply_pretrained(model, "text", PretrainedSpec(text=path))
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    return got, want, model


def test_port_npz_splices_into_jax(tmp_path):
    """``pretrain_and_save`` writes the npz the JAX package's
    ``apply_pretrained(kind="text")`` splices; both packages' spliced
    classifiers give the same logits, and the port's encoder equals the MLM
    encoder bit for bit."""
    texts = _texts(6, 20)
    tok = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
    vocab = max(tok.vocab.values()) + 1
    cfg, _ = _text_cfgs(vocab)
    path = str(tmp_path / "mlm_encoder.npz")
    run = pretrain_and_save(cfg, texts, tok, path,
                            MLMConfig(epochs=2, batch_size=16), max_len=24,
                            device=CPU)
    assert run.steps == 2 * (80 // 16) and len(run.epoch_losses) == 2
    with np.load(path) as f:
        assert "__flax_encoder__" in f.files
        assert "layer_0/attention/query/kernel" in f.files
    ids, mask = tok.encode_batch(texts[:6], 24)
    got, want, model = _both_spliced(path, ids, mask, vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    for name, w in run.encoder.state_dict().items():
        assert torch.equal(model.encoder.state_dict()[name], w), name


def test_jax_npz_loads_into_port(tmp_path):
    """An npz from the JAX package's ``save_encoder_params`` (the encoder of
    its MLM model) splices into the port's text and multimodal models."""
    texts = _texts(7, 8)
    tok = WordPieceTokenizer(corpus_wordpiece_vocab(texts))
    vocab = max(tok.vocab.values()) + 1
    _, jcfg = _text_cfgs(vocab)
    ids, mask = tok.encode_batch(texts, 24)
    _, params = _jax_mlm(jcfg, ids, mask, seed=9)
    path = str(tmp_path / "jax_encoder.npz")
    j_save(params["encoder"], path)
    got, want, model = _both_spliced(path, ids, mask, vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    enc = from_jax_variables(params["encoder"])
    for name, w in model.encoder.state_dict().items():
        assert torch.equal(w, enc[name]), name
    mm = build_model(dataclasses.replace(
        ModelConfig.tiny_2c(), text=dataclasses.replace(
            ModelConfig.tiny_2c().text, vocab_size=vocab)), CPU, seed=0)
    apply_pretrained(mm, "multimodal", PretrainedSpec(text=path))
    for name, w in mm.text_model.state_dict().items():
        assert torch.equal(w, enc[name]), name


def test_to_jax_params_inverts_the_bridge():
    _, jcfg = _text_cfgs()
    _, params = _jax_mlm(jcfg, np.ones((2, 8), np.int32),
                         np.ones((2, 8), np.int32))
    cfg, _ = _text_cfgs()
    model = _port_mlm(cfg, params)
    tree = to_jax_params(model.encoder)
    flat = jax.tree_util.tree_flatten_with_path(params["encoder"])[0]
    back = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in flat] == [p for p, _ in back]
    for (path, w), (_, g) in zip(flat, back):
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_text_params_refuses_other_checkpoints(tmp_path):
    """A file that is not the marked MLM npz is a Hugging Face state dict:
    without the encoder's config it is refused, and an incomplete one, a
    missing file and a tree of another shape raise."""
    np.savez(tmp_path / "hf.npz", **{"embeddings.word_embeddings.weight":
                                     np.zeros((4, 2), np.float32)})
    text_cfg = ModelConfig.small_2a().text
    with pytest.raises(ValueError, match="needs the encoder's config"):
        read_text_params(str(tmp_path / "hf.npz"))
    with pytest.raises(KeyError, match="position_embeddings"):
        read_text_params(str(tmp_path / "hf.npz"), text_cfg)
    with pytest.raises(FileNotFoundError):
        read_text_params(str(tmp_path / "model.bin"), text_cfg)
    model = build_model(ModelConfig.small_2a(), CPU, kind="text")
    with pytest.raises(KeyError, match="position_embeddings"):
        apply_pretrained(model, "text",
                         PretrainedSpec(text=str(tmp_path / "hf.npz")))
    with pytest.raises(ValueError, match="leaf sets differ"):
        tree = to_jax_params(model.encoder)
        del tree["layer_0"]
        path = str(tmp_path / "short.npz")
        from mpmc_tpu_torch.models.pretrained import save_encoder_params
        save_encoder_params(tree, path)
        apply_pretrained(model, "text", PretrainedSpec(text=path))


def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg",
             "text": t,
             "class_label": ("propaganda" if rng.random() < 0.35
                             else "not_propaganda")}
            for i, t in enumerate(_texts(seed, n))]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


@pytest.mark.parametrize("flags", [["--subtask", "2a", "--small",
                                    "--mlm-pack"],
                                   ["--subtask", "2c", "--tiny"]],
                         ids=["2a-packed-mlm", "2c"])
def test_train_mlm_stage_on_cpu(tmp_path, monkeypatch, flags):
    """``train --mlm-epochs 2`` pretrains on train+dev, writes the npz, and
    the fold starts from it; ``--text-params`` with that file skips the
    stage."""
    monkeypatch.chdir(tmp_path)
    _write_manifest("train.json", 40, 0)
    _write_manifest("dev.json", 12, 1, off=1000)
    base = ["train", *flags, "-tr", "train.json", "-te", "dev.json",
            "--device", "cpu", "--fold", "0", "--epochs", "1",
            "--batch-size", "8"]
    assert main(base + ["--mlm-epochs", "2", "--out-dir", "out"]) == 0
    tree = read_text_params("out/mlm_encoder.npz")
    assert "word_embeddings" in tree and "layer_0" in tree
    assert main(base + ["--mlm-epochs", "2", "--out-dir", "out2",
                        "--text-params", "out/mlm_encoder.npz"]) == 0
    assert not (tmp_path / "out2" / "mlm_encoder.npz").exists()
    name = "task2A" if "2a" in flags else "task2C"
    with open(f"out/{name}_train_metrics_fold_0.json") as f:
        assert json.load(f)["steps"]
