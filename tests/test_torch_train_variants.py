"""The port's 2C training variants (mpmc_tpu_torch) against the JAX package
at tiny sizes: each new fusion module against flax through the weight
bridge (MCA, MCA3, cross-modal and self-attention with two and three
inputs, eval and train mode), an MCA eval over a split that the batch does
not divide, two train steps of the new variants (MCA3 packed, small_2c
with the self-attention fusion unpacked, the simple baseline) against
``build_train_step_fn``, the command line's configs for ``--small``,
``--simple``, ``--fusion`` and ``--pooling``, ``bucketing_enabled``, and
``train --subtask 2c`` with ``--simple``, ``--small`` and ``--fusion mca``
end to end beside the JAX command line.  Inputs and weights come from
numpy seeds and the flax init; the parity checks run in f32 with dropout
0."""

import dataclasses
import json
import math

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.cli import experiments as j_experiments
from mpmc_tpu.cli.experiments import make_apply_fn
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import FusionMethod as JFusionMethod
from mpmc_tpu.config import LossType as JLossType
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import PoolingType as JPoolingType
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.config import model_config_to_dict as j_config_to_dict
from mpmc_tpu.models import fusion as j_fusion
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.classifier import \
    PackedMultimodalClassifier as JPackedClassifier
from mpmc_tpu.models.classifier import \
    SimpleMultimodalClassifier as JSimpleClassifier
from mpmc_tpu.train.loop import batch_iter as j_batch_iter
from mpmc_tpu.train.loop import run_eval as j_run_eval
from mpmc_tpu.train.packed import PackedMultimodalPlan as JPlan
from mpmc_tpu.train.packed import make_packed_multimodal_apply_fn
from mpmc_tpu.train.step import (build_train_step_fn, create_train_state,
                                 make_optimizer)
from mpmc_tpu.train.step import make_eval_step as j_make_eval_step
from mpmc_tpu_torch.cli.experiments import (bucketing_enabled, eval_transform,
                                            prepare_2c)
from mpmc_tpu_torch.cli.main import build_parser, main, train_config
from mpmc_tpu_torch.config import (DataConfig, FusionMethod, LossType,
                                   ModelConfig, PoolingType, TrainConfig,
                                   model_config_to_dict)
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models import fusion
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import (from_jax_variables,
                                            to_jax_variables)
from mpmc_tpu_torch.train.loop import run_eval
from mpmc_tpu_torch.train.step import build_train_step, make_eval_step

# f32 on both sides; layers summed in different orders by XLA and PyTorch.
TOL = 1e-5
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


def _random_stats(stats, seed):
    """Running statistics drawn from a numpy seed (the init's 0 and 1 would
    make eval mode the identity)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(0, 0.5, x.shape)).astype(np.float32),
        stats)


# ---------------------------------------------------------------------------
# Fusion modules
# ---------------------------------------------------------------------------

F_DIM = 16
# (name, flax module, port module, inputs)
FUSIONS = [
    ("mca", lambda: j_fusion.MCA(F_DIM), lambda: fusion.MCA(F_DIM), 2),
    ("mca3", lambda: j_fusion.MCA3(F_DIM), lambda: fusion.MCA3(F_DIM), 3),
    ("cross_modal-2", lambda: j_fusion.CrossModalAttention(F_DIM),
     lambda: fusion.CrossModalAttention(F_DIM, 2), 2),
    ("cross_modal-3", lambda: j_fusion.CrossModalAttention(F_DIM),
     lambda: fusion.CrossModalAttention(F_DIM, 3), 3),
    ("self_attention-2", lambda: j_fusion.SelfAttentionFusion(F_DIM),
     lambda: fusion.SelfAttentionFusion(F_DIM), 2),
    ("self_attention-3", lambda: j_fusion.SelfAttentionFusion(F_DIM),
     lambda: fusion.SelfAttentionFusion(F_DIM), 3),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,j_make,make,n_in", FUSIONS,
                         ids=[f[0] for f in FUSIONS])
def test_fusion_matches_flax(name, j_make, make, n_in, train):
    """The flax module's variables through the bridge, no key missing or
    unexpected; the outputs within 1e-4, and in train mode the updated
    BatchNorm statistics too."""
    rng = np.random.default_rng(len(name) + n_in)
    xs = [rng.standard_normal((6, F_DIM)).astype(np.float32)
          for _ in range(n_in)]
    jm = j_make()
    variables = jm.init(jax.random.key(1), *xs)
    params = _np(variables["params"])
    stats = _random_stats(_np(variables.get("batch_stats", {})), 2)
    module = make()
    sd = from_jax_variables(params, stats or None)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)
    if train:
        want, mut = jm.apply({"params": params, "batch_stats": stats}, *xs,
                             train=True, mutable=["batch_stats"])
    else:
        want = jm.apply({"params": params, "batch_stats": stats}, *xs)
    module.train(train)
    got = module(*(torch.from_numpy(x) for x in xs))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    if train and stats:
        new = from_jax_variables({}, _np(mut["batch_stats"]))
        for key, w in new.items():
            np.testing.assert_allclose(module.state_dict()[key].numpy(),
                                       w.numpy(), atol=1e-4, rtol=1e-4)


def test_make_fusion_needs_equal_widths():
    with pytest.raises(ValueError, match="equal modality widths"):
        fusion.make_fusion(FusionMethod.MCA, 16, [16, 32])
    with pytest.raises(ValueError, match="equal modality widths"):
        j_fusion.make_fusion(JFusionMethod.MCA, 16, 2, [16, 32])
    assert isinstance(fusion.make_fusion(FusionMethod.CROSS_MODAL, 16,
                                         [16, 16, 16]).text_to_caption,
                      torch.nn.Module)


# ---------------------------------------------------------------------------
# Data and weights of the tiny variants
# ---------------------------------------------------------------------------

def _ragged(rng, n, S, vocab=512, min_len=2):
    lens = rng.integers(min_len, S - 1, n)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.int32)
    return (rng.integers(5, vocab, (n, S)) * mask).astype(np.int32), mask


def _data(seed, mcfg, n=20):
    rng = np.random.default_rng(seed)
    d = {}
    d["text_ids"], d["text_mask"] = _ragged(rng, n, mcfg.max_text_len)
    if mcfg.caption is not None:
        d["caption_ids"], d["caption_mask"] = _ragged(rng, n,
                                                      mcfg.max_caption_len)
    size = mcfg.image.image_size
    d["image"] = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    d["label"] = rng.integers(0, 2, n).astype(np.int32)
    return d


def _zero_dropout(mcfg):
    enc = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return dataclasses.replace(
        mcfg, dropout=0.0, text=dataclasses.replace(mcfg.text, **enc),
        caption=mcfg.caption and dataclasses.replace(mcfg.caption, **enc),
        image=dataclasses.replace(mcfg.image, finetune_dropout=0.0))


def _configs(preset, fusion_name):
    """The port's and the JAX package's config of one variant."""
    pairs = []
    for cls, fm in ((ModelConfig, FusionMethod), (JModelConfig,
                                                  JFusionMethod)):
        mcfg = getattr(cls, preset)()
        if fusion_name != "concatenation":
            mcfg = dataclasses.replace(
                mcfg, fusion=fm(fusion_name), image=dataclasses.replace(
                    mcfg.image, finetune_dim=mcfg.proj_dim))
        pairs.append(_zero_dropout(mcfg))
    return pairs


def _weights(mcfg, seed=3, v_scale=1.0, kind="multimodal"):
    """Random weights of the port's model of ``kind`` as the flax trees
    ``(params, batch_stats)`` (the inverse bridge; flax names the fusion
    module after its class).  ``v_scale`` multiplies MCA's score kernel
    ``V``: with the initial one its softmax over the batch is nearly
    uniform, every sample gets nearly the batch mean, and the head's
    training-mode BatchNorm divides by a spread of about 1 % of the logits,
    which no tolerance of f32 arithmetic survives."""
    model = build_model(mcfg, CPU, seed=seed, kind=kind)
    params, stats = to_jax_variables(model)
    if kind == "simple":
        return params, stats
    name = type(model.fusion).__name__
    if name == "ConcatAttention" and mcfg.caption is not None:
        name = "ConcatAttention3"
    params[f"{name}_0"] = params.pop("fusion")
    if "fusion" in stats:
        stats[f"{name}_0"] = stats.pop("fusion")
    if "V" in params[f"{name}_0"]:
        params[f"{name}_0"]["V"]["kernel"] *= v_scale
    return params, stats


def test_mca_eval_over_a_ragged_split_matches_jax_run_eval():
    """MCA mixes the samples of a batch, so a real sample's probability
    depends on the eval's padding rows: 13 memes at batch 8 (the last
    batch filled by replicating real rows) give the JAX ``run_eval``'s
    probabilities, and differ from one batch of 13."""
    mcfg, jmcfg = _configs("small_2c", "mca")
    data = _data(4, mcfg, n=13)
    params, stats = _weights(mcfg, v_scale=30.0)
    stats = _random_stats(stats, 5)
    cfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=8),
                       bf16=False)
    state, _ = create_train_state({"params": params, "batch_stats": stats},
                                  make_optimizer(cfg, 1))
    eval_step = j_make_eval_step(make_apply_fn(
        JClassifier(jmcfg), "multimodal", augment_images=True), cfg)
    want = j_run_eval(state, eval_step, data, 8).probs
    model = build_model(mcfg, CPU, kind="multimodal")
    model.load_state_dict(from_jax_variables(params, stats))
    step = make_eval_step(model, TrainConfig(model=mcfg, bf16=False))
    got = run_eval(step, data, 8, CPU).probs
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    one_batch = run_eval(step, data, 13, CPU).probs
    assert np.abs(one_batch - got).max() > 10 * TOL


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

# Weights whose gradient is zero in exact arithmetic: biases that feed a
# training-mode BatchNorm (directly, or through a Linear or attention
# whose probabilities sum to 1), a bias that shifts every score of a
# softmax alike, the single-token attention's q and k, and the last
# encoder layer's LayerNorm bias under a BatchNorm-ed CLS feature.
ZERO_GRAD = ("fc.fc.bias", "gated.gate_fc.bias", "gated.reduce_fc.bias",
             "output_fc.bias", "attention.key.bias", "V.bias", "q.weight",
             "q.bias", "k.weight", "k.bias", "v.bias", "out.bias",
             "output_ln.bias")
# (id, preset, fusion, packed, kind): three modalities packed with MCA3,
# two (small_2c) unpacked with the self-attention fusion's training-mode
# BatchNorm, and the simple baseline (no captions, 2 classes,
# cross-entropy, unpacked) as ``train --simple`` runs it.
STEP_CASES = [("mca3-packed", "tiny_2c", "mca", True, "multimodal"),
              ("small_2c-self_attention-unpacked", "small_2c",
               "self_attention", False, "multimodal"),
              ("simple-unpacked", "tiny_2c", "concatenation", False,
               "simple")]


@pytest.mark.parametrize("preset,fusion_name,packed,kind",
                         [c[1:] for c in STEP_CASES],
                         ids=[c[0] for c in STEP_CASES])
def test_two_train_steps_match_build_train_step_fn(monkeypatch, preset,
                                                   fusion_name, packed, kind):
    """Focal loss (the simple model: 2-class cross-entropy), f32, the fast
    recipe's optimizer, images through the deterministic eval transform on
    both sides (the augmentation's parity is held in the 2C and 2B files);
    packed batches from the JAX plan, unpacked ones from its shuffled
    ``batch_iter`` (the short last batch padded)."""
    mcfg, jmcfg = _configs(preset, fusion_name)
    kw = dict(learning_rate=1e-4, adam_mu_dtype="bfloat16",
              embedding_optimizer="factored", bf16=False)
    loss = "focal"
    if kind == "simple":
        mcfg, jmcfg = (dataclasses.replace(c, caption=None, num_classes=2)
                       for c in (mcfg, jmcfg))
        loss = "ce"
        # The simple model's own Dropout(0.3) before ``bert_fc`` at rate 0
        # on both sides, as the config's dropouts are.
        drop = flax.linen.Dropout
        monkeypatch.setattr(flax.linen, "Dropout",
                            lambda rate, **k: drop(0.0, **k))
    B, total = 8, 2
    data = _data(6, mcfg, n=12)
    params, stats = _weights(mcfg, v_scale=30.0, kind=kind)
    jcfg = JTrainConfig(model=jmcfg, data=JDataConfig(batch_size=B),
                        loss=JLossType(loss), **kw)
    cfg = TrainConfig(model=mcfg, data=DataConfig(batch_size=B),
                      loss=LossType(loss), **kw)
    apply_fn = (make_packed_multimodal_apply_fn(
        JPackedClassifier(jmcfg), augment_images=True,
        eval_transform_only=True) if packed else make_apply_fn(
        JSimpleClassifier(jmcfg) if kind == "simple" else JClassifier(jmcfg),
        kind, augment_images=True, eval_transform_only=True))
    tx = make_optimizer(jcfg, total)
    state, _ = create_train_state({"params": jax.tree_util.tree_map(
        jnp.asarray, params), "batch_stats": stats}, tx)
    j_step = jax.jit(build_train_step_fn(apply_fn, jcfg, tx))
    model = build_model(mcfg, CPU, packed=packed, kind=kind)
    model.load_state_dict(from_jax_variables(params, stats))
    if kind == "simple":
        model.dropout.rate = 0.0
    step = build_train_step(model, cfg, total, {}, torch.Generator(),
                            augment=eval_transform)
    it = (JPlan(data, B).epoch_iter(np.random.default_rng(8)) if packed
          else j_batch_iter(data, B, shuffle=True,
                            rng=np.random.default_rng(8), with_valid=True))
    batches = [b for b, _ in it]
    assert len(batches) == 2
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
    # Adam moves each entry by at most 3.17 lr a step, so an entry whose
    # gradient is at the noise floor may move the other way: every entry
    # is held to that bound, all but 1 % of the others to TOL.
    bound = 2 * 3.17 * kw["learning_rate"] * total
    off, count = 0, 0
    for name, w in want.items():
        d = np.abs(got[name].numpy() - w.numpy())
        if "running_" in name:
            assert d.max() <= 5 * TOL, (name, d.max())
            continue
        assert d.max() <= bound, (name, d.max())
        if not name.endswith(ZERO_GRAD):
            off += int(np.sum(d > TOL))
            count += d.size
    assert off <= 0.01 * count, (off, count)


# ---------------------------------------------------------------------------
# The command line's configs, and bucketing
# ---------------------------------------------------------------------------

CONFIG_FLAGS = [["--tiny", "--fusion", "mca"], ["--fusion", "cross_modal"],
                ["--small"], ["--small", "--fusion", "self_attention"],
                ["--simple"], ["--simple", "--tiny"],
                ["--tiny", "--pooling", "max"]]


@pytest.mark.parametrize("flags", CONFIG_FLAGS,
                         ids=["-".join(f).replace("--", "")
                              for f in CONFIG_FLAGS])
def test_train_config_matches_the_jax_command_line(monkeypatch, flags):
    """The model config, packing and ``simple`` flag that the port's
    ``train --subtask 2c`` hands ``run_subtask_2c``, against what the JAX
    command line hands its ``run_subtask_2c``."""
    seen = {}

    def capture(cfg, **kwargs):
        seen.update(cfg=cfg, simple=kwargs["simple"])
        return j_experiments.SubtaskResult([], [])

    monkeypatch.setattr(j_experiments, "run_subtask_2c", capture)
    argv = ["train", "--subtask", "2c", "-tr", "t.json", "-te", "d.json",
            *flags]
    args = j_build_parser().parse_args(argv)
    assert args.fn(args) == 0
    cfg, _ = train_config(build_parser().parse_args(argv + ["--device",
                                                            "cpu"]))
    assert model_config_to_dict(cfg.model) == j_config_to_dict(
        seen["cfg"].model)
    assert cfg.data.pack_rows == seen["cfg"].data.pack_rows
    assert seen["simple"] == ("--simple" in flags)


@pytest.mark.parametrize("pooling", ["max", "cnn", "nopooling", "cls"])
def test_bucketing_enabled_matches_jax(tmp_path, monkeypatch, pooling):
    """Under the unmasked poolings both packages keep the full text length;
    under cls both bucket it (to multiples of 8 here)."""
    monkeypatch.chdir(tmp_path)
    _write_manifest("train.json", 12, 0)   # at most 14 tokens a text
    seen = {}

    def capture(cfg, model_factory, kind, full_data, *args, **kwargs):
        seen["len"] = full_data["text_ids"].shape[1]
        return j_experiments.SubtaskResult([], [])

    monkeypatch.setattr(j_experiments, "_run_folds", capture)
    data = dict(train_manifest="train.json", dev_manifest="train.json",
                seq_bucket_multiple=8)
    jcfg = JTrainConfig(model=dataclasses.replace(
        JModelConfig.tiny_2c(), pooling=JPoolingType(pooling)),
        data=JDataConfig(**data, cache_dir="jc"))
    j_experiments.run_subtask_2c(jcfg, out_dir="jout")
    cfg = TrainConfig(model=dataclasses.replace(
        ModelConfig.tiny_2c(), pooling=PoolingType(pooling)),
        data=DataConfig(**data, cache_dir="c"))
    prep = prepare_2c(cfg, "out")
    assert prep.data["text_ids"].shape[1] == seen["len"]
    assert bucketing_enabled(prep.cfg) == (pooling == "cls")
    assert (seen["len"] < 32) == (pooling == "cls")


# ---------------------------------------------------------------------------
# train --subtask 2c variants end to end
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


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


# (name, flags, run_meta kind)
RUNS = [("simple", ["--tiny", "--simple"], "simple"),
        ("small", ["--small"], "multimodal"),
        ("mca", ["--tiny", "--fusion", "mca"], "multimodal")]
TSVS = ("task2C_kevinmathew.tsv", "task2C_kevinmathew_probs_fold_0.tsv")


def _argv(root, flags, out):
    return ["train", "--subtask", "2c", "-tr", str(root / "train.json"),
            "-te", str(root / "dev.json"), *flags, "--fold", "0",
            "--epochs", "1", "--batch-size", "8", "--out-dir", str(out)]


def _stub_steps(model, cfg, train_data, kind, **kwargs):
    """The model and steps of the JAX ``_run_folds`` (``_init_and_steps``)
    replaced by constants: a train step that only counts, an eval step whose
    probabilities rise along the batch.  The steps' arithmetic is held
    above; what stays is ``run_subtask_2c``'s own: configs, vocabularies,
    ``run_meta.json``, folds, batches, evals and TSVs."""
    state, _ = create_train_state({"params": {"w": jnp.zeros(1)}},
                                  optax.sgd(0.0))

    def train_step(state, batch, rng):
        return state.replace(step=state.step + 1), {
            "loss": jnp.float32(0.5), "grad_norm": jnp.float32(1.0)}

    def eval_step(state, batch):
        n = batch["label"].shape[0]
        return jnp.linspace(0.2, 0.8, n), jnp.zeros(n)

    return state, train_step, eval_step, None, None, None


@pytest.fixture(scope="module")
def jax_2c_runs(tmp_path_factory):
    """The JAX command line's ``train --subtask 2c`` (fold 0, one epoch,
    steps stubbed) for each of ``RUNS`` on the manifests the port trains
    on."""
    root = tmp_path_factory.mktemp("jax2c")
    _write_manifest(root / "train.json", 24, 0)
    _write_manifest(root / "dev.json", 11, 1, off=1000)
    outs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_experiments, "_init_and_steps", _stub_steps)
        for name, flags, _ in RUNS:
            outs[name] = root / f"jout_{name}"
            args = j_build_parser().parse_args(
                _argv(root, flags, outs[name])
                + ["--cache-dir", str(root / ".jcache")])
            assert args.fn(args) == 0
    return root, outs


@pytest.mark.parametrize("name,flags,kind", RUNS, ids=[r[0] for r in RUNS])
def test_train_2c_variant_end_to_end_on_cpu(tmp_path, monkeypatch,
                                            jax_2c_runs, name, flags, kind):
    """The same TSV names, headers and ids, vocabularies and
    ``run_meta.json`` as the JAX command line; finite losses; packed
    exactly when the JAX recipe packs; ``predict --checkpoint`` gives the
    best eval's probabilities."""
    root, jouts = jax_2c_runs
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out"
    assert main(_argv(root, flags, out) + ["--checkpoint-dir", "ck",
                                           "--device", "cpu"]) == 0
    jout = jouts[name]
    assert sorted(p.name for p in out.glob("*.tsv")) == sorted(
        p.name for p in jout.glob("*.tsv")) == sorted(TSVS)
    for tsv in TSVS:
        got, want = _rows(out / tsv), _rows(jout / tsv)
        assert got[0] == want[0]
        assert [r[0] for r in got] == [r[0] for r in want]
    assert check_format(str(out / TSVS[0]))
    with open(out / "run_meta.json") as f, open(jout / "run_meta.json") as g:
        meta = json.load(f)
        assert meta == json.load(g)
    assert meta["kind"] == kind
    for vocab in ("vocab.txt", "caption_vocab.txt"):
        assert (out / vocab).exists() == (jout / vocab).exists()
        if (out / vocab).exists():
            assert (out / vocab).read_bytes() == (jout / vocab).read_bytes()
    assert (out / "caption_vocab.txt").exists() == (name == "mca")
    with open(out / "task2C_train_metrics_fold_0.json") as f:
        metrics = json.load(f)
    assert len(metrics["steps"]) == metrics["steps_per_epoch"] > 0
    assert (metrics["row_budgets"] is None) == (name == "simple")
    assert all(math.isfinite(s["loss"]) for s in metrics["steps"])
    assert main(["predict", "--subtask", "2c", "--manifest",
                 str(root / "dev.json"), "--checkpoint", "ck/fold_0",
                 "--out", "p.tsv", "--probs-out", "pp.tsv", "--batch-size",
                 "8", "--device", "cpu"]) == 0
    best = [float(r[2]) for r in _rows(out / TSVS[1])[1:]]
    again = [float(r[2]) for r in _rows("pp.tsv")[1:]]
    np.testing.assert_allclose(again, best, atol=1e-6, rtol=0)
