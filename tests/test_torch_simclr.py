"""The port's SimCLR image pretraining and ``--image-params`` splice
(mpmc_tpu_torch) against the JAX package at tiny sizes: ``nt_xent_loss``,
two SimCLR steps of a tiny ResNet with the same augmentation draws, the
warmup-cosine schedule and the epoch's whole groups of steps, the
backbone npz both ways between the packages into the 2B and 2C models,
``train --simclr-epochs`` on the CPU for 2B and 2C, and the grayscale
variant refused.  Inputs come from numpy seeds; weights from the port's
init, carried to flax through the bridge; everything in f32."""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpmc_tpu.cli.experiments import run_subtask_2b as j_run_subtask_2b
from mpmc_tpu.config import DataConfig as JDataConfig
from mpmc_tpu.config import ImageEncoderConfig as JImageEncoderConfig
from mpmc_tpu.config import ModelConfig as JModelConfig
from mpmc_tpu.config import TrainConfig as JTrainConfig
from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.models.classifier import ImageClassifier as JImageClassifier
from mpmc_tpu.models.classifier import MultimodalClassifier as JClassifier
from mpmc_tpu.models.pretrained import PretrainedSpec as JPretrainedSpec
from mpmc_tpu.models.pretrained import apply_pretrained as j_apply_pretrained
from mpmc_tpu.ops.image_ops import fused_normalize_flip_brightness as j_fused
from mpmc_tpu.train.pretrain_image import _build_simclr_model
from mpmc_tpu.train.pretrain_image import nt_xent_loss as j_nt_xent_loss
from mpmc_tpu.train.pretrain_image import \
    save_image_encoder_params as j_save_image_encoder_params
from mpmc_tpu_torch.cli.experiments import run_subtask_2b
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.config import (DataConfig, ImageEncoderConfig,
                                   ModelConfig, TrainConfig)
from mpmc_tpu_torch.image.augment import eval_preprocess
from mpmc_tpu_torch.models import pretrained as port_pretrained
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from mpmc_tpu_torch.models.pretrained import (FLAX_IMAGE_MARKER,
                                              PretrainedSpec,
                                              apply_pretrained,
                                              flatten_params,
                                              read_image_params)
from mpmc_tpu_torch.train import pretrain_image as P
from mpmc_tpu_torch.train.pretrain import warmup_cosine_decay_schedule

CPU = torch.device("cpu")
TINY = dict(arch="tiny_resnet", image_size=32, feature_dim=64,
            finetune_dim=64)


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


# ---------------------------------------------------------------------------
# The loss, the steps, the schedule and the epoch's groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,d,temperature,aligned",
                         [(8, 32, 0.5, False), (8, 32, 0.1, False),
                          (8, 32, 0.5, True), (64, 128, 0.5, False)])
def test_nt_xent_loss_matches_jax(b, d, temperature, aligned):
    rng = np.random.default_rng(b * d)
    z1 = rng.standard_normal((b, d)).astype(np.float32) * 3
    z2 = z1 if aligned else rng.standard_normal((b, d)).astype(np.float32)
    got = P.nt_xent_loss(torch.from_numpy(z1), torch.from_numpy(z2),
                         temperature)
    want = j_nt_xent_loss(jnp.asarray(z1), jnp.asarray(z2), temperature)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6,
                               rtol=1e-6)


def _draws(rng, n):
    return (rng.random(n) < 0.5, rng.uniform(0.9, 1.1, n).astype(np.float32),
            (rng.uniform(-15, 15, n) * math.pi / 180).astype(np.float32))


def test_two_simclr_steps_match_jax():
    """The JAX stage's step (its body, a closure of ``simclr_pretrain``,
    written out here with the two views built from fixed draws through the
    interpret-mode image kernel and the shear rotation) against
    ``SimCLRTrainer.step``: the loss, then the backbone's parameters and
    running statistics after two steps, within 1e-4.  Schedule over 4 steps
    (warmup 1: the first step has lr 0, the second the peak)."""
    n, bs, total = 8, 4, 4
    cfg = P.SimCLRConfig(batch_size=bs, proj_dim=16)
    with torch.device("cpu"):
        model = P.SimCLRModel(ImageEncoderConfig(**TINY), cfg.proj_dim)
    P.init_weights(model, torch.Generator().manual_seed(0))
    params, stats = to_jax_variables(model)
    jmodel = _build_simclr_model(JImageEncoderConfig(**TINY), cfg.proj_dim)
    sched = optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, max(int(cfg.warmup_fraction * total), 1),
        total)
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(sched, weight_decay=cfg.weight_decay))
    opt_state = tx.init(params)

    def view(imgs, flip, bright, angle):
        return j_rotate_shear(j_fused(imgs, flip, bright, interpret=True),
                              angle, cfg.max_rotate_deg)

    @jax.jit
    def j_step(params, batch_stats, opt_state, imgs, d1, d2):
        v1, v2 = view(imgs, *d1), view(imgs, *d2)

        def loss_fn(p):
            both = jnp.concatenate([v1, v2], axis=0)
            out, mut = jmodel.apply({"params": p, "batch_stats": batch_stats},
                                    both, train=True,
                                    mutable=["batch_stats"])
            return j_nt_xent_loss(out[:bs], out[bs:], cfg.temperature), mut

        (loss, mut), grads = jax.value_and_grad(loss_fn,
                                                has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), mut["batch_stats"],
                opt_state, loss)

    trainer = P.SimCLRTrainer(model, total, cfg)
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    for i in range(2):
        rows = rng.permutation(n)[:bs]
        d1, d2 = _draws(rng, bs), _draws(rng, bs)
        params, stats, opt_state, j_loss = j_step(
            params, stats, opt_state, images[rows],
            *(tuple(jnp.asarray(x) for x in d) for d in (d1, d2)))
        loss = trainer.step(torch.from_numpy(images[rows]),
                            *(tuple(torch.from_numpy(x) for x in d)
                              for d in (d1, d2)))
        np.testing.assert_allclose(float(loss), float(j_loss), atol=1e-4,
                                   rtol=1e-4)
    want = from_jax_variables(_np(params)["backbone"],
                              _np(stats)["backbone"])
    got = model.backbone.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-4,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("tf32", [True, False], ids=["tf32-on", "tf32-off"])
def test_simclr_step_computes_in_ieee_f32(monkeypatch, tf32):
    """The step's forward and backward run with TF32 off for cuDNN and
    cuBLAS whatever the caller set (cuDNN's default is on), and the
    caller's settings come back after it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    cfg = P.SimCLRConfig(batch_size=2, proj_dim=8)
    with torch.device("cpu"):
        model = P.SimCLRModel(ImageEncoderConfig(**TINY), cfg.proj_dim)
    seen = []

    def flags(*_):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))

    model.backbone.register_forward_hook(flags)
    next(model.backbone.parameters()).register_hook(flags)   # the backward
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    draws = tuple(torch.from_numpy(x) for x in _draws(rng, 2))
    loss = P.SimCLRTrainer(model, 2, cfg).step(torch.from_numpy(images),
                                               draws, draws)
    assert math.isfinite(float(loss))
    assert seen == [(False, False)] * 2
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == (tf32, tf32)


@pytest.mark.parametrize("n,bs,epochs", [(24, 4, 2), (40, 8, 3), (8, 8, 2)])
def test_schedule_and_whole_groups_match_jax(monkeypatch, n, bs, epochs):
    """The warmup-cosine schedule equals optax's at every step of
    ``steps_per_epoch * epochs``; each epoch runs the JAX loop's whole
    groups of ``min(4, steps_per_epoch)`` steps over consecutive slices of
    one permutation (6 steps an epoch run 4; 5 run 4; 1 runs 1)."""
    spe = n // bs
    total = spe * epochs
    warmup = max(int(0.05 * total), 1)
    ours = warmup_cosine_decay_schedule(1e-3, warmup, total)
    theirs = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, total)
    for step in range(total):
        np.testing.assert_allclose(ours(step), float(theirs(step)),
                                   rtol=1e-6, atol=1e-9)
    batches = []
    monkeypatch.setattr(P.SimCLRTrainer, "step",
                        lambda self, u8, d1, d2: batches.append(u8)
                        or torch.zeros(()))
    images = np.arange(n, dtype=np.uint8)[:, None, None, None] * np.ones(
        (1, 8, 8, 3), np.uint8)
    run = P.simclr_pretrain(ImageEncoderConfig(**dict(TINY, image_size=8)),
                            images, P.SimCLRConfig(epochs=epochs,
                                                   batch_size=bs, seed=5),
                            device=CPU)
    # The JAX loop's rows (mpmc_tpu/train/pretrain_image.py).
    k = max(min(4, spe), 1)
    want, rng = [], np.random.default_rng(5)
    for _ in range(epochs):
        perm = rng.permutation(n)
        for start in range(0, spe - k + 1, k):
            want += list(perm[start * bs:(start + k) * bs].reshape(k, bs))
    assert run.steps == len(batches) == len(want) == epochs * (spe // k) * k
    for got, rows in zip(batches, want):
        np.testing.assert_array_equal(got[:, 0, 0, 0].numpy(), rows)


# ---------------------------------------------------------------------------
# The backbone npz between the packages
# ---------------------------------------------------------------------------

def _tiny_cfgs(kind):
    if kind == "image":
        return (ModelConfig(num_classes=2, image=ImageEncoderConfig(**TINY)),
                JModelConfig(num_classes=2,
                             image=JImageEncoderConfig(**TINY)))
    return ModelConfig.tiny_2c(), JModelConfig.tiny_2c()


def _inputs(kind, mcfg):
    rng = np.random.default_rng(2)
    size = mcfg.image.image_size
    x = {"image": rng.integers(0, 256, (3, size, size, 3), dtype=np.uint8)}
    if kind == "multimodal":
        for key, length in (("text", mcfg.max_text_len),
                            ("caption", mcfg.max_caption_len)):
            x[f"{key}_ids"] = rng.integers(5, 512, (3, length)).astype(
                np.int32)
            x[f"{key}_mask"] = (np.arange(length)[None] < np.array(
                [[length], [5], [9]])).astype(np.int32)
    return x


def _jax_logits(kind, jmcfg, variables, x):
    img = np.asarray(eval_preprocess(torch.from_numpy(x["image"])))
    if kind == "image":
        return np.asarray(jax.jit(JImageClassifier(jmcfg).apply)(variables,
                                                                 img))
    return np.asarray(jax.jit(JClassifier(jmcfg).apply)(
        variables, x["text_ids"], x["text_mask"], img, x["caption_ids"],
        x["caption_mask"]))


def _port_logits(kind, model, x):
    with torch.no_grad():
        args = [eval_preprocess(torch.from_numpy(x["image"]))
                if key == "image" else torch.from_numpy(x[key])
                for key in model.inputs]
        return model.eval()(*args).numpy()


def _flax_variables(model, kind):
    params, stats = to_jax_variables(model)
    if kind == "multimodal":
        params["ConcatAttention3_0"] = params.pop("fusion")
        stats["ConcatAttention3_0"] = stats.pop("fusion")
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["image", "multimodal"])
def test_backbone_npz_splices_both_ways(tmp_path, kind, writer):
    """A backbone (parameters and running statistics of another seed)
    written by one package's ``save_image_encoder_params`` splices into
    both packages' 2B or 2C model: the same logits within 1e-4, and the
    port's backbone equal to the file."""
    mcfg, jmcfg = _tiny_cfgs(kind)
    model = build_model(mcfg, CPU, seed=0, kind=kind)
    variables = _flax_variables(model, kind)
    donor = build_model(ModelConfig(image=ImageEncoderConfig(**TINY)), CPU,
                        seed=9, kind="image").backbone
    with torch.no_grad():              # running statistics of their own
        for name, buf in donor.named_buffers():
            buf.copy_(torch.rand(buf.shape) + (0.5 if "var" in name else 0))
    path = str(tmp_path / "simclr_backbone.npz")
    if writer == "jax":
        j_save_image_encoder_params(*to_jax_variables(donor), path)
    else:
        P.save_image_encoder_params(donor, path)
    apply_pretrained(model, kind, PretrainedSpec(image=path))
    backbone = model.get_submodule(port_pretrained.IMAGE_SUBMODULE[kind])
    for name, w in donor.state_dict().items():
        assert torch.equal(backbone.state_dict()[name], w), name
    spliced = j_apply_pretrained(variables, jmcfg, kind,
                                 JPretrainedSpec(image=path))
    x = _inputs(kind, mcfg)
    np.testing.assert_allclose(_port_logits(kind, model, x),
                               _jax_logits(kind, jmcfg, spliced, x),
                               atol=1e-4, rtol=1e-4)


def test_image_params_refuses_what_is_not_ported(tmp_path):
    """A file that is not the marked SimCLR npz is a torchvision/timm/HF
    state dict: without the arch it is refused, the tiny ResNet has no
    converter (in the JAX package neither), and an incomplete one or a
    missing file raises."""
    model = build_model(ModelConfig(num_classes=2,
                                    image=ImageEncoderConfig(**TINY)), CPU,
                        kind="image")
    np.savez(tmp_path / "tv.npz", **{"conv1.weight": np.zeros((4, 3, 7, 7))})
    with pytest.raises(ValueError, match="needs the backbone's arch"):
        read_image_params(str(tmp_path / "tv.npz"))
    with pytest.raises(ValueError, match="no converter"):
        apply_pretrained(model, "image",
                         PretrainedSpec(image=str(tmp_path / "tv.npz")))
    with pytest.raises(KeyError, match="bn1"):
        read_image_params(str(tmp_path / "tv.npz"), "resnet18")
    with pytest.raises(FileNotFoundError):
        read_image_params(str(tmp_path / "resnet.pth"), "resnet18")
    path = str(tmp_path / "short.npz")
    params, _ = to_jax_variables(model.backbone)
    params.pop(sorted(params)[0])
    np.savez(path, **{f"params/{k}": v
                      for k, v in flatten_params(params).items()},
             **{FLAX_IMAGE_MARKER: np.asarray(1)})
    with pytest.raises(ValueError, match="leaf sets differ"):
        apply_pretrained(model, "image", PretrainedSpec(image=path))
    with pytest.raises(ValueError, match="no text encoder"):
        apply_pretrained(model, "image", PretrainedSpec(text=path))
    text = build_model(ModelConfig.small_2a(), CPU, kind="text")
    with pytest.raises(ValueError, match="no image backbone"):
        apply_pretrained(text, "text", PretrainedSpec(image=path))


# ---------------------------------------------------------------------------
# train --simclr-epochs
# ---------------------------------------------------------------------------

def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg", "text": "نص كلمة",
             "class_label": ("propaganda" if rng.random() < 0.35
                             else "not_propaganda")} for i in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


# (subtask, flags, kind): 2B with a tiny ResNet at 32, the tiny 2C.
SIMCLR_RUNS = [("2b", ["--image-arch", "tiny_resnet", "--image-size", "32"],
                "image"),
               ("2c", ["--tiny"], "multimodal")]


@pytest.mark.parametrize("subtask,flags,kind", SIMCLR_RUNS,
                         ids=[r[0] for r in SIMCLR_RUNS])
def test_train_simclr_stage_on_cpu(tmp_path, monkeypatch, subtask, flags,
                                   kind):
    """``train --simclr-epochs 2`` pretrains over the train images (batch
    min(4 x 8, 24) = 24: one step an epoch), writes
    ``simclr_backbone.npz``, and the fold starts from it; the JAX
    ``apply_pretrained`` splices the file into the same model's flax
    trees; for 2B, ``--image-params`` with the file skips the stage."""
    monkeypatch.chdir(tmp_path)
    _write_manifest("train.json", 24, 0)
    _write_manifest("dev.json", 8, 1, off=1000)
    runs, spliced = [], []
    pretrain, splice = (P.simclr_pretrain,
                        port_pretrained.apply_pretrained)

    def counted(*args, **kwargs):
        runs.append(pretrain(*args, **kwargs))
        return runs[-1]

    def watched(model, kind_, spec):
        out = splice(model, kind_, spec)
        spliced.append((spec.image, {
            k: v.clone() for k, v in model.get_submodule(
                port_pretrained.IMAGE_SUBMODULE[kind_]).state_dict().items()}))
        return out

    monkeypatch.setattr(P, "simclr_pretrain", counted)
    monkeypatch.setattr(port_pretrained, "apply_pretrained", watched)
    base = ["train", "--subtask", subtask, "-tr", "train.json", "-te",
            "dev.json", *flags, "--device", "cpu", "--fold", "0",
            "--epochs", "1", "--batch-size", "8"]
    assert main(base + ["--simclr-epochs", "2", "--out-dir", "out"]) == 0
    path = "out/simclr_backbone.npz"
    assert len(runs) == 1 and runs[0].steps == 2
    assert all(math.isfinite(x) for x in runs[0].epoch_losses)
    assert spliced[0][0] == path
    tree = read_image_params(path)
    assert tree["batch_stats"], "running statistics missing from the npz"
    for name, w in from_jax_variables(tree["params"],
                                      tree["batch_stats"]).items():
        assert torch.equal(spliced[0][1][name], w), name
    with open("out/run_meta.json") as f:
        meta = json.load(f)
    from mpmc_tpu_torch.config import model_config_from_dict
    mcfg = model_config_from_dict(meta["model"])
    jmcfg = _jax_config(meta["model"])
    model = build_model(mcfg, CPU, seed=0, kind=kind)
    variables = j_apply_pretrained(_flax_variables(model, kind), jmcfg,
                                   kind, JPretrainedSpec(image=path))
    where = ("backbone",) if kind == "image" else ("image_model",
                                                   "backbone")
    got = variables["params"]
    for p in where:
        got = got[p]
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_flatten_with_path(tree["params"])[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=str(kp))
    if subtask == "2c":
        return
    assert main(base + ["--simclr-epochs", "2", "--out-dir", "out2",
                        "--image-params", path]) == 0
    assert len(runs) == 1 and not (tmp_path / "out2" /
                                   "simclr_backbone.npz").exists()
    assert spliced[-1][0] == path


def _jax_config(d):
    from mpmc_tpu.config import model_config_from_dict
    return model_config_from_dict(d)


def test_simclr_on_grayscale_is_refused_by_both(tmp_path, monkeypatch):
    """The grayscale tiny ResNet cannot run the stage: the augmentation's
    fused pass normalizes three channels.  The port refuses it before any
    step; the JAX ``run_subtask_2b`` fails too."""
    monkeypatch.chdir(tmp_path)
    _write_manifest("train.json", 8, 0)
    image = dict(arch="tiny_resnet", image_size=32, grayscale=True)
    data = dict(train_manifest="train.json", dev_manifest="train.json",
                batch_size=2)
    cfg = TrainConfig(model=ModelConfig(image=ImageEncoderConfig(**image)),
                      data=DataConfig(**data), epochs=1, simclr_epochs=1)
    with pytest.raises(ValueError, match="SimCLR takes color images"):
        run_subtask_2b(cfg, CPU, out_dir="out", folds=[0])
    jcfg = JTrainConfig(
        model=JModelConfig(image=JImageEncoderConfig(**image)),
        data=JDataConfig(**data), epochs=1, simclr_epochs=1)
    with pytest.raises(Exception) as failure:
        j_run_subtask_2b(jcfg, out_dir="jout", folds=[0])
    assert not (tmp_path / "jout" / "simclr_backbone.npz").exists()
    assert failure.type.__module__.split(".")[0] in ("flax", "jax",
                                                     "builtins")
