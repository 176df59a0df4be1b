"""The plain reference against the PyTorch port at tiny widths on the CPU, in
float32: each model kind's training-mode forward (with the dropout masks
the port drew, as the benchmark records them), loss and gradients from the
same weights, and the recipe's optimizer over a few steps."""

import copy

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.data import make_memes
from portbench.drivers.common import bucket, train_config
from portbench.drivers.train import Recorder
from portbench.reference import nets, train as ref_train
from portbench.weights import make_weights
from tiny import tiny_config

CPU = torch.device("cpu")


# The port's dropout modules with a rate, in a tiny model of each
# configuration (two encoder layers): each encoder's embeddings and two a
# layer; the 2C head's three; ViT has none.
DROPOUTS = {"2c_flagship": 2 * (1 + 2 * 2) + 3, "2b_vit_b16_384": 0,
            "2a_arabert": 1 + 2 * 2}


@pytest.mark.parametrize("config", sorted(DROPOUTS))
def test_forward_loss_gradients_match_the_port(config):
    from mpmc_tpu_torch.models.classifier import build_model
    from mpmc_tpu_torch.train.step import loss_from_outputs

    cfg = tiny_config(config)
    tc = train_config(cfg, 7, CPU)
    traffic = {"propaganda_share": 0.5, "words_median": 6, "words_sigma": 0.5,
               "words_min": 3, "words_max": 20, "caption_tokens_min": 4,
               "caption_tokens_max": 12}
    data = make_memes(cfg, traffic, 6, 7, 0, CPU)
    bucket(tc, [data])
    W = make_weights(cfg, 7, CPU)
    kind = spec.kind(cfg["kind"])
    model = build_model(tc.model, CPU, kind=kind.PORT_KIND)
    model.load_state_dict(W)
    model.train()
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    if "image" in batch:
        batch["image"] = nets.normalize(batch["image"])
    valid = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.float32)

    rec = Recorder(1)
    rec.attach(model)
    out = model(*[batch[k] for k in model.inputs])
    batch["drop"] = rec.steps()[0]["drop"]
    assert len(batch["drop"]) == DROPOUTS[config]
    loss = loss_from_outputs(out, batch["label"], valid, tc)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True)

    leaves = {n: W[n].clone().requires_grad_() for n in names}
    ref_out = kind.logits({**W, **leaves}, cfg, batch, True)
    ref_loss = torch.sum(ref_train.row_losses(ref_out, batch["label"], cfg)
                         * valid) / valid.sum()
    ref_grads = torch.autograd.grad(ref_loss, list(leaves.values()),
                                    allow_unused=True)

    # A training-mode BatchNorm over 6 rows (the head's, over one logit)
    # turns float32 rounding into about 1e-4 of the logits, and of the
    # gradients behind it.
    torch.testing.assert_close(out, ref_out, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-3, atol=1e-6)
    scale = max(float(g.abs().max()) for g in ref_grads if g is not None)
    for n, g, r in zip(names, grads, ref_grads):
        g = torch.zeros_like(W[n]) if g is None else g
        r = torch.zeros_like(W[n]) if r is None else r
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * scale,
                                   msg=lambda m, n=n: f"{n}: {m}")


@pytest.mark.parametrize("mu_dtype,rtol", [(None, 1e-5), ("bfloat16", 2e-2)])
def test_optimizer_matches_the_port(mu_dtype, rtol):
    """Clip, grouped Adam (the first moment in ``mu_dtype``), factored RMS
    on a word-embedding table and the warmup schedule, three steps."""
    from mpmc_tpu_torch.train.step import Optimizer

    cfg = copy.deepcopy(tiny_config("2c_flagship"))
    cfg["recipe"].update(adam_mu_dtype=mu_dtype, warmup_fraction=0.3,
                         grad_clip_norm=0.5, learning_rate=1e-2)
    tc = train_config(cfg, 1, CPU)
    shapes = {"text_model.word_embeddings.weight": (300, 128),
              "text_model.layer_0.attention.query.weight": (16, 16),
              "image_model.finetune_fc1.bias": (16,),
              "output_fc.weight": (1, 16), "fusion.gated.gate_fc.bias": (16,)}
    g = torch.Generator().manual_seed(3)
    # Small weights, so that float32 resolves each change finely.
    start = {n: torch.randn(s, generator=g) * 1e-3
             for n, s in shapes.items()}
    port = {n: p.clone() for n, p in start.items()}
    ref = {n: p.clone() for n, p in start.items()}
    total = 10
    popt = Optimizer(tc, total, port)
    ropt = ref_train.Optimizer(cfg, ref, total)
    for _ in range(4):
        grads = {n: torch.randn(s, generator=g) * 0.3
                 for n, s in shapes.items()}
        grads["text_model.word_embeddings.weight"][::3] = 0.0
        popt.step({n: v.clone() for n, v in grads.items()},
                  Optimizer.global_norm(list(grads.values())))
        ropt.step(ref_train.Optimizer.clip(grads, 0.5))
    for n in shapes:
        want = ref[n] - start[n]
        torch.testing.assert_close(port[n] - start[n], want, rtol=rtol,
                                   atol=10 * rtol * float(want.abs().max()),
                                   msg=lambda m, n=n: f"{n}: {m}")


def test_constant_schedule_matches_the_port():
    """2A's constant rate: Adam at the head's rate, factored RMS at the
    encoder's, the same at every step (no warmup, no decay)."""
    from mpmc_tpu_torch.train.step import Optimizer

    cfg = copy.deepcopy(tiny_config("2a_arabert"))
    cfg["recipe"].update(adam_mu_dtype=None, learning_rate=1e-2)
    tc = train_config(cfg, 1, CPU)
    shapes = {"encoder.word_embeddings.weight": (300, 128),
              "encoder.layer_0.attention.query.weight": (16, 16),
              "output.weight": (2, 16)}
    g = torch.Generator().manual_seed(4)
    start = {n: torch.randn(s, generator=g) * 1e-3 for n, s in shapes.items()}
    port = {n: p.clone() for n, p in start.items()}
    ref = {n: p.clone() for n, p in start.items()}
    popt = Optimizer(tc, 10, port)
    ropt = ref_train.Optimizer(cfg, ref, 10)
    for _ in range(3):
        grads = {n: torch.randn(s, generator=g) * 0.3
                 for n, s in shapes.items()}
        popt.step({n: v.clone() for n, v in grads.items()},
                  Optimizer.global_norm(list(grads.values())))
        ropt.step(ref_train.Optimizer.clip(grads, 1.0))
    for n in shapes:
        want = ref[n] - start[n]
        torch.testing.assert_close(port[n] - start[n], want, rtol=1e-5,
                                   atol=1e-4 * float(want.abs().max()),
                                   msg=lambda m, n=n: f"{n}: {m}")


def test_learning_rate_schedule():
    lr = [ref_train.learning_rate(1.0, s, 20, 0.1) for s in range(21)]
    assert lr[0] == 0.0 and lr[1] == 0.5 and lr[2] == 1.0
    assert lr[20] == 0.0 and np.isclose(lr[11], 0.5)


def test_recorder_keeps_each_checked_step_at_its_slot():
    """Step j's logits and dropout masks land in slot j; steps past the
    checked ones, and calls in eval mode, leave the slots as they were."""
    from mpmc_tpu_torch.models.classifier import build_model

    cfg = tiny_config("2c_flagship")
    tc = train_config(cfg, 5, CPU)
    traffic = {"propaganda_share": 0.5, "words_median": 6, "words_sigma": 0.5,
               "words_min": 3, "words_max": 20, "caption_tokens_min": 4,
               "caption_tokens_max": 12}
    data = make_memes(cfg, traffic, 4, 5, 0, CPU)
    bucket(tc, [data])
    model = build_model(tc.model, CPU, kind=spec.kind(cfg["kind"]).PORT_KIND)
    model.load_state_dict(make_weights(cfg, 5, CPU))
    batch = {k: torch.from_numpy(v) for k, v in data.items()}
    batch["image"] = nets.normalize(batch["image"])
    rec = Recorder(2)
    rec.attach(model)
    seen = []
    with torch.no_grad():
        for mode in ("train", "eval", "train", "train"):
            getattr(model, mode)()
            seen.append(model(*[batch[k] for k in model.inputs]))
    steps = rec.steps()
    torch.testing.assert_close(steps[0]["logits"], seen[0], rtol=0, atol=0)
    torch.testing.assert_close(steps[1]["logits"], seen[2], rtol=0, atol=0)
    assert not torch.equal(steps[0]["drop"]["text_fc.dropout"],
                           steps[1]["drop"]["text_fc.dropout"])
    rec.detach()
    assert rec.rings == {} and not model._forward_hooks
