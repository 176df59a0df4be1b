"""The FLOP and byte counters against shapes worked by hand."""

import numpy as np
import pytest

from portbench import spec
from portbench.counts import PEAKS, attention, flops


def test_attention_bounds_at_vit_384():
    """[16, 577, 12, 64] in bf16: the forward's 4 B H S^2 D operations and
    q, k, v, out once; the backward's 10 B H S^2 D and eight tensors."""
    B, S, H, D = 16, 577, 12, 64
    ops, nbytes = attention.forward(np.full(B, S), H * D)
    assert ops.sum() == 4 * B * H * S * S * D == 16_364_126_208
    assert nbytes.sum() == 4 * B * S * H * D * 2
    fwd = attention.bound_seconds(ops.sum(), nbytes.sum(), PEAKS)
    assert fwd == pytest.approx(nbytes.sum() / 3.35e12)     # bytes bound it
    # The kernel table's bound also moves the f32 log-sum-exp, B H S f32:
    lse = B * H * S * 4
    assert attention.bound_seconds(ops.sum(), nbytes.sum() + lse, PEAKS) \
        * 1e3 == pytest.approx(0.017064, abs=5e-7)
    bops, bbytes = attention.backward(np.full(B, S), H * D)
    assert bops.sum() == 10 * B * H * S * S * D
    assert bbytes.sum() == 8 * B * S * H * D * 2
    assert attention.bound_seconds(bops.sum(), bbytes.sum(), PEAKS) * 1e3 \
        == pytest.approx(0.041365, abs=5e-7)                 # operations


def test_encoder_flops_by_hand():
    # One layer, 10 tokens, H = 4, I = 8: q, k, v, out 4*2*10*4*4 = 1280;
    # MLP 2*2*10*4*8 = 1280; scores and sum 2*2*10*10*4 = 1600.
    assert flops.encoder(10, 4, 8, 1) == 1280 + 1280 + 1600
    assert list(flops.encoder(np.array([10, 10]), 4, 8, 2)) == [8320] * 2


def test_backbones_by_hand():
    # ResNet-18 at 224: 1.814 GMACs of convolutions (torchvision's count).
    assert flops.resnet18(224) == pytest.approx(2 * 1.8141e9, rel=1e-3)
    # ViT-B/16 at 384: 55.5 GMACs (timm's count).
    vit = spec.config("2b_vit_b16_384")["image_encoder"]
    assert flops.vit(vit) == pytest.approx(2 * 55.48e9, rel=1e-3)


def test_meme_counts_follow_their_own_tokens():
    cfg = spec.config("2c_flagship")
    kind = spec.kind(cfg["kind"])

    def tokens(text, caption):
        return {"text": np.array(text), "caption": np.array(caption)}

    one = kind.forward_flops(cfg, 1, tokens([14], [20]))
    two = kind.forward_flops(cfg, 2, tokens([14, 14], [20, 20]))
    assert two == pytest.approx(2 * one)
    longer = kind.forward_flops(cfg, 1, tokens([15], [20]))
    assert longer > one
    ops, _ = attention.model_need(
        kind.attention_parts(cfg, 1, tokens([14], [20])), train=True)
    assert ops == 12 * 768 * (4 + 10) * (14 ** 2 + 20 ** 2)


def test_text_model_counts_by_hand():
    """2A: the encoder over each meme's own tokens, the pooling's score MLP
    (768 x 512, then 512 x 1) and weighted sum over every token, the
    output Linear to 2; attention over the text alone."""
    cfg = spec.config("2a_arabert")
    kind = spec.kind(cfg["kind"])
    L = np.array([14, 40])
    per_token = 2 * 768 * 512 + 2 * 512 + 2 * 768
    want = (flops.encoder(L, 768, 3072, 12).sum() + L.sum() * per_token
            + 2 * 2 * 768 * 2)
    assert kind.forward_flops(cfg, 2, {"text": L}) == pytest.approx(want)
    ops, nbytes = attention.model_need(kind.attention_parts(cfg, 2,
                                                            {"text": L}))
    assert ops == 12 * 4 * 768 * (14 ** 2 + 40 ** 2)
    assert nbytes == 12 * 4 * 768 * 2 * (14 + 40)
