"""The port's 2B image zoo (mpmc_tpu_torch/models/vit.py, efficientnet.py,
convnext.py, the factory in classifier.py and the weight bridge) against
the JAX package's flax modules, and the attention pair at ViT's sequence
lengths against the Pallas kernels in interpret mode.

Weights come from a numpy seed, filled into the flax tree of each module
and carried to the port through ``from_jax_variables``; both sides run in
f32."""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpmc_tpu.config import ImageEncoderConfig as JImageEncoderConfig
from mpmc_tpu.models.classifier import create_image_backbone as j_backbone
from mpmc_tpu.models.convnext import ConvNeXt as JConvNeXt
from mpmc_tpu.models.efficientnet import EfficientNet as JEfficientNet
from mpmc_tpu.models.vit import ViT as JViT
from mpmc_tpu.ops.attention import _bwd_pallas, _fwd_pallas
from mpmc_tpu_torch.config import ImageEncoderConfig
from mpmc_tpu_torch.models.classifier import (create_image_backbone,
                                              init_weights)
from mpmc_tpu_torch.models.convert import _param, from_jax_variables
from mpmc_tpu_torch.models.convnext import ConvNeXt
from mpmc_tpu_torch.models.efficientnet import EfficientNet
from mpmc_tpu_torch.models.vit import ViT
from mpmc_tpu_torch.ops import attention as A

TOL = 1e-4


def _random_variables(tree, seed):
    """The flax variable tree ``tree`` (shapes only) filled from a numpy
    seed: fan-in scaled kernels, small biases, norm scales and batch
    variances in [0.5, 1.5], and a ViT's class token and positions and
    ConvNeXt's layer scale large enough to matter."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        shape = x.shape
        if name == "kernel":
            fan_in = (shape[0] if len(shape) == 3 and parent != "out"
                      else int(np.prod(shape[:-1])))
            return rng.standard_normal(shape) / np.sqrt(fan_in)
        if name in ("scale", "var", "gamma"):
            return rng.uniform(0.5, 1.5, shape)
        if name in ("cls_token", "pos_embed"):
            return 0.5 * rng.standard_normal(shape)
        return 0.1 * rng.standard_normal(shape)       # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, x: fill(p, x).astype(np.float32), tree)


# name: (flax module, port module, input [B, H, W, C]).  EfficientNet runs
# at 64 pixels: at 32 its last stages are 1x1, and training BatchNorm over
# a handful of values amplifies f32 rounding past the tolerance.
ZOO = {
    "vit-p8": (lambda: JViT(patch_size=8, hidden_size=32, num_layers=2,
                            num_heads=2, mlp_dim=64),
               lambda: ViT(32, patch_size=8, hidden_size=32, num_layers=2,
                           num_heads=2, mlp_dim=64), (3, 32, 32, 3)),
    "vit-p32": (lambda: JViT(patch_size=32, hidden_size=32, num_layers=2,
                             num_heads=2, mlp_dim=64),
                lambda: ViT(64, patch_size=32, hidden_size=32, num_layers=2,
                            num_heads=2, mlp_dim=64), (3, 64, 64, 3)),
    "efficientnet-b0": (lambda: JEfficientNet("b0"),
                        lambda: EfficientNet("b0"), (4, 64, 64, 3)),
    "convnext-narrow": (lambda: JConvNeXt(depths=(1, 1, 2, 1),
                                          dims=(8, 16, 24, 32)),
                        lambda: ConvNeXt(depths=(1, 1, 2, 1),
                                         dims=(8, 16, 24, 32)),
                        (3, 32, 32, 3)),
}


@pytest.fixture(scope="module")
def flax_zoo():
    """Each module's random variables, input, and the flax outputs in eval
    and in train mode (with the updated batch statistics)."""
    out = {}
    for i, (name, (make_j, _, shape)) in enumerate(ZOO.items()):
        jm = make_j()
        x = np.random.default_rng(100 + i).standard_normal(shape).astype(
            np.float32)
        tree = jax.eval_shape(jm.init, jax.random.key(0),
                              jax.ShapeDtypeStruct(shape, jnp.float32))
        variables = _random_variables(tree, i)
        jv = jax.tree_util.tree_map(jnp.asarray, variables)
        y_eval, (y_train, upd) = jax.jit(lambda v, x: (
            jm.apply(v, x, train=False),
            jm.apply(v, x, train=True, mutable=["batch_stats"])))(jv, x)
        out[name] = dict(variables=variables, x=x, eval=np.asarray(y_eval),
                         train=np.asarray(y_train),
                         stats=jax.tree_util.tree_map(np.asarray,
                                                      upd.get("batch_stats",
                                                              {})))
    return out


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", list(ZOO))
def test_backbone_matches_flax(flax_zoo, name, mode):
    """Features within 1e-4 after the bridge, which maps every leaf (no
    missing, no unexpected key); in train mode BatchNorm uses the batch
    statistics and updates the running ones as flax does."""
    ref = flax_zoo[name]
    v = ref["variables"]
    model = ZOO[name][1]()
    sd = from_jax_variables(v["params"], v.get("batch_stats"))
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    model.train(mode == "train")
    with torch.no_grad():
        got = model(torch.from_numpy(ref["x"])).numpy()
    assert got.shape == ref[mode].shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref[mode], atol=TOL, rtol=0)
    if mode == "train" and ref["stats"]:
        want = from_jax_variables({}, ref["stats"])
        now = model.state_dict()
        for key, w in want.items():
            np.testing.assert_allclose(now[key].numpy(), w.numpy(),
                                       atol=1e-5, rtol=0, err_msg=key)


def _flax_shapes(tree) -> dict:
    """The port's ``state_dict`` key and shape of every leaf of a flax
    variable tree of shapes, by the bridge's own rule (``_param``), without
    materializing the weights."""
    shapes = {}

    def walk(node, path, stats):
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (name,), stats)
                continue
            if stats:
                leaf, shape = {"mean": "running_mean",
                               "var": "running_var"}[name], val.shape
            else:
                leaf, x = _param(path, name,
                                 np.broadcast_to(np.float32(0), val.shape))
                shape = x.shape
            shapes[".".join(path + (leaf,))] = tuple(shape)

    walk(tree["params"], (), False)
    walk(tree.get("batch_stats", {}), (), True)
    return shapes


# Every arch the JAX factory takes, each with its aliases (arch, aliases,
# image_size, feature_dim, port class); only a ViT's tree depends on the
# size.
ARCHS = [
    ("vit_base_16", ("vit_base_patch16_224",), 224, 768, ViT),
    ("vit_base_16", ("vit_base_patch16_384",), 384, 768, ViT),
    ("vit_base_32", ("clip_vit_b32",), 224, 768, ViT),
    ("vit_large_16", ("vit_large_patch16_384",), 384, 1024, ViT),
    ("convnext_tiny", (), 224, 768, ConvNeXt),
    ("efficientnet_b0", (), 224, 1280, EfficientNet),
    ("efficientnet_b1", (), 224, 1280, EfficientNet),
    ("efficientnet_b2", (), 224, 1408, EfficientNet),
    ("efficientnet_b3", (), 384, 1536, EfficientNet),
    ("efficientnet_b4", (), 384, 1792, EfficientNet),
]


@pytest.mark.parametrize("arch,aliases,size,feature_dim,cls", ARCHS,
                         ids=[f"{a[0]}-{a[2]}" for a in ARCHS])
def test_factory_builds_the_full_width_trees(arch, aliases, size,
                                             feature_dim, cls):
    """At full width, on the meta device: every name and alias builds the
    class, feature width and parameter tree of the flax backbone, key for
    key and shape for shape through the bridge (a ViT's positions follow
    the image size)."""
    jm = j_backbone(JImageEncoderConfig(arch=arch, image_size=size))
    tree = jax.eval_shape(jm.init, jax.random.key(0),
                          jax.ShapeDtypeStruct((1, size, size, 3),
                                               jnp.float32))
    want = _flax_shapes(tree)
    for name in (arch,) + aliases:
        with torch.device("meta"):
            model = create_image_backbone(ImageEncoderConfig(
                arch=name, image_size=size))
        assert type(model) is cls and model.feature_dim == feature_dim
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        assert got == want
    with pytest.raises(ValueError, match="Unknown image arch"):
        create_image_backbone(ImageEncoderConfig(arch="densenet161"))


def test_init_weights_initializes_the_new_parameters():
    """Random weights from the seed: a ViT's class token zero and its
    positions normal(0, 0.02), as flax initializes them; ConvNeXt's layer
    scale at 1e-6; the same seed gives the same weights."""
    makers = (lambda: ViT(64, patch_size=16, hidden_size=96, num_layers=1,
                          num_heads=2, mlp_dim=8),
              lambda: ConvNeXt(depths=(1, 1, 2, 1), dims=(8, 16, 24, 32)))
    for make in makers:
        model, again = make(), make()
        for m in (model, again):
            init_weights(m, torch.Generator().manual_seed(3))
        for key, val in model.state_dict().items():
            assert torch.equal(val, again.state_dict()[key]), key
        if isinstance(model, ViT):
            assert model.pos_embed.shape == (1, 1 + 4 * 4, 96)
            assert torch.equal(model.cls_token, torch.zeros(1, 1, 96))
            assert abs(float(model.pos_embed.detach().std()) - 0.02) < 0.005
        else:
            gammas = [p for n, p in model.named_parameters()
                      if n.endswith("gamma")]
            assert len(gammas) == 5
            assert all(torch.all(g == 1e-6) for g in gammas)


# ---------------------------------------------------------------------------
# The attention pair at ViT's sequence lengths
# ---------------------------------------------------------------------------

# 1 + (size / patch)^2: ViT-B/32 at 224, B/16 and L/16 at 224, and at 384.
# B = H = 1 and D = 8 keep interpret mode quick.
VIT_SEQ = [50, 197, 577]


def _qkv(S, seed, D=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, 1, D)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("S", VIT_SEQ)
def test_plain_forward_matches_pallas_at_vit_lengths(S):
    q, k, v, _ = _qkv(S, S)
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), None, "none",
                                         1.0 / np.sqrt(8))
    out, lse = A.attention_forward_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), None, "none")
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", VIT_SEQ)
def test_plain_backward_matches_pallas_at_vit_lengths(S, dtype):
    """Both sides get the same q, k, v, out, lse and dO; bf16 rounds P and
    dS at the same points (see test_torch_attention_bwd.py)."""
    q, k, v, do = _qkv(S, S + 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(8)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _fwd_pallas(jq, jk, jv, None, "none", scale)
        want = _bwd_pallas("none", scale, (jq, jk, jv, None, out, lse),
                           jdo)[:3]
    got = A.attention_backward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), None, "none",
        torch.from_numpy(np.asarray(out.astype(jnp.float32))).to(tdt),
        torch.from_numpy(np.asarray(lse)), torch.from_numpy(do).to(tdt))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("Sq,Sk", [(A.MAX_SEQ + 1, 8), (8, A.MAX_SEQ + 1)])
def test_kernel_wrappers_refuse_sequences_above_the_cap(Sq, Sk):
    """Above the cap both wrappers raise before anything else, whatever
    the device; at the cap a CPU tensor gets as far as the device check."""
    q = torch.zeros(1, Sq, 1, 8)
    k = torch.zeros(1, Sk, 1, 8)
    with pytest.raises(ValueError, match=f"Sq, Sk <= {A.MAX_SEQ}"):
        A.attention_forward_cuda(q, k, k, None, "none")
    lse = torch.zeros(1, 1, Sq)
    with pytest.raises(ValueError, match=f"Sq, Sk <= {A.MAX_SEQ}"):
        A.attention_backward_cuda(q, k, k, None, "none", q, lse, q)
    at_cap = torch.zeros(1, A.MAX_SEQ, 1, 8)
    with pytest.raises(ValueError, match="CUDA device"):
        A.attention_forward_cuda(at_cap, at_cap, at_cap, None, "none")
