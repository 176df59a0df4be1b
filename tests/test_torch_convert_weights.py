"""The port's offline weight converters (mpmc_tpu_torch.models.hf_convert,
vision_convert and pretrained) against the JAX package's and against torch
oracles.

Oracles are random-weight torch models in the exact Hugging Face,
torchvision and timm key layouts: ``transformers``' BertModel, RobertaModel,
ViTModel and ConvNextModel, and hand-built ResNet, ResNeXt, SE-ResNeXt (timm
SE) and torchvision-ConvNeXt modules (torchvision and timm are not
installed).  For each: the port's flax-layout tree equals the JAX
converter's key for key and bit for bit, and the port's module loaded from
it gives the oracle's features within 2e-4 (the JAX tests' tolerance) on
the CPU in f32.  Then ``load_state_dict`` on every file format, and
``apply_pretrained`` for every model kind beside the JAX package's on the
same starting weights, with each refusal.  Channel counts are not square
and the BatchNorm statistics and layer scales are random, so a transposed
or misplaced tensor shows."""

import os

# transformers would also import TensorFlow, which none of these tests use
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn as tnn  # noqa: E402

from mpmc_tpu.config import model_config_from_dict as j_cfg_from_dict
from mpmc_tpu.models.hf_convert import convert_bert_state_dict as j_bert
from mpmc_tpu.models.pretrained import PretrainedSpec as JSpec
from mpmc_tpu.models.pretrained import apply_pretrained as j_apply_pretrained
from mpmc_tpu.models.pretrained import load_state_dict as j_load_state_dict
from mpmc_tpu.models.vision_convert import \
    convert_convnext_state_dict as j_convnext
from mpmc_tpu.models.vision_convert import \
    convert_image_state_dict as j_image
from mpmc_tpu.models.vision_convert import convert_resnet_state_dict as j_resnet
from mpmc_tpu.models.vision_convert import convert_vit_state_dict as j_vit
from mpmc_tpu.config import TextEncoderConfig as JTextEncoderConfig
from mpmc_tpu_torch.config import (ImageEncoderConfig, ModelConfig,
                                   TextEncoderConfig, model_config_to_dict)
from mpmc_tpu_torch.models.bert import TextEncoder
from mpmc_tpu_torch.models.classifier import build_model
from mpmc_tpu_torch.models.convert import to_jax_params, to_jax_variables
from mpmc_tpu_torch.models.convnext import ConvNeXt
from mpmc_tpu_torch.models.hf_convert import (convert_bert_state_dict,
                                              read_safetensors)
from mpmc_tpu_torch.models.pretrained import (PretrainedSpec, _load,
                                              apply_pretrained,
                                              flatten_params,
                                              infer_text_config_from_tree,
                                              load_state_dict,
                                              read_image_params,
                                              read_text_params)
from mpmc_tpu_torch.models.resnet import ResNet
from mpmc_tpu_torch.models.vision_convert import (
    convert_convnext_state_dict, convert_image_state_dict,
    convert_resnet_state_dict, convert_vit_state_dict)
from mpmc_tpu_torch.models.vit import ViT

TOL = 2e-4
CPU = torch.device("cpu")


def _transformers():
    return pytest.importorskip("transformers")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread.  On a loaded machine
    (the suite's parallel workers) a pool of threads per process turns each
    small op into a wait at the pool's barrier, many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_sd(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def assert_trees_equal(got, want):
    """Key for key, dtype and bits."""
    g, w = flatten_params(got), flatten_params(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == np.asarray(w[k]).dtype, k
        np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)


def _randomize_bn_stats(model, rng):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.tensor(
                    rng.standard_normal(m.num_features) * 0.1,
                    dtype=torch.float32))
                m.running_var.copy_(torch.tensor(
                    rng.random(m.num_features) * 0.5 + 0.5,
                    dtype=torch.float32))


# ---------------------------------------------------------------------------
# Text: BERT and RoBERTa
# ---------------------------------------------------------------------------

BERT = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position_embeddings=64)
ROBERTA = dict(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4,
               intermediate_size=64, max_position_embeddings=40,
               type_vocab_size=1, pad_token_id=1,
               roberta_style_positions=True, layer_norm_eps=1e-5)


def _hf_text(kind, seed=0, pooler=True):
    tf = _transformers()
    c = BERT if kind == "bert" else ROBERTA
    common = dict(vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                  num_hidden_layers=c["num_layers"],
                  num_attention_heads=c["num_heads"],
                  intermediate_size=c["intermediate_size"],
                  max_position_embeddings=c["max_position_embeddings"],
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    if kind == "bert":
        return tf.BertModel(tf.BertConfig(type_vocab_size=2, **common),
                            add_pooling_layer=pooler).eval()
    return tf.RobertaModel(tf.RobertaConfig(type_vocab_size=1, pad_token_id=1,
                                            **common),
                           add_pooling_layer=pooler).eval()


def _text_cfgs(kind):
    c = BERT if kind == "bert" else ROBERTA
    extra = dict(hidden_dropout=0.0, attention_dropout=0.0)
    return TextEncoderConfig(**c, **extra), JTextEncoderConfig(**c, **extra)


@pytest.mark.parametrize("kind", ["bert", "roberta"])
def test_text_conversion_equals_jax_and_transformers(kind):
    oracle = _hf_text(kind, seed=1)
    sd = _numpy_sd(oracle)
    cfg, jcfg = _text_cfgs(kind)
    tree = convert_bert_state_dict(sd, cfg)
    assert_trees_equal(tree, j_bert(sd, jcfg))
    enc = TextEncoder(cfg)
    _load(enc, tree, {})
    enc.eval()
    rng = np.random.default_rng(0)
    B, S = 3, 16
    ids = rng.integers(2, cfg.vocab_size, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[0, 10:] = 0
    mask[2, 5:] = 0
    if kind == "roberta":
        ids[mask == 0] = cfg.pad_token_id
    with torch.no_grad():
        ref = oracle(torch.tensor(ids), attention_mask=torch.tensor(mask))
        hidden, pooled = enc(torch.tensor(ids), torch.tensor(mask),
                             return_pooled=True)
    # RoBERTa on its valid positions, as the JAX test compares it (nothing
    # reads a padded position's output)
    valid = mask == 1 if kind == "roberta" else np.ones_like(mask, bool)
    np.testing.assert_allclose(hidden.numpy()[valid],
                               ref.last_hidden_state.numpy()[valid],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pooled.numpy(), ref.pooler_output.numpy(),
                               atol=TOL, rtol=TOL)
    assert infer_text_config_from_tree(tree) == TextEncoderConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size,
        max_position_embeddings=cfg.max_position_embeddings,
        type_vocab_size=cfg.type_vocab_size)


# ---------------------------------------------------------------------------
# ResNet family: torchvision / timm layout oracles
# ---------------------------------------------------------------------------

class _TimmSE(tnn.Module):
    """timm's SEModule: 1x1 convs ``fc1``/``fc2`` around a ReLU."""

    def __init__(self, ch):
        super().__init__()
        hidden = max(int(ch / 16), 8)
        self.fc1 = tnn.Conv2d(ch, hidden, 1)
        self.fc2 = tnn.Conv2d(hidden, ch, 1)

    def forward(self, x):
        s = self.fc2(torch.relu(self.fc1(x.mean(dim=(2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _TorchBlock(tnn.Module):
    """torchvision BasicBlock (``width is None``) or Bottleneck, with
    timm's SE gate after the last BatchNorm when ``se``."""

    def __init__(self, cin, planes, stride, bottleneck, groups=1,
                 base_width=64, se=False):
        super().__init__()
        if bottleneck:
            w = int(planes * (base_width / 64.0)) * groups
            cout = planes * 4
            self.conv1 = tnn.Conv2d(cin, w, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(w)
            self.conv2 = tnn.Conv2d(w, w, 3, stride, 1, groups=groups,
                                    bias=False)
            self.bn2 = tnn.BatchNorm2d(w)
            self.conv3 = tnn.Conv2d(w, cout, 1, bias=False)
            self.bn3 = tnn.BatchNorm2d(cout)
        else:
            cout = planes
            self.conv1 = tnn.Conv2d(cin, cout, 3, stride, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(cout)
            self.conv2 = tnn.Conv2d(cout, cout, 3, 1, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(cout)
        self.bottleneck = bottleneck
        self.se = _TimmSE(cout) if se else None
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, cout, 1, stride, bias=False),
                tnn.BatchNorm2d(cout))
        self.cout = cout

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.bottleneck:
            y = self.bn3(self.conv3(torch.relu(y)))
        if self.se is not None:
            y = self.se(y)
        return torch.relu(y + idt)


class _TorchResNet(tnn.Module):
    """torchvision.models.resnet.ResNet's module tree and keys."""

    def __init__(self, depths, widths, bottleneck=False, groups=1,
                 base_width=64, se=False, num_classes=10):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, widths[0], 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(widths[0])
        cin = widths[0]
        for li, (depth, width) in enumerate(zip(depths, widths), 1):
            blocks = []
            for bi in range(depth):
                stride = 2 if (bi == 0 and li > 1) else 1
                blocks.append(_TorchBlock(cin, width, stride, bottleneck,
                                          groups, base_width, se))
                cin = blocks[-1].cout
            setattr(self, f"layer{li}", tnn.Sequential(*blocks))
        self.fc = tnn.Linear(cin, num_classes)

    def forward(self, x):
        y = tnn.functional.max_pool2d(
            torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for li in (1, 2, 3, 4):
            y = getattr(self, f"layer{li}")(y)
        return y.mean(dim=(2, 3))


def _resnet_oracle(seed, depths, widths, **kw):
    torch.manual_seed(seed)
    oracle = _TorchResNet(depths, widths, **kw)
    _randomize_bn_stats(oracle, np.random.default_rng(seed))
    return oracle.eval()


RESNETS = {
    "resnet18": (dict(depths=(2, 2, 2, 2), widths=(16, 24, 40, 56)),
                 dict(block="basic")),
    "resnext": (dict(depths=(1, 1, 1, 1), widths=(8, 16, 24, 32),
                     bottleneck=True, groups=4, base_width=8),
                dict(block="bottleneck", groups=4, base_width=8)),
    "seresnext": (dict(depths=(1, 2, 1, 1), widths=(8, 16, 24, 32),
                       bottleneck=True, groups=4, base_width=8, se=True),
                  dict(block="bottleneck", groups=4, base_width=8,
                       use_se=True)),
}


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_conversion_equals_jax_and_oracle(name):
    okw, pkw = RESNETS[name]
    oracle = _resnet_oracle(3, **okw)
    sd = _numpy_sd(oracle)
    got = convert_resnet_state_dict(sd)
    assert_trees_equal(got, j_resnet(sd))
    net = ResNet(okw["depths"], okw["widths"], stem_width=okw["widths"][0],
                 **pkw)
    _load(net, got["params"], got["batch_stats"])
    net.eval()
    x = np.random.default_rng(1).standard_normal((2, 48, 40, 3)
                                                 ).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.tensor(x).permute(0, 3, 1, 2)).numpy()
        out = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    # the classifier head only on request, as in the JAX package
    with_head = convert_resnet_state_dict(sd, num_classes=10)
    assert_trees_equal(with_head, j_resnet(sd, num_classes=10))
    assert with_head["params"]["classifier"]["kernel"].shape == (
        oracle.fc.in_features, 10)


# ---------------------------------------------------------------------------
# ViT: HF ViTModel and the timm layout built from its tensors
# ---------------------------------------------------------------------------

def _hf_vit(seed, hidden=64, heads=4):
    tf = _transformers()
    cfg = tf.ViTConfig(hidden_size=hidden, num_hidden_layers=2,
                       num_attention_heads=heads, intermediate_size=96,
                       image_size=32, patch_size=16, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    torch.manual_seed(seed)
    oracle = tf.ViTModel(cfg, add_pooling_layer=False).eval()
    with torch.no_grad():       # a non-zero class token and positions
        oracle.embeddings.cls_token.normal_()
        oracle.embeddings.position_embeddings.normal_(0, 0.5)
    return oracle


def _timm_from_hf(hf):
    timm = {"cls_token": hf["embeddings.cls_token"],
            "pos_embed": hf["embeddings.position_embeddings"],
            "patch_embed.proj.weight":
                hf["embeddings.patch_embeddings.projection.weight"],
            "patch_embed.proj.bias":
                hf["embeddings.patch_embeddings.projection.bias"],
            "norm.weight": hf["layernorm.weight"],
            "norm.bias": hf["layernorm.bias"]}
    for i in range(2):
        h, t = f"encoder.layer.{i}.", f"blocks.{i}."
        for ours, theirs in (("norm1", "layernorm_before"),
                             ("norm2", "layernorm_after"),
                             ("attn.proj", "attention.output.dense"),
                             ("mlp.fc1", "intermediate.dense"),
                             ("mlp.fc2", "output.dense")):
            for leaf in ("weight", "bias"):
                timm[f"{t}{ours}.{leaf}"] = hf[f"{h}{theirs}.{leaf}"]
        for leaf in ("weight", "bias"):
            timm[f"{t}attn.qkv.{leaf}"] = np.concatenate(
                [hf[f"{h}attention.attention.{n}.{leaf}"]
                 for n in ("query", "key", "value")])
    return timm


@pytest.mark.parametrize("layout", ["hf", "timm"])
def test_vit_conversion_equals_jax_and_oracle(layout):
    oracle = _hf_vit(4)
    sd = _numpy_sd(oracle)
    if layout == "timm":
        sd = _timm_from_hf(sd)
    got = convert_vit_state_dict(sd, num_heads=4)
    assert_trees_equal(got, j_vit(sd, num_heads=4))
    net = ViT(32, patch_size=16, hidden_size=64, num_layers=2, num_heads=4,
              mlp_dim=96, ln_eps=1e-12)
    _load(net, got["params"], got["batch_stats"])
    net.eval()
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)
                                                 ).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.tensor(x).permute(0, 3, 1, 2)
                     ).last_hidden_state[:, 0].numpy()
        out = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# ConvNeXt: HF ConvNextModel and a torchvision-layout oracle
# ---------------------------------------------------------------------------

CNX_DEPTHS, CNX_DIMS = (1, 1, 2, 1), (8, 16, 24, 40)


class _LN2d(tnn.LayerNorm):
    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _Permute(tnn.Module):
    def __init__(self, dims):
        super().__init__()
        self.dims = dims

    def forward(self, x):
        return x.permute(*self.dims)


class _CNBlock(tnn.Module):
    """torchvision's CNBlock: ``block.{0,2,3,5}`` and ``layer_scale``
    ``[dim, 1, 1]``."""

    def __init__(self, dim):
        super().__init__()
        self.block = tnn.Sequential(
            tnn.Conv2d(dim, dim, 7, padding=3, groups=dim),
            _Permute((0, 2, 3, 1)), tnn.LayerNorm(dim, eps=1e-6),
            tnn.Linear(dim, 4 * dim), tnn.GELU(), tnn.Linear(4 * dim, dim),
            _Permute((0, 3, 1, 2)))
        self.layer_scale = tnn.Parameter(torch.rand(dim, 1, 1))

    def forward(self, x):
        return x + self.layer_scale * self.block(x)


class _TorchvisionConvNeXt(tnn.Module):
    def __init__(self, depths, dims):
        super().__init__()
        layers = [tnn.Sequential(tnn.Conv2d(3, dims[0], 4, 4),
                                 _LN2d(dims[0], eps=1e-6))]
        for si, (depth, dim) in enumerate(zip(depths, dims)):
            if si > 0:
                layers.append(tnn.Sequential(_LN2d(dims[si - 1], eps=1e-6),
                                             tnn.Conv2d(dims[si - 1], dim,
                                                        2, 2)))
            layers.append(tnn.Sequential(*[_CNBlock(dim)
                                           for _ in range(depth)]))
        self.features = tnn.Sequential(*layers)
        self.classifier = tnn.Sequential(_LN2d(dims[-1], eps=1e-6),
                                         tnn.Flatten(1),
                                         tnn.Linear(dims[-1], 10))

    def forward(self, x):
        y = self.features(x).mean(dim=(2, 3), keepdim=True)
        return self.classifier[1](self.classifier[0](y))


def _convnext_oracle(layout, seed):
    torch.manual_seed(seed)
    if layout == "torchvision":
        return _TorchvisionConvNeXt(CNX_DEPTHS, CNX_DIMS).eval(), None
    tf = _transformers()
    cfg = tf.ConvNextConfig(depths=list(CNX_DEPTHS),
                            hidden_sizes=list(CNX_DIMS), num_channels=3,
                            layer_norm_eps=1e-6)
    oracle = tf.ConvNextModel(cfg).eval()
    with torch.no_grad():
        for name, par in oracle.named_parameters():
            if "layer_scale" in name:
                par.copy_(torch.rand_like(par))
    return oracle, "pooler_output"


@pytest.mark.parametrize("layout", ["hf", "torchvision"])
def test_convnext_conversion_equals_jax_and_oracle(layout):
    oracle, key = _convnext_oracle(layout, 5)
    sd = _numpy_sd(oracle)
    got = convert_convnext_state_dict(sd, depths=CNX_DEPTHS)
    assert_trees_equal(got, j_convnext(sd, depths=CNX_DEPTHS))
    net = ConvNeXt(CNX_DEPTHS, CNX_DIMS)
    _load(net, got["params"], got["batch_stats"])
    net.eval()
    x = np.random.default_rng(3).standard_normal((2, 64, 48, 3)
                                                 ).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.tensor(x).permute(0, 3, 1, 2))
        ref = (getattr(ref, key) if key else ref).numpy()
        out = net(torch.tensor(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,want", [
    ("resnet18", "stem_conv"), ("resnext50_32x4d", "stem_conv"),
    ("seresnext50_32x4d", "stem_conv"), ("vit_base_patch16_384",
                                         "cls_token"),
    ("convnext_tiny", "stem_conv")])
def test_image_dispatch_equals_jax(arch, want):
    """``convert_image_state_dict`` picks the JAX converter per factory
    name; EfficientNet and unknown archs raise in both packages."""
    if arch.startswith(("resnet", "resnext", "seresnext")):
        sd = _numpy_sd(_resnet_oracle(6, **RESNETS["resnext"][0]))
    elif arch.startswith("vit"):
        sd = _timm_from_hf(_numpy_sd(_hf_vit(6, hidden=48, heads=12)))
    else:
        sd = _numpy_sd(_TorchvisionConvNeXt((3, 3, 9, 3),
                                            (8, 16, 24, 40)))
    got = convert_image_state_dict(sd, arch)
    assert want in got["params"]
    assert_trees_equal(got, j_image(sd, arch))


@pytest.mark.parametrize("arch", ["efficientnet_b0", "efficientnet_b3",
                                  "tiny_resnet", "densenet161"])
def test_image_dispatch_refuses_like_jax(arch):
    with pytest.raises(ValueError, match="no converter"):
        convert_image_state_dict({}, arch)
    with pytest.raises(ValueError, match="no converter"):
        j_image({}, arch)


# ---------------------------------------------------------------------------
# Checkpoint files
# ---------------------------------------------------------------------------

def _file_sd():
    rng = np.random.default_rng(7)
    return {"a.weight": rng.standard_normal((5, 3)).astype(np.float32),
            "a.bias": rng.standard_normal(5).astype(np.float32),
            "b.half": rng.standard_normal((2, 4)).astype(np.float16),
            "b.steps": rng.integers(-9, 9, (3,)).astype(np.int64),
            "c.scalar": np.asarray(1.5, np.float32)}


@pytest.mark.parametrize("fmt", ["dir_bin", "dir_safetensors", "pt",
                                 "safetensors", "npz"])
def test_load_state_dict_every_format(tmp_path, fmt):
    """Each format reads to the same arrays as the JAX package's
    ``load_state_dict`` (and, for ``.safetensors``, ``safetensors.numpy``)."""
    from safetensors.numpy import load_file, save_file
    sd = _file_sd()
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if fmt.startswith("dir"):
        path = str(tmp_path / "ckpt")
        os.makedirs(path)
        if fmt == "dir_bin":
            torch.save(tensors, os.path.join(path, "pytorch_model.bin"))
        else:
            save_file(sd, os.path.join(path, "model.safetensors"))
    elif fmt == "pt":
        path = str(tmp_path / "r.pt")
        torch.save(tensors, path)
    elif fmt == "safetensors":
        path = str(tmp_path / "r.safetensors")
        save_file(sd, path, metadata={"format": "pt"})
        want = load_file(path)
        got = read_safetensors(path)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    else:
        path = str(tmp_path / "r.npz")
        np.savez(path, **sd)
    got, want = load_state_dict(path), j_load_state_dict(path)
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        assert got[k].dtype == np.asarray(want[k]).dtype == sd[k].dtype, k
        assert got[k].shape == sd[k].shape, k
        np.testing.assert_array_equal(got[k], sd[k])
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_read_safetensors_refuses_what_numpy_cannot_hold(tmp_path):
    """A BF16 tensor has no numpy type: refused, as ``safetensors.numpy``
    refuses it, never read as something else."""
    from safetensors.torch import save_file
    path = str(tmp_path / "w.safetensors")
    save_file({"w": torch.randn(4, 6).to(torch.bfloat16)}, path)
    with pytest.raises(ValueError, match="BF16"):
        read_safetensors(path)


def test_read_params_npz_and_refusals(tmp_path):
    """A state dict without the flax marker is converted (the arch or the
    encoder config are then needed); a missing file or a missing key
    raises."""
    oracle = _hf_text("bert", seed=2)
    cfg, _ = _text_cfgs("bert")
    path = str(tmp_path / "bert.npz")
    np.savez(path, **_numpy_sd(oracle))
    assert_trees_equal(read_text_params(path, cfg),
                       convert_bert_state_dict(_numpy_sd(oracle), cfg))
    with pytest.raises(ValueError, match="needs the encoder's config"):
        read_text_params(path)
    rpath = str(tmp_path / "r.pt")
    oracle = _resnet_oracle(8, **RESNETS["resnet18"][0])
    torch.save(oracle.state_dict(), rpath)
    assert_trees_equal(read_image_params(rpath, "resnet18"),
                       j_resnet(_numpy_sd(oracle)))
    with pytest.raises(ValueError, match="needs the backbone's arch"):
        read_image_params(rpath)
    with pytest.raises(FileNotFoundError):
        load_state_dict(str(tmp_path / "missing.bin"))
    short = _numpy_sd(oracle)
    del short["layer1.0.bn1.running_var"]
    with pytest.raises(KeyError, match="running_var"):
        convert_resnet_state_dict(short)


# ---------------------------------------------------------------------------
# apply_pretrained, every kind, beside the JAX package's
# ---------------------------------------------------------------------------

RESNET18_AT_32 = dict(arch="resnet18", image_size=32, feature_dim=512,
                      finetune_dim=32)


def _flax_variables(model, kind):
    params, stats = to_jax_variables(model)
    if kind == "multimodal":
        params["ConcatAttention3_0"] = params.pop("fusion")
        stats["ConcatAttention3_0"] = stats.pop("fusion")
    return {"params": params, "batch_stats": stats}


def _write_hf_dir(tmp_path, name, module):
    path = str(tmp_path / name)
    os.makedirs(path, exist_ok=True)
    torch.save(module.state_dict(), os.path.join(path, "pytorch_model.bin"))
    return path


def _kind_case(tmp_path, kind):
    """The model config and the checkpoints of one kind: the BERT without
    its pooler (the model keeps its own), RoBERTa for the caption encoder,
    a full-width ResNet-18 with random statistics (its 1000-logit head for
    the simple model) as ``.pt`` or ``.safetensors``."""
    bert, _ = _text_cfgs("bert")
    roberta, _ = _text_cfgs("roberta")
    spec = {}
    if kind in ("text", "simple", "multimodal"):
        spec["text"] = _write_hf_dir(tmp_path, "bert",
                                     _hf_text("bert", 11, pooler=False))
    if kind == "multimodal":
        spec["caption"] = _write_hf_dir(tmp_path, "roberta",
                                        _hf_text("roberta", 12))
    if kind != "text":
        oracle = _resnet_oracle(13, (2, 2, 2, 2), (64, 128, 256, 512),
                                num_classes=1000)
        if kind == "multimodal":
            from safetensors.torch import save_file
            spec["image"] = str(tmp_path / "resnet18.safetensors")
            save_file(oracle.state_dict(), spec["image"])
        else:
            spec["image"] = str(tmp_path / "resnet18.pt")
            torch.save(oracle.state_dict(), spec["image"])
    image = ImageEncoderConfig(**RESNET18_AT_32)
    mcfg = {"text": ModelConfig(text=bert, caption=None, image=None,
                                num_classes=2),
            "image": ModelConfig(text=None, caption=None, image=image,
                                 num_classes=2),
            "simple": ModelConfig(text=bert, caption=None, image=image,
                                  num_classes=2, proj_dim=32),
            "multimodal": ModelConfig(text=bert, caption=roberta,
                                      image=image, proj_dim=32)}[kind]
    return mcfg, spec


@pytest.mark.parametrize("kind", ["text", "image", "simple", "multimodal"])
def test_apply_pretrained_every_kind_equals_jax(tmp_path, kind):
    _transformers()
    mcfg, spec = _kind_case(tmp_path, kind)
    model = build_model(mcfg, CPU, seed=0, kind=kind)
    variables = _flax_variables(model, kind)
    want = j_apply_pretrained(variables, j_cfg_from_dict(
        model_config_to_dict(mcfg)), kind, JSpec(**spec))
    apply_pretrained(model, kind, PretrainedSpec(**spec))
    got = _flax_variables(model, kind)
    assert_trees_equal(got["params"], want["params"])
    assert_trees_equal(got["batch_stats"], want["batch_stats"])
    if "text" in spec:     # the checkpoint has no pooler: the model's stays
        enc = model.encoder if kind == "text" else model.text_model
        np.testing.assert_array_equal(
            to_jax_params(enc)["pooler"]["kernel"],
            variables["params"]["encoder" if kind == "text"
                                else "text_model"]["pooler"]["kernel"])


@pytest.mark.parametrize("kind,part,match", [
    ("text", "image", "no image backbone"),
    ("text", "caption", "no caption encoder"),
    ("image", "text", "no text encoder"),
    ("image", "caption", "no caption encoder"),
    ("simple", "caption", "no caption encoder")])
def test_apply_pretrained_refusals_like_jax(tmp_path, kind, part, match):
    """A checkpoint for a part the kind lacks raises in both packages."""
    _transformers()
    mcfg, spec = _kind_case(tmp_path, kind)
    if part not in spec:
        _, other = _kind_case(tmp_path, "multimodal")
        spec[part] = other[part]
    model = build_model(mcfg, CPU, seed=0, kind=kind)
    with pytest.raises(ValueError, match=match):
        apply_pretrained(model, kind, PretrainedSpec(**spec))
    with pytest.raises(ValueError):
        j_apply_pretrained(_flax_variables(model, kind), j_cfg_from_dict(
            model_config_to_dict(mcfg)), kind, JSpec(**spec))


def test_apply_pretrained_shape_mismatch(tmp_path):
    """A checkpoint of another vocab size or arch raises before any weight
    moves; a multimodal model without a caption branch refuses one."""
    _transformers()
    mcfg, spec = _kind_case(tmp_path, "multimodal")
    small_vocab = ModelConfig(
        text=TextEncoderConfig(**dict(BERT, vocab_size=127)), caption=None,
        image=None, num_classes=2)
    model = build_model(small_vocab, CPU, seed=0, kind="text")
    before = to_jax_params(model.encoder)
    with pytest.raises(ValueError, match="shape mismatch"):
        apply_pretrained(model, "text", PretrainedSpec(text=spec["text"]))
    assert_trees_equal(to_jax_params(model.encoder), before)
    vit = ModelConfig(text=None, caption=None, num_classes=2,
                      image=ImageEncoderConfig(arch="vit_base_32",
                                               image_size=32))
    model = build_model(vit, CPU, seed=0, kind="image")
    with pytest.raises((ValueError, KeyError)):
        apply_pretrained(model, "image", PretrainedSpec(image=spec["image"]))
    no_caption = ModelConfig(text=mcfg.text, caption=None, image=mcfg.image,
                             proj_dim=32)
    model = build_model(no_caption, CPU, seed=0, kind="multimodal")
    with pytest.raises(ValueError, match="no caption encoder"):
        apply_pretrained(model, "multimodal",
                         PretrainedSpec(caption=spec["caption"]))
