"""The port's captioner (mpmc_tpu_torch/models/captioner.py) and the 2C
caption options of ``train`` against the JAX package at tiny sizes: the
ViT's token sequence and the captioner's logits against flax through the
weight bridge (the decoder at its default 6 heads of D = 21), greedy
``generate`` ids equal to JAX's with every written position's top-2
margin asserted, the decode function, the placeholder caption cache byte
for byte, the scratch captioner and the cache keys, and ``train --subtask
2c`` with ``--caption-vocab`` beside the JAX command line and with
``--scratch-captioner``.  Inputs come from numpy seeds and the flax init;
both sides run in f32."""

import glob
import hashlib
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.cli import experiments as j_experiments
from mpmc_tpu.cli.experiments import corpus_wordpiece_vocab as j_corpus_vocab
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.models.captioner import ImageCaptioner as JImageCaptioner
from mpmc_tpu.models.captioner import make_decode_fn as j_make_decode_fn
from mpmc_tpu.models.captioner import precompute_captions as j_captions
from mpmc_tpu.models.vit import ViT as JViT
from mpmc_tpu_torch.cli.experiments import corpus_wordpiece_vocab
from mpmc_tpu_torch.cli.main import main
from mpmc_tpu_torch.io.tsv import check_format
from mpmc_tpu_torch.models import captioner
from mpmc_tpu_torch.models.captioner import (ImageCaptioner, make_decode_fn,
                                             make_scratch_caption_fn,
                                             precompute_captions)
from mpmc_tpu_torch.models.convert import from_jax_variables
from mpmc_tpu_torch.models.vit import ViT
from mpmc_tpu_torch.ops import attention as A

TOL = 1e-5
# A decoder at the scratch captioner's width: 128 wide with the default 6
# heads, so each head is 21 wide and the projections 126; one layer, a
# small vocab and a small encoder keep it cheap.
CAP = dict(vocab_size=40, image_size=32, patch_size=8, enc_hidden=32,
           enc_layers=1, enc_heads=2, dec_hidden=128, dec_layers=1,
           max_len=8)
PROMPT = [[5, 6], [7, 5], [6, 6]]
EOS = 3


def _np(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), tree)


@pytest.fixture(scope="module")
def jax_captioner():
    """The flax captioner's weights (positions and biases made large
    enough to matter), its logits on a prompt and its greedy ids."""
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    prompt = np.asarray(PROMPT, np.int32)
    cap = JImageCaptioner(**CAP)
    variables = cap.init(jax.random.key(0), jnp.asarray(imgs),
                         jnp.asarray(prompt))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (x + 0.1 * rng.standard_normal(x.shape).astype(
            np.float32)) if p[-1].key in ("bias", "cls_token", "pos_embed")
        else x, _np(variables["params"]))
    variables = {"params": params}
    tokens = rng.integers(0, CAP["vocab_size"], (3, CAP["max_len"]))
    logits = cap.apply(variables, jnp.asarray(imgs),
                       jnp.asarray(tokens, jnp.int32))
    gen = cap.apply(variables, jnp.asarray(imgs), jnp.asarray(prompt),
                    eos_id=EOS, method=JImageCaptioner.generate)
    return dict(params=params, imgs=imgs, tokens=tokens,
                logits=np.asarray(logits), generated=np.asarray(gen))


def _port_captioner(params):
    model = ImageCaptioner(**CAP)
    model.load_state_dict(from_jax_variables(params))
    return model.eval()


def test_vit_return_tokens_matches_flax():
    """``return_tokens=True``: the final-LayerNorm sequence, class token
    first; the default still returns the class token's features."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    jvit = JViT(patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64)
    params = _np(jvit.init(jax.random.key(1), jnp.asarray(x))["params"])
    params["pos_embed"] += 0.5 * rng.standard_normal(
        params["pos_embed"].shape).astype(np.float32)
    want = np.asarray(jvit.apply({"params": params}, jnp.asarray(x),
                                 return_tokens=True))
    vit = ViT(32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
              mlp_dim=64)
    vit.load_state_dict(from_jax_variables(params))
    with torch.no_grad():
        got = vit(torch.from_numpy(x), return_tokens=True).numpy()
        cls = vit(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 17, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(cls, got[:, 0])


def test_captioner_logits_match_flax_at_d21(jax_captioner):
    model = _port_captioner(jax_captioner["params"])
    layer = model.decoder.layer_0
    assert (layer.num_heads, layer.head_dim) == (6, 21)
    assert layer.self_out.in_features == layer.cross_out.in_features == 126
    with torch.no_grad():
        got = model(torch.from_numpy(jax_captioner["imgs"]),
                    torch.from_numpy(jax_captioner["tokens"])).numpy()
    np.testing.assert_allclose(got, jax_captioner["logits"], atol=TOL,
                               rtol=0)


def test_generate_ids_equal_jax_with_margins(jax_captioner):
    """Greedy ids equal JAX's, and at each written position the top-2
    logit margin exceeds 1e-4, so the equality is not a coin toss.  The
    decoder is causal, so one pass over the final ids gives the logits of
    every step."""
    model = _port_captioner(jax_captioner["params"])
    imgs = torch.from_numpy(jax_captioner["imgs"])
    prompt = torch.tensor(PROMPT)
    got = model.generate(imgs, prompt, eos_id=EOS).numpy()
    want = jax_captioner["generated"]
    np.testing.assert_array_equal(got, want)
    with torch.no_grad():
        logits = model(imgs, torch.from_numpy(got)).numpy()
    P = prompt.shape[1]
    written = 0
    for b in range(got.shape[0]):
        for pos in range(P, CAP["max_len"]):
            top2 = np.sort(logits[b, pos - 1])[-2:]
            assert top2[1] - top2[0] > 1e-4, (b, pos, top2)
            written += 1
            if got[b, pos] == EOS:
                break
    assert written >= got.shape[0] * 2


def test_cross_attention_goes_through_the_kernel_wrapper(jax_captioner,
                                                        monkeypatch):
    """Every attention of ``generate`` (the encoder's layers once, the
    decoder's cross-attention at each of the max_len - 1 positions) calls
    ``attention_forward``, which on a CUDA tensor launches the kernel or
    raises; the causal self-attention is plain tensor ops."""
    calls = []

    def counting(q, k, v, mask=None, mode="padding"):
        calls.append((tuple(q.shape), tuple(k.shape), mode))
        return A.attention_forward_reference(q, k, v, mask, mode)

    monkeypatch.setattr(A, "attention_forward", counting)
    monkeypatch.setattr(captioner, "attention_forward", counting)
    model = _port_captioner(jax_captioner["params"])
    model.generate(torch.from_numpy(jax_captioner["imgs"]),
                   torch.tensor(PROMPT), eos_id=EOS)
    steps = CAP["max_len"] - 1
    assert len(calls) == CAP["enc_layers"] + CAP["dec_layers"] * steps
    assert calls[0] == ((3, 17, 2, 16), (3, 17, 2, 16), "none")
    assert set(calls[1:]) == {((3, 8, 6, 21), (3, 17, 6, 21), "none")}


def test_decode_fn_matches_jax():
    texts = ["a meme of something", "funny cat poster", "news clip art"]
    vocab = corpus_wordpiece_vocab(texts, max_words=4000)
    assert vocab == j_corpus_vocab(texts, max_words=4000)
    rows = np.random.default_rng(2).integers(0, max(vocab.values()) + 3,
                                             (20, 9))
    decode, j_decode = make_decode_fn(vocab), j_make_decode_fn(vocab)
    assert [decode(r) for r in rows] == [j_decode(r) for r in rows]


def test_placeholder_caption_cache_is_byte_identical(tmp_path):
    paths = [f"d/im_{i}.png" for i in range(5)]
    imgs = np.zeros((5, 8, 8, 3), np.uint8)
    want = j_captions(paths, imgs, cache_dir=str(tmp_path / "jax"))
    got = precompute_captions(paths, cache_dir=str(tmp_path / "port"))
    assert got == want
    (j_file,) = (tmp_path / "jax").glob("captions_*.json")
    (p_file,) = (tmp_path / "port").glob("captions_*.json")
    assert p_file.name == j_file.name
    assert p_file.read_bytes() == j_file.read_bytes()


def _cache_name(paths, tag, prompt="a meme of"):
    key = hashlib.sha256(("\n".join(paths) + prompt + "\x00"
                          + tag).encode()).hexdigest()[:16]
    return f"captions_{key}.json"


def test_scratch_captioner_generates_words(tmp_path):
    """Port of the JAX package's test: word captions decoded through the
    caption vocab, cached as text under the port's own tag, the same again
    from the cache."""
    texts = ["a meme of something", "funny cat poster", "news clip art"]
    gen_fn, tok = make_scratch_caption_fn(texts, image_size=32, max_len=8,
                                          device="cpu")
    assert gen_fn.cache_tag == "scratch-captioner-torch-0-32"
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, (3, 32, 32, 3)).astype(np.uint8)
    paths = [f"d/im_{i}.png" for i in range(3)]
    caps = precompute_captions(paths, imgs, cache_dir=str(tmp_path),
                               generate_fn=gen_fn)
    assert len(caps) == 3
    for c in caps:
        assert c and not any(w.isdigit() for w in c.split())
    (cache,) = glob.glob(str(tmp_path / "captions_*.json"))
    assert cache.endswith(_cache_name(paths, gen_fn.cache_tag))
    assert not cache.endswith(_cache_name(paths, "scratch-captioner-0-32"))
    with open(cache) as f:
        assert json.load(f)[paths[0]] == caps[0]
    assert precompute_captions(paths, imgs, cache_dir=str(tmp_path),
                               generate_fn=gen_fn) == caps
    # The weights come from a CPU generator: the same on every device.
    again, _ = make_scratch_caption_fn(texts, image_size=32, max_len=8,
                                       device="cpu")
    assert again(imgs) == caps


def test_caption_cache_keys_on_generator(tmp_path):
    """A placeholder run and a generate_fn run over the same paths do not
    share cache entries."""
    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    paths = ["d/a.png", "d/b.png"]
    placeholder = precompute_captions(paths, imgs, cache_dir=str(tmp_path))

    def gen(images_u8):
        return ["real words here"] * len(images_u8)

    gen.cache_tag = "test-gen"
    real = precompute_captions(paths, imgs, cache_dir=str(tmp_path),
                               generate_fn=gen)
    assert real == ["real words here"] * 2
    assert placeholder != real
    assert precompute_captions(paths, imgs,
                               cache_dir=str(tmp_path)) == placeholder


def test_captioner_generate_keeps_the_prompt():
    cap = ImageCaptioner(vocab_size=64, image_size=32, patch_size=8,
                         enc_hidden=32, enc_layers=1, enc_heads=2,
                         dec_hidden=32, dec_layers=1, max_len=8)
    captioner.init_flax_like(cap, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    prompt = torch.tensor([[5, 6]] * 2)
    tokens = cap.generate(img, prompt, eos_id=3)
    assert tokens.shape == (2, 8)
    assert torch.equal(tokens[:, :2], prompt)


def test_precompute_captions_cache(tmp_path):
    paths = ["a.jpg", "b.jpg"]
    c1 = precompute_captions(paths, cache_dir=str(tmp_path))
    c2 = precompute_captions(paths, cache_dir=str(tmp_path))
    assert c1 == c2 and len(c1) == 2
    assert all(c.startswith("a meme of") for c in c1)


# ---------------------------------------------------------------------------
# train --subtask 2c --caption-vocab / --scratch-captioner
# ---------------------------------------------------------------------------

LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")
TSVS = ("task2C_kevinmathew.tsv", "task2C_kevinmathew_probs_fold_0.tsv")


def _write_manifest(path, n, seed, off=0):
    rng = np.random.default_rng(seed)
    rows = [{"id": f"memes/img_{off + i}.jpg",
             "img_path": f"memes/img_{off + i}.jpg",
             "text": " ".join("".join(rng.choice(LETTERS,
                                                 int(rng.integers(2, 6))))
                              for _ in range(int(rng.integers(2, 12)))),
             "class_label": ("propaganda" if rng.random() < 0.35
                             else "not_propaganda")} for i in range(n)]
    with open(path, "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)


def _rows(path):
    with open(path) as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _caption_vocab(path):
    """A caption vocab that no corpus vocab over the captions equals."""
    tokens = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "meme",
               "of"] + [f"{a}{b}" for a in "0123456789abcdef"
                        for b in "0123456789abcdef"]
              + ["##" + c for c in "0123456789abcdef"] + list("0123456789"))
    path.write_text("\n".join(tokens) + "\n", encoding="utf-8")


def _stub_steps(model, cfg, train_data, kind, **kwargs):
    """The JAX ``_run_folds``'s model and steps replaced by constants (a
    counting train step, an eval step rising along the batch): what stays
    is ``run_subtask_2c``'s own files."""
    from mpmc_tpu.train.step import create_train_state
    import optax
    state, _ = create_train_state({"params": {"w": jnp.zeros(1)}},
                                  optax.sgd(0.0))

    def train_step(state, batch, rng):
        return state.replace(step=state.step + 1), {
            "loss": jnp.float32(0.5), "grad_norm": jnp.float32(1.0)}

    def eval_step(state, batch):
        n = batch["label"].shape[0]
        return jnp.linspace(0.2, 0.8, n), jnp.zeros(n)

    return state, train_step, eval_step, None, None, None


def _argv(root, out, *flags):
    return ["train", "--subtask", "2c", "-tr", str(root / "train.json"),
            "-te", str(root / "dev.json"), "--tiny", "--fold", "0",
            "--epochs", "1", "--batch-size", "8", "--out-dir", str(out),
            *flags]


def test_train_2c_caption_vocab_matches_jax(tmp_path, monkeypatch):
    """``--caption-vocab C`` tokenizes the captions with C: the same TSV
    names, headers and ids, ``caption_vocab.txt`` (C's tokens) and
    ``run_meta.json`` as the JAX command line (its steps stubbed)."""
    monkeypatch.chdir(tmp_path)
    _write_manifest(tmp_path / "train.json", 24, 0)
    _write_manifest(tmp_path / "dev.json", 11, 1, off=1000)
    _caption_vocab(tmp_path / "C.txt")
    flags = ["--caption-vocab", str(tmp_path / "C.txt")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_experiments, "_init_and_steps", _stub_steps)
        args = j_build_parser().parse_args(
            _argv(tmp_path, tmp_path / "jout", *flags)
            + ["--cache-dir", "jcache"])
        assert args.fn(args) == 0
    assert main(_argv(tmp_path, tmp_path / "out", *flags)
                + ["--device", "cpu"]) == 0
    out, jout = tmp_path / "out", tmp_path / "jout"
    assert sorted(p.name for p in out.glob("*.tsv")) == sorted(
        p.name for p in jout.glob("*.tsv")) == sorted(TSVS)
    for tsv in TSVS:
        got, want = _rows(out / tsv), _rows(jout / tsv)
        assert got[0] == want[0]
        assert [r[0] for r in got] == [r[0] for r in want]
    assert check_format(str(out / TSVS[0]))
    for name in ("caption_vocab.txt", "vocab.txt"):
        assert (out / name).read_bytes() == (jout / name).read_bytes()
    assert (out / "caption_vocab.txt").read_bytes() == (
        tmp_path / "C.txt").read_bytes()
    with open(out / "run_meta.json") as f, open(jout / "run_meta.json") as g:
        meta = json.load(f)
        assert meta == json.load(g)
    assert meta["model"]["caption"]["vocab_size"] == len(
        (tmp_path / "C.txt").read_text().split())


def test_train_2c_scratch_captioner_end_to_end(tmp_path, monkeypatch):
    """``--scratch-captioner`` captions the images with the scratch
    captioner before the caption vocab is built: word captions in the
    cache under the port's tag (seed 42, 64 pixels), a caption vocab over
    them, and a trained fold whose checkpoint ``predict`` reads."""
    monkeypatch.chdir(tmp_path)
    _write_manifest(tmp_path / "train.json", 24, 0)
    _write_manifest(tmp_path / "dev.json", 11, 1, off=1000)
    calls = []
    real = captioner.make_scratch_caption_fn

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(captioner, "make_scratch_caption_fn", spy)
    assert main(_argv(tmp_path, tmp_path / "out", "--scratch-captioner",
                      "--checkpoint-dir", "ck", "--cache-dir", "cache",
                      "--device", "cpu")) == 0
    assert calls == [dict(image_size=64, seed=42,
                          device=torch.device("cpu"))]
    placeholder = re.compile(r"^a meme of [0-9a-f]{8}$")
    caps = {}
    for name in ("train.json", "dev.json"):
        with open(tmp_path / name) as f:
            paths = [r["img_path"] for r in json.load(f)]
        cache = tmp_path / "cache" / _cache_name(
            paths, "scratch-captioner-torch-42-64")
        with open(cache) as f:
            caps.update(json.load(f))
        assert set(paths) <= set(caps)
    assert not any(placeholder.match(c) for c in caps.values())
    assert not any(w.isdigit() for c in caps.values() for w in c.split())
    vocab = (tmp_path / "out" / "caption_vocab.txt").read_text().split()
    assert set(w for c in caps.values() for w in c.split()) <= set(vocab)
    assert check_format(str(tmp_path / "out" / TSVS[0]))
    assert (tmp_path / "ck" / "fold_0" / "model.pt").exists()
