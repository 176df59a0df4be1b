"""The port's classic side (mpmc_tpu_torch.baselines and the ``baselines``,
``extract-features`` and ``smoke`` commands) against the JAX package.

Every classic baseline's TSV equals the JAX package's byte for byte on
seeded synthetic manifests, and the ``baselines`` command prints the same
rows.  ``extract-features`` loads the same random Hugging Face BERT-base
directory and ConvNeXt-Tiny checkpoint in both packages and writes the
same JSON: the text features within 1e-4, the image features within 1e-4
of the largest |feature|.  Images decode as the JAX package's PIL path
decodes them (its optional C++ decoder resizes differently; porting it is
later work).  ``smoke`` learns on the CPU."""

import io
import json
import os
from contextlib import redirect_stdout

# transformers would also import TensorFlow, which none of these tests use
os.environ.setdefault("USE_TF", "0")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mpmc_tpu.baselines import classic as j_classic  # noqa: E402
from mpmc_tpu.baselines.extract_features import \
    extract_features as j_extract_features  # noqa: E402
from mpmc_tpu.cli.main import main as j_main  # noqa: E402
from mpmc_tpu.image import decode as j_decode  # noqa: E402
from mpmc_tpu.image.pipeline import ImagePipeline  # noqa: E402
from mpmc_tpu_torch.baselines import classic  # noqa: E402
from mpmc_tpu_torch.baselines.extract_features import (  # noqa: E402
    extract_features, resolve_text)
from mpmc_tpu_torch.cli.main import main  # noqa: E402
from mpmc_tpu_torch.image.decode import decode_batch  # noqa: E402
from mpmc_tpu_torch.text.normalize import \
    preprocess_arabic_tweet  # noqa: E402

LETTERS = list("ابتثجحخدذرزسشصضطظعغفقكلمنهوي")


def _rows(n, seed, off):
    """Memes of words from a 50-word pool whose label shows, most of the
    time, in a signal word, so the n-gram SVMs have something to find."""
    rng = np.random.default_rng(seed)
    pool = ["".join(rng.choice(LETTERS, rng.integers(2, 6)))
            for _ in range(50)]
    out = []
    for i in range(n):
        y = int(rng.random() < 0.4)
        words = list(rng.choice(pool, rng.integers(3, 9)))
        signal = y if rng.random() < 0.8 else 1 - y
        words.insert(int(rng.integers(0, len(words) + 1)),
                     "دعاية" if signal else "عادي")
        out.append({"id": f"memes/img_{off + i}.png",
                    "img_path": f"memes/img_{off + i}.png",
                    "text": " ".join(words),
                    "class_label": "propaganda" if y else "not_propaganda"})
    return out


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    root = tmp_path_factory.mktemp("classic")
    for name, n, seed, off in (("train.json", 90, 0, 0),
                               ("dev.json", 30, 1, 1000)):
        with open(root / name, "w", encoding="utf-8") as f:
            json.dump(_rows(n, seed, off), f, ensure_ascii=False)
    return str(root / "train.json"), str(root / "dev.json"), root


def _same_file(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read(), (a, b)


NGRAM = [dict(), dict(analyzer="char_wb", ngram_range=(2, 5),
                      max_features=3000),
         dict(analyzer="char", ngram_range=(1, 3), max_features=800)]


@pytest.mark.parametrize("runner", ["majority", "random_2A", "random_2B",
                                    "random_2C"])
def test_majority_and_random_tsvs_equal_jax(tmp_path, manifests, runner):
    tr, dv, _ = manifests
    out = {p: str(tmp_path / f"{p}.tsv") for p in ("port", "jax")}
    if runner == "majority":
        got = classic.run_majority_baseline(tr, dv, out["port"])
        want = j_classic.run_majority_baseline(tr, dv, out["jax"])
    else:
        sub = runner[-2:]
        got = classic.run_random_baseline(tr, dv, out["port"], subtask=sub)
        want = j_classic.run_random_baseline(tr, dv, out["jax"],
                                             subtask=sub)
    assert got == want
    _same_file(out["port"], out["jax"])


@pytest.mark.parametrize("kw", NGRAM, ids=["word", "char_wb", "char"])
def test_ngram_tsvs_equal_jax(tmp_path, manifests, kw):
    """The label TSV, the calibrated probability TSV, the per-fold
    probability TSVs and the 2A fold protocol's val TSVs and scores."""
    tr, dv, _ = manifests
    p, j = tmp_path / "port", tmp_path / "jax"
    p.mkdir()
    j.mkdir()
    got = classic.run_ngram_baseline(tr, dv, str(p / "n.tsv"), run_id="fam",
                                     probs_out=str(p / "n_probs.tsv"), **kw)
    want = j_classic.run_ngram_baseline(tr, dv, str(j / "n.tsv"),
                                        run_id="fam",
                                        probs_out=str(j / "n_probs.tsv"),
                                        **kw)
    assert got == want
    paths = classic.run_ngram_fold_probs(tr, dv, str(p / "f"), num_folds=3,
                                         run_id="fam", **kw)
    jpaths = j_classic.run_ngram_fold_probs(tr, dv, str(j / "f"),
                                            num_folds=3, run_id="fam", **kw)
    f1s = classic.run_ngram_cv(tr, dv, str(p / "cv"), num_folds=3, **kw)
    jf1s = j_classic.run_ngram_cv(tr, dv, str(j / "cv"), num_folds=3, **kw)
    assert f1s == jf1s
    assert [os.path.basename(x) for x in paths] == [
        os.path.basename(x) for x in jpaths]
    names = sorted(os.listdir(j))
    assert sorted(os.listdir(p)) == names and len(names) == 2 + 3 + 3
    for name in names:
        _same_file(p / name, j / name)


def _feature_jsons(root, train, dev, dim=12, sep=0.7):
    rng = np.random.default_rng(5)
    paths = {}
    for split, path in (("train", train), ("dev", dev)):
        with open(path, encoding="utf-8") as f:
            rows = json.load(f)
        table = {kind: {r["id"]: (rng.standard_normal(dim) + sep * (
            r["class_label"] == "propaganda")).tolist() for r in rows}
            for kind in ("imgfeats", "textfeats")}
        paths[split] = str(root / f"{split}_feats.json")
        with open(paths[split], "w") as f:
            json.dump(table, f)
    return paths


@pytest.mark.parametrize("use_text", [False, True])
def test_feature_svm_tsv_equals_jax(tmp_path, manifests, use_text):
    tr, dv, _ = manifests
    feats = _feature_jsons(tmp_path, tr, dv)
    got = classic.run_feature_svm_baseline(
        feats["train"], feats["dev"], tr, dv, str(tmp_path / "p.tsv"),
        use_text=use_text)
    want = j_classic.run_feature_svm_baseline(
        feats["train"], feats["dev"], tr, dv, str(tmp_path / "j.tsv"),
        use_text=use_text)
    assert got == want
    _same_file(tmp_path / "p.tsv", tmp_path / "j.tsv")


def _printed(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("sub,flags", [
    ("2a", ["--ngram-probs", "--ngram-fold-probs", "3", "--ngram-cv", "3"]),
    ("2a", ["--ngram-analyzer", "char_wb", "--ngram-range", "2", "5",
            "--ngram-max-features", "2000"]),
    ("2b", []),
    ("2c", ["--ngram-analyzer", "char"])])
def test_baselines_command_rows_equal_jax(tmp_path, manifests, sub, flags):
    """The printed rows and every file the command writes; 2B and 2C read
    the feature JSONs from ``--features-dir`` (no extraction)."""
    tr, dv, _ = manifests
    feats = tmp_path / "feats"
    feats.mkdir()
    _feature_jsons(feats, tr, dv)
    outs = {}
    for who, fn in (("port", main), ("jax", j_main)):
        outs[who] = tmp_path / who
        outs[who].mkdir()
        argv = ["baselines", "--subtask", sub, "-tr", tr, "-te", dv,
                "-o", str(outs[who]), "--features-dir", str(feats), *flags]
        outs[who + "_printed"] = _printed(fn, argv).replace(
            str(outs[who]), "OUT")
    assert outs["port_printed"] == outs["jax_printed"]
    assert "majority: acc=" in outs["port_printed"]
    names = sorted(os.listdir(outs["jax"]))
    assert sorted(os.listdir(outs["port"])) == names
    for name in names:
        _same_file(outs["port"] / name, outs["jax"] / name)


# ---------------------------------------------------------------------------
# extract-features
# ---------------------------------------------------------------------------

def _write_images(root, rows, rng):
    """Real PNG and JPEG files at several sizes (one left missing)."""
    from PIL import Image
    sizes = [(300, 200), (224, 224), (97, 131), (240, 260)]
    for i, r in enumerate(rows[:-1]):
        w, h = sizes[i % len(sizes)]
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = root / r["img_path"]
        path.parent.mkdir(parents=True, exist_ok=True)
        if i % 2:
            r["img_path"] = r["img_path"][:-4] + ".jpg"
            Image.fromarray(a).save(root / r["img_path"], quality=90)
        else:
            Image.fromarray(a).save(path)


@pytest.fixture(scope="module")
def feature_inputs(tmp_path_factory):
    """Seven memes with images, a vocab.txt, a random BERT-base HF
    directory (``model.safetensors``) and an HF ConvNeXt-Tiny ``.bin``."""
    tf = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("feats")
    rows = _rows(7, 3, 0)
    _write_images(root, rows, np.random.default_rng(4))
    with open(root / "m.json", "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    tok, _, _ = resolve_text([preprocess_arabic_tweet(r["text"])
                              for r in rows], None, None)
    tok.save(str(root / "vocab.txt"))
    torch.manual_seed(0)
    bert = tf.BertModel(tf.BertConfig(vocab_size=max(tok.vocab.values()) + 1))
    bert.save_pretrained(str(root / "bert"))
    cnx = tf.ConvNextModel(tf.ConvNextConfig())
    with torch.no_grad():
        for name, par in cnx.named_parameters():
            if "layer_scale" in name:
                par.copy_(torch.rand_like(par))
    torch.save(cnx.state_dict(), root / "convnext_tiny.bin")
    return root


def test_decode_equals_jax_image_pipeline(feature_inputs, monkeypatch):
    """The port's decode gives the JAX ``ImagePipeline.preload``'s uint8
    (its PIL path) on the test images, the missing one included."""
    root = feature_inputs
    with open(root / "m.json", encoding="utf-8") as f:
        paths = [r["img_path"] for r in json.load(f)]
    monkeypatch.setattr(j_decode, "_load_native", lambda: None)
    want = ImagePipeline(paths, root=str(root), size=224).preload()
    np.testing.assert_array_equal(
        decode_batch(paths, 224, False, str(root), num_threads=16), want)


def test_extract_features_json_equals_jax(feature_inputs, monkeypatch):
    root = feature_inputs
    monkeypatch.setattr(j_decode, "_load_native", lambda: None)
    kw = dict(image_root=str(root), batch_size=4,
              text_vocab_path=str(root / "vocab.txt"),
              text_params_path=str(root / "bert"),
              image_params_path=str(root / "convnext_tiny.bin"))
    got = extract_features(str(root), "m.json", "p.json",
                           features_dir=str(root / "port"), device="cpu",
                           **kw)
    want = j_extract_features(str(root), "m.json", "j.json",
                              features_dir=str(root / "jax"), **kw)
    assert got == str(root / "port" / "p.json")
    with open(got) as f, open(want) as g:
        got, want = json.load(f), json.load(g)
    assert sorted(got) == sorted(want) == ["imgfeats", "textfeats"]
    for kind, tol in (("textfeats", None), ("imgfeats", None)):
        assert list(got[kind]) == list(want[kind])
        g = np.asarray(list(got[kind].values()))
        w = np.asarray(list(want[kind].values()))
        assert g.shape == w.shape == (7, 768)
        atol = 1e-4 if kind == "textfeats" else 1e-4 * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


def test_extract_features_refusals(tmp_path, feature_inputs):
    """Flax ``.msgpack`` files are refused; an MLM npz needs its vocab file
    of the same size, as in the JAX package."""
    root = feature_inputs
    for flag in ("text_params_path", "image_params_path"):
        with pytest.raises(ValueError, match="msgpack"):
            extract_features(str(root), "m.json", "x.json",
                             features_dir=str(tmp_path), device="cpu",
                             **{flag: str(tmp_path / "w.msgpack")})
    from mpmc_tpu_torch.config import TextEncoderConfig
    from mpmc_tpu_torch.models.bert import TextEncoder
    from mpmc_tpu_torch.models.convert import to_jax_params
    from mpmc_tpu_torch.models.pretrained import save_encoder_params
    npz = str(tmp_path / "mlm_encoder.npz")
    save_encoder_params(to_jax_params(TextEncoder(TextEncoderConfig.tiny(
        vocab_size=50))), npz)
    with pytest.raises(ValueError, match="needs its matching vocab"):
        resolve_text(["a b"], None, npz)
    with pytest.raises(ValueError, match="wrong vocab.txt"):
        resolve_text(["a b"], str(root / "vocab.txt"), npz)


def test_extract_features_command_asks_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        main(["extract-features", "-d", str(tmp_path), "-f", "m.json",
              "-o", "x.json"])


def test_smoke_learns_on_cpu():
    # the tiny model on one intra-op thread: on a loaded machine (the
    # suite's parallel workers) a pool of threads per process makes each
    # small op wait at the pool's barrier, many times slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _printed(main, ["smoke", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    f1 = json.loads(out.strip().splitlines()[-1])["smoke_best_macro_f1"]
    assert f1 > 0.6
