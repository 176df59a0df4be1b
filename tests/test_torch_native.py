"""The port's C++ host runtime (``mpmc_tpu_torch/native_lib.py``, its own
build of ``native/image_decode.cpp`` and ``native/tokenizer.cpp``) against
the JAX package's on the same inputs.

* ``image/decode``: ``decode_image`` and ``decode_batch`` bit-equal to
  ``mpmc_tpu.image.decode`` with the JAX native backend loaded (a
  high-frequency 900x600 PNG, the same image as a JPEG, so that libjpeg's
  ``scale_denom`` prescaling applies at 224, a grayscale PNG, an RGBA PNG,
  a truncated file, a missing one), and on the PIL path with both native
  backends switched off; the decoder built against Pillow's bundled
  libjpeg and libpng (the route a machine without their development files
  takes) equal to the system build;
* the committed fixtures under ``tests/torch_data/`` (which ``chip_smoke.py``
  decodes on the card): the expected pixels equal the JAX native decode;
  :func:`write_fixtures` regenerates them;
* the native tokenizer: 0 differing rows against the JAX native tokenizer
  and the port's Python ``WordPieceTokenizer`` over 3,000 seeded Arabic,
  Latin, emoji and diacritic texts, lengths 16 and 128, both corpus vocab
  modes, with and without lower-casing;
* ``BatchTokenizer``'s npz cache: a hit, a miss under another vocab salt,
  and the JAX package's key;
* every library loads from ``mpmc_tpu_torch/_build/``.
"""

import os

import numpy as np
import pytest
from PIL import Image

from mpmc_tpu import native_lib as j_native_lib
from mpmc_tpu.cli.experiments import corpus_wordpiece_vocab as j_corpus_vocab
from mpmc_tpu.image import decode as j_decode
from mpmc_tpu.text.native import NativeWordPieceTokenizer as JNativeTok
from mpmc_tpu.text.tokenizer import BatchTokenizer as JBatchTokenizer
from mpmc_tpu_torch import native_lib
from mpmc_tpu_torch.cli.experiments import (build_tokenizer,
                                            corpus_wordpiece_vocab)
from mpmc_tpu_torch.image import decode, native
from mpmc_tpu_torch.text.native import NativeWordPieceTokenizer
from mpmc_tpu_torch.text.tokenizer import (BatchTokenizer,
                                           HybridWordPieceTokenizer)
from mpmc_tpu_torch.text.wordpiece import WordPieceTokenizer
from mpmc_tpu_torch.text.wordpiece_learn import learn_wordpiece_vocab

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_data")
# fixture file -> [(expected-pixels key, size, grayscale)]
FIXTURES = {"hf.png": [("hf_png_224", 224, False)],
            "hf.jpg": [("hf_jpg_224", 224, False),
                       ("hf_jpg_gray_128", 128, True)],
            "gray.png": [("gray_png_96", 96, False)],
            "rgba.png": [("rgba_png_96", 96, False)]}


def high_frequency(h: int, w: int, seed: int, noise: float) -> np.ndarray:
    """uint8 ``[h, w, 3]``: a 2-pixel checkerboard, an XOR pattern and a
    sinusoid near the Nyquist rate, plus Gaussian noise, so that two
    resize kernels disagree by many levels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    r = (np.sin(xx * 0.9) + np.cos(yy * 1.3)) * 60 + 128
    g = ((xx ^ yy) & 255).astype(np.float64)
    b = np.where(((xx // 2) + (yy // 2)) % 2 == 0, 30.0, 220.0)
    img = np.stack([r, g, b], -1) + rng.normal(0, noise, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def write_images(out_dir: str, h: int, w: int, jpeg_h: int, jpeg_w: int,
                 noise: float) -> None:
    """hf.png, hf.jpg (quality 90), gray.png, rgba.png and a truncated
    JPEG and PNG, from numpy seed 11."""
    os.makedirs(out_dir, exist_ok=True)
    Image.fromarray(high_frequency(h, w, 11, noise)).save(
        os.path.join(out_dir, "hf.png"))
    Image.fromarray(high_frequency(jpeg_h, jpeg_w, 11, 20)).save(
        os.path.join(out_dir, "hf.jpg"), quality=90)
    small = high_frequency(h // 2, w // 2, 12, noise)
    Image.fromarray(small).convert("L").save(os.path.join(out_dir,
                                                          "gray.png"))
    alpha = (np.arange(small.size // 3) % 256).astype(np.uint8).reshape(
        small.shape[:2])
    Image.fromarray(np.dstack([small, alpha]), "RGBA").save(
        os.path.join(out_dir, "rgba.png"))
    for name in ("hf.jpg", "hf.png"):
        with open(os.path.join(out_dir, name), "rb") as f:
            data = f.read()
        with open(os.path.join(out_dir, "truncated_" + name), "wb") as f:
            f.write(data[: len(data) // 3])


def write_fixtures(out_dir: str = DATA) -> None:
    """The committed fixtures: small images (a 320x240 PNG, a 640x480 JPEG
    that libjpeg prescales by 2 at 224) and ``expected.npz``, their pixels
    from the JAX package's native decode."""
    write_images(out_dir, 240, 320, 480, 640, noise=0)
    for name in ("truncated_hf.jpg", "truncated_hf.png"):
        os.remove(os.path.join(out_dir, name))
    load_jax_native()
    want = {key: j_decode.decode_image(name, size, gray, out_dir)
            for name, cases in FIXTURES.items()
            for key, size, gray in cases}
    np.savez_compressed(os.path.join(out_dir, "expected.npz"), **want)


def load_jax_native():
    """The JAX package's decoder module, loaded.  Every test process
    imports ``tests/test_native.py``, whose ``skipif`` builds the JAX
    library at collection time: processes that build it at once can leave
    one of them with a failed load, remembered for the session.  The
    library is on disk by now, so such a process loads it again."""
    if j_native_lib.load() is None:
        j_native_lib._tried = False
        j_decode._native_checked = False
    assert j_native_lib.load() is not None, "the JAX native library builds"
    assert j_decode._load_native() is not None
    return j_decode


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native decoder, loaded (built by its own
    ``native/build.sh`` when absent)."""
    return load_jax_native()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("img"))
    write_images(out, 600, 900, 600, 900, noise=20)
    return out


CASES = [(name, size, gray) for name in ("hf.png", "hf.jpg", "gray.png",
                                         "rgba.png", "truncated_hf.jpg",
                                         "truncated_hf.png", "missing.jpg")
         for size, gray in ((224, False), (64, True))]


@pytest.mark.parametrize("name,size,gray", CASES)
def test_decode_image_bit_equal_to_jax_native(jax_native, images, name, size,
                                              gray):
    assert decode._load_native() is not None
    miss_port, miss_jax = [], []
    got = decode.decode_image(name, size, gray, images, miss_port)
    want = jax_native.decode_image(name, size, gray, images, miss_jax)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert miss_port == miss_jax


def test_decode_pixels_differ_from_pil(jax_native, images):
    """The fault the native path repairs: on the high-frequency PNG the
    native resize and PIL's differ by many levels, so equality above is
    not PIL against PIL."""
    nat = decode.decode_image("hf.png", 224, False, images)
    with Image.open(os.path.join(images, "hf.png")) as im:
        pil = np.asarray(im.convert("RGB").resize((224, 224),
                                                  Image.BILINEAR))
    assert np.abs(nat.astype(int) - pil.astype(int)).max() > 50


def test_decode_batch_bit_equal_and_counts_backends(jax_native, images):
    paths = [n for n, _, _ in CASES[::2]] * 3
    for key in decode.backend_counts:
        decode.backend_counts[key] = 0
    got = decode.decode_batch(paths, 224, False, images, num_threads=8)
    want = jax_native.decode_batch(paths, 224, False, images, num_threads=8)
    np.testing.assert_array_equal(got, want)
    # Truncated JPEG: libjpeg decodes what is there (a warning);
    # truncated PNG: libpng fails, PIL fails, synthetic pixels.
    assert decode.backend_counts == {"native": 15, "pil": 0,
                                     "synthetic": 6}
    with pytest.raises(FileNotFoundError, match="2/7"):
        decode.decode_batch(paths[:7], 64, True, images, strict=True)


@pytest.mark.parametrize("name,size,gray", CASES)
def test_pil_path_bit_equal_to_jax_pil(images, monkeypatch, name, size,
                                       gray):
    monkeypatch.setattr(decode, "_native", None)
    monkeypatch.setattr(decode, "_native_checked", True)
    monkeypatch.setattr(j_decode, "_native", None)
    monkeypatch.setattr(j_decode, "_native_checked", True)
    miss_port, miss_jax = [], []
    got = decode.decode_image(name, size, gray, images, miss_port)
    want = j_decode.decode_image(name, size, gray, images, miss_jax)
    np.testing.assert_array_equal(got, want)
    assert miss_port == miss_jax
    paths = [n for n, _, _ in CASES[::2]]
    np.testing.assert_array_equal(
        decode.decode_batch(paths, size, gray, images),
        j_decode.decode_batch(paths, size, gray, images))


def test_pillow_bundled_route_equals_system_build(images, tmp_path):
    """The decoder compiled through ``native/include`` against Pillow's
    bundled libjpeg and libpng gives the system build's pixels."""
    import ctypes
    routes = dict(native_lib._routes("image_decode"))
    if "pillow" not in routes:
        pytest.skip("this Pillow bundles no libjpeg/libpng")
    path, err = native_lib._compile("image_decode", routes["pillow"])
    assert err is None, err
    lib = ctypes.CDLL(path)
    lib.img_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_uint8)]
    for name, size, gray in CASES:
        want = native.decode_resize(os.path.join(images, name), size, gray)
        out = np.empty((size, size, 1 if gray else 3), np.uint8)
        ok = lib.img_decode_resize(
            os.path.join(images, name).encode(), size, int(gray),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        assert bool(ok) == (want is not None), name
        if ok:
            np.testing.assert_array_equal(out, want)


def test_a_failed_route_falls_through_to_the_next(monkeypatch):
    """A route that does not compile (or whose library does not load) is
    recorded in ``errors`` and the next route is taken: the machine
    without libjpeg/libpng development files builds the Pillow route."""
    routes = native_lib._routes("image_decode")
    if len(routes) < 2:
        pytest.skip("this Pillow bundles no libjpeg/libpng")
    broken = [("system", ("-lno_such_library_anywhere",))] + routes[1:]
    monkeypatch.setattr(native_lib, "_routes", lambda name: broken)
    for attr in ("_loaded", "errors", "routes"):
        monkeypatch.setattr(native_lib, attr, {})
    lib = native_lib.load("image_decode")
    assert lib is not None and native_lib.routes == {"image_decode":
                                                     "pillow"}
    assert native_lib.errors["image_decode"].startswith("[system] g++ failed")
    assert lib.img_jpeg_lib_version() == 62


def test_committed_fixtures(jax_native):
    """``tests/torch_data/expected.npz`` is the JAX native decode of the
    committed images, and the port's native decode gives it too."""
    want = np.load(os.path.join(DATA, "expected.npz"))
    assert sorted(want.files) == sorted(k for c in FIXTURES.values()
                                        for k, _, _ in c)
    for name, cases in FIXTURES.items():
        for key, size, gray in cases:
            np.testing.assert_array_equal(
                jax_native.decode_image(name, size, gray, DATA), want[key])
            np.testing.assert_array_equal(
                decode.decode_image(name, size, gray, DATA), want[key])
    total = sum(os.path.getsize(os.path.join(DATA, f))
                for f in os.listdir(DATA))
    assert total <= 1 << 20


def test_libraries_load_from_the_port_build_dir():
    build_dir = os.path.realpath(native_lib.BUILD_DIR)
    assert build_dir.endswith(os.path.join("mpmc_tpu_torch", "_build"))
    for name in ("tokenizer", "image_decode"):
        lib = native_lib.load(name)
        assert lib is not None, native_lib.errors.get(name)
        assert os.path.dirname(os.path.realpath(lib._name)) == build_dir
        assert "libmpmc_native" not in lib._name
    assert native.lib_versions()[0] >= 62


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

ARABIC = [chr(c) for c in range(0x0621, 0x064B)]
DIACRITICS = [chr(c) for c in range(0x064B, 0x0653)]
LATIN = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
             "éèüöäßçñÉÜİıœ")
EMOJI = ["😀", "🔥", "👍🏽", "🇸🇦", "❤️", "😂"]
PUNCT = list(".,!?؟،؛:()[]\"'-_/#@") + ["...", "«", "»"]
DIGITS = list("0123456789٠١٢٣٤٥٦٧٨٩")
SPACES = [" ", " ", " ", "\t", "\n", "‏", " "]


def random_texts(n: int, seed: int):
    rng = np.random.default_rng(seed)

    def word():
        kind = rng.integers(0, 10)
        if kind < 5:
            letters = [rng.choice(ARABIC) for _ in range(rng.integers(1, 8))]
            if rng.random() < 0.4:
                letters = [c + (rng.choice(DIACRITICS)
                                if rng.random() < 0.5 else "")
                           for c in letters]
            return "".join(letters)
        if kind < 7:
            return "".join(rng.choice(LATIN, rng.integers(1, 9)))
        if kind < 8:
            return "".join(rng.choice(EMOJI, rng.integers(1, 3)))
        if kind < 9:
            return "".join(rng.choice(DIGITS, rng.integers(1, 5)))
        return "".join(rng.choice(PUNCT, rng.integers(1, 3)))

    return ["".join(word() + str(rng.choice(SPACES))
                    for _ in range(rng.integers(0, 40))) for _ in range(n)]


@pytest.fixture(scope="module")
def corpus():
    return random_texts(3000, seed=7)


def _vocab_file(tmp_path, vocab, name):
    path = tmp_path / name
    WordPieceTokenizer(vocab).save(str(path))
    return str(path)


@pytest.mark.parametrize("mode", ["words", "subword"])
@pytest.mark.parametrize("lower", [False, True])
def test_native_tokenizer_zero_differing_rows(corpus, tmp_path, mode, lower):
    train = corpus[:1500]
    if mode == "words":
        vocab = corpus_wordpiece_vocab(train, max_words=2000)
        assert vocab == j_corpus_vocab(train, max_words=2000)
    else:
        vocab = learn_wordpiece_vocab(train, vocab_size=600)
    path = _vocab_file(tmp_path, vocab, f"{mode}_{lower}.txt")
    port = NativeWordPieceTokenizer(path, do_lower_case=lower)
    jax_ = JNativeTok(path, do_lower_case=lower)
    py = WordPieceTokenizer.from_file(path, do_lower_case=lower)
    for length in (16, 128):
        ids, mask = port.encode_batch(corpus, length)
        for other in (jax_, py):
            o_ids, o_mask = other.encode_batch(corpus, length)
            differ = int(((ids != o_ids) | (mask != o_mask)).any(axis=1).sum())
            assert differ == 0, (type(other).__module__, length, differ)


def test_native_tokenizer_threads_and_edge_cases(corpus, tmp_path):
    path = _vocab_file(tmp_path, corpus_wordpiece_vocab(corpus[:500]), "v")
    one = NativeWordPieceTokenizer(path, num_threads=1)
    many = NativeWordPieceTokenizer(path, num_threads=8)
    np.testing.assert_array_equal(one.encode_batch(corpus, 48)[0],
                                  many.encode_batch(corpus, 48)[0])
    py = WordPieceTokenizer.from_file(path)
    for s in ["", "   ", "a" * 300, "x!y?z", "مرحبا، بكم.", "tab\there",
              "emoji 😀 inside", "١٢٣ أرقام"]:
        np.testing.assert_array_equal(one.encode(s, 32)[0],
                                      py.encode(s, 32)[0])
    assert one.encode_batch([], 8)[0].shape == (0, 8)


class _Counting:
    """A backend that counts its calls (class name as the cache key
    sees it)."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def encode_batch(self, texts, max_length):
        self.calls += 1
        return self.inner.encode_batch(texts, max_length)


def test_batch_tokenizer_cache_hit_miss_and_jax_key(corpus, tmp_path):
    path = _vocab_file(tmp_path, corpus_wordpiece_vocab(corpus[:500]), "v")
    backend = _Counting(NativeWordPieceTokenizer(path))
    cache = str(tmp_path / "cache")
    texts = corpus[:200]
    first = BatchTokenizer(backend, 32, cache_dir=cache, cache_salt="a")(texts)
    assert backend.calls == 1 and len(os.listdir(cache)) == 1
    hit = BatchTokenizer(backend, 32, cache_dir=cache, cache_salt="a")(texts)
    assert backend.calls == 1
    np.testing.assert_array_equal(hit.ids, first.ids)
    np.testing.assert_array_equal(hit.mask, first.mask)
    BatchTokenizer(backend, 32, cache_dir=cache, cache_salt="b")(texts)
    assert backend.calls == 2 and len(os.listdir(cache)) == 2
    BatchTokenizer(backend, 16, cache_dir=cache, cache_salt="a")(texts)
    assert backend.calls == 3
    # The key names the backend's class: the two packages' native
    # tokenizers key a split alike, so their tok_<key>.npz files coincide.
    port_bt = BatchTokenizer(NativeWordPieceTokenizer(path), 32,
                             cache_salt="s")
    jax_bt = JBatchTokenizer(JNativeTok(path), 32, cache_salt="s")
    assert port_bt._cache_key(texts) == jax_bt._cache_key(texts)


def test_build_tokenizer_is_native_with_a_hashed_corpus_vocab(corpus,
                                                              tmp_path):
    cache = str(tmp_path / "c")
    tok = build_tokenizer(corpus[:300], None, cache_dir=cache)
    assert isinstance(tok, HybridWordPieceTokenizer)
    files = sorted(os.listdir(cache))
    assert len(files) == 1 and files[0].startswith("corpus_vocab_")
    ids, mask = tok.encode_batch(corpus[:300], 64)
    py = WordPieceTokenizer(corpus_wordpiece_vocab(corpus[:300]))
    np.testing.assert_array_equal(ids, py.encode_batch(corpus[:300], 64)[0])
    assert any(f.startswith("tok_") for f in os.listdir(cache))
    vocab_file = str(tmp_path / "vocab.txt")
    tok.save(vocab_file)
    again = build_tokenizer([], vocab_file, cache_dir=cache)
    assert isinstance(again, HybridWordPieceTokenizer)
    assert again.vocab == tok.vocab
