"""``mpmc_tpu_torch/text/bpe.py`` (``ByteLevelBPETokenizer``) against
``mpmc_tpu.text.bpe`` on a hand-written ``vocab.json``/``merges.txt``: the
same ids and masks, truncation and padding, and the same unknown-token and
special-token handling."""

import json

import numpy as np
import pytest

from mpmc_tpu.text.bpe import ByteLevelBPETokenizer as JBPE
from mpmc_tpu.text.bpe import bytes_to_unicode as j_bytes_to_unicode
from mpmc_tpu_torch.text.bpe import ByteLevelBPETokenizer, bytes_to_unicode

SPACE = "Ġ"   # GPT-2's printable stand-in for the space byte
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o"),
          (SPACE, "w"), ("o", "r"), (SPACE + "w", "or"), ("l", "d"),
          (SPACE + "wor", "ld"), ("1", "2"), ("Ø", "§"), ("t", "h"),
          ("th", "e"), (SPACE, "the")]
TEXTS = ["hello world", "hello, world! 12 12", "the world", "",
         "Hello World", "unknown qz", "  spaced   out  ", "سلام world",
         "emoji 😀 here", "hello " * 40, "it's we've", "the12the"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    tokens = ["<s>", "<pad>", "</s>", "<unk>"]
    tokens += sorted(set(bytes_to_unicode().values()))
    tokens += ["".join(m) for m in MERGES]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    del vocab["q"]                        # an unknown piece
    (d / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False),
                                  encoding="utf-8")
    (d / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in MERGES) + "\n",
        encoding="utf-8")
    return str(d / "vocab.json"), str(d / "merges.txt")


def test_byte_map_equal():
    assert bytes_to_unicode() == j_bytes_to_unicode()
    assert len(set(bytes_to_unicode().values())) == 256


@pytest.mark.parametrize("length", [4, 8, 16, 64])
def test_ids_and_masks_equal_jax(files, length):
    port = ByteLevelBPETokenizer.from_files(*files)
    ref = JBPE.from_files(*files)
    ids, mask = port.encode_batch(TEXTS, length)
    j_ids, j_mask = ref.encode_batch(TEXTS, length)
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(mask, j_mask)
    assert ids.dtype == mask.dtype == np.int32
    assert ids.shape == (len(TEXTS), length)
    # Framing, truncation and padding: <s> first, </s> after the kept body,
    # pad id 1 with mask 0 beyond it.
    assert (ids[:, 0] == port.bos_id).all()
    n = mask.sum(axis=1)
    assert (ids[np.arange(len(TEXTS)), n - 1] == port.eos_id).all()
    assert all((ids[i, n[i]:] == port.pad_id).all() for i in range(len(n)))
    assert (n <= length).all() and n.max() == length


def test_merges_and_unknowns(files):
    port = ByteLevelBPETokenizer.from_files(*files)
    vocab = port.vocab
    assert port.tokenize_to_ids("hello world") == [
        vocab["hello"], vocab[SPACE + "world"]]
    assert vocab["<unk>"] in port.tokenize_to_ids("q")
    assert port.tokenize_to_ids("hello world") == JBPE.from_files(
        *files).tokenize_to_ids("hello world")
