"""A traffic mix with a ``work_seed`` gives every seed the same work: the
memes' lengths and labels in one order, the system's own seed and the first
fold from it; the token ids, the pixels and the weights from the seed."""

import numpy as np
import pytest
import torch

from portbench.data import make_memes
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["train_2c_hostfed", "train_2a_packed"])
def test_work_is_the_same_for_every_seed(name):
    cell = tiny_cell(name)
    cfg, t = cell["config"], cell["traffic"]
    assert "work_seed" in t
    a, b = (make_memes(cfg, t, 40, seed, 0, CPU) for seed in (11, 2**31 + 7))
    assert np.array_equal(a["label"], b["label"])
    assert np.array_equal(a["text_mask"], b["text_mask"])
    assert not np.array_equal(a["text_ids"], b["text_ids"])
    if "image" in a:
        assert np.array_equal(a["caption_mask"], b["caption_mask"])
        assert not np.array_equal(a["image"], b["image"])
    free = dict(t)
    del free["work_seed"]
    c, d = (make_memes(cfg, free, 40, seed, 0, CPU) for seed in (11, 12))
    assert not np.array_equal(c["text_mask"], d["text_mask"])


def test_the_system_seed_and_first_fold_follow_the_work_seed(monkeypatch):
    from portbench.drivers import train

    cell = tiny_cell("train_2a_packed")
    monkeypatch.setattr(train.Session, "_build", lambda self, k: None)
    monkeypatch.setattr(train.Session, "_first_steps", lambda self: None)
    seen = []
    for seed in (3, 2**31 + 4):
        s = train.Session(cell, seed, CPU)
        s.setup()
        seen.append((s.tc.seed, s.first_fold))
        assert s.W is not None
    w = cell["traffic"]["work_seed"]
    assert seen == [(w, w % 5)] * 2
