"""The port's submission tools (``check``, ``score``, ``combine``,
``analyze``) and the modules behind them (``io/scorer``, ``io/tsv``
readers, ``cv/ensemble``, ``train/metrics`` threshold scans, ``analysis``)
against the JAX package's, on a synthetic gold manifest and synthetic
per-fold probability TSVs: the numbers must be equal, the printed reports
identical and the TSV that ``combine`` writes the same bytes."""

import json

import numpy as np
import pytest

from mpmc_tpu import analysis as j_analysis
from mpmc_tpu.cli.main import build_parser as j_build_parser
from mpmc_tpu.cv import ensemble as j_ensemble
from mpmc_tpu.io import scorer as j_scorer
from mpmc_tpu.io import tsv as j_tsv
from mpmc_tpu.train import metrics as j_metrics
from mpmc_tpu_torch import analysis
from mpmc_tpu_torch.cli.main import build_parser
from mpmc_tpu_torch.cv import ensemble
from mpmc_tpu_torch.io import scorer, tsv
from mpmc_tpu_torch.train import metrics

N = 48
WORDS = ["دعاية", "نص", "مهم", "جدا", "عادي", "يومي", "خبر", "#وسم", "اليوم"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A gold manifest split in two files, five fold TSVs of run id
    ``neural`` and three of run id ``ngram`` (probabilities that lean
    towards the gold label), a label TSV, and a malformed one."""
    d = tmp_path_factory.mktemp("submission")
    rng = np.random.default_rng(0)
    ids = [f"memes/img_{i}.jpg" for i in range(N)]
    gold = (rng.random(N) < 0.4).astype(int)
    rows = [{"id": i, "img_path": i,
             "text": " ".join(rng.choice(WORDS, int(rng.integers(2, 8)))),
             "class_label": "propaganda" if y else "not_propaganda"}
            for i, y in zip(ids, gold)]
    paths = {"gold": [str(d / "gold_a.json"), str(d / "gold_b.json")]}
    for path, part in zip(paths["gold"], (rows[:30], rows[30:])):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(part, f, ensure_ascii=False)
    with open(d / "gold.json", "w", encoding="utf-8") as f:
        json.dump(rows, f, ensure_ascii=False)
    paths["gold_all"] = str(d / "gold.json")
    paths["folds"] = []
    for k, (run_id, spread) in enumerate([("neural", 0.25)] * 5
                                         + [("ngram", 0.4)] * 3):
        p = np.clip(0.5 + (gold - 0.5) * 0.3
                    + rng.normal(0, spread, N), 0.001, 0.999)
        if k == 0:
            p[:3] = [1.0, 0.0, 0.5]          # the logit clamp and a tie
        path = str(d / f"fold_{k}.tsv")
        j_tsv.write_prob_tsv(path, ids, (p > 0.5).astype(int), p, run_id)
        paths["folds"].append(path)
    paths["labels"] = str(d / "pred.tsv")
    j_tsv.write_label_tsv(paths["labels"], ids,
                          (rng.random(N) < 0.5).astype(int), "run-1")
    paths["bad"] = str(d / "bad.tsv")
    with open(paths["bad"], "w") as f:
        f.write("id\tlabel\trun_id\nmemes/img_0.jpg\tmaybe\trun\n")
    paths["dir"] = d
    return paths


def _run(parser, argv, capsys):
    args = parser.parse_args(argv)
    rc = args.fn(args)
    return rc, capsys.readouterr().out


def _both(argv, capsys):
    """(rc, stdout) of the JAX command and of the port's."""
    return (_run(j_build_parser(), argv, capsys),
            _run(build_parser(), argv, capsys))


def test_check_matches_jax(files, capsys):
    results = []
    for paths in ([files["labels"]], [files["labels"], files["bad"]],
                  files["folds"][:1]):
        want, got = _both(["check", "-p", *paths], capsys)
        assert got == want
        results.append(got)
    # A 4-column probability TSV is not a submission.
    assert results == [(0, "OK\n"), (1, "FORMAT ERROR\n"),
                       (1, "FORMAT ERROR\n")]
    assert tsv.check_format(files["labels"]) is True
    assert tsv.check_format(files["bad"]) is False


def test_score_and_readers_match_jax(files, capsys):
    want, got = _both(["score", "-g", files["gold_all"], "-p",
                       files["labels"]], capsys)
    assert got == want and got[0] == 0 and got[1].startswith("acc: ")
    assert (scorer.evaluate(files["gold_all"], files["labels"])
            == j_scorer.evaluate(files["gold_all"], files["labels"]))
    assert (tsv.read_predictions(files["labels"])
            == j_tsv.read_predictions(files["labels"]))
    for path in files["folds"]:
        assert tsv.read_run_id(path) == j_tsv.read_run_id(path)
        got_p, want_p = (tsv.read_prob_predictions(path),
                         j_tsv.read_prob_predictions(path))
        assert got_p[:2] == want_p[:2]
        np.testing.assert_array_equal(got_p[2], want_p[2])
    # A bad file is refused before scoring, by both.
    assert _both(["score", "-g", files["gold_all"], "-p", files["bad"]],
                 capsys)[1][0] == 1
    with pytest.raises(ValueError, match="No such id"):
        scorer.evaluate(files["gold"][0], files["labels"])


def test_metric_functions_match_jax(files):
    rng = np.random.default_rng(1)
    y = (rng.random(60) < 0.4).astype(int)
    p = np.round(rng.random(60), 2)
    pred = (p > 0.5).astype(int)
    for name in ("accuracy_score", "macro_f1", "binary_f1",
                 "weighted_precision_recall"):
        assert getattr(scorer, name)(y, pred) == getattr(j_scorer, name)(
            y, pred)
    for got, want in zip(scorer.precision_recall_f1(y, pred, [0, 1]),
                         j_scorer.precision_recall_f1(y, pred, [0, 1])):
        np.testing.assert_array_equal(got, want)
    for name in ("threshold_scan", "macro_f1_threshold_scan"):
        assert getattr(metrics, name)(y, p) == getattr(j_metrics, name)(y, p)
        assert (getattr(metrics, name)(y, p, 7)
                == getattr(j_metrics, name)(y, p, 7))
    assert scorer.read_gold(files["gold_all"]) == j_scorer.read_gold(
        files["gold_all"])


def test_ensemble_functions_match_jax(files):
    folds, run_ids = [], []
    for path in files["folds"]:
        ids, _, probs = j_tsv.read_prob_predictions(path)
        folds.append(dict(zip(ids, probs)))
        run_ids.append(j_tsv.read_run_id(path))
    gold = j_scorer.read_gold(files["gold_all"])
    assert ensemble.majority_voting(folds) == j_ensemble.majority_voting(folds)
    for space in ("prob", "logit"):
        assert (ensemble.average_probability(folds, space)
                == j_ensemble.average_probability(folds, space))
        fam = ensemble.group_average(folds, run_ids, space)
        assert fam == j_ensemble.group_average(folds, run_ids, space)
        a, b = fam.values()
        assert (ensemble.family_weight_scan(a, b, gold, num=11, space=space)
                == j_ensemble.family_weight_scan(a, b, gold, num=11,
                                                 space=space))
    for metric in ("binary", "macro", "youden"):
        assert (ensemble.threshold_optimization(folds[0], gold,
                                                metric=metric)
                == j_ensemble.threshold_optimization(folds[0], gold,
                                                     metric=metric))
    b = dict(list(folds[1].items())[:-1])
    with pytest.raises(ValueError, match="id sets differ"):
        ensemble.family_weight_scan(folds[0], b, gold)


COMBINE = {
    "prob": [],
    "logit": ["--average", "logit"],
    "macro": ["--metric", "macro"],
    "youden": ["--metric", "youden", "--per-member"],
    "families": ["--group-by-run-id"],
    "families-logit": ["--group-by-run-id", "--average", "logit"],
    "family-weight": ["--scan-family-weight", "--metric", "macro"],
    "per-member": ["--per-member", "--metric", "binary"],
}


@pytest.mark.parametrize("case", sorted(COMBINE))
def test_combine_matches_jax_byte_for_byte(files, capsys, case):
    """Both commands over the same TSVs and the gold split in two files;
    the port's printed report and written TSV equal the JAX package's."""
    d = files["dir"]
    outs = {}
    for who, parser in (("jax", j_build_parser()), ("port", build_parser())):
        out = str(d / f"ens_{case}_{who}.tsv")
        argv = ["combine", "--files", *files["folds"], "--gold",
                *files["gold"], "--out", out, *COMBINE[case]]
        rc, stdout = _run(parser, argv, capsys)
        with open(out, "rb") as f:
            outs[who] = (rc, stdout.replace(out, "OUT"), f.read())
    assert outs["port"] == outs["jax"]
    rc, _, body = outs["port"]
    assert rc == 0 and body.startswith(b"id\tlabel\trun_id\n")
    assert body.count(b"\tensemble\n") == N
    # One family is not two: both refuse the weight scan.
    argv = ["combine", "--files", *files["folds"][:5], "--gold",
            files["gold_all"], "--scan-family-weight"]
    want, got = _both(argv, capsys)
    assert got == want and got[0] == 1


def test_analyze_matches_jax(files, capsys):
    for top in ("15", "0", "3"):
        want, got = _both(["analyze", "-g", files["gold_all"], "-p",
                           files["labels"], "--top-words", top], capsys)
        assert got == want and got[0] == 0
    assert "misclassified: " in got[1]
    rows = analysis.misclassified(files["labels"], files["gold_all"])
    assert rows == j_analysis.misclassified(files["labels"], files["gold_all"])
    for normalize in (True, False):
        assert (analysis.word_frequencies(rows, normalize, 5)
                == j_analysis.word_frequencies(rows, normalize, 5))
    rep = analysis.per_class_report(files["labels"], files["gold_all"])
    want = j_analysis.per_class_report(files["labels"], files["gold_all"])
    assert json.dumps(rep, default=float) == json.dumps(want, default=float)
