"""``correct`` at a size a CPU test holds: a sound run passes its limits;
the control (the reference in the program's place at the precision below)
and each fault the cells can have come out not correct. The same at the
cells' own sizes on the card (``cuda``)."""

import numpy as np
import pytest
import torch

import lemon_tpu_torch.knn.index as knn_index
import lemon_tpu_torch.models.clip as clip_mod
from portbench import check as chk
from portbench import control, harness
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


def _run(cell):
    return harness.run(BENCH, cell, 2**31 + 77, 0.01, False, CPU, 0.0)


def _within(numbers, limits):
    return all(numbers[n] <= limits[n] for n in limits)


@pytest.mark.parametrize("kind,precision", [("labels", "fp32"), ("captions", "fp32"), ("labels", "bf16")])
def test_a_sound_run_is_correct(kind, precision):
    res = _run(tiny_cell(kind, precision))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] == 1 and res["failed"] == 0


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_the_control_is_not_correct(precision):
    cell = tiny_cell("labels", precision)
    got = control.readings(cell, 2**31 + 78, CPU)
    assert _within(got["program"], cell.limits), got["program"]
    assert not _within(got["control"], cell.limits), got["control"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Each image batch's second half replaced by the mean of its first."""
    encode = clip_mod.ClipModel.encode_image

    def half(self, pixels):
        out = encode(self, pixels)
        h = len(out) // 2
        return torch.cat([out[:h], out[:h].mean(0, keepdim=True).expand(len(out) - h, -1)])

    monkeypatch.setattr(clip_mod.ClipModel, "encode_image", half)
    res = _run(tiny_cell())
    assert not res["correct"] and res["checks"]["img_emb_gap"]["value"] > res["checks"]["img_emb_gap"]["limit"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    """One neighbour id of one query, changed as the search returns it."""
    search = knn_index.ExactKnnIndex.search

    def altered(self, q, k):
        scores, ids = search(self, q, k)
        ids = ids.copy()
        ids[0, -1] = next(i for i in range(self.ntotal) if i not in ids[0])
        return scores, ids

    monkeypatch.setattr(knn_index.ExactKnnIndex, "search", altered)
    res = _run(tiny_cell())
    assert not res["correct"] and res["checks"]["knn_gap"]["value"] > res["checks"]["knn_gap"]["limit"]


@pytest.mark.parametrize("how", ["fit-first-point", "reported-f1-altered"])
def test_a_fit_cut_short_or_misreported_is_not_correct(monkeypatch, how):
    """The fit returns the grid's first point (every hyperparameter 0), or
    reports a val F1 that its choice does not reach."""
    from lemon_tpu_torch import detect
    from lemon_tpu_torch.scoring.lemon import calc_scores, unpack_hparams
    from lemon_tpu_torch.scoring.thresholds import optimize_f1_efficient

    fit = detect.maximize_metric

    def cut_short(logs_val, **kw):
        if how != "fit-first-point":
            x, f1, thres = fit(logs_val, **kw)
            return x, f1 + 0.1, thres
        x = np.zeros(6)
        f1, thres = optimize_f1_efficient(logs_val.is_mislabel, calc_scores(logs_val, unpack_hparams(x)),
                                          return_thres=True)
        return x, f1, thres

    monkeypatch.setattr(detect, "maximize_metric", cut_short)
    res = _run(tiny_cell())
    assert not res["correct"] and res["checks"]["fit_gap"]["value"] > res["checks"]["fit_gap"]["limit"]
    others = set(chk.NUMBERS) - {"fit_gap"}
    assert all(res["checks"][n]["value"] <= res["checks"][n]["limit"] for n in others), res["checks"]


def test_a_reported_metric_altered_is_not_correct(monkeypatch):
    """The val and test splits' AUROC, altered by 1e-9 as the program reports them."""
    from lemon_tpu_torch import detect

    evaluate = detect.eval_metrics

    def altered(y, score, **kw):
        out = evaluate(y, score, **kw)
        return dict(out, AUROC=out["AUROC"] + 1e-9) if len(y) == 100 and "fix_thress" in kw else out

    monkeypatch.setattr(detect, "eval_metrics", altered)
    res = _run(tiny_cell())
    assert not res["correct"] and res["checks"]["auroc_gap"]["value"] > 0


def test_a_detection_that_raises_is_failed_and_not_correct(monkeypatch):
    """Embedding a split longer than one batch (the warm-up's) raises."""
    from lemon_tpu_torch.models.encoder import ClipEncoder

    embed = ClipEncoder.embed_split

    def broken(self, split, texts, **kw):
        if len(split) > self.batch_size:
            raise RuntimeError("planted")
        return embed(self, split, texts, **kw)

    monkeypatch.setattr(ClipEncoder, "embed_split", broken)
    res = _run(tiny_cell())
    assert not res["correct"] and res["failed"] == res["attempted"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct_at_the_cells_size(card, workload):
    """The control, the program's int8 path (bf16 cells) and, where the cell
    compares ``fit_gap``, the fit cut to the grid's first point; the
    grid-only fit is read but may pass."""
    cell = harness.Cell.load(BENCH, workload)
    skip = {"fit-grid-only"} | (set() if "fit_gap" in cell.limits else {"fit-first-point"})
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control.readings(cell, seed, card, who=set(control.STAND_INS) - skip)
        assert _within(got["program"], cell.limits), got["program"]
        for who in set(got) - {"program"}:
            assert not _within(got[who], cell.limits), (who, got[who])
