"""The architecture modules: a configuration names its towers, and a second
architecture enters the harness with files of its own; a configuration's
keys are checked against its architecture; the reference's towers take the
exact GELU where a configuration asks for it."""

import copy
import json
import sys

import numpy as np
import pytest
import torch

from portbench import arch, harness
from portbench.arch import openai_clip
from portbench.tests import biomed_arch
from portbench.tests.tiny import TINY
from portbench.weights import make_weights

CPU = torch.device("cpu")
BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_as_openai_clip(workload):
    cell = harness.Cell.load(BENCH, workload)
    assert "architecture" not in cell.config and arch.of(cell.config) is openai_clip


def _bench_with(tmp_path, cfg: dict) -> dict:
    """BENCHMARK.json with one configuration, written under ``tmp_path``,
    in the place of ``b32-cifar100-fp32``'s (whose traffic and limits the
    cell keeps)."""
    path = tmp_path / f"{cfg['name']}.json"
    path.write_text(json.dumps(cfg))
    bench = copy.deepcopy(BENCH)
    bench["configs"] = [{"name": cfg["name"], "file": str(path)}]
    bench["workloads"] = [{"name": "b32-cifar100-fp32", "config": cfg["name"], "traffic": "cifar100", "chips": 1}]
    return bench


@pytest.mark.parametrize("fault,message", [("missing", "lacks 'text_layers'"),
                                           ("unknown", "holds 'text_intermediate_size'")])
def test_a_config_with_a_missing_or_unknown_key_is_refused(tmp_path, fault, message):
    cfg = harness.load_json(harness.PKG / "configs" / "clip-vit-b32-fp32.json")
    if fault == "missing":
        del cfg["text_layers"]
    else:
        cfg["text_intermediate_size"] = 2048
    with pytest.raises(SystemExit, match=message):
        harness.Cell.load(_bench_with(tmp_path, cfg), "b32-cifar100-fp32")


def test_a_second_architecture_enters_with_files_of_its_own(tmp_path, monkeypatch):
    """The port's BiomedCLIP, supplied by the test as ``portbench.arch.tiny_biomed``:
    a cell of it loads, sets up, runs a detection and is judged through the
    harness's own calls."""
    monkeypatch.setitem(sys.modules, "portbench.arch.tiny_biomed", biomed_arch)
    built = []
    encoder = biomed_arch.encoder

    def recorded(*args):
        built.append(encoder(*args))
        return built[-1]

    monkeypatch.setattr(biomed_arch, "encoder", recorded)
    cfg = {"name": "tiny-biomed", "architecture": "tiny_biomed", "source": "a test", "precision": "fp32",
           "reduced": [], **biomed_arch.TINY}
    cell = harness.Cell.load(_bench_with(tmp_path, cfg), "b32-cifar100-fp32")
    cell.mix["rows"] = {"train": 400, "val": 100, "test": 100}
    cell.mix["check_rows"] = 96
    cell.mix["detection"]["batch_size"] = 32

    res = harness.run(BENCH, cell, 2**31 + 79, 0.01, False, CPU, 0.0)
    assert res["correct"] and res["attempted"] == 1, res["checks"]
    assert res["checks"]["img_emb_gap"]["value"] < 1e-8 and res["checks"]["txt_emb_gap"]["value"] < 1e-8
    from lemon_tpu_torch.models.biomed import BiomedClipConfig, BiomedClipModel

    assert type(built[0].model) is BiomedClipModel and built[0].model.cfg.text == BiomedClipConfig.tiny().text
    with torch.device("meta"):
        tiny = BiomedClipModel(BiomedClipConfig.tiny()).state_dict()
    assert biomed_arch.param_shapes(cell.config) == [(k, tuple(v.shape)) for k, v in tiny.items()]


def test_an_exact_gelu_clip_matches_the_program():
    """``quick_gelu: false``: the reference's MLP takes the exact (erf) GELU,
    as the program's does, within the fp32 tolerance of
    ``test_portbench_reference.py``."""
    cfg = dict(TINY, precision="fp32", quick_gelu=False)
    W = make_weights(cfg, 11, CPU)
    enc = harness.build_encoder(cfg, W, CPU, 8, 11)
    ref = arch.of(cfg)
    tokens = torch.from_numpy(ref.tokenize(["a photo of a cat", "two dogs on a beach at night"] * 4, cfg))
    pixels = ref.preprocess(torch.from_numpy(np.random.default_rng(2).integers(0, 256, (8, 32, 32, 3),
                                                                               dtype=np.uint8)), cfg)
    with torch.no_grad():
        for mine, theirs in ((ref.encode_image(W, cfg, pixels), enc.model.encode_image(pixels)),
                             (ref.encode_text(W, cfg, tokens), enc.model.encode_text(tokens))):
            theirs = theirs / theirs.norm(dim=-1, keepdim=True)
            assert (mine - theirs).abs().max().item() < 1e-5
