"""The port's generative judges (``baselines/judges.py``, ``cli/run_judges.py``)
and its sharded BLIP-2 checkpoints (``models/blip2.load_blip2`` /
``save_blip2``, ``models/safetensors_io``), held to the JAX package on the
CPU.

- Every case of tests/test_judges_and_preprocess.py that drives the judges
  runs on both packages: the case's own body, its names bound to the
  port's module or left on the JAX one (``tests/port_cases.py``); its two
  CLI cases are re-stated with the port's ``--platform cpu``.
- ``run_judges --backend flax`` on a tiny HF BLIP-2 (HF's ``save_pretrained``
  in shards, weights drawn wider than HF's init so the greedy replies vary):
  the port's generated ids and ``raw_output`` equal the JAX CLI's at
  ``--generate_batch_size`` 1 and 4, ``pred_score`` within 1e-5 and every
  ``agg_results`` entry within 1e-5 (the JAX metrics are sklearn's, the
  port's numpy's). One JAX run per batch size, shared by a module fixture.
- ``--backend echo``: equal ``scores.csv`` for llava and for vdc with the
  builtin QA table, both packages in one process (``hash()`` is salted per
  process).
- A sharded HF checkpoint (safetensors or ``torch.save`` shards, or fp16
  safetensors): the port's ``load_blip2`` gives the JAX ``load_blip2``'s
  logits within 1e-5; ``save_blip2``'s shards read back bit for bit, and
  HF's ``from_pretrained`` reads them.
"""

import pickle
import sys

import jax
import numpy as np
import pytest
import torch

import lemon_tpu.baselines.judges as jax_judges
import lemon_tpu_torch.baselines.judges as port_judges
import test_judges_and_preprocess as jax_cases
from port_cases import PACKAGES, case_on, run_case

TOL = 1e-5
JUDGE_CASES = ("test_llava_verdict_parsing", "test_llava_score_direction",
               "test_llava_judge_end_to_end_with_fake_vlm", "test_vqg_parse_caps_and_cleans",
               "test_generate_questions_uses_caption_prompt", "test_specific_answer_matching",
               "test_common_answer_matching_and_score", "test_vdc_pipeline_end_to_end",
               "test_vdc_composition_matches_reference")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("case", JUDGE_CASES)
def test_judge_case_on_both_packages(request, case, package):
    run_case(request, jax_cases, case, package)


def test_the_cases_bind_the_port():
    fn = case_on(jax_cases, "test_vdc_pipeline_end_to_end", "lemon_tpu_torch")
    assert fn.case.__globals__["VdcPipeline"] is port_judges.VdcPipeline
    assert fn.case.__globals__["run_llava_judge"] is port_judges.run_llava_judge
    assert jax_cases.VdcPipeline is jax_judges.VdcPipeline


def _main(package):
    if package == "lemon_tpu":
        from lemon_tpu.cli.run_judges import main

        return main
    from lemon_tpu_torch.cli.run_judges import main

    return lambda argv: main(argv + ["--platform", "cpu"])


@pytest.mark.parametrize("package", PACKAGES)
def test_run_judges_classification_dataset_with_builtin_qa(tmp_path, package):
    """tests/test_judges_and_preprocess.py's case on both CLIs: classification
    splits judge their labels as text, which are the builtin QA table's keys."""
    import importlib

    labels = importlib.import_module(f"{package}.data.labels")
    out = tmp_path / "vdc_clf"
    _main(package)([
        "--judge", "vdc", "--output_dir", str(out), "--backend", "echo",
        "--dataset", "synthetic", "--noise_type", "symmetric",
        "--specific_qa_csv", "builtin", "--synthetic_n", "60", "--debug",
    ])
    assert (out / "done").exists()
    df = pickle.load(open(out / "res.pkl", "rb"))["df"]
    assert set(df["noisy_label"]).issubset(set(labels.LABEL_SETS["cifar10"]))
    sixths = np.round(df["pred_score"].to_numpy() * 6)
    np.testing.assert_allclose(df["pred_score"].to_numpy(), sixths / 6, atol=1e-9)
    assert any(s not in (0.0, 0.5, 1.0) for s in df["pred_score"])


@pytest.mark.parametrize("package", PACKAGES)
def test_vendored_cifar10_specific_qa(tmp_path, package):
    import importlib

    judges = importlib.import_module(f"{package}.baselines.judges")
    labels = importlib.import_module(f"{package}.data.labels")
    qa = judges.load_cifar10_specific_questions()
    assert set(qa) == set(labels.LABEL_SETS["cifar10"])
    assert all(len(v) == 4 for v in qa.values())
    q, a = qa["airplane"][0]
    assert "airplane" in q and a == "yes"
    p = tmp_path / "qa.csv"
    p.write_text("label,question,answer\ncat,Is it a cat?,yes\n")
    assert judges.load_cifar10_specific_questions(p) == {"cat": [("Is it a cat?", "yes")]}


def test_vendored_qa_table_is_the_jax_one():
    from pathlib import Path

    names = [Path(m.__file__).parent / "assets" / "vdc_cifar10_specific_qa.csv" for m in (jax_judges, port_judges)]
    assert names[0].read_bytes() == names[1].read_bytes()
    assert port_judges.load_cifar10_specific_questions() == jax_judges.load_cifar10_specific_questions()


# ---------------------------------------------------------------------------
# tiny HF BLIP-2 checkpoints


def _hf_blip2():
    from transformers import Blip2Config, Blip2ForConditionalGeneration, Blip2QFormerConfig, Blip2VisionConfig
    from transformers import OPTConfig

    torch.manual_seed(3)
    v = Blip2VisionConfig(hidden_size=32, intermediate_size=48, num_hidden_layers=2, num_attention_heads=2,
                          image_size=56, patch_size=14)
    q = Blip2QFormerConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=48,
                           encoder_hidden_size=32, cross_attention_frequency=2, vocab_size=100)
    t = OPTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, ffn_dim=48, vocab_size=120,
                  max_position_embeddings=64, word_embed_proj_dim=32)
    model = Blip2ForConditionalGeneration(Blip2Config.from_vision_qformer_text_configs(v, q, t, num_query_tokens=4))
    model.eval()
    with torch.no_grad():  # wider than HF's init: greedy replies that vary from row to row
        for p in model.parameters():
            p.add_(torch.randn_like(p) * (0.3 if p.dim() > 1 else 0.1))
    return model


@pytest.fixture(scope="module")
def sharded_blip2(tmp_path_factory):
    """{layout: a sharded save_pretrained dir of one HF model}: safetensors,
    ``torch.save`` files, safetensors in fp16 (the loader casts to fp32)."""
    import copy

    model = _hf_blip2()
    dirs = {k: tmp_path_factory.mktemp(f"blip2_{k}") for k in ("safetensors", "torch_save", "safetensors_fp16")}
    model.save_pretrained(dirs["safetensors"], max_shard_size="100KB")
    model.save_pretrained(dirs["torch_save"], max_shard_size="100KB", safe_serialization=False)
    copy.deepcopy(model).half().save_pretrained(dirs["safetensors_fp16"], max_shard_size="50KB")
    for d in dirs.values():
        assert not (d / "model.safetensors").exists() and not (d / "pytorch_model.bin").exists()
        assert len(list(d.glob("model-*"))) > 1 or len(list(d.glob("pytorch_model-*"))) > 1
    return dirs


def _port_logits(ckpt, pixels, ids):
    from lemon_tpu_torch.models.blip2 import load_blip2

    model, _ = load_blip2(ckpt, max_text_len=ids.shape[1], device=torch.device("cpu"))
    with torch.no_grad():
        return model.eval()(torch.from_numpy(pixels), torch.from_numpy(ids)).numpy()


def _jax_logits(ckpt, pixels, ids):
    from lemon_tpu.models.blip2 import load_blip2

    model, params, _ = load_blip2(ckpt, max_text_len=ids.shape[1])
    return np.asarray(model.apply(params, jax.numpy.asarray(pixels), jax.numpy.asarray(ids.astype(np.int32))))


def _pixels_ids(seed=0, b=3, length=10):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 100, (b, length))
    ids[:, 0] = 2
    return rng.random((b, 56, 56, 3), np.float32), ids


@pytest.mark.parametrize("layout", ["safetensors", "torch_save", "safetensors_fp16"])
def test_load_blip2_reads_sharded_checkpoints(sharded_blip2, layout, monkeypatch):
    ckpt = sharded_blip2[layout]
    pixels, ids = _pixels_ids()
    monkeypatch.setitem(sys.modules, "transformers", None)  # the port must not need it
    ours = _port_logits(ckpt, pixels, ids)
    monkeypatch.undo()
    theirs = _jax_logits(ckpt, pixels, ids)
    assert ours.shape == theirs.shape == (3, 10, 120)
    assert np.abs(ours - theirs).max() <= TOL


def test_missing_shard_raises(sharded_blip2, tmp_path):
    import shutil

    from lemon_tpu_torch.models.blip2 import load_blip2

    broken = tmp_path / "broken"
    shutil.copytree(sharded_blip2["safetensors"], broken)
    shard = sorted(broken.glob("model-*.safetensors"))[1]
    shard.unlink()
    with pytest.raises(FileNotFoundError, match=shard.name):
        load_blip2(broken, device=torch.device("cpu"))
    (broken / "model.safetensors.index.json").unlink()
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        load_blip2(broken, device=torch.device("cpu"))


def test_save_blip2_round_trip_and_hf_reads_it(tmp_path):
    """The port's writer: shards and an index above ``max_shard_bytes``,
    read back by the port bit for bit and by HF's ``from_pretrained``, whose
    logits equal the port model's."""
    import json

    from transformers import Blip2ForConditionalGeneration

    from lemon_tpu_torch.models.blip2 import Blip2Config, blip2_config_from_hf, load_blip2, save_blip2
    from lemon_tpu_torch.models.captioner import init_captioner

    cfg = Blip2Config.tiny()
    model = init_captioner(cfg, seed=1, device=torch.device("cpu")).eval()
    files = save_blip2(model, tmp_path / "ckpt", max_shard_bytes=20_000)
    names = {f.name for f in files}
    assert "model.safetensors.index.json" in names and len([n for n in names if n.startswith("model-")]) > 2
    index = json.loads((tmp_path / "ckpt" / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"].values()) == {n for n in names if n.startswith("model-")}
    read = blip2_config_from_hf(json.loads((tmp_path / "ckpt" / "config.json").read_text()),
                                max_text_len=cfg.max_text_len)
    assert (read.vision_mlp_dim, read.qformer_mlp_dim, read.decoder_mlp_dim, read.max_positions) == (
        4 * cfg.vision.vision_width, 4 * cfg.qformer_width, 4 * cfg.decoder_width, cfg.max_text_len + cfg.n_queries)
    back, _ = load_blip2(tmp_path / "ckpt", max_text_len=cfg.max_text_len, device=torch.device("cpu"))
    want = model.state_dict()
    assert all(torch.equal(t, want[k]) for k, t in back.state_dict().items() if "lora" not in k)

    hf = Blip2ForConditionalGeneration.from_pretrained(tmp_path / "ckpt", dtype=torch.float32).eval()
    pixels, ids = _pixels_ids(b=2, length=8)
    ids[ids >= cfg.vocab_size] = 5
    with torch.no_grad():
        ours = back.eval()(torch.from_numpy(pixels), torch.from_numpy(ids)).numpy()
        img = hf.vision_model(torch.from_numpy(pixels.transpose(0, 3, 1, 2))).last_hidden_state
        q = hf.qformer(query_embeds=hf.query_tokens.expand(2, -1, -1), encoder_hidden_states=img).last_hidden_state
        lm_in = hf.language_projection(q)
        emb = torch.cat([lm_in, hf.language_model.get_input_embeddings()(torch.from_numpy(ids))], dim=1)
        theirs = hf.language_model(inputs_embeds=emb, attention_mask=torch.ones(emb.shape[:2],
                                                                                dtype=torch.long)).logits
    assert np.abs(ours - theirs[:, lm_in.shape[1]:].numpy()).max() <= TOL


# ---------------------------------------------------------------------------
# run_judges --backend flax against the JAX CLI

FLAX_ARGV = ["--judge", "llava", "--backend", "flax", "--dataset", "synthetic_caption", "--synthetic_n", "40",
             "--max_new_tokens", "6"]


def _recording(mp, module):
    """Record the logs ``module.run_llava_judge`` returns."""
    logs = []
    orig = module.run_llava_judge

    def run(*a, **k):
        out = orig(*a, **k)
        logs.extend(out)
        return out

    mp.setattr(module, "run_llava_judge", run)
    return logs


@pytest.fixture(scope="module")
def judge_runs(sharded_blip2, tmp_path_factory):
    """{batch size: {"jax"/"port": (logs, generated ids, res.pkl, out dir)}}:
    the JAX CLI and the port's on one sharded checkpoint."""
    from lemon_tpu.cli.run_judges import main as jax_main
    from lemon_tpu_torch.cli.run_judges import main as port_main

    ckpt = str(sharded_blip2["safetensors"])
    runs = {}
    for bs in (1, 4):
        runs[bs] = {}
        out = tmp_path_factory.mktemp(f"jax_judge_bs{bs}")
        with pytest.MonkeyPatch.context() as mp:
            logs, ids = _recording(mp, jax_judges), []
            jit = jax.jit

            def recording_jit(fn, *a, **k):
                jitted = jit(fn, *a, **k)

                def call(*args):
                    res = jitted(*args)
                    if isinstance(res, tuple) and len(res) == 2:  # generate_judged: (tokens, log-probs)
                        ids.append(np.asarray(res[0]))
                    return res

                return call

            mp.setattr(jax, "jit", recording_jit)
            stdout, stderr = sys.stdout, sys.stderr
            try:
                jax_main(FLAX_ARGV + ["--vlm_checkpoint", ckpt, "--generate_batch_size", str(bs),
                                      "--output_dir", str(out)])
            finally:
                sys.stdout, sys.stderr = stdout, stderr
        runs[bs]["jax"] = (logs, np.concatenate(ids), pickle.load(open(out / "res.pkl", "rb")), out)
        out = tmp_path_factory.mktemp(f"port_judge_bs{bs}")
        stdout, stderr = sys.stdout, sys.stderr
        with pytest.MonkeyPatch.context() as mp:
            logs = _recording(mp, port_judges)
            try:
                result = port_main(FLAX_ARGV + ["--vlm_checkpoint", ckpt, "--generate_batch_size", str(bs),
                                                "--output_dir", str(out), "--platform", "cpu"])
            finally:
                sys.stdout, sys.stderr = stdout, stderr
        ids = np.concatenate([b["tokens"] for b in result["vlm"].batches])
        runs[bs]["port"] = (logs, ids, pickle.load(open(out / "res.pkl", "rb")), out)
    return runs


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


@pytest.mark.parametrize("bs", [1, 4])
def test_flax_backend_matches_the_jax_cli(judge_runs, bs):
    (jlogs, jids, jres, jout), (plogs, pids, pres, pout) = judge_runs[bs]["jax"], judge_runs[bs]["port"]
    assert len(jlogs) == len(plogs) == 8 and jids.shape == pids.shape == (8, 6)
    np.testing.assert_array_equal(pids, jids)
    assert [l["raw_output"] for l in plogs] == [l["raw_output"] for l in jlogs]
    assert len({l["raw_output"] for l in plogs}) > 2  # the replies vary
    js, ps = jres["df"]["pred_score"].to_numpy(), pres["df"]["pred_score"].to_numpy()
    assert np.abs(js - ps).max() <= TOL
    ja, pa = _flat(jres["agg_results"]), _flat(pres["agg_results"])
    assert ja.keys() == pa.keys()
    for k in ja:
        assert (np.isnan(ja[k]) and np.isnan(pa[k])) or abs(ja[k] - pa[k]) <= TOL, k
    for name in ("args.json", "out.txt", "res.pkl", "scores.csv", "done"):
        assert (pout / name).exists() and (jout / name).exists(), name


def test_flax_batching_keeps_the_replies(judge_runs):
    """Left-padded batches of 4 and one pair at a time: the same replies."""
    assert [l["raw_output"] for l in judge_runs[1]["port"][0]] == [l["raw_output"] for l in judge_runs[4]["port"][0]]
    np.testing.assert_array_equal(judge_runs[1]["port"][1], judge_runs[4]["port"][1])


@pytest.mark.parametrize("judge", ["llava", "vdc"])
def test_echo_backend_scores_equal_in_one_process(tmp_path, judge):
    argv = ["--judge", judge, "--backend", "echo", "--dataset", "synthetic_caption", "--synthetic_n", "60",
            "--generate_batch_size", "4", "--specific_qa_csv", "builtin"]
    csvs = []
    for package in PACKAGES:
        out = tmp_path / package
        stdout, stderr = sys.stdout, sys.stderr
        try:
            _main(package)(argv + ["--output_dir", str(out)])
        finally:
            sys.stdout, sys.stderr = stdout, stderr
        assert (out / "done").exists()
        csvs.append((out / "scores.csv").read_bytes())
    assert csvs[0] == csvs[1]


@pytest.mark.parametrize("extra", [["--backend", "hf", "--vlm_checkpoint", "."],
                                   ["--backend", "echo", "--llm_checkpoint", "."],
                                   ["--backend", "flax", "--llm_checkpoint", "."]])
def test_transformers_paths_are_refused(tmp_path, extra):
    from lemon_tpu_torch.cli.run_judges import main

    with pytest.raises(SystemExit, match="transformers"):
        main(["--judge", "llava", "--output_dir", str(tmp_path), "--platform", "cpu", *extra])


def test_vdc_on_flax_needs_an_llm(tmp_path, sharded_blip2):
    from lemon_tpu_torch.cli.run_judges import main

    stdout, stderr = sys.stdout, sys.stderr
    try:
        with pytest.raises(SystemExit, match="LLM"):
            main(["--judge", "vdc", "--backend", "flax", "--vlm_checkpoint", str(sharded_blip2["safetensors"]),
                  "--output_dir", str(tmp_path), "--platform", "cpu"])
    finally:
        sys.stdout, sys.stderr = stdout, stderr


def test_too_many_new_tokens_for_the_positions(tmp_path, sharded_blip2):
    from lemon_tpu_torch.cli.run_judges import Blip2Judge

    with pytest.raises(SystemExit, match="positions"):
        Blip2Judge.load(sharded_blip2["safetensors"], torch.device("cpu"), max_new_tokens=100)


def test_the_card_is_the_default(tmp_path, monkeypatch):
    """Without ``--platform`` the CLI asks for the card, and raises where
    there is none (``torch.cuda.is_available`` false, as on this machine)."""
    from lemon_tpu_torch.cli.run_judges import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--judge", "llava", "--backend", "echo", "--output_dir", str(tmp_path)])


def test_judge_prompt_tokens_with_a_shipped_tokenizer(tmp_path, sharded_blip2):
    """A checkpoint that ships OPT's tokenizer files: the prompts' ids and
    the decoded replies (special tokens skipped) equal the JAX backend's
    through ``AutoTokenizer``."""
    import shutil

    from test_torch_gpt2_bpe import CORPUS, _learn
    from transformers import AutoTokenizer, GPT2TokenizerFast

    from lemon_tpu_torch.cli.run_judges import Blip2Judge

    d = tmp_path / "ckpt"
    shutil.copytree(sharded_blip2["safetensors"], d)
    vocab, merges = _learn(CORPUS, 60)
    (tmp_path / "vocab.json").write_text(__import__("json").dumps(vocab), encoding="utf-8")
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges) + "\n",
                                         encoding="utf-8")
    GPT2TokenizerFast(str(tmp_path / "vocab.json"), str(tmp_path / "merges.txt"), bos_token="</s>",
                      eos_token="</s>", pad_token="<pad>", unk_token="</s>", add_bos_token=True).save_pretrained(d)
    judge = Blip2Judge.load(d, torch.device("cpu"), max_new_tokens=6)
    hf = AutoTokenizer.from_pretrained(str(d))
    prompts = ['The proposed caption for this image is "a photo of a cat". Is this caption correct?', "two dogs"]
    ids, mask = judge.tokenize_left(prompts)
    for r, p in enumerate(prompts):
        want = hf(f"Question: {p} Answer:", truncation=True, max_length=ids.shape[1])["input_ids"]
        assert ids[r][mask[r] == 1].tolist() == want and mask[r, -1] == 1
    rows = [[2, 40, 41, 300, 2, 1, 1], [0, 3, 90, 1, 1, 1, 1]]
    assert judge.decode_text(rows) == [hf.decode([t for t in row if t != 1], skip_special_tokens=True).strip()
                                       for row in rows]
