"""The port's host-side tools against the JAX package's, on the CPU:
``data/preprocess.py`` and ``cli/preprocess.py``, ``cli/aggregate.py``,
``cli/experiments.py``, ``cli/launchers.py``, ``cli/sweep.py`` and
``cli/parity_check.py``.

- The cases of tests/test_judges_and_preprocess.py (preprocessing),
  test_preprocess_builders.py, test_noun_heuristic.py, test_aggregate.py,
  test_sweep.py and test_parity_probe.py run on both packages: each case's
  own body, its names bound to the port's module or left on the JAX one
  (``tests/port_cases.py``).
- The six builders write equal frames (values, dtypes, ``attrs``) from the
  builder cases' fixtures; ``cli/preprocess`` writes the same pickle.
- Every experiment grid: the same run ids in both packages and the same
  argv apart from the module's name; the port's own parser of the job's
  CLI accepts every job's argv.
- ``paper_table`` over one root (the fabricated runs of test_aggregate.py
  and one tiny port ``run_lemon --platform cpu`` run): the same CSV from
  both CLIs; ``hparam_drop_table``: the same rows, metrics within 1e-6 (JAX
  scores through jnp and sklearn, the port through torch and numpy).
- ``parity_check`` probes one checkpoint root given as a symlink and as its
  real path once (the JAX file probes it twice).
"""

import inspect
import json
import pickle
import shlex
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import test_aggregate
import test_judges_and_preprocess
import test_noun_heuristic
import test_parity_probe
import test_preprocess_builders
import test_sweep
from port_cases import PACKAGES, case_on, run_case, twin
from test_parity_probe import empty_env  # noqa: F401  (a fixture of the parity cases)

PREPROCESS_CASES = ("test_section_text_and_caption", "test_extract_nouns_and_interning",
                    "test_build_caption_metadata")
BUILDER_CASES = ("test_build_mscoco", "test_build_mscoco_categories_merge_across_files",
                 "test_build_flickr30_and_loader_roundtrip", "test_build_imagenet_red", "test_build_cc3m",
                 "test_build_mmimdb", "test_build_mimiccxr")
# builder case -> the file it writes under tmp_path
BUILDER_OUTPUTS = {"test_build_mscoco": "coco_root/multimodal_mislabel_split.pkl",
                   "test_build_flickr30_and_loader_roundtrip": "data/flickr30k/multimodal_mislabel_split.pkl",
                   "test_build_imagenet_red": "imgs/multimodal_mislabel_split.csv",
                   "test_build_cc3m": "cc3m_root/multimodal_mislabel_split.pkl",
                   "test_build_mmimdb": "out/multimodal_mislabel_split.pkl",
                   "test_build_mimiccxr": "out/multimodal_mislabel_split.pkl"}
NOUN_CASES = ("test_heuristic_agreement_with_gold", "test_noun_noise_pairing_agreement")
AGGREGATE_CASES = ("test_paper_table_winner_is_per_config_even_on_cross_config_ties",
                   "test_paper_table_seed_aggregation")
SWEEP_CASES = ("test_job_state_transitions", "test_attempts_persist_and_gate_failed_state",
               "test_daemon_retries_flaky_and_fails_hopeless", "test_embedding_cache_excluded_from_identity",
               "test_daemon_max_rounds_stops_early")
PARITY_CASES = ("test_probe_empty", "test_probe_finds_root_and_gates_configs", "test_probe_tarball_counts_as_present",
                "test_probe_hub_cache_checkpoint", "test_no_checkpoint_means_nothing_runnable",
                "test_auto_mode_exits_zero_without_assets", "test_single_mode_requires_checkpoint",
                "test_checkpoint_found_at_discovered_candidate_root",
                "test_env_checkpoint_pointing_nowhere_is_a_hard_error", "test_auto_isolates_per_config_failures")
EXPERIMENTS = ("lemon_all", "lemon_caption_real", "lemon_caption_vary_noise", "lemon_caption_ablations",
               "lemon_cifar_ablations", "vary_val_set", "discrepancy_baseline", "synthetic_smoke",
               "cc3m_clip_scratch", "lemon_caption_mimic_clip_scratch", "lemon_cc3m_filter_using_scratch",
               "cc3m_clip_scratch_filtered_from_scratch")


@pytest.mark.parametrize("package", PACKAGES)
@pytest.mark.parametrize("module,case", [(test_judges_and_preprocess, c) for c in PREPROCESS_CASES]
                         + [(test_preprocess_builders, c) for c in BUILDER_CASES]
                         + [(test_noun_heuristic, c) for c in NOUN_CASES]
                         + [(test_aggregate, c) for c in AGGREGATE_CASES]
                         + [(test_sweep, c) for c in SWEEP_CASES]
                         + [(test_parity_probe, c) for c in PARITY_CASES],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_case_on_both_packages(request, module, case, package):
    run_case(request, module, case, package)


def test_every_jax_case_is_listed():
    """The lists above hold every case of the sweep, aggregate, parity,
    builder and noun modules (a case added there is run here too)."""
    for module, cases in ((test_preprocess_builders, BUILDER_CASES), (test_noun_heuristic, NOUN_CASES),
                          (test_aggregate, AGGREGATE_CASES), (test_sweep, SWEEP_CASES),
                          (test_parity_probe, PARITY_CASES)):
        assert set(cases) == {n for n in vars(module) if n.startswith("test_")}, module.__name__


def _read(path: Path, root: Path):
    """The frame a builder wrote, ``root`` in its strings replaced."""
    df = pd.read_csv(path) if path.suffix == ".csv" else pd.read_pickle(path)
    for col in df.columns:
        if pd.api.types.is_object_dtype(df[col]) or pd.api.types.is_string_dtype(df[col]):
            df[col] = [v.replace(str(root), "<root>") if isinstance(v, str) else v for v in df[col]]
    return df


@pytest.mark.parametrize("case", sorted(BUILDER_OUTPUTS))
def test_builders_write_equal_frames(monkeypatch, tmp_path, case):
    """The JAX case and the port's, each on the fixture files it writes into
    a directory of its own; the two frames written must be equal."""
    frames = []
    for package in PACKAGES:
        root = tmp_path / package
        root.mkdir()
        kwargs = {"tmp_path": root, "monkeypatch": monkeypatch}
        wanted = inspect.signature(getattr(test_preprocess_builders, case)).parameters
        case_on(test_preprocess_builders, case, package)(**{k: v for k, v in kwargs.items() if k in wanted})
        frames.append(_read(root / BUILDER_OUTPUTS[case], root))
    pd.testing.assert_frame_equal(frames[0], frames[1], check_exact=True)
    assert frames[0].attrs == frames[1].attrs


def test_preprocess_cli_writes_the_same_pickle(tmp_path):
    from lemon_tpu.cli.preprocess import main as jax_main
    from lemon_tpu_torch.cli.preprocess import main as port_main

    kp = test_preprocess_builders._karpathy_json(tmp_path, "flickr30k", id_key="imgid")
    outs = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        main(["flickr30", "--karpathy", str(kp), "--out", str(tmp_path / name)])
        outs.append(pd.read_pickle(tmp_path / name / "multimodal_mislabel_split.pkl"))
    pd.testing.assert_frame_equal(outs[0], outs[1], check_exact=True)
    assert outs[0].attrs == outs[1].attrs and outs[0].attrs["noun_vocab"]


# ---------------------------------------------------------------------------
# experiments and the sweep


def _parser(script: str):
    import importlib

    return importlib.import_module(script).build_parser()


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_experiment_jobs_match_the_jax_grid(tmp_path, experiment):
    from lemon_tpu.cli.sweep import build_jobs as jax_jobs
    from lemon_tpu_torch.cli.sweep import build_jobs as port_jobs

    cache = str(tmp_path / "cache")
    jax, port = jax_jobs(experiment, tmp_path, embedding_cache=cache), port_jobs(experiment, tmp_path,
                                                                                embedding_cache=cache)
    assert len(port) == len(jax) > 0
    assert [j.run_id for j in port] == [j.run_id for j in jax]
    assert [j.output_dir for j in port] == [j.output_dir for j in jax]
    script = port[0].script
    assert script.startswith("lemon_tpu_torch.cli.") and jax[0].script == script.replace("lemon_tpu_torch",
                                                                                         "lemon_tpu")
    parser = _parser(script)
    for pj, jj in zip(port, jax):
        p_argv, j_argv = shlex.split(pj.command), shlex.split(jj.command)
        assert p_argv[:3] == [sys.executable, "-m", script] and j_argv[3:] == p_argv[3:]
        parser.parse_args(p_argv[3:])  # the port's CLI takes the job's argv


def test_sweep_cli_status_and_dry_launch(tmp_path, capsys):
    """``status`` and a ``dry`` launch through both CLIs: the same states and
    the same commands apart from the module's name."""
    from lemon_tpu.cli.sweep import main as jax_main
    from lemon_tpu_torch.cli.sweep import main as port_main

    printed = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        for command in (["status"], ["launch", "--command_launcher", "dry", "--yes", "--embedding_cache", "auto"],
                        ["status"]):
            main([*command, "--experiment", "synthetic_smoke", "--output_root", str(tmp_path / name)])
        printed.append(capsys.readouterr().out.replace(str(tmp_path / name), "<root>"))
    assert printed[1] == printed[0].replace("lemon_tpu.cli.", "lemon_tpu_torch.cli.")
    assert "{'incomplete': 4}" in printed[1]
    assert "launched 4 jobs" in printed[1] and printed[1].count("lemon_tpu_torch.cli.run_lemon") == 4


# ---------------------------------------------------------------------------
# aggregate over one root


@pytest.fixture(scope="module")
def sweep_root(tmp_path_factory):
    """test_aggregate.py's fabricated runs (args.json + res.pkl, each with
    the frame of the real run) and one tiny port ``run_lemon`` run."""
    from lemon_tpu_torch.cli.run_lemon import main as run_lemon

    root = tmp_path_factory.mktemp("sweep_root")
    real = root / "real_run"
    stdout, stderr = sys.stdout, sys.stderr
    try:
        run_lemon(["--output_dir", str(real), "--dataset", "synthetic_caption", "--noise_type", "random",
                   "--clip_model", "tiny", "--synthetic_n", "200", "--knn_k", "3", "--platform", "cpu"])
    finally:
        sys.stdout, sys.stderr = stdout, stderr
    df = pickle.load(open(real / "res.pkl", "rb"))["df"]
    rows = (test_aggregate._runs("A", [(10, "cos", 0, 0.7, 0.60), (20, "cos", 0, 0.9, 0.70)])
            + test_aggregate._runs("B", [(10, "cos", 0, 0.9, 0.80), (20, "cos", 1, 0.95, 0.99)]))
    for i, row in enumerate(rows):
        run = root / f"fabricated_{i}"
        run.mkdir()
        args = {k: row[k] for k in ("dataset", "noise_type", "noise_level", "knn_k", "dist_type", "data_seed")}
        agg = {"know_val_labels": {"val": {"F1_optimal": row["know_val_labels_val_F1_optimal"]},
                                   "test": {m: row[f"know_val_labels_test_{m}"]
                                            for m in ("AUROC", "AUPRC", "F1_optimal")}}}
        (run / "args.json").write_text(json.dumps(args))
        with open(run / "res.pkl", "wb") as f:
            pickle.dump({"df": df, "agg_results": agg}, f)
        (run / "done").write_text("done")
    return root


def test_paper_table_equal_over_one_root(sweep_root, tmp_path, capsys):
    from lemon_tpu.cli.aggregate import collect_runs as jax_collect, main as jax_main, paper_table as jax_table
    from lemon_tpu_torch.cli.aggregate import collect_runs, main as port_main, paper_table

    pd.testing.assert_frame_equal(collect_runs(sweep_root), jax_collect(sweep_root), check_exact=True)
    table = paper_table(collect_runs(sweep_root))
    pd.testing.assert_frame_equal(table, jax_table(jax_collect(sweep_root)), check_exact=True)
    assert len(table) == 3  # A, B and the real run's (synthetic_caption, random, 0.4)
    for name, main in (("jax", jax_main), ("port", port_main)):
        main(["--root", str(sweep_root), "--csv", str(tmp_path / f"{name}.csv")])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert capsys.readouterr().out.count("collected 5 completed runs") == 2


def test_hparam_drop_table_equal_over_one_root(sweep_root):
    from lemon_tpu.cli.aggregate import hparam_drop_table as jax_drop
    from lemon_tpu_torch.cli.aggregate import hparam_drop_table

    port, jax = hparam_drop_table(sweep_root), jax_drop(sweep_root)
    assert len(port) == 5
    metrics = ["AUROC", "AUPRC", "F1_prev"]
    pd.testing.assert_frame_equal(port.drop(columns=metrics), jax.drop(columns=metrics), check_exact=True)
    np.testing.assert_allclose(port[metrics].to_numpy(float), jax[metrics].to_numpy(float), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# parity_check


@pytest.mark.parametrize("package", PACKAGES)
def test_a_root_under_two_names_is_probed_once(empty_env, monkeypatch, package):  # noqa: F811
    """$LEMON_TPU_DATA_ROOT is a symlink to a candidate root: the port looks
    for the checkpoint there once (it dedups on the resolved path), the JAX
    file twice (on the path as given)."""
    import pathlib

    pc = twin("lemon_tpu.cli.parity_check") if package == "lemon_tpu_torch" else __import__(
        "lemon_tpu.cli.parity_check", fromlist=["_"])
    real = empty_env / "real_root"
    (real / "checkpoints").mkdir(parents=True)
    link = empty_env / "link_root"
    link.symlink_to(real, target_is_directory=True)
    monkeypatch.setenv("LEMON_TPU_DATA_ROOT", str(link))
    monkeypatch.setattr(pc, "_CANDIDATE_ROOTS", (str(real),))
    probed = []
    exists = pathlib.Path.exists

    def counting(self, *a, **k):
        if self.name.startswith("huggingface_clip."):
            probed.append(self)
        return exists(self, *a, **k)

    monkeypatch.setattr(pathlib.Path, "exists", counting)
    assert pc._find_hf_clip_checkpoint() is None
    roots = {p.parent.parent for p in probed}
    assert len(probed) == (4 if package == "lemon_tpu_torch" else 8), probed
    assert roots == ({link} if package == "lemon_tpu_torch" else {link, real})
    (real / "checkpoints" / "huggingface_clip.pt").write_bytes(b"x")
    assert pc._find_hf_clip_checkpoint() == link / "checkpoints" / "huggingface_clip.pt"
