"""scripts/capability_study_torch.py against scripts/capability_study.py:
the scales' training configurations, the checkpoint and guidance selection
and the full scale's checks over the JAX study's own artefact
(docs/capability_r5.json), and the smoke scale end to end on the CPU with
--eval_only rerunning its curve and selection on the finished workdir."""

import importlib.util
import json
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, file):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", file))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # neither script imports JAX at its top
    return module


@pytest.fixture(scope="module")
def study():
    return _load("capability_study_torch", "capability_study_torch.py")


@pytest.fixture(scope="module")
def r5():
    with open(os.path.join(REPO, "docs", "capability_r5.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("scale", ["full", "smoke", "smokefit"])
def test_train_args_match_the_jax_study(study, scale):
    """Every field both Namespaces hold is equal, but the data path: the
    port's clips are in memory, the JAX study's in an h5 pair."""
    jax_study = _load("capability_study", "capability_study.py")
    ours = vars(study.train_args("save", scale))
    theirs = vars(jax_study.train_args("ds/chi3d_train.h5", "save", scale))
    shared = (set(ours) & set(theirs)) - {"data_path"}
    assert set(theirs) - {"data_path"} <= shared
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}


def test_selection_over_the_jax_artefact_picks_its_choice(study, r5):
    """r5's candidates in its order (candidates x guidance sweep): 16008 and
    18000 tie at accuracy_gen_train 0.50417, and the earlier wins."""
    sel = r5["selection"]
    headline = {(s, g): sel["candidate_headline"][f"ckpt{s}_g{g}"]
                for s in sel["candidates"] for g in sel["guidance_sweep"]
                if f"ckpt{s}_g{g}" in sel["candidate_headline"]}
    assert len(headline) == len(sel["candidate_headline"])
    assert study.choose(headline) == (sel["chosen_step"], sel["chosen_guidance"]) == (16008, 2.5)


def test_curve_ranking_breaks_ties_on_train_fid_then_step(study):
    curve = [dict(step=8, accuracy_gen_train=0.5, fid_gen_train=3.0),
             dict(step=2008, accuracy_gen_train=0.5, fid_gen_train=2.0),
             dict(step=4008, accuracy_gen_train=0.5, fid_gen_train=2.0),
             dict(step=6008, accuracy_gen_train=0.4, fid_gen_train=1.0),
             dict(step=8008)]
    assert study.rank_curve(curve, 8008) == [2008, 4008]
    assert study.rank_curve([dict(step=8)], 12000) == [12000]


def test_full_checks_over_the_jax_artefact(study, r5):
    """The six checks whose names both artefacts share give r5's values; the
    script's gate of 4x chance (accuracy_gen_test > 0.5) misses at 0.4994,
    3.996 x chance."""
    checks = {name: held for name, (held, _) in study.full_checks(r5).items()}
    shared = set(checks) & set(r5["checks"])
    assert len(shared) == 6
    assert {k: checks[k] for k in shared} == {k: r5["checks"][k] for k in shared}
    assert checks["accuracy_gen_trained>4x_chance"] is False
    multiple = study.calibration(r5)["accuracy_multiple_of_chance"]
    assert multiple == pytest.approx(r5["checks_note"]["accuracy_multiple_of_chance"], abs=5e-4)
    assert multiple == pytest.approx(3.996, abs=5e-4)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once,
    and torch's spinning thread pools then slow these small ops tenfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_smoke_scale_end_to_end_then_eval_only(study, tmp_path, monkeypatch, one_torch_thread):
    """--scale smoke --device cpu exits 0 with a curve point per checkpoint,
    the selection, the three rows, the calibration and the smoke check;
    --eval_only on its workdir gives the same curve, selection and rows
    from the kept clips, classifier and checkpoints without training. Cut
    to 8 samples and the reduced ST-GCN: the reference-size classifier's
    features and 256-wide FIDs take most of a CPU evaluation, 14 of them."""
    monkeypatch.setitem(study.SCALES, "smoke",
                        dict(study.SCALES["smoke"], stgcn=study.REDUCED_STGCN))
    work, out, again = tmp_path / "work", tmp_path / "smoke.json", tmp_path / "again.json"
    cut = ["--scale", "smoke", "--device", "cpu", "--headline_samples", "8"]
    assert study.main(cut + ["--workdir", str(work), "--out", str(out)]) == 0
    with open(out) as f:
        art = json.load(f)
    save_dir = work / "cmdm_save"
    steps = sorted(int(n[5:14]) for n in os.listdir(save_dir) if n.startswith("model"))
    assert len(steps) >= 2 and [p["step"] for p in art["fid_vs_step"]] == steps
    sel = art["selection"]
    assert set(sel["candidates"]) <= set(steps) and sel["guidance_sweep"] == [1.0]
    assert (sel["chosen_step"], sel["chosen_guidance"]) in {(s, 1.0) for s in sel["candidates"]}
    for row in ("trained", "random_init", "oracle"):
        assert art[row]["accuracy_gen_test"]["n_seeds"] == 1
    chosen = sel["candidate_headline"][f"ckpt{sel['chosen_step']}_g{sel['chosen_guidance']}"]
    assert chosen["accuracy_gen_test"] == art["trained"]["accuracy_gen_test"]["mean"]
    assert set(art["calibration"]) >= {"accuracy_multiple_of_chance",
                                        "trained_over_oracle_accuracy"}
    assert art["checks"] == {"smoke_plumbing_only": True} and art["ok"]
    assert art["eval_protocol"]["num_samples"] == 8 and art["dataset"]["num_clips_test"] == 16

    stamps = {n: os.path.getmtime(save_dir / n) for n in os.listdir(save_dir)}
    assert study.main(cut + ["--eval_only", str(work), "--out", str(again)]) == 0
    with open(again) as f:
        rerun = json.load(f)
    assert {n: os.path.getmtime(save_dir / n) for n in os.listdir(save_dir)} == stamps
    assert "cmdm_training" not in rerun["walls_s"]
    assert rerun["cmdm_training"]["reused"] == str(work)
    assert rerun["cmdm_training"]["steps"] == steps[-1]
    for key in ("fid_vs_step", "selection", "trained", "random_init", "oracle"):
        assert rerun[key] == art[key], key
    with pytest.raises(ValueError, match="a smoke run"):
        study.main(["--scale", "smokefit", "--device", "cpu", "--eval_only", str(work)])
