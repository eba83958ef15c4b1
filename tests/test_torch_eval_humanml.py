"""regennet_torch.eval.eval_humanml (and its metrics, the in-training route
and generate --length_estimator) against the JAX package.

* The metric functions under the same numpy seed.
* The debug protocol end to end: a tiny text CMDM from the port's trainer
  (`train_mdm --dataset humanml --device cpu`, 2 layers, latent 64, 10
  diffusion steps, as tests/test_torch_generate.py builds it; the JAX CLI
  reads its .pt and args.json too) scored by both CLIs against the same
  evaluators (the port's random ones, at small widths in both packages,
  saved as a finest.tar, which the JAX CLI converts), with CFG 2.5. The port's sampler is fed the JAX loop's
  noise for each batch (the split keys, replicated as
  tests/test_torch_generate.py does); both condition on the hashed text
  embeddings (the CLIP probe fails at once, as without weights). The
  summaries agree within 1e-4 x max(1, |jax|), the R-precision counts
  exactly.
* The multimodality path, 2 prompts x 3 repeats, the same way.
* The comp_v6 route: a small generator drawn by torch and saved in the
  released layout, as train_t2m_gen's .pt and as a latest.tar beside one
  args.json, with a length estimator; debug mode through the port's .pt
  against the JAX CLI on the .tar, z = mu in both (JAX's normal draws
  zeroed, the port's prior_noise None): the summaries as above and the
  lengths each replication's estimator drew, equal; the port's .tar route
  gives the .pt route's summary; the multimodality path (2 prompts x 4
  repeats, each repeat's length drawn) against the JAX factory's;
  generate's comp_v6 route against the JAX CLI's (--no-render) within
  1e-5 x max(1, max|jax|).
* Each CLI refuses the modes it does not run.
* The in-training route on the CPU writes its log and reports
  top1..3_R_precision_* under "Eval".
* generate's length estimator: its logits against JAX's on the same GloVe
  word inputs, and the lengths it writes.
"""

import contextlib
import json
import os
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_torch.convert import from_flax
from regennet_torch.data.humanml.dataset import write_synthetic_humanml
from regennet_torch.diffusion import sampling
from regennet_torch.eval import eval_humanml, humanml_metrics
from regennet_torch.models import clip_text, t2m_eval, t2m_gen
from regennet_torch.sample import generate
from regennet_torch.train import train_mdm, train_platforms
from regennet_torch.utils import parser_util
from regennet_tpu.eval import eval_humanml as jeval
from regennet_tpu.eval import humanml_metrics as jmetrics
from regennet_tpu.models import clip_text as jclip_text
from regennet_tpu.models import t2m_eval as jt2m
from regennet_tpu.sample import generate as jgenerate
from tests.test_torch_generate import _no_clip, _replicate_loop_noise

STEPS = 10


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def without_clip():
    """Both packages' CLIP probes fail as they do without local weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(clip_text, "ClipTextEncoder", _no_clip)
        mp.setattr(jclip_text, "ClipTextEncoder", _no_clip)
        yield


SMALL_WIDTHS = dict(dim_text_hidden=32, dim_coemb_hidden=16, dim_motion_hidden=48,
                    dim_movement_enc_hidden=32, dim_movement_latent=24)


@pytest.fixture(scope="module", autouse=True)
def small_widths():
    """Both packages' evaluators at small widths (T2M_OPT is read when a
    network is built): the published ones make each JAX compile slow."""
    with pytest.MonkeyPatch.context() as mp:
        for opt in (t2m_eval.T2M_OPT, jt2m.T2M_OPT):
            for key, value in SMALL_WIDTHS.items():
                mp.setitem(opt, key, value)
        yield


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(checkpoint path, data root, finest.tar of random evaluators)."""
    root = write_synthetic_humanml(str(tmp_path_factory.mktemp("humanml")), num_clips=8,
                                   min_len=40, max_len=200)
    save_dir = tmp_path_factory.mktemp("run") / "humanml"
    args = parser_util.train_args([
        "--save_dir", str(save_dir), "--data_path", root, "--device", "cpu",
        "--layers", "2", "--latent_dim", "64", "--batch_size", "4", "--num_steps", "2",
        "--save_interval", "2", "--log_interval", "1", "--steps_per_call", "1",
        "--diffusion_steps", str(STEPS)])
    train_mdm.main(args)
    finest = save_dir / "finest.tar"
    torch.save(t2m_eval.evaluator_state(t2m_eval.T2MEvaluatorWrapper("humanml", seed=5)),
               finest)
    return str(save_dir / "model000000002.pt"), root, str(finest)


def _jax_noise(seed, shapes):
    """The JAX factory's per-batch keys split from PRNGKey(seed), and each
    batch's loop noise."""
    rng, out = jax.random.PRNGKey(seed), []
    for shape in shapes:
        rng, srng = jax.random.split(rng)
        out.append(_replicate_loop_noise(srng, shape, STEPS))
    return out


def _feed(monkeypatch, noises):
    """The port's sampler takes the next batch's JAX noise at each call."""
    loop = sampling.p_sample_loop
    it = iter(noises)

    def fed(sched, cfg, model_fn, shape, cond, **kw):
        x0, zs = next(it)
        assert tuple(x0.shape) == tuple(shape)
        kw.pop("generator")
        return loop(sched, cfg, model_fn, shape, cond, noise=x0, step_noise=zs, **kw)

    monkeypatch.setattr(sampling, "p_sample_loop", fed)


def _close(ours, ref):
    assert set(ours) == set(ref)
    for k, v in ref.items():
        if k.startswith("R_precision"):
            assert ours[k] == v, k  # the same hits over the same batches
        else:
            assert abs(ours[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, ours[k], v)


def test_metric_functions_match_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(12, 8)), rng.normal(size=(12, 8))
    b[3] = a[3]  # a sure top-1 hit
    np.testing.assert_allclose(humanml_metrics.euclidean_distance_matrix(a, b),
                               jmetrics.euclidean_distance_matrix(a, b), rtol=1e-12)
    order = np.argsort(humanml_metrics.euclidean_distance_matrix(a, b), axis=1)
    np.testing.assert_array_equal(humanml_metrics.calculate_top_k(order, 3),
                                  jmetrics.calculate_top_k(order, 3))
    for sum_all in (False, True):
        np.testing.assert_array_equal(
            humanml_metrics.calculate_R_precision(a, b, 3, sum_all),
            jmetrics.calculate_R_precision(a, b, 3, sum_all))
        np.testing.assert_allclose(humanml_metrics.calculate_matching_score(a, b, sum_all),
                                   jmetrics.calculate_matching_score(a, b, sum_all),
                                   rtol=1e-12)
    stack = rng.normal(size=(5, 6, 8))
    for name, args in (("calculate_diversity", (a, 7)), ("calculate_multimodality", (stack, 4))):
        np.random.seed(3)
        ours = getattr(humanml_metrics, name)(*args)
        np.random.seed(3)
        assert ours == getattr(jmetrics, name)(*args), name
    assert humanml_metrics.calculate_frechet_distance is not None
    mu, cov = humanml_metrics.calculate_activation_statistics(a)
    np.testing.assert_allclose(mu, a.mean(0))


def _eval_args(model_path, finest, mode="debug"):
    return parser_util.evaluation_parser([
        "--model_path", model_path, "--rec_model_path", finest, "--eval_mode", mode,
        "--guidance_param", "2.5", "--seed", "3", "--device", "cpu"])


def test_debug_protocol_matches_jax(trained, monkeypatch):
    model_path, root, finest = trained
    args = _eval_args(model_path, finest)
    assert (args.dataset, args.data_path, args.latent_dim) == ("humanml", root, 64)
    ref = jeval.main(Namespace(**vars(args)))
    # debug: the 4 test clips in one batch (32 asked), two replications
    _feed(monkeypatch, _jax_noise(3, [(4, 263, 1, 196)] * 2))
    ours = eval_humanml.main(args, device="cpu")
    _close(ours, ref)
    assert set(ours) == {f"{m}_{n}" for m in ("Matching Score", "R_precision", "FID",
                                               "Diversity") for n in ("ground truth", "humanml")}
    # eval_humanml_<run>_<mode>.log beside the checkpoint
    with open(os.path.join(os.path.dirname(model_path), "eval_humanml_humanml_debug.log")) as f:
        log = f.read()
    assert log.count("Replication") == 2 and "R_precision_humanml" in log


def _factories(trained, mm):
    """The port's and JAX's generated-motion factories on the trained CMDM."""
    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_torch.train import checkpoint
    from regennet_torch.utils.model_util import TextData, create_model_and_diffusion
    from regennet_tpu.data.humanml.dataset import Text2MotionDataset as JDataset
    from regennet_tpu.train import checkpoint as jcheckpoint
    from regennet_tpu.utils.model_util import create_model_and_diffusion as jcreate

    model_path, root, _ = trained
    with open(os.path.join(os.path.dirname(model_path), "args.json")) as f:
        margs = Namespace(**json.load(f))
    model, sched, cfg = create_model_and_diffusion(margs, TextData())
    checkpoint.load_model(model, model_path)
    jmodel, jsched, jcfg = jcreate(margs, TextData())
    x = jnp.zeros((1, 263, 1, 196))
    params = jmodel.init(jax.random.PRNGKey(0), x, jnp.zeros((1,), jnp.int32),
                         {"cmotion": x, "text_emb": jnp.zeros((1, 512))})["params"]
    params = jax.tree_util.tree_map(lambda t, v: jnp.asarray(v), params,
                                    jcheckpoint.load_checkpoint(model_path)["params"])
    kw = dict(batch_size=4, num_samples=4, guidance=2.5, seed=1, mm_num_samples=mm[0],
              mm_num_repeats=mm[1])
    return (eval_humanml.make_gen_loader_factory(Text2MotionDataset(root, split="test"),
                                                 model.eval(), sched, cfg, **kw),
            jeval.make_gen_loader_factory(JDataset(root, split="test"), jmodel, params,
                                          jsched, jcfg, **kw),
            Text2MotionDataset(root, split="test"), JDataset(root, split="test"))


def _jax_variables(finest):
    from regennet_tpu.convert.torch_ckpt import convert_t2m_checkpoint

    return convert_t2m_checkpoint(finest)


def test_multimodality_path_matches_jax(trained, monkeypatch, tmp_path):
    """2 prompts x 3 repeats: the repeats of a prompt sampled as one batch,
    the prompts chosen by np.random.default_rng(seed + call)."""
    ours_factory, jax_factory, ds, jds = _factories(trained, (2, 3))
    wrapper = t2m_eval.T2MEvaluatorWrapper("humanml", state=trained[2])
    jwrapper = jt2m.T2MEvaluatorWrapper("humanml", variables=_jax_variables(trained[2]))
    run = dict(replication_times=1, diversity_times=4, mm_num_times=2, run_mm=True)
    np.random.seed(0)
    import random
    random.seed(0)
    ref = jeval.evaluation(jwrapper, jeval.make_gt_loader_factory(jds, 4, 4),
                           {"mdm": jax_factory}, str(tmp_path / "jax.log"), **run)
    _feed(monkeypatch, _jax_noise(1, [(4, 263, 1, 196)] + [(3, 263, 1, 196)] * 2))
    np.random.seed(0)
    random.seed(0)
    ours = eval_humanml.evaluation(wrapper, eval_humanml.make_gt_loader_factory(ds, 4, 4),
                                   {"mdm": ours_factory}, str(tmp_path / "ours.log"), **run)
    _close(ours, ref)
    assert "MultiModality_mdm" in ours and np.isfinite(ours["MultiModality_mdm"])


COMP_SIZES = dict(dim_z=4, pri_hidden=16, dec_hidden=16, text_hidden=8, att_vec=8, n_layers=2)


@pytest.fixture(scope="module")
def comp_v6(trained, tmp_path_factory):
    """(the generator's .pt, the same state as latest.tar, a length
    estimator .tar): small widths, torch-drawn, the movement latent
    SMALL_WIDTHS'."""
    _, root, _ = trained
    run = tmp_path_factory.mktemp("comp") / "comp"
    run.mkdir()
    generator = torch.Generator().manual_seed(11)
    latent = SMALL_WIDTHS["dim_movement_latent"]
    gen = t2m_eval.random_init_(t2m_gen.CompV6Generator(dim_pose=263, mov_latent=latent,
                                                        **COMP_SIZES), generator)
    (mov_enc,) = t2m_eval.networks(263, "movement_enc")
    t2m_eval.random_init_(mov_enc, generator)
    state = {**t2m_gen.generator_state(gen, mov_enc), "epoch": 1}
    torch.save(state, run / "model000000001.pt")
    torch.save(state, run / "latest.tar")
    with open(run / "args.json", "w") as f:
        json.dump({**COMP_SIZES, "mov_latent": latent, "unit_length": 4,
                   "dataset": "humanml", "data_path": root}, f)
    est = t2m_eval.random_init_(t2m_eval.MotionLenEstimatorBiGRU(output_size=50), generator)
    torch.save({"estimator": est.state_dict()}, run / "length.tar")
    return str(run / "model000000001.pt"), str(run / "latest.tar"), str(run / "length.tar")


@contextlib.contextmanager
def _z_is_mu(monkeypatch):
    """Both generators sample z = mu: the port's prior noise None, JAX's
    normal draws zeros."""
    with monkeypatch.context() as m:
        m.setattr(t2m_gen, "prior_noise", lambda *a: None)
        m.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(
            shape, dtype))
        yield


def _recorded_lengths(monkeypatch, module):
    """The m_lens of every batch module's comp_v6 factories return."""
    seen = []
    make = module.make_comp_gen_loader_factory

    def recording(*a, **kw):
        factory = make(*a, **kw)

        def run():
            batches = factory()
            seen.append([np.asarray(b[5]).tolist() for b in batches])
            return batches

        return run

    monkeypatch.setattr(module, "make_comp_gen_loader_factory", recording)
    return seen


def test_comp_v6_debug_route_matches_jax(trained, comp_v6, monkeypatch):
    _, _, finest = trained
    pt, tar, length = comp_v6
    args = parser_util.evaluation_parser([
        "--model_path", pt, "--rec_model_path", finest, "--eval_mode", "debug", "--seed", "3",
        "--device", "cpu", "--length_estimator", length])
    assert args.data_path == trained[1]  # from the args.json beside the .pt
    jlens, lens = _recorded_lengths(monkeypatch, jeval), _recorded_lengths(
        monkeypatch, eval_humanml)
    with _z_is_mu(monkeypatch):
        ref = jeval.main(Namespace(**{**vars(args), "model_path": tar}))
        ours = eval_humanml.main(args, device="cpu")
    _close(ours, ref)
    assert set(ours) == {f"{m}_{n}" for m in ("Matching Score", "R_precision", "FID",
                                               "Diversity") for n in ("ground truth", "comp")}
    # two replications of the test split's 4 clips, the estimator's draws
    assert lens == jlens and len(lens) == 2 and len(lens[0][0]) == 4
    assert all(v % 4 == 0 and 4 <= v <= 196 for rep in lens for b in rep for v in b)
    assert lens[0] != lens[1]  # each replication draws afresh


def test_comp_v6_multimodality_path_matches_jax(trained, comp_v6, monkeypatch, tmp_path):
    """The comp_v6 factories with the estimator, 2 prompts x 4 repeats: each
    repeat's length drawn by the estimator, the prompts chosen by
    np.random.default_rng(seed + call); z = mu in both."""
    import random

    from regennet_torch.data.humanml.dataset import Text2MotionDataset
    from regennet_tpu.convert.torch_ckpt import convert_comp_v6_checkpoint
    from regennet_tpu.data.humanml.dataset import Text2MotionDataset as JDataset

    _, root, finest = trained
    pt, tar, length = comp_v6
    kw = dict(batch_size=4, num_samples=4, seed=1, unit_length=4, mm_num_samples=2,
              mm_num_repeats=4, min_mov_length=10)
    jgen, jmov_enc, _ = jeval.rebuild_comp_v6_generator(tar, 263)
    jstate = convert_comp_v6_checkpoint(tar)
    jest, jest_params = jeval.load_length_estimator(length)
    jds = JDataset(root, split="test")
    jax_factory = jeval.make_comp_gen_loader_factory(
        jds, jgen, jstate["params"], jmov_enc, jstate["movement_enc"], len_estimator=jest,
        len_est_params=jest_params, **kw)
    gen, mov_enc, _ = eval_humanml.load_comp_v6_checkpoint(pt, 263, "cpu")
    ds = Text2MotionDataset(root, split="test")
    ours_factory = eval_humanml.make_comp_gen_loader_factory(
        ds, gen, mov_enc, len_estimator=t2m_eval.load_length_estimator(length), **kw)
    mm_lens = []

    def evaluate(module, wrapper, dataset, factory, log):
        def recording():
            batches, mm = factory()
            mm_lens.append([np.asarray(lens).tolist() for _, lens in mm])
            return batches, mm

        np.random.seed(0)
        random.seed(0)
        with _z_is_mu(monkeypatch):
            return module.evaluation(
                wrapper, module.make_gt_loader_factory(dataset, 4, 4), {"comp": recording},
                str(tmp_path / log), replication_times=1, diversity_times=4, mm_num_times=2,
                run_mm=True)

    ref = evaluate(jeval, jt2m.T2MEvaluatorWrapper("humanml", variables=_jax_variables(finest)),
                   jds, jax_factory, "jax.log")
    ours = evaluate(eval_humanml, t2m_eval.T2MEvaluatorWrapper("humanml", state=finest), ds,
                    ours_factory, "ours.log")
    _close(ours, ref)
    assert "MultiModality_comp" in ours and np.isfinite(ours["MultiModality_comp"])
    assert mm_lens[0] == mm_lens[1] and len(mm_lens[0]) == 2 and len(mm_lens[0][0]) == 4


def test_comp_v6_tar_route_gives_the_pt_summary(trained, comp_v6, monkeypatch):
    _, root, finest = trained
    pt, tar, length = comp_v6
    summaries = []
    for path in (pt, tar):
        args = parser_util.evaluation_parser([
            "--model_path", path, "--rec_model_path", finest, "--eval_mode", "debug",
            "--seed", "5", "--device", "cpu", "--length_estimator", length,
            "--data_path", root])
        summaries.append(eval_humanml.main(args, device="cpu"))
    assert summaries[0] == summaries[1] and np.isfinite(summaries[0]["FID_comp"])


def test_comp_v6_generate_route_matches_jax(comp_v6, trained, tmp_path, monkeypatch):
    pt, tar, _ = comp_v6
    _, root, _ = trained
    argv = ["--data_path", root, "--text_prompt", "a person walks forward", "--num_samples",
            "2", "--motion_length", "1.7", "--glove_root", str(tmp_path / "no_glove"),
            "--seed", "2"]
    with _z_is_mu(monkeypatch):
        ref = jgenerate.main(jgenerate.parse_args(
            ["--model_path", tar, "--output_dir", str(tmp_path / "jax"), "--no-render", *argv]))
        ours = generate.main(parser_util.generate_args(
            ["--model_path", pt, "--output_dir", str(tmp_path / "ours"), "--device", "cpu",
             "--no-render", *argv]), device="cpu")
    assert ours["motion"].shape == (2, 32, 22, 3)  # 34 frames, whole snippets of 4
    for k in ("feature", "motion"):
        ref_k = np.asarray(ref[k])
        assert ours[k].shape == ref_k.shape
        err = float(np.abs(ours[k] - ref_k).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(ref_k).max())), (k, err)
    saved = np.load(tmp_path / "ours" / "results.npy", allow_pickle=True).item()
    assert set(saved) == set(ref) and saved["text"] == ref["text"]
    np.testing.assert_array_equal(saved["lengths"], ref["lengths"])


def test_each_cli_refuses_the_modes_it_does_not_run(trained):
    from regennet_torch.eval import eval_cmdm, eval_humanact12_uestc

    model_path, _, finest = trained
    args = _eval_args(model_path, finest, "wo_mm")
    assert args.eval_mode == "wo_mm" and args.length_estimator == ""
    for main in (eval_cmdm.main, eval_humanact12_uestc.main):
        with pytest.raises(ValueError, match="unknown eval mode wo_mm"):
            main(Namespace(**vars(args)), device="cpu")
    args.eval_mode = "mm_long"
    with pytest.raises(ValueError, match="unknown eval mode mm_long"):
        eval_humanml.main(args, device="cpu")


@pytest.mark.parametrize("mode,protocol", [
    ("debug", (32, 2, False, (0, 0), 0)), ("wo_mm", (1000, 20, False, (0, 0), 0)),
    ("full", (1000, 20, False, (0, 0), 0)), ("mm_short", (1000, 5, True, (100, 30), 10))])
def test_each_mode_runs_the_jax_protocol(trained, monkeypatch, mode, protocol):
    """main's protocol per mode (the JAX CLI's, eval_humanml.py:430-445):
    samples and replications at batch 32, multimodality only in mm_short
    (100 prompts x 30 repeats, 10 times); outside debug the GloVe archive
    is required unless REGENNET_ALLOW_HASHED_GLOVE=1. The sampling and the
    metrics are stubbed: test_debug_protocol_matches_jax runs them."""
    model_path, _, finest = trained
    seen = {}
    monkeypatch.setattr(eval_humanml, "make_gen_loader_factory",
                        lambda ds, model, sched, cfg, bs, n, **kw: seen.update(
                            bs=bs, n=n, mm=(kw["mm_num_samples"], kw["mm_num_repeats"])))
    monkeypatch.setattr(eval_humanml, "evaluation",
                        lambda w, gt, gens, log, **kw: seen.update(kw) or {})
    monkeypatch.delenv("REGENNET_ALLOW_HASHED_GLOVE", raising=False)
    if mode != "debug":
        with pytest.raises(FileNotFoundError, match="strict GloVe"):
            eval_humanml.main(_eval_args(model_path, finest, mode), device="cpu")
        monkeypatch.setenv("REGENNET_ALLOW_HASHED_GLOVE", "1")
    eval_humanml.main(_eval_args(model_path, finest, mode), device="cpu")
    num_samples, reps, run_mm, mm, mm_times = protocol
    assert (seen["bs"], seen["n"], seen["mm"]) == (32, num_samples, mm)
    assert (seen["replication_times"], seen["run_mm"], seen["mm_num_times"]) == (
        reps, run_mm, mm_times)


def test_in_training_route_logs_and_reports(trained, tmp_path, monkeypatch):
    _, root, finest = trained
    reported = []
    monkeypatch.setattr(train_platforms.NoPlatform, "report_scalar",
                        lambda self, **kw: reported.append(kw))
    save_dir = tmp_path / "run"
    args = parser_util.train_args([
        "--save_dir", str(save_dir), "--data_path", root, "--device", "cpu",
        "--layers", "1", "--latent_dim", "32", "--batch_size", "4", "--num_steps", "2",
        "--save_interval", "2", "--log_interval", "1", "--steps_per_call", "1",
        "--diffusion_steps", "4", "--eval_during_training", "--rec_model_path", finest,
        "--eval_batch_size", "4", "--eval_num_samples", "-1", "--eval_rep_times", "1"])
    train_mdm.main(args)
    evals = [r for r in reported if r.get("group_name") == "Eval"]
    steps = {r["iteration"] for r in evals}
    assert 2 in steps  # after the last save, and one log per evaluation
    for step in steps:
        assert (save_dir / f"eval_humanml_{step:09d}.log").is_file()
    names = {r["name"] for r in evals}
    assert {f"top{k}_R_precision_{n}" for k in (1, 2, 3) for n in ("model", "ground truth")} \
        <= names
    assert {"FID_model", "Diversity_model", "Matching Score_model"} <= names


def test_length_estimator_logits_match_jax(trained, tmp_path):
    """The estimator of a released-layout file ({"estimator": ...}): the
    port's logits on its word inputs against JAX's, and generate's
    lengths (multiples of 4 within [4, T])."""
    model_path, root, _ = trained
    est = jt2m.MotionLenEstimatorBiGRU(output_size=50)
    params = est.init(jax.random.PRNGKey(7), jnp.zeros((2, 8, 300)), jnp.zeros((2, 8, 15)),
                      jnp.asarray([8, 8]))["params"]
    path = tmp_path / "latest.tar"
    torch.save({"estimator": {k: torch.tensor(v) for k, v in
                              from_flax.length_estimator_state_dict_from_flax(params).items()}},
               path)
    prompts = ["a person walks forward", "a person jumps", "a person turns left slowly"]
    glove = str(tmp_path / "no_glove")
    inputs = generate._word_inputs(prompts, glove)
    for a, b in zip(inputs, jgenerate._word_inputs(prompts, glove)):
        np.testing.assert_array_equal(a, b)
    jest, jparams = jeval.load_length_estimator(str(path))
    ref = np.asarray(jest.apply({"params": jparams}, *map(jnp.asarray, inputs)))
    logits, lengths = generate.estimate_lengths(
        t2m_eval.load_length_estimator(str(path)), prompts, glove, T=120, seed=0)
    np.testing.assert_allclose(logits, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    assert lengths.dtype == np.int64 and ((lengths % 4) == 0).all()
    assert ((lengths >= 4) & (lengths <= 120)).all()

    out = tmp_path / "out"
    result = generate.main(parser_util.generate_args([
        "--model_path", model_path, "--data_path", root, "--text_prompt", prompts[0],
        "--num_samples", "3", "--motion_length", "6", "--length_estimator", str(path),
        "--glove_root", glove, "--seed", "0", "--output_dir", str(out), "--no-render"]),
        device="cpu")
    again = generate.estimate_lengths(t2m_eval.load_length_estimator(str(path)),
                                      [prompts[0]] * 3, glove, T=120, seed=0)[1]
    np.testing.assert_array_equal(result["lengths"], again)
    saved = np.load(out / "results.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(saved["lengths"], again)
