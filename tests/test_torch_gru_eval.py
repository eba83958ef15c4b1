"""regennet_torch's single-person a2m evaluation against the JAX package's.

`eval_humanact12_uestc.evaluate` on one synthetic dataset in both
packages, with 1-step respacing and a denoiser that returns a fixed
motion per action: the posterior at t = 0 is then the prediction, so no
sampling noise enters and the generated batches are the same.
* HumanAct12 (the GRU classifier of one released-layout file that both
  packages read; conditional, and unconstrained without the protocol's
  files): the generated and ground-truth rot6d batches are bit-equal,
  their SMPL joints (each package's own decode) within 1e-5 x max(1,
  max|jax|), the metrics within 1e-4 relative (1e-9 absolute for the
  FID of a set with itself);
* UESTC (the single-person ST-GCN on shared weights): the arrays the
  classifier sees are bit-equal, the metrics within 1e-4 relative;
* the unconstrained protocol: on a tiny modi-struct array from given
  joints, and the whole route (1000 samples asked, the dataset's worth
  sampled) from the same openpose ST-GCN file, within 1e-4 relative;
* `eval_humanact12_uestc.main` end to end on the CPU for humanact12,
  uestc and an --unconstrained model, at T = 16.
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.data.get_data import get_dataset as jget_dataset
from regennet_tpu.diffusion import DiffusionConfig as JConfig
from regennet_tpu.diffusion import make_schedule as jmake_schedule
from regennet_tpu.eval import eval_humanact12_uestc as jlegacy
from regennet_tpu.eval import gru_eval as jgru_eval
from regennet_tpu.eval import stgcn_eval as jstgcn_eval
from regennet_tpu.eval import unconstrained as JU
from regennet_tpu.models.stgcn import STGCN as JSTGCN
from regennet_torch.convert.from_flax import stgcn_state_dict_from_flax
from regennet_torch.data.get_data import get_dataset
from regennet_torch.diffusion import DiffusionConfig, make_schedule
from regennet_torch.eval import eval_humanact12_uestc as legacy
from regennet_torch.eval import gru_eval, stgcn_eval
from regennet_torch.eval import unconstrained as U
from regennet_torch.models import gru_classifier
from regennet_torch.models.stgcn import make_unconstrained_stgcn
from regennet_torch.train import checkpoint
from tests.test_legacy import _fabricate_unconstrained_stgcn_sd
from tests.test_torch_chip_smoke import one_torch_thread  # noqa: F401

T = 16
WRITERS = {"humanact12": (jsynthetic.write_humanact12_pkl, "num_clips", 12),
           "uestc": (jsynthetic.write_uestc_assets, "num_videos", 40)}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for name, (write, count, _) in WRITERS.items():
        out[name] = write(str(tmp_path_factory.mktemp(name)), **{count: 24})
    out["rec"] = tmp_path_factory.mktemp("rec")
    return out


def _datasets(roots, name):
    kw = dict(name=name, num_frames=T, num_person=1, data_path=roots[name], split="train",
              setting="mdm", pose_rep="rot6d", body_model="smpl")
    return jget_dataset(**kw), get_dataset(**kw)


def _patterns(data, num_actions):
    """A rot6d motion per action, from the dataset's items."""
    items = [data[i]["inp"] for i in range(min(num_actions, len(data)))]
    return np.stack([items[a % len(items)] for a in range(num_actions)])


def _args(name, **over):
    base = dict(seed=10, batch_size=4, num_samples=10, num_seeds=2, dataset=name,
                eval_mode="full", unconstrained=False, guidance_param=1.0, num_frames=T,
                body_model="smpl")
    base.update(over)
    return Namespace(**base)


def _gru_file(roots):
    path = roots["rec"] / "humanact12_gru.tar"
    if not path.exists():
        model = gru_classifier.random_init_(gru_classifier.MotionDiscriminator(output_size=12),
                                            torch.Generator().manual_seed(5))
        torch.save({"model": model.state_dict()}, path)
    return str(path)


def _record(monkeypatch, module, store):
    """Keep every batch list module._build_batches returns."""
    build = module._build_batches

    def recorded(*a, **kw):
        out = build(*a, **kw)
        store.append(out)
        return out

    monkeypatch.setattr(module, "_build_batches", recorded)


def _run_both(monkeypatch, roots, name, jrec, rec, args):
    """eval_humanact12_uestc.evaluate in both packages on one dataset, the
    deterministic denoiser and 1-step respacing, the JAX package's
    classifier from `jrec`, the port's from `rec`; returns (ours, ref,
    the port's batch lists, the JAX package's)."""
    jdata, data = _datasets(roots, name)
    pattern = _patterns(jdata, WRITERS[name][2])
    jpattern, tpattern = jnp.asarray(pattern), torch.tensor(pattern)
    jbatches, batches = [], []
    _record(monkeypatch, jgru_eval, jbatches)
    _record(monkeypatch, gru_eval, batches)
    ref = jlegacy.evaluate(
        Namespace(**vars(args)), lambda: (lambda x, t, cond: jpattern[cond["action"][:, 0]]),
        jmake_schedule("cosine", 1000, timestep_respacing="1"),
        JConfig(model_mean_type="start_x"), jdata, jrec)
    ours = legacy.evaluate(
        args, lambda: (lambda x, t, cond: tpattern[cond["action"][:, 0]]),
        make_schedule("cosine", 1000, timestep_respacing="1"),
        DiffusionConfig(model_mean_type="start_x"), data, rec)
    return ours, ref, batches, jbatches


def _hold_metrics(ours, ref):
    assert ours["feats"].keys() == ref["feats"].keys()
    for key, values in ref["feats"].items():
        want = [float(v) for v in (values if isinstance(values, list) else [values])]
        got = ours["feats"][key]
        got = [float(v) for v in (got if isinstance(got, list) else [got])]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9, err_msg=key)


@pytest.mark.parametrize("unconstrained", [False, True])
def test_humanact12_route_matches_jax(monkeypatch, roots, unconstrained):
    rec = _gru_file(roots)
    args = _args("humanact12", unconstrained=unconstrained)
    ours, ref, batches, jbatches = _run_both(monkeypatch, roots, "humanact12", rec, rec,
                                             args)
    # 2 seeds x (gen, gt, gt2), each 3 batches (the third trimmed to 2 rows)
    assert len(batches) == len(jbatches) == 6
    for ob, jb in zip(batches, jbatches):
        assert [len(b["output"]) for b in ob] == [len(b["output"]) for b in jb] == [4, 4, 2]
        for b, j in zip(ob, jb):
            np.testing.assert_array_equal(b["output"], np.asarray(j["output"]))
            np.testing.assert_array_equal(b["lengths"], j["lengths"])
            np.testing.assert_array_equal(b["y"], j["y"])
            xyz = np.asarray(j["output_xyz"])
            np.testing.assert_allclose(b["output_xyz"], xyz, rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(xyz).max())))
    _hold_metrics(ours, ref)
    assert all(len(v) == 2 for v in ours["feats"].values())
    if unconstrained:
        assert np.isnan(float(ours["feats"]["accuracy_gen"][0]))
        assert "kid_unconstrained" in ours["feats"]


class _Recorder:
    """An evaluator that keeps every batch it is shown."""

    def __init__(self, inner):
        self.inner, self.num_classes, self.outputs = inner, inner.num_classes, []

    def __call__(self, batch):
        self.outputs.append(np.asarray(batch["output"]))
        return self.inner(batch)


REDUCED = dict(channels=(8, 16), strides=(1, 2))


def test_uestc_route_matches_jax(monkeypatch, roots):
    """A reduced single-person ST-GCN on shared weights (the JAX package's
    variables, carried into a .pt file that the port reads) in place of
    each package's 40-class UESTC classifier."""
    jm = JSTGCN(in_channels=6, num_class=40, num_person=1, layout="smpl", strategy="spatial",
                **{k: tuple(v) for k, v in REDUCED.items()})
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), {"output": jnp.zeros((1, 25, 6, T))}, train=False))
    path = roots["rec"] / "uestc_stgcn.pt"
    torch.save({k: torch.tensor(v) for k, v in stgcn_state_dict_from_flax(variables).items()},
               path)
    recorders = []

    def loader(make):
        def load(args, rec, *rest, **kw):
            recorders.append(_Recorder(make(rec)))
            return recorders[-1]
        return load

    monkeypatch.setattr(jlegacy, "_load_uestc_evaluator", loader(
        lambda rec: jstgcn_eval.STGCNEvaluator("uestc", "smpl", 40, 6, 1, variables,
                                               **REDUCED)))
    monkeypatch.setattr(legacy, "load_uestc_evaluator", loader(
        lambda rec: stgcn_eval.STGCNEvaluator("uestc", "smpl", 40, 6, 1, rec, **REDUCED)))
    args = _args("uestc", num_samples=8)
    ours, ref, _, _ = _run_both(monkeypatch, roots, "uestc", "random", str(path), args)
    jrec, rec = recorders
    # 2 seeds x {gen, gt} x {train: 3 batches (the third crosses 8
    # samples), test: the split's 8 clips}
    assert len(rec.outputs) == len(jrec.outputs) == 2 * 2 * (3 + 2)
    for a, b in zip(rec.outputs, jrec.outputs):
        assert a.shape == b.shape == (4, 25, 6, T)
        np.testing.assert_array_equal(a, b)
    _hold_metrics(ours, ref)
    assert "fid_gen_test" in ours["feats"]


def _unconstrained_assets(roots):
    sd = _fabricate_unconstrained_stgcn_sd(torch)
    path = roots["rec"] / "humanact12_gru_modi_struct.pth.tar"
    torch.save(sd, path)
    motions = np.random.default_rng(3).normal(size=(40, 16, 3, T)).astype(np.float32)
    data_path = roots["rec"] / "humanact12_modi_struct.npy"
    np.save(data_path, motions)
    return sd, str(path), str(data_path)


@pytest.mark.parametrize("fast", [True, False])
def test_unconstrained_protocol_matches_jax(roots, fast):
    from regennet_tpu.convert.torch_ckpt import convert_stgcn

    sd, path, data_path = _unconstrained_assets(roots)
    gen = np.random.default_rng(4).normal(size=(30, 24, 3, T)).astype(np.float32)
    motions = np.load(data_path)
    ref = JU.evaluate_unconstrained_reference_protocol(
        convert_stgcn({k: v.numpy() for k, v in sd.items()}), gen, motions, fast=fast)
    model = checkpoint.load_classifier_state(make_unconstrained_stgcn(), path)
    ours = U.evaluate_unconstrained_reference_protocol(model, gen, motions, fast=fast)
    assert ours.keys() == ref.keys()
    assert ("precision_unconstrained" in ours) is not fast
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key], value, rtol=1e-4, err_msg=key)


def test_unconstrained_route_with_its_files_matches_jax(monkeypatch, roots):
    _, path, data_path = _unconstrained_assets(roots)
    args = _args("humanact12", unconstrained=True, num_seeds=1, unconstrained_rec_path=path,
                 unconstrained_data_path=data_path)
    rec = _gru_file(roots)
    ours, ref, batches, jbatches = _run_both(monkeypatch, roots, "humanact12", rec, rec,
                                             args)
    # the route's own sampling: the dataset's 24 clips in batches of 4
    assert [len(b) for b in batches] == [len(b) for b in jbatches] == [3, 3, 3, 6]
    for b, j in zip(batches[-1], jbatches[-1]):
        np.testing.assert_array_equal(b["output"], np.asarray(j["output"]))
    _hold_metrics(ours, ref)
    assert "fid_unconstrained" in ours["feats"] and "precision_unconstrained" not in ours["feats"]


def _checkpoint(tmp_path, name, **over):
    """A random CMDM of the test size saved as model000000005.pt, with its
    args.json, as train_mdm writes them."""
    from regennet_torch.utils.model_util import create_model_and_diffusion

    run = tmp_path / name
    run.mkdir()
    train_args = dict(
        dataset=name.split("_")[0], data_dir="", num_person=1, data_path="",
        pose_rep="rot6d", body_model="smpl", vel_threshold=0.01, shuffle=False,
        setting="mdm", arch="trans_enc", emb_trans_dec=False, wo_pos_emb=False,
        cm_mode="concat", layers=2, latent_dim=32, cond_mask_prob=0.1, lambda_rcxyz=0.0,
        lambda_vel=0.0, lambda_fc=0.0, lambda_orient=1.0, lambda_body=1.0,
        lambda_transl=1.0, unconstrained=False, noise_schedule="cosine",
        diffusion_steps=10, sigma_small=True, num_frames=T)
    train_args.update(over)

    class _Data:
        num_actions = 12 if train_args["dataset"] == "humanact12" else 40

    torch.manual_seed(0)
    model, _, _ = create_model_and_diffusion(Namespace(**train_args), _Data())
    torch.save(model.state_dict(), run / "model000000005.pt")
    (run / "args.json").write_text(json.dumps(train_args))
    return str(run / "model000000005.pt")


@pytest.mark.parametrize("name", ["humanact12", "uestc", "humanact12_unconstrained"])
def test_main_end_to_end_on_cpu(tmp_path, roots, name):
    """main in debug mode (10 samples, 2 seeds) at the batch of 4, a
    random classifier from --seed; the results file holds the returned
    metrics."""
    from regennet_torch.eval import tools
    from regennet_torch.utils import parser_util

    uncon = name.endswith("unconstrained")
    model_path = _checkpoint(tmp_path, name, unconstrained=uncon)
    argv = ["--model_path", model_path, "--rec_model_path", "random", "--batch_size", "4",
            "--guidance_param", "1"]
    if uncon:
        _, path, data_path = _unconstrained_assets(roots)
        argv += ["--unconstrained_rec_path", path, "--unconstrained_data_path", data_path]
    args = parser_util.evaluation_parser(argv)
    assert args.unconstrained is uncon and args.dataset == name.split("_")[0]
    args.data_path = roots[args.dataset]
    result = legacy.main(args, device="cpu")
    path = legacy.results_path(args)
    assert path.endswith("evaluation_results_iter000000005_samp10_scale1p0_a2m.yaml")
    assert tools.load_metrics(path) == result
    feats = result["feats"]
    if args.dataset == "uestc":
        assert set(feats) == {f"accuracy_{k}_{s}" for k in ("gen", "gt")
                              for s in ("train", "test")}
    else:
        assert {"accuracy_gen", "fid_gen", "diversity_gt2"} <= set(feats)
    assert ("fid_unconstrained" in feats) is uncon
