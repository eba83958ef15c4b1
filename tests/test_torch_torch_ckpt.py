"""regennet_torch.convert.torch_ckpt (`--check`) against the JAX package's
checker, on files the port's modules write at small sizes.

* detect_kind gives every kind the JAX function gives, on the same objects;
* --check loads each file strictly into the port's module for its kind,
  prints the JAX CLI's OK line and counts the file's parameters, as the
  JAX checker does for the same file;
* a file with a key removed, or one added, raises.
"""

import os

import pytest
import torch

from regennet_tpu.convert import torch_ckpt as jtc
from regennet_torch.convert import torch_ckpt as tc
from regennet_torch.models import actor_cvae, clip_text_tower, cmdm, gru_classifier, stgcn
from regennet_torch.models import t2m_eval, t2m_gen

ACTOR_ARCHS = ("transformer", "fc", "gru", "grutrans", "transgru", "autotrans")


def _objects():
    """{kind: what the port writes for it}, each at a small size."""
    torch.manual_seed(0)
    out = {}
    for arch, cm_mode, cond in (("online", "concat", "action"), ("offline", "add", "action"),
                                ("gru", "add", "action"), ("mlp", "add", "text")):
        out[f"cmdm/{arch}"] = cmdm.CMDM(
            njoints=5, nfeats=6, num_actions=3, num_frames=7, latent_dim=16, ff_size=24,
            num_layers=2, num_heads=2, arch=arch, cm_mode=cm_mode, cond_mode=cond).state_dict()
    out["stgcn"] = stgcn.STGCN(in_channels=12, num_class=5, num_person=2, layout="smplx",
                               channels=(8, 8, 16, 16), strides=(1, 2, 1, 2)).state_dict()
    out["gru"] = {"model": gru_classifier.MotionDiscriminator(10, 12, 2, 4).state_dict()}
    for arch in ACTOR_ARCHS:
        out[f"actor/{arch}"] = actor_cvae.ActorCVAE(
            njoints=5, nfeats=6, num_actions=3, latent_dim=16, ff_size=24, num_layers=2,
            num_heads=2, arch=arch, num_frames=7, num_gru_layers=3).state_dict()
    gen = t2m_gen.CompV6Generator(dim_pose=251, text_hidden=8, att_vec=6, dim_z=5,
                                  pri_hidden=12, dec_hidden=14, n_layers=2, mov_latent=512)
    (mov_enc,) = t2m_eval.networks(251, "movement_enc")
    out["comp_v6"] = {**t2m_gen.generator_state(gen, mov_enc), "epoch": 1}
    out["t2m"] = {**t2m_eval.evaluator_state(t2m_eval.T2MEvaluatorWrapper("kit")), "epoch": 1}
    (est,) = t2m_eval.networks(251, "estimator", length_bins=12)
    out["length_est"] = {"estimator": est.state_dict(), "epoch": 1}
    out["clip_text"] = clip_text_tower.ClipTextTower(
        vocab_size=40, context_length=9, dim=16, heads=2, num_layers=2,
        proj_dim=8).state_dict()
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for kind, obj in _objects().items():
        paths[kind] = str(d / (kind.replace("/", "_") + ".pt"))
        torch.save(obj, paths[kind])
    return paths


def _count(obj):
    """The parameter count of the tensors a checkpoint holds."""
    if torch.is_tensor(obj):
        return obj.numel()
    if isinstance(obj, dict):
        return sum(_count(v) for k, v in obj.items()
                   if not str(k).endswith(("num_batches_tracked", "pe")) and k != "A")
    return 0


def _keys(obj, prefix=""):
    """Every key of a checkpoint, nested state dicts' keys dotted below theirs."""
    out = []
    for k, v in obj.items():
        out.append(prefix + str(k))
        if isinstance(v, dict):
            out += _keys(v, prefix + str(k) + ".")
    return out


def test_detect_kind_on_every_kind_matches_jax():
    objects = _objects()
    assert len(objects) == 16
    for kind, obj in objects.items():
        assert tc.detect_kind(obj) == jtc.detect_kind(obj) == kind
    for bad in ({"x.weight": torch.zeros(1)}, [1, 2]):
        for fn in (tc.detect_kind, jtc.detect_kind):
            with pytest.raises(ValueError):
                fn(bad)


@pytest.mark.parametrize("kind", ["cmdm/online", "cmdm/offline", "cmdm/gru", "cmdm/mlp",
                                  "stgcn", "gru", "comp_v6", "t2m", "length_est",
                                  "clip_text"] + [f"actor/{a}" for a in ACTOR_ARCHS])
def test_check_loads_every_kind_the_port_writes(files, kind, capsys):
    path = files[kind]
    assert tc.main(["--check", path]) == 0
    line = capsys.readouterr().out.strip()
    summary = tc.check_checkpoint(path)
    assert summary["kind"] == kind
    assert line == (f"OK: {path} is a valid {kind} checkpoint ({summary['arrays']} arrays, "
                    f"{summary['parameters']:,} parameters, all keys consumed)")
    assert summary["parameters"] == _count(torch.load(path, weights_only=False))
    jax_summary = jtc.check_checkpoint(path)
    assert jax_summary["kind"] == kind
    if not any({"gru", "recurrent"} & set(k.split("."))
               for k in _keys(torch.load(path, weights_only=False))):
        # the JAX count folds each GRU gate's second bias into its first
        assert summary["parameters"] == jax_summary["parameters"]
    # --kind names the kind outright
    assert tc.check_checkpoint(path, kind)["arrays"] == summary["arrays"]


@pytest.mark.parametrize("kind", ["cmdm/online", "stgcn", "actor/autotrans", "t2m",
                                  "clip_text"])
def test_a_missing_or_an_extra_key_raises(files, kind, tmp_path):
    obj = torch.load(files[kind], weights_only=False)
    sd = obj["movement_encoder"] if kind == "t2m" else obj
    key = next(k for k in sd if k.endswith("weight"))
    value = sd.pop(key)
    torch.save(obj, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="missing"):
        tc.check_checkpoint(str(tmp_path / "missing.pt"), kind)
    sd[key] = value
    sd["extra_layer.weight"] = torch.zeros(2)
    torch.save(obj, tmp_path / "extra.pt")
    with pytest.raises(ValueError, match="unconsumed"):
        tc.check_checkpoint(str(tmp_path / "extra.pt"), kind)
    assert os.path.getsize(tmp_path / "extra.pt") > 0
