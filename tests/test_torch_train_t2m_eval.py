"""regennet_torch.train.train_t2m_eval against regennet_tpu.train.train_t2m_eval.

Both CLIs run `--stage all` for one epoch on the same synthetic HumanML
split, with a batch that holds the whole split: one update of each stage
(decomp: Adam; matching: the global norm clipped at 0.5, then Adam, the
negative shift from np.random.default_rng(seed + 1); length:
cross-entropy, Adam) on the same batch, whose items both packages draw
from `random` and numpy's ambient stream in the same order. The port
starts each stage from the JAX stage's own starting weights: its initial
draws (a run of zero epochs), carried across by convert.from_flax, and
for the matching stage the movement encoder JAX's decomp update made.
Both packages' T2M_OPT is cut to small widths.

Checked, per stage: the printed loss terms, within 1e-5 relative (plus
the print's 1e-6 rounding); the gradients Adam receives (after the
clipping), within 1e-3 x the largest JAX gradient of each tensor (the
decomp stage's are sums of L1 signs that cancel: they read up to 2e-4); the
parameters after the update, within 1e-5 x max(1, max|jax|) of each
tensor. Adam's first step moves an entry by lr x g / (|g| + eps), a full
lr whatever the size of g, so an entry whose gradient is below 1e-4 of
its tensor's largest (rounding decides its sign) may differ by up to 2 lr
(the movement encoder's first conv bias, and entries of the length
estimator's GRU, do). The port's checkpoints pass
regennet_tpu.convert.torch_ckpt's converters with full key coverage.
"""

import contextlib
import copy
import functools
import io
import re

import jax
import numpy as np
import pytest
import torch

from regennet_torch.convert import from_flax
from regennet_torch.data.humanml.dataset import write_synthetic_humanml
from regennet_torch.models import t2m_eval
from regennet_torch.train import train_t2m_eval
from regennet_tpu.convert import torch_ckpt
from regennet_tpu.models import t2m_eval as jt2m
from regennet_tpu.train import checkpoint as jcheckpoint
from regennet_tpu.train import train_t2m_eval as jtrain

CLIPS = 6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hml_root(tmp_path_factory):
    return write_synthetic_humanml(str(tmp_path_factory.mktemp("hml")), num_clips=CLIPS,
                                   min_len=40, max_len=200)


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


def _argv(root, save_dir, epochs):
    return ["--data_path", root, "--save_dir", str(save_dir), "--stage", "all",
            "--batch_size", str(4 * CLIPS), "--num_epochs", str(epochs)]


def _jax_run(root, save_dir, epochs, monkeypatch):
    """The JAX CLI's saved states by stage, kept in memory, and the
    gradients each Adam update received, in update order."""
    import optax

    saved, grads = {}, []

    def keep(stage_dir, step, state):
        saved[stage_dir.rsplit("/", 1)[-1]] = jax.device_get(state)["params"]
        return stage_dir

    adam = optax.adam

    def recording_adam(lr):
        inner = adam(lr)

        def update(updates, state, params=None):
            jax.debug.callback(lambda u: grads.append(jax.device_get(u)), updates)
            return inner.update(updates, state, params)

        return optax.GradientTransformation(inner.init, update)

    with monkeypatch.context() as m:
        m.setattr(jcheckpoint, "save_checkpoint", keep)
        m.setattr(optax, "adam", recording_adam)
        jtrain.main(jtrain.parse_args(_argv(root, save_dir, epochs)))
    return saved, grads


def _logs(text):
    """{stage: {term: value}} of the printed epoch lines."""
    out = {}
    for stage, terms in re.findall(r"\[(\w+)\] epoch 1: (.*)", text):
        out[stage] = {k: float(v) for k, v in (t.split("=") for t in terms.split())}
    return out


def _close(ours, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(np.asarray(ours) - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), (what, err)


def _port_names(*networks):
    return [f"{key}.{n}" for key, net in networks for n, _ in net.named_parameters()]


@pytest.fixture(scope="module")
def runs(hml_root, tmp_path_factory):
    """JAX's initial states, its states after one epoch, its logs and
    gradients; the port's results, saved files, logs and gradients (by the
    reference names, flax's converted to them)."""
    tmp = tmp_path_factory.mktemp("runs")
    with pytest.MonkeyPatch.context() as mp:
        init, _ = _jax_run(hml_root, tmp / "jax0", 0, mp)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            after, jgrads = _jax_run(hml_root, tmp / "jax1", 1, mp)
        jax_logs = _logs(buf.getvalue())
        assert len(jgrads) == 3  # one update a stage
        jax_grads = {
            "decomp": from_flax.decomp_state_from_flax(jgrads[0]),
            "matching": {"text_encoder": from_flax._bigru_co(jgrads[1]["text"],
                                                             jgrads[1]["text"]["pos_emb"]),
                         "motion_encoder": from_flax._bigru_co(jgrads[1]["motion"])},
            "length": {"estimator": from_flax.length_estimator_state_dict_from_flax(
                jgrads[2])}}

        evaluator = from_flax.t2m_evaluator_state_from_flax(init["matching"])
        starts = {
            "train_decomp": from_flax.decomp_state_from_flax(init["decomp"]),
            "train_matching": {k: evaluator[k] for k in ("text_encoder", "motion_encoder")},
            "train_length": {"estimator": from_flax.length_estimator_state_dict_from_flax(
                init["length"])},
        }
        for name, start in starts.items():
            mp.setattr(train_t2m_eval, name,
                       functools.partial(getattr(train_t2m_eval, name), init=start))
        decomp = train_t2m_eval.train_decomp
        jax_movement = from_flax.decomp_state_from_flax(after["decomp"])["movement_enc"]
        port_decomp = []

        def decomp_then_jax_encoder(*args, **kwargs):
            """The port's decomp stage, then JAX's encoder for the matching stage."""
            enc, dec = decomp(*args, **kwargs)
            port_decomp.append((copy.deepcopy(enc), dec))
            t2m_eval.load_state(enc, jax_movement)
            return enc, dec

        mp.setattr(train_t2m_eval, "train_decomp", decomp_then_jax_encoder)
        port_grads = []
        adam_step = torch.optim.Adam.step

        def recording_step(self, *args, **kwargs):
            port_grads.append([p.grad.detach().clone() for g in self.param_groups
                               for p in g["params"]])
            return adam_step(self, *args, **kwargs)

        mp.setattr(torch.optim.Adam, "step", recording_step)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ours = train_t2m_eval.main(
                train_t2m_eval.parse_args(_argv(hml_root, tmp / "port", 1)), device="cpu")
    ours["decomp"] = port_decomp[0]
    names = [
        _port_names(("movement_enc", ours["decomp"][0]), ("movement_dec", ours["decomp"][1])),
        _port_names(("text_encoder", t2m_eval.TextEncoderBiGRUCo()),
                    ("motion_encoder", t2m_eval.MotionEncoderBiGRUCo())),
        _port_names(("estimator", ours["length"]))]
    assert len(port_grads) == 3
    port_grads = {stage: dict(zip(n, (g.numpy() for g in grads)))
                  for stage, n, grads in zip(("decomp", "matching", "length"), names,
                                             port_grads)}
    return dict(init=init, after=after, jax_logs=jax_logs, jax_grads=jax_grads,
                ours=ours, save_dir=tmp / "port", port_logs=_logs(buf.getvalue()),
                port_grads=port_grads)


def test_each_stage_logs_the_jax_loss_terms(runs):
    jax_logs, port_logs = runs["jax_logs"], runs["port_logs"]
    assert set(jax_logs) == set(port_logs) == {"decomp", "matching", "length"}
    for stage, terms in jax_logs.items():
        assert set(port_logs[stage]) == set(terms)
        for k, v in terms.items():
            assert abs(port_logs[stage][k] - v) <= 1e-5 * abs(v) + 1e-6, (stage, k)


def _numpy_state(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def _stage_states(runs, stage):
    """(JAX's state before, JAX's after, the port's after), by network."""
    init, after, ours = runs["init"], runs["after"], runs["ours"]
    if stage == "decomp":
        return (from_flax.decomp_state_from_flax(init["decomp"]),
                from_flax.decomp_state_from_flax(after["decomp"]),
                {"movement_enc": _numpy_state(ours["decomp"][0]),
                 "movement_dec": _numpy_state(ours["decomp"][1])})
    if stage == "matching":
        nets = ("text_encoder", "motion_encoder")
        before = from_flax.t2m_evaluator_state_from_flax(init["matching"])
        ref = from_flax.t2m_evaluator_state_from_flax(after["matching"])
        return ({k: before[k] for k in nets}, {k: ref[k] for k in nets},
                {k: {n: v.numpy() for n, v in ours["matching"][k].items()} for k in nets})
    convert = from_flax.length_estimator_state_dict_from_flax
    return ({"estimator": convert(init["length"])}, {"estimator": convert(after["length"])},
            {"estimator": _numpy_state(ours["length"])})


@pytest.mark.parametrize("stage", ["decomp", "matching", "length"])
def test_one_update_matches_jax(runs, stage):
    before, ref, got = _stage_states(runs, stage)
    jgrads, pgrads = runs["jax_grads"][stage], runs["port_grads"][stage]
    lr = 1e-4  # the CLI's default
    moved = 0
    for net, sd in ref.items():
        assert set(got[net]) == set(sd), net
        for name, value in sd.items():
            what = f"{stage}: {net}.{name}"
            g_ref = np.asarray(jgrads[net][name])
            g_scale = float(np.abs(g_ref).max())
            g_err = float(np.abs(pgrads[f"{net}.{name}"] - g_ref).max())
            assert g_err <= 1e-3 * g_scale, (what, "gradient", g_err, g_scale)
            value = np.asarray(value)
            err = np.abs(got[net][name] - value)
            tol = 1e-5 * max(1.0, float(np.abs(value).max()))
            noise = np.abs(g_ref) <= 1e-4 * g_scale  # Adam's step takes its sign
            assert err[~noise].max(initial=0.0) <= tol, (what, float(err.max()))
            assert err[noise].max(initial=0.0) <= 2 * lr + tol, what
            moved += not np.array_equal(value, before[net][name])
    assert moved > 0  # the update moved the parameters


def test_checkpoints_load_through_the_jax_converters(runs):
    """The saved files are in the released layouts: the matching .pt is a
    finest.tar for convert_t2m_evaluator and the port's wrapper, the length
    .pt a latest.tar for convert_length_estimator (key coverage enforced)."""
    ours, save_dir = runs["ours"], runs["save_dir"]
    matching = t2m_eval.load_torch_file(save_dir / "matching" / "model000000001.pt")
    variables = torch_ckpt.convert_t2m_evaluator(matching)
    assert set(variables) == {"movement", "text", "motion"}
    wrapper = t2m_eval.T2MEvaluatorWrapper("humanml", state=str(
        save_dir / "matching" / "model000000001.pt"))
    for key, net in (("text_encoder", wrapper.text_enc), ("motion_encoder", wrapper.motion_enc)):
        for name, value in net.state_dict().items():
            np.testing.assert_array_equal(value.numpy(), ours["matching"][key][name].numpy())
    length = t2m_eval.load_torch_file(save_dir / "length" / "model000000001.pt")
    params = torch_ckpt.convert_length_estimator(length)["params"]
    assert np.asarray(params["head_out"]["kernel"]).shape == (128, 196 // 4 + 1)
    est = t2m_eval.load_length_estimator(str(save_dir / "length" / "model000000001.pt"))
    assert est.output[9].out_features == 50
    decomp = t2m_eval.load_torch_file(save_dir / "decomp" / "model000000001.pt")
    assert set(decomp) == {"movement_enc", "movement_dec", "ep"}


def test_matching_alone_needs_a_decomp_checkpoint(hml_root, tmp_path):
    args = train_t2m_eval.parse_args(["--data_path", hml_root, "--save_dir",
                                      str(tmp_path / "run"), "--stage", "matching"])
    with pytest.raises(ValueError, match="needs a decomp checkpoint"):
        train_t2m_eval.main(args, device="cpu")
