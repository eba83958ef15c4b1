"""regennet_torch's comp_v6 generator (models/t2m_gen.py, train/train_t2m_gen.py,
data/humanml/get_opt.py) against the JAX package's.

The modules at small widths, 2 layers a cell (where the prior and
posterior cells' quirk shows), on inputs made with numpy from a seed and
weights carried across by convert.from_flax.comp_v6_state_from_flax:
- the text encoder, captions padded past the batch's longest: the backward
  stream flipped within each length and zeroed past it;
- the attention over the first max(cap_lens) positions;
- each cell, a time-to-arrival below 0 included (clipped);
- generate with z = mu, and with the noise JAX draws (its per-snippet
  `split(rng, 3)`) fed as eps;
- the training forward with teacher forcing off and on, and comp_v6_losses
  (the swapped reconstruction lambdas);
- a released-layout latest.tar written from the port's modules: the
  port's load_comp_v6 and JAX's convert_comp_v6 give the same motions.
f32 tolerance 1e-5 x max(1, max|jax|).

The trainers: both CLIs on the same synthetic HumanML split in one batch
(one update an epoch), the JAX decomp stage's movement autoencoder carried
across, the port started from JAX's initial generator and fed JAX's noise.
The printed losses, the gradients Adam receives after the clipping
(within 1e-3 x the largest JAX gradient of each tensor) and the
parameters after Adam (as tests/test_torch_train_t2m_eval.py holds them:
an entry whose gradient is below 1e-4 of its tensor's largest may differ
by up to 2 lr, Adam's first step taking its sign); the GRU cells' bias_hh
r/z slices stay 0. Then --resume from JAX's first checkpoint, carried
across with its Adam state, against JAX's resumed epoch.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_torch.convert import from_flax
from regennet_torch.data.humanml import get_opt
from regennet_torch.data.humanml.dataset import write_synthetic_humanml
from regennet_torch.models import t2m_eval, t2m_gen
from regennet_torch.train import train_t2m_gen
from regennet_tpu.convert import torch_ckpt
from regennet_tpu.data.humanml import get_opt as jget_opt
from regennet_tpu.models import t2m_eval as jt2m_eval
from regennet_tpu.models import t2m_gen as jt2m_gen
from regennet_tpu.train import checkpoint as jcheckpoint
from regennet_tpu.train import train_t2m_gen as jtrain

KW = dict(dim_pose=12, dim_word=16, dim_pos_ohot=5, text_hidden=16, att_vec=16, dim_z=4,
          pri_hidden=24, dec_hidden=32, n_layers=2, mov_latent=6)
B, L, M = 3, 9, 5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(ours, ref, what=""):
    ref = np.asarray(ref)
    ours = ours.detach().cpu().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    assert err <= 1e-5 * max(1.0, float(np.abs(ref).max())), (what, err)


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(word=f32(B, L, 16), pos=f32(B, L, 5),
                cap_lens=np.array([7, 5, 4]),  # positions 7 and 8 lie past the longest
                movements=f32(B, M, 6), m_lens=np.array([20, 16, 12]),  # tta reaches -2
                mov_in0=f32(B, 6))


def _load(port, params):
    sd = from_flax.comp_v6_state_from_flax(jax.device_get(params))
    for name, net in t2m_gen.networks(port, None).items():
        net.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd[name].items()})
    return port


@pytest.fixture(scope="module")
def pair():
    """(JAX generator, its params, the port's generator with them, inputs)."""
    x = _inputs()
    jgen = jt2m_gen.CompV6Generator(**KW)
    key = jax.random.PRNGKey(0)
    params = jgen.init(key, x["word"], x["pos"], x["cap_lens"], x["movements"], x["m_lens"],
                       x["mov_in0"], key, jnp.ones(()))["params"]
    return jgen, params, _load(t2m_gen.CompV6Generator(**KW).eval(), params), x


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _jax_noise(key, mov_len, batch, dim_z):
    """The eps JAX's loop draws from `key`: per snippet `key, r_pos, r_pri =
    split(key, 3)`, eps_pri from r_pri, eps_post from r_pos."""
    pri, post = [], []
    for _ in range(mov_len):
        key, r_pos, r_pri = jax.random.split(key, 3)
        pri.append(jax.random.normal(r_pri, (batch, dim_z)))
        post.append(jax.random.normal(r_pos, (batch, dim_z)))
    return _t(np.stack(pri)), _t(np.stack(post))


def test_text_encoder_flips_and_zeroes(pair):
    jgen, params, port, x = pair
    ref = jgen.apply({"params": params}, x["word"], x["pos"], x["cap_lens"],
                     method=lambda m, *a: m.text_enc(*a))
    with torch.no_grad():
        ours = port.text_enc(_t(x["word"]), _t(x["pos"]), x["cap_lens"])
    _close(ours[0], ref[0], "word hiddens")
    _close(ours[1], ref[1], "final states")
    for row, length in enumerate(x["cap_lens"]):
        assert not ours[0][row, length:].any() and ours[0][row, :length].abs().min() > 0


def test_attention_runs_over_the_batch_span(pair):
    """Softmax over max(cap_lens) positions: the zero hiddens of the shorter
    rows take part, positions past the longest caption do not."""
    jgen, params, port, x = pair
    word_hids = np.asarray(jgen.apply({"params": params}, x["word"], x["pos"], x["cap_lens"],
                                      method=lambda m, *a: m.text_enc(*a))[0])
    query = np.random.default_rng(1).normal(size=(B, KW["dec_hidden"])).astype(np.float32)
    span = int(x["cap_lens"].max())
    ref_v, ref_w = jgen.apply({"params": params}, query, word_hids, span,
                              method=lambda m, *a: m.att_layer(*a))
    with torch.no_grad():
        ours_v, ours_w = port.att_layer(_t(query), _t(word_hids[:, :span]))
    _close(ours_v, ref_v, "attended values")
    _close(ours_w, np.asarray(ref_w)[:, :span], "weights")
    assert not np.asarray(ref_w)[:, span:].any()
    assert float(ours_w[2, 4:span].min()) > 0  # row 2's zero hiddens take part


@pytest.mark.parametrize("cell", ["seq_pri", "seq_post", "seq_dec"])
def test_each_cell_at_two_layers(pair, cell):
    jgen, params, port, _ = pair
    rng = np.random.default_rng(2)
    width = {"seq_pri": 6 + 16, "seq_post": 12 + 16, "seq_dec": 6 + 16 + 4}[cell]
    inputs = rng.normal(size=(B, width)).astype(np.float32)
    text = rng.normal(size=(B, 2 * KW["text_hidden"])).astype(np.float32)
    tta = np.array([3, 0, -2])
    key = jax.random.PRNGKey(3)

    def apply(m, inputs, text, tta):
        sub = getattr(m, cell)
        hidden = sub.get_init_hidden(text)
        return sub(inputs, hidden, tta) if cell == "seq_dec" else sub(inputs, hidden, tta, key)

    ref = jgen.apply({"params": params}, inputs, text, tta, method=apply)
    sub = getattr(port, cell)
    with torch.no_grad():
        hidden = sub.get_init_hidden(_t(text))
        if cell == "seq_dec":
            ours = sub(_t(inputs), hidden, _t(tta))
        else:
            ours = sub(_t(inputs), hidden, _t(tta),
                       _t(jax.random.normal(key, (B, KW["dim_z"]))))
    assert len(ours[-1]) == len(ref[-1]) == 2
    for i, (a, b) in enumerate(zip(ours[:-1], ref[:-1])):
        _close(a, b, f"{cell} output {i}")
    for i, (a, b) in enumerate(zip(ours[-1], ref[-1])):
        _close(a, b, f"{cell} hidden {i}")


@pytest.mark.parametrize("noise", ["mu", "jax_stream"])
def test_generate_matches_jax(pair, noise):
    jgen, params, port, x = pair
    key = None if noise == "mu" else jax.random.PRNGKey(4)
    ref = jgen.apply({"params": params}, x["word"], x["pos"], x["cap_lens"], x["m_lens"],
                     x["mov_in0"], key, M, method=jgen.generate)
    eps = None if key is None else _jax_noise(key, M, B, KW["dim_z"])[0]
    with torch.no_grad():
        ours = port.generate(_t(x["word"]), _t(x["pos"]), x["cap_lens"], x["m_lens"],
                             _t(x["mov_in0"]), M, eps)
    assert set(ours) == set(ref) == {"fake_motions", "fake_movements", "mus_pri",
                                     "logvars_pri"}
    for k in ref:
        _close(ours[k], ref[k], k)
    assert ours["fake_motions"].shape == (B, M * 4, KW["dim_pose"])


def _training_forward(pair, teacher_force):
    jgen, params, port, x = pair
    key = jax.random.PRNGKey(5)
    ref = jgen.apply({"params": params}, x["word"], x["pos"], x["cap_lens"], x["movements"],
                     x["m_lens"], x["mov_in0"], key, jnp.asarray(float(teacher_force)))
    eps_pri, eps_post = _jax_noise(key, M, B, KW["dim_z"])
    ours = port(_t(x["word"]), _t(x["pos"]), x["cap_lens"], _t(x["movements"]), x["m_lens"],
                _t(x["mov_in0"]), teacher_force, eps_pri, eps_post)
    return ours, ref


@pytest.mark.parametrize("teacher_force", [False, True])
def test_training_forward_matches_jax(pair, teacher_force):
    ours, ref = _training_forward(pair, teacher_force)
    assert set(ours) == set(ref)
    for k in ref:
        _close(ours[k], ref[k], k)


def test_losses_match_jax(pair):
    _, _, _, x = pair
    ours, ref = _training_forward(pair, False)
    motions = np.random.default_rng(6).normal(size=(B, M * 4, KW["dim_pose"])).astype(
        np.float32)
    lambdas = (2.0, 3.0, 0.5)  # rec_mov, rec_mot, kld: the swap shows
    jl = jt2m_gen.comp_v6_losses(ref, motions, x["movements"], *lambdas)
    pl = t2m_gen.comp_v6_losses({k: _t(v) for k, v in ref.items()}, _t(motions),
                                _t(x["movements"]), *lambdas)
    for k in jl:
        _close(pl[k], jl[k], k)
    np.testing.assert_allclose(
        float(pl["loss_gen"]), float(pl["loss_mot_rec"]) * 2.0 + float(pl["loss_mov_rec"]) * 3.0
        + float(pl["loss_kld"]) * 0.5, rtol=1e-6)
    # kl_criterion divides by the rows of the concatenated means: M x B
    mu, lv = np.asarray(ref["mus_post"]), np.asarray(ref["logvars_post"])
    assert mu.shape[0] == M * B
    np.testing.assert_allclose(float(t2m_gen.kl_criterion(_t(mu), _t(lv), _t(0 * mu),
                                                          _t(0 * lv))),
                               np.sum((np.exp(lv) + mu ** 2 - lv - 1) / 2) / (M * B), rtol=1e-5)


def test_released_tar_loads_as_convert_comp_v6_reads_it(tmp_path):
    """A CompTrainerV6-layout latest.tar (torch-drawn weights, so bias_hh's
    r/z slices are not 0; the positional tables' .pe buffers and the
    trainer's counters inside): the port loads it as it is and generates
    what JAX generates from convert_comp_v6."""
    generator = torch.Generator().manual_seed(7)
    gen = t2m_eval.random_init_(t2m_gen.CompV6Generator(**KW), generator)
    mov_enc = t2m_eval.random_init_(t2m_eval.MovementConvEncoder(8, 6, 6), generator)
    state = t2m_gen.generator_state(gen, mov_enc)
    for name in ("seq_pri", "seq_post", "seq_dec"):
        state[name]["positional_encoder.pe"] = torch.randn(300, 1, 8)
    tar = tmp_path / "latest.tar"
    torch.save({**state, "ep": 3, "total_it": 120}, tar)

    loaded = t2m_gen.CompV6Generator(**KW).eval()
    loaded_enc = t2m_eval.MovementConvEncoder(8, 6, 6).eval()
    t2m_gen.load_comp_v6(loaded, loaded_enc, t2m_eval.load_torch_file(tar))
    converted = torch_ckpt.convert_comp_v6_checkpoint(str(tar))
    x = _inputs()
    zeros = np.zeros((B, 4, 8), np.float32)
    jmov0 = np.asarray(jt2m_eval.MovementConvEncoder(6, 6).apply(
        {"params": converted["movement_enc"]}, zeros))[:, 0]
    jgen = jt2m_gen.CompV6Generator(**KW)
    ref = jgen.apply({"params": converted["params"]}, x["word"], x["pos"], x["cap_lens"],
                     x["m_lens"], jmov0, None, M, method=jgen.generate)
    with torch.no_grad():
        mov0 = loaded_enc(_t(zeros))[:, 0]
        _close(mov0, jmov0, "mov_in0")
        ours = loaded.generate(_t(x["word"]), _t(x["pos"]), x["cap_lens"], x["m_lens"], mov0, M)
    for k in ref:
        _close(ours[k], ref[k], k)
    with pytest.raises(RuntimeError, match="Unexpected key"):  # nothing else is dropped
        state["att_layer"]["extra.weight"] = torch.zeros(1)
        t2m_gen.load_comp_v6(loaded, loaded_enc, state)


def test_get_opt_matches_jax(tmp_path):
    from tests.test_t2m_gen import OPT_TXT

    root = tmp_path / "Comp_v6_KLD005"
    (root / "model").mkdir(parents=True)
    (root / "opt.txt").write_text(OPT_TXT)
    model_path = str(root / "model" / "latest.tar")
    assert get_opt.find_opt_file(model_path) == jget_opt.find_opt_file(model_path) == str(
        root / "opt.txt")
    ours, ref = (vars(m.parse_opt_file(str(root / "opt.txt"))) for m in (get_opt, jget_opt))
    assert ours == ref and all(type(ours[k]) is type(ref[k]) for k in ref)
    assert ours["dim_pos_ohot"] == 15 and ours["is_continue"] is False
    sizes = get_opt.comp_v6_sizes_from_opt(get_opt.parse_opt_file(str(root / "opt.txt")))
    assert sizes == jget_opt.comp_v6_sizes_from_opt(jget_opt.parse_opt_file(
        str(root / "opt.txt")))
    assert get_opt.find_opt_file(str(tmp_path / "nowhere" / "latest.tar")) is None


# -- the trainers -------------------------------------------------------------

TRAIN_ARGS = ["--batch_size", "4", "--dim_z", "8", "--pri_hidden", "32", "--dec_hidden", "32",
              "--text_hidden", "16", "--att_vec", "16", "--n_layers", "2",
              "--max_motion_length", "24", "--seed", "0"]
LR = 2e-4  # the CLI's default


def _logs(text):
    return {int(e): {k: float(v) for k, v in (t.split("=") for t in terms.split())}
            for e, terms in re.findall(r"\[comp_v6\] epoch (\d+): (.*)", text)}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs: JAX's initial generator, its first epoch (the Adam inputs
    recorded, the checkpoint written) and its resumed second; the port's
    first epoch from JAX's start and its resumed second from JAX's first
    checkpoint, each fed JAX's noise."""
    import optax

    tmp = tmp_path_factory.mktemp("t2m_gen")
    root = write_synthetic_humanml(str(tmp / "hml"), num_clips=4, min_len=45, max_len=56)
    enc = jt2m_eval.MovementConvEncoder(512, 512)
    dec = jt2m_eval.MovementConvDecoder(512, 263)
    decomp = {"movement_enc": enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 259)))["params"],
              "movement_dec": dec.init(jax.random.PRNGKey(1), jnp.zeros((1, 1, 512)))["params"]}
    jdecomp = jcheckpoint.save_checkpoint(str(tmp / "decomp_jax"), 1, {"params": decomp})
    (tmp / "decomp").mkdir()
    port_decomp = tmp / "decomp" / "model000000001.pt"
    torch.save(_torch_tree(from_flax.decomp_state_from_flax(jax.device_get(decomp))),
               port_decomp)

    def jax_argv(save_dir, epochs, *extra):
        return ["--data_path", root, "--save_dir", str(save_dir), "--decomp_checkpoint",
                jdecomp, "--num_epochs", str(epochs), *TRAIN_ARGS, *extra]

    jgrads = []
    adam = optax.adam

    def recording_adam(lr):
        inner = adam(lr)

        def update(updates, state, params=None):
            jax.debug.callback(lambda u: jgrads.append(jax.device_get(u)), updates)
            return inner.update(updates, state, params)

        return optax.GradientTransformation(inner.init, update)

    # JAX's noise for a batch: PRNGKey(seed) split once per batch (from the
    # start on a resume too)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    jax_eps = _jax_noise(key, 6, 4, 8)  # 24 frames: 6 snippets
    port_grads = []
    adam_step = torch.optim.Adam.step

    def recording_step(self, *a, **kw):
        port_grads.append({id(p): p.grad.detach().clone() for g in self.param_groups
                           for p in g["params"]})
        return adam_step(self, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adam", recording_adam)
        _, init = jtrain.main(jtrain.parse_args(jax_argv(tmp / "jax0", 0)))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, after = jtrain.main(jtrain.parse_args(jax_argv(tmp / "jax" / "comp_v6", 1)))
            _, resumed = jtrain.main(jtrain.parse_args(
                jax_argv(tmp / "jax" / "comp_v6", 2, "--resume")))
        jax_logs = _logs(buf.getvalue())
        epoch1 = jcheckpoint.load_checkpoint(str(tmp / "jax" / "comp_v6" / "model000000001"))

        build = train_t2m_gen.build_networks

        def from_jax_start(*a):
            gen, mov_enc = build(*a)
            return _load(gen, init), mov_enc

        mp.setattr(train_t2m_gen, "build_networks", from_jax_start)
        mp.setattr(t2m_gen, "training_noise", lambda *a: jax_eps)
        mp.setattr(torch.optim.Adam, "step", recording_step)

        def port_argv(save_dir, epochs, *extra):
            return ["--data_path", root, "--save_dir", str(save_dir), "--decomp_checkpoint",
                    str(port_decomp), "--num_epochs", str(epochs), "--device", "cpu",
                    *TRAIN_ARGS, *extra]

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            first = train_t2m_gen.main(train_t2m_gen.parse_args(port_argv(tmp / "port", 1)))
            resume_dir = tmp / "resume" / "comp_v6"
            resume_dir.mkdir(parents=True)
            torch.save(_torch_tree(from_flax.comp_v6_train_state_from_flax(
                {**jax.device_get(epoch1), "epoch": 1})), resume_dir / "model000000001.pt")
            second = train_t2m_gen.main(train_t2m_gen.parse_args(
                port_argv(resume_dir, 2, "--resume")))
        port_logs = _logs(buf.getvalue())
    assert len(jgrads) == 2 and len(port_grads) == 2  # one update an epoch
    return dict(init=init, after=after, resumed=resumed, epoch1=epoch1, jgrads=jgrads,
                port_grads=port_grads, first=first, second=second, jax_logs=jax_logs,
                port_logs=port_logs)


def _named_grads(gen, grads):
    return {name: {n: grads[id(p)].numpy() for n, p in net.named_parameters()}
            for name, net in t2m_gen.networks(gen, None).items()}


def _hold_update(before, ref, ours, jgrad, pgrad):
    """ours (the port's state dicts after Adam) against ref (JAX's, by the
    reference names), the gradients Adam received beside each other."""
    moved = 0
    for net, sd in ref.items():
        got = {k: v.detach().numpy() for k, v in ours[net].state_dict().items()}
        assert set(got) == set(sd), net
        for name, value in sd.items():
            what = f"{net}.{name}"
            g_ref = np.asarray(jgrad[net][name])
            g_scale = float(np.abs(g_ref).max())
            g_err = float(np.abs(pgrad[net][name] - g_ref).max())
            assert g_err <= 1e-3 * max(g_scale, 1e-12), (what, "gradient", g_err, g_scale)
            value = np.asarray(value)
            err = np.abs(got[name] - value)
            tol = 1e-5 * max(1.0, float(np.abs(value).max()))
            noise = np.abs(g_ref) <= 1e-4 * g_scale  # Adam's step takes its sign
            assert err[~noise].max(initial=0.0) <= tol, (what, float(err.max()))
            assert err[noise].max(initial=0.0) <= 2 * LR + tol, what
            moved += not np.array_equal(value, np.asarray(before[net][name]))
            if name.startswith("gru.") and "bias_hh" in name:  # the frozen r/z slices
                H = value.shape[-1] // 3
                assert not got[name][..., :2 * H].any() and not pgrad[net][name][..., :2 * H].any()
    assert moved > 0


def test_one_update_matches_jax(runs):
    first = runs["first"]
    gen = first["generator"]
    convert = from_flax.comp_v6_state_from_flax
    _hold_update(convert(jax.device_get(runs["init"])),
                 convert(jax.device_get(runs["after"])), t2m_gen.networks(gen, None),
                 convert(jax.device_get(runs["jgrads"][0])),
                 _named_grads(gen, runs["port_grads"][0]))
    for k, v in runs["jax_logs"][1].items():
        assert abs(runs["port_logs"][1][k] - v) <= 1e-5 * abs(v) + 1e-6, k
    saved = t2m_eval.load_torch_file(first["path"])
    assert set(saved) == set(t2m_gen.NETWORKS) | {"opt", "epoch"} and saved["epoch"] == 1
    assert saved["opt"]["step"] == 1


def test_resume_matches_jax(runs):
    """JAX's first checkpoint with its Adam state, carried across; the
    port's resumed epoch against JAX's."""
    second = runs["second"]
    gen = second["generator"]
    convert = from_flax.comp_v6_state_from_flax
    _hold_update(convert(jax.device_get(runs["epoch1"]["params"])),
                 convert(jax.device_get(runs["resumed"])), t2m_gen.networks(gen, None),
                 convert(jax.device_get(runs["jgrads"][1])),
                 _named_grads(gen, runs["port_grads"][1]))
    for k, v in runs["jax_logs"][2].items():
        assert abs(runs["port_logs"][2][k] - v) <= 1e-5 * abs(v) + 1e-6, k
    saved = t2m_eval.load_torch_file(second["path"])
    assert saved["epoch"] == 2 and saved["opt"]["step"] == 2
    # the checkpoint reads through the JAX converter with full key coverage
    assert set(torch_ckpt.convert_comp_v6(saved)) == {"params", "movement_enc"}
