"""regennet_torch's bf16 training (`--compute_dtype bfloat16`) against the
JAX package's `make_train_step` with `CMDM(dtype=jnp.bfloat16)`.

The second train step of each trunk (online, offline, gru, mlp) at dropout
0 and cond_mask_prob 0: the JAX state after one bf16 step is carried to the
port with `train_state_from_flax`, and both packages take the second step
on the same batch, t and noise. Both keep f32 parameters and compute each
layer in bf16, but they round at different points (torch's bf16 Linear adds
the bias before its one rounding, a parameter cast rounds LayerNorm's scale
and bias, torch's GRU keeps its carry in bf16 where flax's GRUCell keeps it
in f32), so the two bf16 steps differ by bf16 rounding noise. The JAX
package's own f32 gradient measures that noise. Tolerances:
* loss terms: relative 2^-5 (the means of bf16 outputs through the joint
  decode; grad_norm and param_norm likewise);
* gradients: 2^-6 x max(1, max|JAX gradient|) per tensor, and over all
  tensors the port's distance from the JAX bf16 gradient is at most twice
  the JAX f32 gradient's distance from it (the global 2-norm);
* first moments: 0.1 x the gradient tolerance (mu' = 0.9 mu + 0.1 g);
* second moments: 1e-4 relative plus what the measured gradient error
  gives, (1 - b2)(2 |g| dg + dg^2);
* parameters: each entry moves by the AdamW update of the port's own f32
  moments (1e-6); against the JAX parameters within lr / 16 where the
  gradient is 64x above the tensor's measured gradient error, and within
  2 lr elsewhere (there the two updates may take opposite signs);
* EMA: 1e-6 + (1 - rate) x the parameter's difference.

Then the trainer itself at bf16: its state stays f32 while the model's
self-attention sees bf16 q, k, v and its output is f32; an update below a
parameter's bf16 ulp still moves it (the master weights are f32); and the
CLI trains, resumes and samples at bf16 on the CPU.
"""

from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.diffusion import losses as jlosses
from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
from regennet_tpu.models import cmdm as jcmdm
from regennet_tpu.train import training_loop as jtl
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax, train_state_from_flax
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.models import cmdm, transformer
from regennet_torch.train import training_loop
from tests.test_torch_chip_smoke import one_torch_thread  # noqa: F401
from tests.test_torch_training import _cli_args, _decoder, _loader
from tests.test_torch_trunks import _batch, _torch_batch

B, J, F, T, D = 3, 56, 6, 12, 64
LR, WD, EMA = 1e-3, 0.1, 0.99
B1, B2, EPS = 0.9, 0.999, 1e-8
LAMBDAS = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0, lambda_orient=1.0,
               lambda_body=1.0, lambda_transl=1.0)
ARCHS = ["online", "offline", "gru", "mlp"]
TERM_RTOL, GRAD_TOL = 2.0 ** -5, 2.0 ** -6


def _kwargs(arch):
    transformer_arch = arch in ("online", "offline")
    return dict(njoints=J, nfeats=F, num_actions=8, num_frames=T, latent_dim=D,
                ff_size=128, num_layers=2, num_heads=2 if transformer_arch else 4,
                dropout=0.0, arch=arch, cm_mode="concat" if transformer_arch else "add",
                cond_mode="action", cond_mask_prob=0.0)


def _jax_second_step(arch):
    """The JAX bf16 state after one step, the state, metrics and gradients
    of the second, its q_sample noise, and the JAX f32 gradients of that
    second step from the same state."""
    kw = _kwargs(arch)
    jm = jcmdm.CMDM(**kw, dtype=jnp.bfloat16)
    b1, b2 = _batch(1), _batch(2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(b1["motion"]), jnp.asarray(b1["t"]),
                     {k: jnp.asarray(v) for k, v in b1["cond"].items()})["params"]
    assert {x.dtype for x in jax.tree_util.tree_leaves(params)} == {jnp.dtype("float32")}
    jsched, jcfg = jmake_schedule("cosine", 1000), JConfig(**LAMBDAS)
    opt = jtl.make_optimizer(LR, WD, 0)
    jdec = _decoder("jax")
    step_fn = jax.jit(jtl.make_train_step(jm, jsched, jcfg, opt, jdec, ema_rate=EMA))
    state0 = dict(params=params, opt_state=opt.init(params),
                  ema_params=jax.tree_util.tree_map(jnp.array, params),
                  step=jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    state1 = jax.device_get(step_fn(state0, b1, rng)[0])
    state2, metrics = jax.device_get(step_fn(state1, b2, rng))
    drng, crng, nrng = jax.random.split(jax.random.fold_in(rng, 1), 3)
    noise = np.asarray(jax.random.normal(nrng, b2["motion"].shape, jnp.float32))

    # the bf16 step's gradients from its first moment: mu' = 0.9 mu + 0.1 g
    grads = cmdm_state_dict_from_flax(jax.tree_util.tree_map(
        lambda m1, m0: (np.asarray(m1, np.float64) - B1 * np.asarray(m0, np.float64))
        / (1 - B1), state2["opt_state"][0].mu, state1["opt_state"][0].mu))

    jm32 = jcmdm.CMDM(**kw)

    def loss32(p):
        def model_fn(x, t, cond):
            return jm32.apply({"params": p}, x, t, cond, train=True,
                              rngs={"dropout": drng, "cond_mask": crng})
        terms = jlosses.training_losses(jsched, jcfg, model_fn, b2["motion"], b2["t"],
                                        b2["cond"], nrng, rot2xyz_fn=jdec)
        return jnp.mean(terms["loss"] * b2["weights"])

    grads32 = cmdm_state_dict_from_flax(
        jax.device_get(jax.jit(jax.grad(loss32))(state1["params"])))
    return state1, state2, metrics, grads, grads32, noise, b2


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_jax(arch):
    state1, state2, jmetrics, jgrads, jgrads32, noise, b2 = _jax_second_step(arch)
    model = cmdm.CMDM(**_kwargs(arch))
    optimizer = training_loop.make_optimizer(model.parameters(), LR, WD)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate = train_state_from_flax(state1)
    training_loop.load_train_state(model, optimizer, ema, tstate)
    before = {n: p.detach().double().clone() for n, p in model.named_parameters()}
    step = training_loop.make_train_step(
        model, make_schedule("cosine", 1000), DiffusionConfig(**LAMBDAS), optimizer,
        _decoder("torch"), ema, ema_rate=EMA, dtype=torch.bfloat16)
    metrics = step(_torch_batch(b2), torch.Generator().manual_seed(0), tstate["step"],
                   noise=torch.tensor(noise))

    hold_bf16_second_step(model, optimizer, ema, before, metrics, jmetrics, state2, jgrads,
                          jgrads32, LR)
    if arch == "gru":
        named = dict(model.named_parameters())
        for i in range(2):
            name = f"gru.bias_hh_l{i}"
            assert torch.equal(named[name][: 2 * D].double(), before[name][: 2 * D])


def hold_bf16_second_step(model, optimizer, ema, before, metrics, jmetrics, state2, jgrads,
                          jgrads32, lr, wd=WD, ema_rate=EMA):
    """The port's bf16 second step (its metrics, the model's gradients,
    AdamW's moments, the parameters and `ema` after it; `before`: the f64
    parameters before it; `lr`: the step's learning rate) against the JAX
    bf16 step's (jmetrics, state2, the gradients jgrads), with the JAX f32
    gradients jgrads32 as the measure of bf16 noise, at the tolerances of
    the module docstring."""
    for name, ref in jmetrics.items():
        if name != "loss_per_elem":
            np.testing.assert_allclose(float(metrics[name]), float(ref), rtol=TERM_RTOL,
                                       atol=1e-7, err_msg=name)
    np.testing.assert_allclose(metrics["loss_per_elem"].numpy(), jmetrics["loss_per_elem"],
                               rtol=TERM_RTOL)
    want = {k: cmdm_state_dict_from_flax(v) for k, v in (
        ("params", state2["params"]), ("ema", state2["ema_params"]),
        ("mu", state2["opt_state"][0].mu), ("nu", state2["opt_state"][0].nu))}
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    to_bf16 = to_f32 = 0.0
    bc1, bc2 = 1 - B1 ** 2, 1 - B2 ** 2  # Adam's bias corrections at update 2
    for name, p in named.items():
        g, jg = p.grad.numpy(), jgrads[name]
        assert p.dtype == p.grad.dtype == torch.float32
        scale = max(1.0, np.abs(jg).max())
        dg = np.abs(g - jg)
        assert dg.max() <= GRAD_TOL * scale, (name, float(dg.max()), scale)
        to_bf16 += float((dg ** 2).sum())
        to_f32 += float(((jgrads32[name] - jg) ** 2).sum())
        st = optimizer.state[p]
        mu, nu = st["exp_avg"].numpy(), st["exp_avg_sq"].numpy()
        np.testing.assert_allclose(mu, want["mu"][name], rtol=0,
                                   atol=(1 - B1) * GRAD_TOL * scale, err_msg=name)
        noise_g = float(dg.max())
        nu_tol = (1e-4 * np.abs(want["nu"][name]) + 1e-12
                  + (1 - B2) * (2 * np.abs(jg) * noise_g + noise_g ** 2))
        assert (np.abs(nu - want["nu"][name]) <= nu_tol).all(), name
        # the f32 master weights take AdamW's update of the port's own moments
        update = lr * ((mu / bc1) / (np.sqrt(nu / bc2) + EPS) + wd * before[name].numpy())
        np.testing.assert_allclose(p.detach().double().numpy(),
                                   before[name].numpy() - update, rtol=0, atol=1e-6,
                                   err_msg=name)
        diff = np.abs(p.detach().numpy() - want["params"][name])
        clear = np.abs(jg) > 64 * noise_g
        assert (diff[clear] <= lr / 16).all(), (name, float(diff[clear].max()))
        assert (diff <= 2 * lr * 1.01).all(), name
        ema_diff = np.abs(ema[name].numpy() - want["ema"][name])
        assert (ema_diff <= 1e-6 + (1 - ema_rate) * diff).all(), name
    # the port's bf16 step is at most twice as far from the JAX bf16 step as
    # the JAX f32 step is (two independent bf16 roundings of one size put
    # it at sqrt(2) times)
    assert to_bf16 <= 4 * to_f32, (to_bf16 ** 0.5, to_f32 ** 0.5)


def _bf16_loop(tmp_path, arch="online", **over):
    from regennet_torch.train.train_platforms import NoPlatform
    from regennet_torch.utils.model_util import create_model_and_diffusion

    cm_mode = "concat" if arch == "online" else "add"
    args = _cli_args(tmp_path, compute_dtype="bfloat16", arch=arch, cm_mode=cm_mode,
                     num_frames=16, **over)
    data = _loader()
    model, sched, cfg = create_model_and_diffusion(args, data)
    return training_loop.TrainLoop(args, NoPlatform(None), model, sched, cfg, data,
                                   torch.device("cpu")), data


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_keeps_an_f32_state_and_computes_in_bf16(monkeypatch, tmp_path, arch):
    """After a bf16 step every parameter, gradient, EMA entry and AdamW
    moment is f32; the self-attention entry saw bf16 q, k and v (the
    transformer trunks); the model's output is f32."""
    seen, outputs = [], []
    attend = transformer.fused_attention_btd_train

    def spy(q, k, v, *rest, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return attend(q, k, v, *rest, **kw)

    monkeypatch.setattr(transformer, "fused_attention_btd_train", spy)
    loop, data = _bf16_loop(tmp_path, arch)
    loop.model.register_forward_hook(lambda mod, args, out: outputs.append(out.dtype))
    assert loop.dtype == torch.bfloat16
    loop.run_step(*next(iter(data)))
    layers = 2 if arch in ("online", "offline") else 0
    assert seen == [(torch.bfloat16,) * 3] * layers
    assert outputs == [torch.float32]
    for name, p in loop.model.named_parameters():
        moments = loop.optimizer.state[p]
        assert {p.dtype, p.grad.dtype, loop.ema[name].dtype, moments["exp_avg"].dtype,
                moments["exp_avg_sq"].dtype} == {torch.float32}, name
    if arch == "gru":  # the r/z slices' gradient is zeroed on the f32 leaf
        assert not loop.model.gru.bias_hh_l0.grad[:64].any()


def test_bf16_master_weights_take_updates_below_a_bf16_ulp(tmp_path):
    """At lr 1e-6 AdamW moves each entry by about 1e-6, far below half a
    bf16 ulp of any entry of magnitude 1/8 or more (2^-12): the f32 master
    weights still move there, where weights kept in bf16 could not."""
    loop, data = _bf16_loop(tmp_path, lr=1e-6)
    before = {n: p.detach().clone() for n, p in loop.model.named_parameters()}
    loop.run_step(*next(iter(data)))
    moved = checked = 0
    for name, p in loop.model.named_parameters():
        big = (before[name].abs() >= 0.125) & (p.grad != 0)
        delta = (p.detach() - before[name])[big]
        assert (delta.abs() < 2.0 ** -12).all(), name
        moved += int((delta != 0).sum())
        checked += int(big.sum())
    assert checked > 1000 and moved == checked, (moved, checked)


def test_bf16_train_resume_and_sample_cli_on_cpu(tmp_path):
    """train_mdm --compute_dtype bfloat16 --steps_per_call 2, a resumed run,
    then cgenerate --compute_dtype bfloat16 on the saved .pt: args.json
    records the dtype, the checkpoints are f32 in the reference layout."""
    import json

    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.sample import cgenerate
    from regennet_torch.train import checkpoint, train_mdm

    args = _cli_args(tmp_path, compute_dtype="bfloat16")
    loop = train_mdm.main(args, device="cpu", data=_loader())
    assert loop.state_step == 3 and loop.dtype == torch.bfloat16
    with open(tmp_path / "save" / "args.json") as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    model3 = checkpoint.load_state_dict(str(tmp_path / "save" / "model000000003.pt"))
    assert {v.dtype for v in model3.values()} == {torch.float32}
    assert set(model3) == set(loop.model.state_dict())

    resumed = _cli_args(tmp_path, compute_dtype="bfloat16", num_steps=5, overwrite=True)
    loop2 = train_mdm.main(resumed, device="cpu", data=_loader())
    assert loop2.resume_step == 3 and loop2.state_step == 5
    opt5 = torch.load(tmp_path / "save" / "opt000000005.pt", weights_only=True)
    assert opt5["step"] == 5
    for state in opt5["optimizer"]["state"].values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == torch.float32
    model5 = checkpoint.load_state_dict(str(tmp_path / "save" / "model000000005.pt"))
    assert {v.dtype for v in model5.values()} == {torch.float32}
    assert any(not torch.equal(v, model3[k]) for k, v in model5.items())

    T = args.num_frames
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=6,
                                             min_len=T + 4, max_len=2 * T),
                  dataname="chi3d", split="test", num_frames=T, num_person=2)
    sample_args = Namespace(**{**vars(args), **dict(
        model_path=str(tmp_path / "save" / "model000000005.pt"), num_samples=2,
        num_repetitions=1, use_ddim=True, timestep_respacing="ddim5",
        guidance_param=2.5, output_dir=str(tmp_path / "samples"), motion_length=60,
        input_text="", action_file="", text_prompt="", action_name="")})
    res = np.load(cgenerate.main(sample_args, device="cpu", data=data),
                  allow_pickle=True).item()
    assert res["output"].shape == (2, 56, 6, T) and np.isfinite(res["motion"]).all()



@pytest.mark.parametrize("frames", [48, 150])
def test_gru_bf16_forward_gap_does_not_grow_with_frames(frames):
    """torch's bf16 GRU keeps its carry in bf16, flax's GRUCell in f32: the
    bf16 forward against the JAX package's stays within the 2^-6 x max(1,
    max|JAX output|) that tests/test_torch_trunks.py holds at 12 frames,
    at 48 and at the flagship's 150."""
    from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax as to_torch

    kw = dict(_kwargs("gru"), num_frames=frames)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, J, F, frames)).astype(np.float32)
    cmotion = (rng.normal(size=(B, J, F, frames)) * 0.5).astype(np.float32)
    t, action = np.array([3, 500, 999]), np.array([[1], [5], [7]])
    jm = jcmdm.CMDM(**kw, dtype=jnp.bfloat16)
    jcond = {"cmotion": jnp.asarray(cmotion), "action": jnp.asarray(action)}
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), jcond)["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jcond))
    model = cmdm.CMDM(**kw)
    model.load_state_dict({k: torch.tensor(v) for k, v in to_torch(
        jax.tree_util.tree_map(np.asarray, params)).items()})
    with torch.no_grad():
        ours = model.bfloat16()(torch.tensor(x), torch.tensor(t),
                                {"cmotion": torch.tensor(cmotion),
                                 "action": torch.tensor(action)}).numpy()
    assert np.abs(ours - ref).max() <= 2.0 ** -6 * max(1.0, np.abs(ref).max())
