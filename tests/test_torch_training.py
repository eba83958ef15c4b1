"""regennet_torch's training path against the JAX package's.

* One whole train step at dropout 0 and cond_mask_prob 0: the JAX state
  after one `make_train_step` step is carried to the port with
  `train_state_from_flax`; both packages then take the second step on the
  same batch, t and noise (the noise drawn from the JAX step's `nrng`).
  Loss terms, gradients, updated parameters, EMA and the AdamW moments are
  compared (tolerances at the comparisons).
* The train CLI on the CPU: a run with --steps_per_call 2, a resumed run,
  and cgenerate on the saved .pt; the checkpoint steps are those the JAX
  loop writes for the same num_steps / save_interval / steps_per_call.
"""

import os
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
from regennet_tpu.ops import body_model as jbm
from regennet_tpu.ops import pose_decode as jpd
from regennet_tpu.train import training_loop as jtl
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax, train_state_from_flax
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.models import cmdm
from regennet_torch.ops import body_model as bm
from regennet_torch.ops import pose_decode as pd
from regennet_torch.train import training_loop

B, J, F, T = 3, 56, 6, 16
LR, WD, ANNEAL, EMA = 1e-3, 0.1, 10, 0.99
LAMBDAS = dict(lambda_rcxyz=1.0, lambda_vel=1.0, lambda_fc=1.0, lambda_orient=1.0,
               lambda_body=1.0, lambda_transl=1.0)
MODEL = dict(njoints=J, nfeats=F, num_actions=8, num_frames=T, latent_dim=64,
             ff_size=128, num_layers=2, num_heads=2, dropout=0.0, arch="online",
             cm_mode="concat", cond_mode="action", cond_mask_prob=0.0)


def _batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, 1, 1, T), bool)
    mask[2, ..., 11:] = False
    return {
        "motion": rng.normal(size=(B, J, F, T)).astype(np.float32),
        "t": np.array([7, 420, 990], np.int32),
        "weights": np.array([1.0, 0.7, 1.3], np.float32),
        "cond": {"mask": mask,
                 "cmotion": rng.normal(size=(B, J, F, T)).astype(np.float32),
                 "action": np.array([[1], [4], [6]])},
    }


def _decoder(package):
    kw = dict(pose_rep="rot6d", jointstype="smplx", translation=True, glob=True,
              vertstrans=False, num_person=1)
    if package == "jax":
        return jpd.make_rot2xyz(jbm.synthetic("smplx", num_vertices=24), **kw)
    return pd.make_rot2xyz(bm.synthetic("smplx", num_vertices=24), **kw)


def _torch_batch(batch):
    return {"motion": torch.tensor(batch["motion"]), "t": torch.tensor(batch["t"]).long(),
            "weights": torch.tensor(batch["weights"]),
            "cond": {k: torch.tensor(v) for k, v in batch["cond"].items()}}


def test_train_step_matches_jax():
    jm = jcmdm.CMDM(**MODEL)
    b1, b2 = _batch(1), _batch(2)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(b1["motion"]),
                     jnp.asarray(b1["t"]), {k: jnp.asarray(v) for k, v in b1["cond"].items()}
                     )["params"]
    jsched, jcfg = jmake_schedule("cosine", 1000), JConfig(**LAMBDAS)
    opt = jtl.make_optimizer(LR, WD, ANNEAL)
    jdec = _decoder("jax")
    step_fn = jax.jit(jtl.make_train_step(jm, jsched, jcfg, opt, jdec, ema_rate=EMA))
    state0 = dict(params=params, opt_state=opt.init(params),
                  ema_params=jax.tree_util.tree_map(jnp.array, params),
                  step=jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    state1, _ = step_fn(state0, b1, rng)  # moments, EMA and step become non-trivial
    state2, jm2 = step_fn(state1, b2, rng)

    # the second step's gradients and noise, as make_train_step derives them
    drng, crng, nrng = jax.random.split(jax.random.fold_in(rng, 1), 3)
    noise = np.asarray(jax.random.normal(nrng, b2["motion"].shape, jnp.float32))

    def jloss(p):
        def model_fn(x, t, cond):
            return jm.apply({"params": p}, x, t, cond, train=True,
                            rngs={"dropout": drng, "cond_mask": crng})
        terms = jlosses.training_losses(jsched, jcfg, model_fn, b2["motion"], b2["t"],
                                        b2["cond"], nrng, rot2xyz_fn=jdec)
        return jnp.mean(terms["loss"] * b2["weights"])

    jgrads = cmdm_state_dict_from_flax(jax.device_get(jax.jit(jax.grad(jloss))(state1["params"])))

    # the port, from the JAX state after step 1
    model = cmdm.CMDM(**MODEL)
    optimizer = training_loop.make_optimizer(model.parameters(), LR, WD)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate = train_state_from_flax(jax.device_get(state1))
    assert (tstate["step"], tstate["adam_step"]) == (1, 1)
    training_loop.load_train_state(model, optimizer, ema, tstate)
    step = training_loop.make_train_step(
        model, make_schedule("cosine", 1000), DiffusionConfig(**LAMBDAS), optimizer,
        _decoder("torch"), ema, ema_rate=EMA,
        lr_schedule=lambda s: training_loop.learning_rate(LR, ANNEAL, s))
    metrics = step(_torch_batch(b2), torch.Generator().manual_seed(0), tstate["step"],
                   noise=torch.tensor(noise))

    # loss terms: f32 sums in other orders
    for name, ref in jax.device_get(jm2).items():
        if name == "loss_per_elem":
            np.testing.assert_allclose(metrics[name].numpy(), ref, rtol=1e-5)
            continue
        np.testing.assert_allclose(float(metrics[name]), float(ref), rtol=1e-5,
                                   err_msg=name)
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads)
    want = {k: cmdm_state_dict_from_flax(jax.device_get(v)) for k, v in (
        ("params", state2["params"]), ("ema", state2["ema_params"]),
        ("mu", state2["opt_state"][0].mu), ("nu", state2["opt_state"][0].nu))}
    flips = 0
    for name, p in named.items():
        g, jg = p.grad.numpy(), jgrads[name]
        # gradients: 2e-5 of the tensor's largest entry (f32 chains through
        # two layers, the joint decode and three sum orders)
        np.testing.assert_allclose(g, jg, rtol=0, atol=2e-5 * max(1.0, np.abs(jg).max()),
                                   err_msg=name)
        st = optimizer.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), want["mu"][name], rtol=0,
                                   atol=2e-5 * max(1.0, np.abs(want["mu"][name]).max()))
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), want["nu"][name],
                                   rtol=1e-4, atol=1e-12)
        # updated parameters and EMA within 1e-6, except where the
        # gradient is below 1e-6 of the tensor's largest entry: there Adam's
        # step lr * mu_hat / (sqrt(nu_hat) + eps) is the ratio of two sums
        # of rounding noise, of either sign, and may differ by up to lr.
        # Such entries are the key bias of each self-attention (its true
        # gradient is 0: the softmax ignores a shift shared by a query's
        # scores); about 120 of the model's 182,544 parameters here.
        diff = np.abs(p.detach().numpy() - want["params"][name])
        noise_level = np.abs(jg) < 1e-6 * np.abs(jg).max()
        assert (diff[~noise_level] <= 1e-6).all(), name
        assert (diff <= LR * 1.01).all(), name
        flips += int((diff > 1e-6).sum())
        ema_diff = np.abs(ema[name].numpy() - want["ema"][name])
        assert (ema_diff <= 1e-6 + (1 - EMA) * diff).all(), name
    assert flips <= 200, flips


def _cli_args(tmp_path, **over):
    base = dict(
        cuda=True, device=0, seed=10, batch_size=4, use_ddim=False,
        timestep_respacing="", noise_schedule="cosine", diffusion_steps=100,
        sigma_small=True, setting="cmdm", arch="online", emb_trans_dec=False,
        wo_pos_emb=False, cm_mode="concat", layers=2, latent_dim=32,
        cond_mask_prob=0.1, lambda_rcxyz=0.0, lambda_vel=1.0, lambda_fc=0.0,
        lambda_orient=1.0, lambda_body=1.0, lambda_transl=1.0, unconstrained=False,
        dataset="chi3d", data_dir="", num_person=2, data_path="", pose_rep="rot6d",
        body_model="smplx", vel_threshold=0.01, shuffle=False,
        save_dir=str(tmp_path / "save"), overwrite=False,
        train_platform_type="NoPlatform", lr=1e-3, weight_decay=0.0,
        lr_anneal_steps=0, ema_rate=0.9999, eval_batch_size=32, eval_split="test",
        eval_during_training=False, rec_model_path="", nan_guard=False,
        eval_rep_times=3, eval_num_samples=1000, log_interval=1, save_interval=2,
        num_steps=3, num_frames=16, profile_steps=0, profile_start=10,
        resume_checkpoint="", data_parallel=-1, tensor_parallel=1,
        param_sharding="replicated", compute_dtype="float32", steps_per_call=2,
    )
    base.update(over)
    return Namespace(**base)


def _loader(num_clips=12, batch_size=4, T=16):
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.data.get_data import BatchLoader, get_collate_fn

    feeder = Feeder(clips=synthetic.make_clips("chi3d", "train", num_clips=num_clips,
                                               min_len=T + 4, max_len=2 * T),
                    dataname="chi3d", split="train", num_frames=T, num_person=2)
    return BatchLoader(feeder, batch_size, get_collate_fn("chi3d", "cmdm"))


def _jax_loop_saves(num_batches, num_steps, save_interval, steps_per_call,
                    resume_step=0):
    """The steps at which the JAX TrainLoop saves: its own run_loop and
    _bookkeep, with the device steps and the checkpoint write stubbed."""
    from regennet_tpu.train.train_platforms import NoPlatform as JNoPlatform

    loop = object.__new__(jtl.TrainLoop)
    loop.args = Namespace(profile_steps=0, eval_during_training=False)
    loop.data = [(None, None)] * num_batches
    loop.num_epochs = num_steps // (num_batches + 1)
    loop.steps_per_call, loop._block_buf = steps_per_call, []
    loop.step, loop.resume_step, loop.num_steps = 0, resume_step, num_steps
    loop.lr_anneal_steps, loop.log_interval = 0, 10 ** 9
    loop.save_interval, loop._last_save_at = save_interval, None
    loop.train_platform, loop.global_batch = JNoPlatform(None), 1
    saved = []
    loop.run_step = lambda motion, cond: {"loss": 0.0}
    loop.run_block = lambda items: [{"loss": 0.0}] * len(items)
    loop.save = lambda: saved.append(loop.step + loop.resume_step)
    loop.run_loop()
    return saved


def test_train_cli_resume_and_sample_on_cpu(tmp_path):
    from regennet_torch.data import synthetic
    from regennet_torch.data.feeder import Feeder
    from regennet_torch.sample import cgenerate
    from regennet_torch.train import checkpoint, train_mdm

    def saved_steps():
        return sorted(checkpoint.parse_step_from_path(n) for n in
                      os.listdir(tmp_path / "save") if n.startswith("model"))

    args = _cli_args(tmp_path)
    loop = train_mdm.main(args, device="cpu", data=_loader())
    assert len(loop.data) == 3 and loop.state_step == 3
    assert saved_steps() == _jax_loop_saves(3, 3, 2, 2) == [2, 3]
    for step in (2, 3):
        assert (tmp_path / "save" / f"opt{step:09d}.pt").exists()
    assert (tmp_path / "save" / "args.json").exists()
    with pytest.raises(FileExistsError, match="overwrite"):
        train_mdm.main(args, device="cpu", data=_loader())

    # resume from the latest checkpoint: its weights, EMA, AdamW state and RNGs
    resumed = _cli_args(tmp_path, num_steps=5, overwrite=True)
    model3 = checkpoint.load_state_dict(str(tmp_path / "save" / "model000000003.pt"))
    loop2 = train_mdm.main(resumed, device="cpu", data=_loader())
    assert loop2.resume_step == 3 and loop2.state_step == 5
    assert saved_steps() == sorted({2, 3} | set(_jax_loop_saves(3, 5, 2, 2, 3))) == [2, 3, 5]
    opt5 = torch.load(tmp_path / "save" / "opt000000005.pt", weights_only=True)
    assert opt5["step"] == 5
    assert all(float(s["step"]) == 5 for s in opt5["optimizer"]["state"].values())
    moved = [k for k, v in checkpoint.load_state_dict(
        str(tmp_path / "save" / "model000000005.pt")).items()
        if not torch.equal(v, model3[k])]
    assert moved  # the resumed run trained on

    # the trained checkpoint samples through the port's cgenerate
    T = args.num_frames
    data = Feeder(clips=synthetic.make_clips("chi3d", "test", num_clips=6,
                                             min_len=T + 4, max_len=2 * T),
                  dataname="chi3d", split="test", num_frames=T, num_person=2)
    sample_args = Namespace(**{**vars(args), **dict(
        model_path=str(tmp_path / "save" / "model000000005.pt"), num_samples=2,
        num_repetitions=1, use_ddim=True, timestep_respacing="ddim5",
        guidance_param=1.0, output_dir=str(tmp_path / "samples"), motion_length=60,
        input_text="", action_file="", text_prompt="", action_name="")})
    res = np.load(cgenerate.main(sample_args, device="cpu", data=data),
                  allow_pickle=True).item()
    assert res["output"].shape == (2, 56, 6, T) and np.isfinite(res["motion"]).all()


def test_nan_guard_rolls_back_the_block(tmp_path):
    from regennet_torch.train.train_platforms import NoPlatform
    from regennet_torch.utils.model_util import create_model_and_diffusion

    args = _cli_args(tmp_path, nan_guard=True)
    data = _loader()
    model, sched, cfg = create_model_and_diffusion(args, data)
    loop = training_loop.TrainLoop(args, NoPlatform(None), model, sched, cfg, data,
                                   torch.device("cpu"))
    items = list(data)[:2]
    before = [p.detach().clone() for p in loop.model.parameters()]
    ema_before = {n: e.clone() for n, e in loop.ema.items()}
    step = loop._train_step

    def poisoned(batch, generator, n, noise=None):
        metrics = step(batch, generator, n, noise)
        if n == 1:  # the block's second step goes non-finite
            metrics["loss"] = torch.tensor(float("nan"))
        return metrics

    loop._train_step = poisoned
    assert loop.run_block(items) == [{"nan_skipped": True}] * 2
    for p, b in zip(loop.model.parameters(), before):
        assert torch.equal(p, b)
    assert all(torch.equal(loop.ema[n], e) for n, e in ema_before.items())
    assert not loop.optimizer.state or all(
        float(s["step"]) == 0 for s in loop.optimizer.state.values())
    loop._train_step = step
    per_step = loop.run_block(items)
    assert len(per_step) == 2 and all(np.isfinite(float(m["loss"])) for m in per_step)
    assert loop._bookkeep(per_step, 0.0) is False and loop.state_step == 2


def test_train_forward_dropouts():
    """The training forward: at rate 0 it is the sampling forward; its
    draws come from the generator alone; condition dropout at probability
    1 is the unconditioned (CFG) forward; the single-key cross-attention
    weight of each (batch, head, query) is 1/(1 - rate) or 0."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(B, J, F, T)).astype(np.float32))
    t = torch.tensor([3, 500, 999])
    cond = {"cmotion": torch.tensor(rng.normal(size=(B, J, F, T)).astype(np.float32)),
            "action": torch.tensor([[1], [5], [7]])}
    torch.manual_seed(0)
    model = cmdm.CMDM(**MODEL)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        plain = model(x, t, cond)
        torch.testing.assert_close(model(x, t, cond, train=True, generator=gen), plain,
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="Generator"):
            model(x, t, cond, train=True)
        model.cond_mask_prob = 1.0
        torch.testing.assert_close(model(x, t, cond, train=True, generator=gen),
                                   model(x, t, {**cond, "uncond": True}), rtol=0, atol=0)
        model.cond_mask_prob = 0.0

        rate = 0.5
        for mod in model.modules():
            if hasattr(mod, "dropout"):
                mod.dropout = rate
        runs = [model(x, t, cond, train=True, generator=torch.Generator().manual_seed(s))
                for s in (2, 2, 3)]
        torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
        assert not torch.equal(runs[0], runs[2])
        assert not torch.allclose(runs[0], plain)

        cross = model.seqTransDecoder.layers[0].multihead_attn
        seen = []
        handle = cross.out_proj.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
        q_in = torch.randn(B, T, 64)
        memory = torch.randn(B, 1, 64)
        cross(q_in, memory, False, torch.Generator().manual_seed(4))
        handle.remove()
        v = torch.nn.functional.linear(memory, cross.in_proj_weight[128:],
                                       cross.in_proj_bias[128:])
        heads = seen[0].view(B, T, 2, 32)
        full = (v / (1 - rate)).view(B, 1, 2, 32).expand(B, T, 2, 32)
        kept = (heads == full).all(-1)
        dropped = (heads == 0).all(-1)
        assert (kept | dropped).all() and 0.3 < kept.float().mean() < 0.7
