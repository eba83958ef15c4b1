"""regennet_torch's distributed training (parallel/mesh.py) in two gloo
processes on the CPU, against one process and against the JAX package's
sharded TrainLoop.

Two ranks, started with a launcher's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) by tests/_torch_dist_worker.py, run
each scenario once: --data_parallel 2 at f32 (dropout, condition dropout,
--nan_guard's snapshots and the loss-aware schedule sampler on) and at
bf16, --tensor_parallel 2 (1 head of 16 per rank), --param_sharding fsdp
(--nan_guard on, with a resume into a sharded run), and one evaluation
batch shared 3/2 between the ranks. Each
is held against the port's one-process step on the concatenated global
batch. The `jax_*` scenarios start from the weights of a JAX TrainLoop
with data_parallel=2, tensor_parallel=2 and param_sharding="fsdp" on four
of the eight virtual CPU devices of tests/conftest.py (dropout 0, its
q_sample noise handed in) and are held against that loop's step.

Tolerance: f32 within 1e-5 x max(1, max|p|) for parameters, AdamW moments
and EMA, where the reference gradient exceeds 1e-6 of its tensor's
largest entry; below that (each self-attention's key bias, whose true
gradient is 0) Adam's step is a ratio of rounding noise and may differ by
up to lr. At bf16 (one step) a rank's gradient is rounded to bf16 before
the all-reduce, one process's after the whole batch's sum, and the GEMMs
of 4 and 8 rows may sum in other orders: there the AdamW moments agree to
four bf16 ulps (2^-5 of the tensor's largest entry; the second moment
2^-4 of its largest), and the noise level below which Adam's first step
(lr times the gradient's sign) may flip is 2^-4 of the tensor's largest
gradient. A gradient that is not averaged over the ranks misses by far
more.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
_spec = importlib.util.spec_from_file_location("_torch_dist_worker",
                                               os.path.join(HERE, "_torch_dist_worker.py"))
worker = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(worker)

GLOBAL_BATCH = 8
DP = {"data_parallel": 2}
SCENARIOS = {
    "dp": dict(args=dict(DP, nan_guard=True), steps=3, sampler="loss-second-moment"),
    "dp_bf16": dict(args=dict(DP, compute_dtype="bfloat16"), steps=1),
    "tp": dict(args={"tensor_parallel": 2}, steps=2),
    # rank 1's rows of the second batch hold a NaN: both ranks roll it back
    "dp_nan": dict(args=dict(DP, nan_guard=True), steps=3, nan_step=1),
    "fsdp": dict(args=dict(DP, param_sharding="fsdp", nan_guard=True), steps=3,
                 resume_after=2),
}
JAX_SCENARIOS = {
    "jax_dp": DP,
    "jax_tp": {"tensor_parallel": 2},
    "jax_fsdp": dict(DP, param_sharding="fsdp"),
}
NO_DROPOUT = dict(dropout=0.0, cond_mask_prob=0.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """A JAX TrainLoop step on a 2x2 ('data', 'model') mesh with FSDP, and
    its initial weights and q_sample noise for the port."""
    import jax

    from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
    from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
    from regennet_tpu.models import cmdm as jcmdm
    from regennet_tpu.train import training_loop as jtl
    from regennet_tpu.train.train_platforms import NoPlatform as JNoPlatform
    from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax, train_state_from_flax

    out = tmp_path_factory.mktemp("jax")
    saved = os.environ.get("REGENNET_PRNG_IMPL")
    os.environ["REGENNET_PRNG_IMPL"] = "threefry2x32"  # draws that do not depend on sharding
    try:
        args = worker.make_args(str(out / "save"), data_parallel=2, tensor_parallel=2,
                                param_sharding="fsdp", **NO_DROPOUT)
        batch = worker.global_batches(1, GLOBAL_BATCH)[0]
        loop = jtl.TrainLoop(args, JNoPlatform(args.save_dir),
                             jcmdm.CMDM(**worker.MODEL, **NO_DROPOUT),
                             jmake_schedule("cosine", 10), JConfig(**worker.LAMBDAS), [batch])
        assert loop.mesh.shape == {"data": 2, "model": 2}
        params0 = cmdm_state_dict_from_flax(jax.device_get(loop.state["params"]))
        _, _, nrng = jax.random.split(jax.random.fold_in(loop.rng, 0), 3)
        noise = np.asarray(jax.random.normal(nrng, batch[0].shape, np.float32))
        loss = float(loop.run_step(*batch)["loss"])
        state1 = train_state_from_flax(jax.device_get(loop.state))
    finally:
        if saved is None:
            os.environ.pop("REGENNET_PRNG_IMPL")
        else:
            os.environ["REGENNET_PRNG_IMPL"] = saved
    torch.save({k: torch.tensor(v) for k, v in params0.items()}, str(out / "init.pt"))
    np.save(str(out / "noise.npy"), noise[None])
    return {"state": str(out / "init.pt"), "noise": str(out / "noise.npy"), "loss": loss,
            "after": state1}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_step):
    """Every scenario in one launch of two gloo ranks: {"out", "results"}."""
    out = tmp_path_factory.mktemp("dist")
    scenarios = {k: dict(v, batch=GLOBAL_BATCH) for k, v in SCENARIOS.items()}
    for name, over in JAX_SCENARIOS.items():
        scenarios[name] = dict(args=dict(over, **NO_DROPOUT), steps=1, batch=GLOBAL_BATCH,
                               state=jax_step["state"], noise=jax_step["noise"])
    cfg_path = out / "cfg.json"
    cfg_path.write_text(json.dumps({"out": str(out), "scenarios": scenarios, "sample": True}))
    port = str(_free_port())
    procs = []
    for rank in range(2):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"), str(cfg_path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    for rank, proc in enumerate(procs):
        try:
            stdout, stderr = proc.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise
        assert proc.returncode == 0, f"rank {rank}:\n{stdout[-2000:]}\n{stderr[-4000:]}"
    results = [json.loads((out / f"rank{r}.json").read_text()) for r in range(2)]
    return {"out": out, "results": results}


def _saved(run_dir):
    """(model state dict, opt file) of the last checkpoint a run wrote."""
    from regennet_torch.train import checkpoint

    path = checkpoint.latest_checkpoint(str(run_dir))
    step = checkpoint.parse_step_from_path(path)
    opt = torch.load(os.path.join(str(run_dir), checkpoint.opt_name(step)), weights_only=False)
    return torch.load(path), opt, step


def _moments(opt_file):
    """{exp_avg, exp_avg_sq} by parameter name (the EMA's names are in the
    parameters' order, which numbers the optimizer's state)."""
    state = opt_file["optimizer"]["state"]
    return {k: {n: state[i][k] for i, n in enumerate(opt_file["ema"])}
            for k in ("exp_avg", "exp_avg_sq")}


def _assert_state(model, opt, ref_model, ref_opt, lr, bound=1e-5, bf16=False):
    """Parameters, EMA and AdamW moments within bound x max(1, max|ref|);
    where the reference's first moment is noise (below 1e-6 of its
    tensor's largest entry), parameters within lr. bf16: the moments
    within four bf16 ulps, the noise level 2^-4."""
    names = [n for n in ref_model if n in ref_opt["ema"]]
    assert set(names) == set(opt["ema"])
    got, want = _moments(opt), _moments(ref_opt)
    for n in names:
        ref = ref_model[n].float()
        tol = bound * max(1.0, ref.abs().max().item())
        m = want["exp_avg"][n]
        noise = m.abs() < (2.0 ** -4 if bf16 else 1e-6) * m.abs().max()
        diff = (model[n].float() - ref).abs()
        assert (diff[~noise] <= tol).all(), (n, diff[~noise].max().item())
        assert (diff <= max(tol, lr * 1.01)).all(), n
        m_tol = 2.0 ** -5 * m.abs().max().item() if bf16 else bound * max(1.0, m.abs().max().item())
        torch.testing.assert_close(got["exp_avg"][n], m, rtol=0, atol=m_tol)
        v = want["exp_avg_sq"][n]
        torch.testing.assert_close(got["exp_avg_sq"][n], v, rtol=2.0 ** -4 if bf16 else 1e-4,
                                   atol=2.0 ** -4 * v.max().item() if bf16 else 1e-12)
        ema_tol = max(tol, lr * 1.01) if noise.any() else tol
        assert (opt["ema"][n].float() - ref_opt["ema"][n].float()).abs().max() <= ema_tol, n


def _one_process(tmp_path, name, batches=None, **kw):
    """The port's one-process run of a scenario on the global batches."""
    sc = SCENARIOS.get(name) or {"args": dict(JAX_SCENARIOS[name], **NO_DROPOUT), "steps": 1}
    over = {k: v for k, v in sc["args"].items()
            if k not in ("data_parallel", "tensor_parallel", "param_sharding")}
    saved = os.environ.get("REGENNET_SCHEDULE_SAMPLER")
    os.environ["REGENNET_SCHEDULE_SAMPLER"] = sc.get("sampler", "uniform")
    try:
        args = worker.make_args(str(tmp_path / name), batch_size=GLOBAL_BATCH, **over)
        loop = worker.make_loop(args, None, kw.get("state", ""))
        batches = batches or worker.global_batches(sc["steps"], GLOBAL_BATCH,
                                                   nan_step=sc.get("nan_step"))
        noise = np.load(kw["noise"]) if kw.get("noise") else None
        losses = worker.run(loop, batches, noise)
        loop.save()
    finally:
        if saved is None:
            os.environ.pop("REGENNET_SCHEDULE_SAMPLER")
        else:
            os.environ["REGENNET_SCHEDULE_SAMPLER"] = saved
    return loop, losses


def _check_against_one_process(tmp_path, ranks, name, bf16=False):
    loop, losses = _one_process(tmp_path, name)
    for r in range(2):
        np.testing.assert_allclose(ranks["results"][r][name]["losses"], losses,
                                   rtol=1e-3 if bf16 else 1e-5)
    model, opt, step = _saved(ranks["out"] / name)
    ref_model, ref_opt, ref_step = _saved(tmp_path / name)
    assert step == ref_step == SCENARIOS[name]["steps"] - ("nan_step" in SCENARIOS[name])
    _assert_state(model, opt, ref_model, ref_opt, lr=1e-4, bf16=bf16)
    return loop


def test_data_parallel_f32_and_the_loss_aware_sampler_match_one_process(tmp_path, ranks):
    loop = _check_against_one_process(tmp_path, ranks, "dp")
    assert [r["dp"]["layout"] for r in ranks["results"]] == [[0, 2, 0, 1], [1, 2, 0, 1]]
    # the sampler learnt every rank's (t, loss) pairs, in the global order
    for r in range(2):
        np.testing.assert_array_equal(ranks["results"][r]["dp"]["counts"],
                                      loop.schedule_sampler._loss_counts)
        np.testing.assert_allclose(ranks["results"][r]["dp"]["history"],
                                   loop.schedule_sampler._loss_history, rtol=1e-5, atol=0)
    assert loop.schedule_sampler._loss_counts.sum() == 3 * GLOBAL_BATCH


def test_nan_guard_rolls_back_every_rank_together(tmp_path, ranks):
    """A NaN in rank 1's rows only: the global loss is NaN on both ranks,
    both drop the step, and the run equals one process's."""
    loop = _check_against_one_process(tmp_path, ranks, "dp_nan")
    for r in range(2):
        losses = ranks["results"][r]["dp_nan"]["losses"]
        assert np.isnan(losses[1]) and np.isfinite([losses[0], losses[2]]).all()
    assert loop.state_step == 2


def test_data_parallel_bf16_matches_one_process(tmp_path, ranks):
    _check_against_one_process(tmp_path, ranks, "dp_bf16", bf16=True)


def test_tensor_parallel_matches_one_process(tmp_path, ranks):
    _check_against_one_process(tmp_path, ranks, "tp")
    for r in range(2):  # every attention at 1 of its 2 heads, head dim 16
        assert ranks["results"][r]["tp"]["layout"] == [0, 1, r, 2]
        assert ranks["results"][r]["tp"]["num_heads"] == [1] * 4


def test_fsdp_matches_one_process_and_resumes_into_a_sharded_run(tmp_path, ranks):
    _check_against_one_process(tmp_path, ranks, "fsdp")
    # the whole checkpoint loads into the one-device model, as cgenerate does
    from regennet_torch.train import checkpoint

    model = worker.make_model(worker.make_args(""))
    checkpoint.load_model(model, checkpoint.latest_checkpoint(str(ranks["out"] / "fsdp")))


@pytest.mark.parametrize("name", list(JAX_SCENARIOS))
def test_sharded_step_matches_jax_trainloop_and_one_process(tmp_path, ranks, jax_step, name):
    loop, losses = _one_process(tmp_path, name, state=jax_step["state"],
                                noise=jax_step["noise"])
    np.testing.assert_allclose(losses, [jax_step["loss"]], rtol=1e-5)
    for r in range(2):
        np.testing.assert_allclose(ranks["results"][r][name]["losses"], losses, rtol=1e-5)
    model, opt, _ = _saved(ranks["out"] / name)
    ref_model, ref_opt, _ = _saved(tmp_path / name)
    _assert_state(model, opt, ref_model, ref_opt, lr=1e-4)
    after = jax_step["after"]
    jax_model = {n: torch.tensor(v) for n, v in after["model"].items()}
    names = [n for n in jax_model if n in after["ema"]]
    jax_opt = {"ema": {n: torch.tensor(after["ema"][n]) for n in names},
               "optimizer": {"state": {i: {"exp_avg": torch.tensor(after["exp_avg"][n]),
                                           "exp_avg_sq": torch.tensor(after["exp_avg_sq"][n])}
                                       for i, n in enumerate(names)}}}
    _assert_state(model, opt, jax_model, jax_opt, lr=1e-4)


def test_evaluation_batch_shared_by_the_ranks_matches_one_process(ranks):
    from regennet_torch.diffusion import sampling
    from regennet_torch.models.cmdm import make_model_fn

    sched, dcfg = worker.make_diffusion()
    model = worker.make_model(worker.make_args("")).eval()
    motion, cond = worker.global_batches(1, 5, seed=4)[0]
    ref = sampling.p_sample_loop(sched, dcfg, make_model_fn(model), motion.shape,
                                 {k: torch.tensor(v) for k, v in cond["y"].items()},
                                 clip_denoised=False, generator=torch.Generator().manual_seed(5))
    for r in range(2):
        got = np.load(ranks["out"] / f"sample_rank{r}.npy")
        np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-5)


def test_parallel_options_without_a_launcher_raise(tmp_path, monkeypatch):
    from regennet_torch.parallel import mesh
    from regennet_torch.train import train_mdm

    for key in mesh.LAUNCHER_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(key, raising=False)
    for over in ({"data_parallel": 2}, {"tensor_parallel": 2}):
        args = worker.make_args(str(tmp_path / "save"), **over)
        with pytest.raises(RuntimeError, match="no launcher environment"):
            mesh.setup(args, torch.device("cpu"))
        with pytest.raises(RuntimeError, match="no launcher environment"):
            train_mdm.main(Namespace(**vars(args)), device="cpu", data=[None])
        assert not os.path.exists(tmp_path / "save" / "args.json")
    # one process, fsdp or not, trains without a group: the one-rank layout
    layout = mesh.setup(worker.make_args("", param_sharding="fsdp"), torch.device("cpu"))
    assert layout == mesh.one_process(fsdp=True) and layout.data_group is None
    assert mesh.process_shard_info() == (0, 1)


def test_a_head_offset_seed_draws_the_whole_models_bits():
    """A [B, 3] seed (a tensor-parallel rank's heads) draws the dropout bits
    of the same heads of the whole model, in the plain training attention
    too: a rank's output is the whole model's output at its heads."""
    from regennet_torch.ops import attention

    B, H, T, hd = 2, 4, 9, 8
    seeds = torch.tensor([[7, -1], [2 ** 30, 5]], dtype=torch.int32)
    for h0 in (0, 2):
        offset = torch.cat([seeds, torch.full((B, 1), h0, dtype=torch.int32)], 1)
        torch.testing.assert_close(attention.dropout_bits(offset, B, 2, T),
                                   attention.dropout_bits(seeds, B, H, T)[:, h0:h0 + 2],
                                   rtol=0, atol=0)
    q, k, v = torch.randn(3, B, T, H * hd, generator=torch.Generator().manual_seed(0))
    whole = attention.fused_attention_btd_train(q, k, v, H, 0.3, seeds)
    cols = slice(2 * hd, 4 * hd)
    offset = torch.cat([seeds, torch.full((B, 1), 2, dtype=torch.int32)], 1)
    part = attention.fused_attention_btd_train(q[..., cols], k[..., cols], v[..., cols], 2,
                                               0.3, offset)
    torch.testing.assert_close(part, whole[..., cols], rtol=0, atol=0)
    assert attention.seed_mode(offset.shape) == 2 and attention.seed_mode(seeds.shape) == 1
