"""regennet_torch's ST-GCN trainer against the JAX package's, and the
learnable synthetic clips.

* One train step of the reduced classifier (the learning guard's size)
  from shared variables: logits, loss and gradients at 1e-4 x max(1,
  max|jax|) (f32 convolutions summed in other orders), the updated
  parameters within 1e-6 where Adam's step is not a ratio of rounding
  noise, and the running statistics. Those differ on purpose: torch
  folds the unbiased batch variance into running_var, flax the biased
  one, so the port's running_var exceeds flax's by the flax update term
  over n - 1 (n: the values each channel's statistics pool, 32 x 24 = 768
  at data_bn); the test holds exactly that, within 1e-5.
* keep_best, the checkpoint the evaluation loads, and the CLI's clips.
"""

import copy
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.models.stgcn import STGCN as JSTGCN
from regennet_tpu.models.stgcn import cross_entropy_loss as jcross_entropy
from regennet_torch.convert.from_flax import stgcn_state_dict_from_flax
from regennet_torch.data import synthetic
from regennet_torch.data.feeder import Feeder
from regennet_torch.eval import eval_cmdm, stgcn_eval, train_stgcn
from regennet_torch.models.stgcn import STGCN, accuracy_from_logits, cross_entropy_loss

REDUCED = dict(channels=(32, 32, 64, 64), strides=(1, 1, 2, 1))
N, T, LR = 32, 24, 1e-3


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, 56, 12, T)).astype(np.float32)
    return x, rng.integers(0, 8, size=N)


def _bn_counts(model):
    """{BatchNorm state-dict prefix: n}, the values pooled per channel."""
    counts = {}
    model.train()

    def hook(name):
        def fn(mod, args):
            x = args[0]
            counts[name] = x.numel() // x.shape[1]
        return fn

    handles = [m.register_forward_pre_hook(hook(n)) for n, m in model.named_modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        model(torch.tensor(_batch()[0]))
    for h in handles:
        h.remove()
    return counts


def test_one_train_step_matches_flax():
    x, labels = _batch()
    jm = JSTGCN(in_channels=12, num_class=8, num_person=2, layout="smplx", **REDUCED)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), {"output": jnp.asarray(x)})
    opt = optax.adam(LR)

    def loss_fn(params):
        out, mutated = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                {"output": jnp.asarray(x)}, train=True,
                                mutable=["batch_stats"])
        return jcross_entropy(out["yhat"], jnp.asarray(labels)), (out["yhat"],
                                                                 mutated["batch_stats"])

    (jloss, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    updates, _ = opt.update(jgrads, opt.init(variables["params"]), variables["params"])
    jparams = optax.apply_updates(variables["params"], updates)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    before = stgcn_state_dict_from_flax(np_tree(variables))
    after = stgcn_state_dict_from_flax(np_tree({"params": jparams, "batch_stats": jstats}))
    grads = stgcn_state_dict_from_flax(np_tree({"params": jgrads,
                                                "batch_stats": variables["batch_stats"]}))

    model = STGCN(in_channels=12, num_class=8, num_person=2, layout="smplx", **REDUCED)
    model.load_state_dict({k: torch.tensor(v) for k, v in before.items()}, strict=False)
    counts = _bn_counts(model)
    assert counts["data_bn"] == N * T
    model.load_state_dict({k: torch.tensor(v) for k, v in before.items()}, strict=False)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR)
    logits_seen = []
    handle = model.fcn.register_forward_hook(lambda m, a, out: logits_seen.append(out))
    loss, acc = train_stgcn.train_step(model, optimizer, torch.tensor(x),
                                       torch.tensor(labels))
    handle.remove()

    logits = logits_seen[0][:, :, 0, 0].detach().numpy()
    np.testing.assert_allclose(logits, np.asarray(jlogits), rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jlogits).max()))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == accuracy_from_logits(np.asarray(jlogits), labels)
    torch.testing.assert_close(cross_entropy_loss(torch.tensor(np.asarray(jlogits)),
                                                  torch.tensor(labels)),
                               torch.tensor(float(jloss)), rtol=1e-6, atol=0)
    named = dict(model.named_parameters())
    for name, p in named.items():
        g = grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(g).max()), err_msg=name)
        # Adam's first step is lr g / (|g| + eps): within 1e-6 unless the
        # gradient is within 1000x of its own measured error
        diff = np.abs(p.detach().numpy() - after[name])
        noise = float(np.abs(p.grad.numpy() - g).max())
        loud = np.abs(g) >= 1e3 * noise
        assert (diff[loud] <= 1e-6).all(), name
        assert (diff <= 2 * LR * 1.01).all(), name  # a sign flip at most
    state = model.state_dict()
    for prefix, n in counts.items():
        mean, var = f"{prefix}.running_mean", f"{prefix}.running_var"
        np.testing.assert_allclose(state[mean].numpy(), after[mean], rtol=1e-5, atol=1e-6)
        update = after[var] - 0.9 * before[var]  # flax's 0.1 x biased variance
        np.testing.assert_allclose(state[var].numpy() - after[var], update / (n - 1),
                                   rtol=1e-3, atol=1e-5 * np.abs(after[var]).max(),
                                   err_msg=var)


def _args(tmp_path, **over):
    kw = dict(dataset="chi3d", data_path="", pose_rep="rot6d", body_model="smplx",
              glob=True, translation=True, num_frames=16, batch_size=8, lr=1e-3,
              num_epochs=3, save_every=2, save_dir=str(tmp_path / "stgcn"), seed=0,
              keep_best=True, **{f"stgcn_{k}": v for k, v in REDUCED.items()})
    kw.update(over)
    return Namespace(**kw)


def _data(num_clips=16, T=16):
    pair = synthetic.make_clip_pair("chi3d", num_clips, min_len=T + 4, max_len=T + 16,
                                    learnable=True)
    return Feeder(clips=pair["train"], test_clips=pair["test"], dataname="chi3d",
                  split="train", num_frames=T, num_person=2)


def test_keep_best_returns_the_best_epoch(tmp_path, monkeypatch):
    """The held-out accuracies 0.25, 0.75, 0.5: the second epoch's
    classifier comes back, in eval mode; checkpoints at epochs 2 and 3
    (a two-block classifier: the choice does not depend on the size)."""
    scripted, seen = iter([0.25, 0.75, 0.5]), []
    measure = train_stgcn.held_out_accuracy

    def fake(model, loader, device):
        measure(model, loader, device)
        seen.append(copy.deepcopy(model.state_dict()))
        return next(scripted)

    monkeypatch.setattr(train_stgcn, "held_out_accuracy", fake)
    args = _args(tmp_path, stgcn_channels=(8, 8), stgcn_strides=(1, 1))
    model = train_stgcn.run_training(args, device="cpu", data=_data(8))
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, seen[1][k]), k
    assert not all(torch.equal(seen[1][k], seen[2][k]) for k in seen[1])
    assert sorted(p.name for p in (tmp_path / "stgcn").iterdir()) == [
        "model000000002.pt", "model000000003.pt"]


def test_checkpoint_loads_into_the_evaluation(tmp_path):
    """A reference-size classifier trained one epoch loads through
    eval_cmdm.load_stgcn_evaluator; a reduced one through STGCNEvaluator
    with its channels and strides; both give the trained model's outputs."""
    data = _data(8)
    x = torch.tensor(np.stack([data[i]["inp"] for i in range(4)]))
    for over in (dict(stgcn_channels=None, num_epochs=1), {}):
        args = _args(tmp_path / str(len(over)), keep_best=False, **over)
        model = train_stgcn.run_training(args, device="cpu", data=data)
        path = tmp_path / str(len(over)) / "stgcn" / f"model{args.num_epochs:09d}.pt"
        if over:
            evaluator = eval_cmdm.load_stgcn_evaluator(args, str(path))
        else:
            evaluator = stgcn_eval.STGCNEvaluator("chi3d", "smplx", 8, 12, 2, str(path),
                                                  **REDUCED)
        with torch.no_grad():
            want = model(x)
        got = evaluator({"output": x.numpy()})
        for key in ("features", "yhat"):
            np.testing.assert_allclose(got[key], want[key].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dataname", ["chi3d", "ntu"])
def test_learnable_clips_equal_jax(tmp_path, dataname):
    """make_clips(learnable=True) gives the JAX package's h5 clips bit for
    bit, for both splits of the pair."""
    h5py = pytest.importorskip("h5py")
    kw = dict(min_len=32, max_len=48, learnable=True)
    jsynthetic.make_dataset_pair(str(tmp_path), dataname, num_clips=12, **kw)
    pair = synthetic.make_clip_pair(dataname, 12, **kw)
    for split in ("train", "test"):
        with h5py.File(tmp_path / f"{dataname}_{split}.h5", "r") as f:
            ref = {k: f[k][:] for k in f}
        ours = pair[split]
        assert set(ours) == set(ref)
        for key, clip in ours.items():
            assert clip.dtype == ref[key].dtype
            np.testing.assert_array_equal(clip, ref[key])
