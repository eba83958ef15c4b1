"""train_gan of regennet_torch against the JAX package's, on the CPU: the
numpy stream order (every noise batch and fake label the steps are handed,
bit-equal, with the steps stubbed out in both trainers), and the CLI for
2 epochs in each loss mode at a small width with its checkpoint and
--gen_per_class h5.
"""

import os

import numpy as np
import pytest
import torch

from regennet_tpu.data import synthetic as jsynthetic
from regennet_tpu.train import train_gan as jtrain_gan
from regennet_torch.models.actor_gan import Discriminator, Generator
from regennet_torch.train import train_gan


@pytest.fixture(scope="module")
def data_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("gands")
    return str(jsynthetic.make_dataset_pair(str(root), "chi3d", num_clips=12))


def _argv(data_path, save_dir, loss_mode, **extra):
    argv = ["--data_path", data_path, "--save_dir", save_dir,
            "--num_frames", "8", "--batch_size", "4", "--num_epochs", "2", "--snapshot", "1",
            "--latent_dim", "16", "--nnoise", "4", "--noise_channel", "3",
            "--loss_mode", loss_mode, "--repeat_D", "2", "--seed", "3"]
    for k, v in extra.items():
        argv += [f"--{k}", str(v)]
    return argv


@pytest.mark.parametrize("loss_mode", ["hinge", "wgan-gp"])
def test_stream_order_matches_jax(data_path, tmp_path, monkeypatch, loss_mode):
    seen = {"jax": [], "torch": []}

    def jax_steps(*a, **k):
        def d_step(params_d, opt_state_d, params_g, x, y, noise, y_fake, rng):
            seen["jax"].append(("d", np.asarray(x), np.asarray(y), np.asarray(noise),
                                np.asarray(y_fake)))
            return params_d, opt_state_d, {"lossD": 0.0}

        def g_step(params_g, opt_state_g, params_d, noise, y_fake):
            seen["jax"].append(("g", np.asarray(noise), np.asarray(y_fake)))
            return params_g, opt_state_g, {"lossG": 0.0}
        return d_step, g_step

    def torch_steps(*a, **k):
        def d_step(x, y, noise, y_fake):
            seen["torch"].append(("d", x.numpy(), y.numpy(), noise.numpy(), y_fake.numpy()))
            return {"lossD": torch.tensor(0.0)}

        def g_step(noise, y_fake):
            seen["torch"].append(("g", noise.numpy(), y_fake.numpy()))
            return {"lossG": torch.tensor(0.0)}
        return d_step, g_step

    monkeypatch.setattr(jtrain_gan, "make_gan_steps", jax_steps)
    monkeypatch.setattr(train_gan, "make_gan_steps", torch_steps)
    jtrain_gan.main(jtrain_gan.parse_args(_argv(data_path, str(tmp_path / "j"), loss_mode)))
    train_gan.main(train_gan.parse_args(_argv(data_path, str(tmp_path / "t"), loss_mode)),
                   device="cpu")
    # 2 epochs of 3 full batches (12 clips at batch 4); G after every
    # second D step
    expected = [s for idx in range(6) for s in ("d", "g")[:1 + (idx % 2 == 0)]]
    assert [s[0] for s in seen["torch"]] == [s[0] for s in seen["jax"]] == expected
    for ours, ref in zip(seen["torch"], seen["jax"]):
        assert ours[0] == ref[0]
        for a, b in zip(ours[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("loss_mode", ["hinge", "wgan-gp"])
def test_cli_trains_saves_and_dumps(data_path, tmp_path, loss_mode):
    h5py = pytest.importorskip("h5py")
    save_dir = str(tmp_path / "run")
    args = train_gan.parse_args(_argv(data_path, save_dir, loss_mode, gen_per_class=2,
                                      device="cpu"))
    G, D = train_gan.main(args)
    for epoch in (1, 2):
        assert os.path.isfile(os.path.join(save_dir, f"model{epoch:09d}.pt"))
        assert os.path.isfile(os.path.join(save_dir, f"opt{epoch:09d}.pt"))
    state = torch.load(os.path.join(save_dir, "model000000002.pt"), weights_only=True)
    G2 = Generator(56, 12, 8, 8, noise_dim=3, latent_dim=16)
    D2 = Discriminator(56, 12, 8, latent_dim=16)
    torch.nn.ModuleDict({"G": G2, "D": D2}).load_state_dict(state, strict=True)
    for a, b in zip(G2.state_dict().values(), G.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for p in list(G.parameters()) + list(D.parameters()):
        assert torch.isfinite(p).all()
    with h5py.File(os.path.join(save_dir, "gen_per_class.h5")) as f:
        assert sorted(f) == sorted(f"A{c + 1:03d}_{i}" for c in range(8) for i in range(2))
        assert f["A001_0"].shape == (56, 12, 8)


def test_cli_needs_cuda_unless_asked_for_the_cpu(data_path, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gan.main(train_gan.parse_args(_argv(data_path, str(tmp_path / "r"), "hinge")))
