"""The benchmark's plain reference against the port at small sizes on the
CPU: each piece the judge relies on gives what the program gives."""

import gzip

import numpy as np
import pytest
import torch

from _portbench_helpers import REPO  # noqa: F401  (puts the repository on the path)
from portbench import data
from portbench.reference import clip_bpe, model, numerics, train

CFG = dict(arch="online", layers=2, latent_dim=32, num_heads=4, dropout=0.1,
           cond_mask_prob=0.1, cond_mode="action", num_actions=8, num_frames=12,
           njoints=56, nfeats=6, diffusion_steps=1000)


def program_model(cfg, seed=3):
    from regennet_torch.models.cmdm import CMDM

    m = CMDM(njoints=cfg["njoints"], nfeats=cfg["nfeats"], num_actions=cfg["num_actions"],
             num_frames=cfg["num_frames"], latent_dim=cfg["latent_dim"],
             num_layers=cfg["layers"], num_heads=cfg["num_heads"], dropout=cfg["dropout"],
             arch=cfg["arch"], cm_mode="concat", cond_mode=cfg["cond_mode"],
             cond_mask_prob=cfg["cond_mask_prob"])
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    weights = data.draw_weights(shapes, seed, "cpu")
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(weights[n])
    return m, weights


def inputs(cfg, B=3, seed=5):
    g = torch.Generator().manual_seed(seed)
    shape = (B, cfg["njoints"], cfg["nfeats"], cfg["num_frames"])
    cond = {"cmotion": torch.randn(shape, generator=g),
            "action": torch.randint(0, cfg["num_actions"], (B, 1), generator=g)}
    if cfg["cond_mode"] == "text":
        cond["text_emb"] = torch.randn(B, 512, generator=g)
    return torch.randn(shape, generator=g), torch.randint(0, 1000, (B,), generator=g), cond


def test_schedule_matches_the_program():
    from regennet_torch.diffusion.schedule import make_schedule

    prog = make_schedule("cosine", 1000)
    ref = numerics.cosine_schedule(1000, "cpu")
    for mine, theirs in (("sqrt_ab", "sqrt_alphas_cumprod"),
                         ("sqrt_one_minus_ab", "sqrt_one_minus_alphas_cumprod"),
                         ("post_coef1", "posterior_mean_coef1"),
                         ("post_coef2", "posterior_mean_coef2"),
                         ("post_log_var", "posterior_log_variance_clipped")):
        assert torch.equal(ref[mine], getattr(prog, theirs)), mine


def test_keep_mask_matches_the_program_bits():
    from regennet_torch.ops import attention

    seeds = torch.randint(-2 ** 31, 2 ** 31, (3, 2), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    bits = attention.dropout_bits(seeds, 3, 4, 9)
    expected = bits >= attention.dropout_threshold(0.1)
    assert torch.equal(numerics.keep_mask(seeds, 4, 9, 0.1), expected)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, -3.0])
    assert numerics.round_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, -3.0]


@pytest.mark.parametrize("arch, cond_mode", [("online", "action"), ("trans_enc", "text")])
def test_guided_denoiser_matches_the_program(arch, cond_mode):
    from regennet_torch.models.cmdm import make_cfg_model_fn

    cfg = dict(CFG, arch=arch, cond_mode=cond_mode)
    m, weights = program_model(cfg)
    x, t, cond = inputs(cfg)
    fn = make_cfg_model_fn(m.eval(), 2.5)
    prog = fn(x, t, fn.prepare(cond))
    ref = model.cfg_denoise(weights, cfg, x, t, cond, 2.5)
    assert (prog - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("arch, cond_mode", [("online", "action"), ("trans_enc", "text")])
def test_training_forward_replays_the_program_draws(arch, cond_mode):
    cfg = dict(CFG, arch=arch, cond_mode=cond_mode)
    m, weights = program_model(cfg)
    x, t, cond = inputs(cfg)
    prog = m(x, t, cond, train=True, generator=torch.Generator().manual_seed(9))
    draws = model.Draws(torch.Generator().manual_seed(9), "cpu")
    ref = model.denoise(weights, cfg, x, t, cond, draws)
    assert (prog - ref).abs().max() <= 1e-5 * ref.abs().max()
    # a different stream gives other masks: the replay is what matches
    other = model.denoise(weights, cfg, x, t, cond,
                          model.Draws(torch.Generator().manual_seed(8), "cpu"))
    assert (prog - other).abs().max() > 1e-2 * ref.abs().max()


def test_joint_decode_matches_the_program():
    from regennet_torch.ops import body_model
    from regennet_torch.ops.pose_decode import make_rot2xyz

    x = torch.randn(2, 56, 6, 5, generator=torch.Generator().manual_seed(2))
    fn = make_rot2xyz(body_model.get_body_model("smplx"), pose_rep="rot6d", jointstype="smplx",
                      translation=True, glob=True, vertstrans=False, num_person=1)
    rest = torch.tensor(train.synthetic_rest_joints())
    ref = train.decode_joints(x, rest, "float32")
    assert torch.allclose(fn(x), ref, atol=1e-5)


def test_loss_terms_match_the_program():
    from regennet_torch.diffusion import losses
    from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
    from regennet_torch.ops import body_model
    from regennet_torch.ops.pose_decode import make_rot2xyz

    g = torch.Generator().manual_seed(4)
    x0, out = torch.randn(3, 56, 6, 7, generator=g), torch.randn(3, 56, 6, 7, generator=g)
    cond = {"mask": torch.ones(3, 1, 1, 7, dtype=torch.bool),
            "cmotion": torch.randn(3, 56, 6, 7, generator=g)}
    cond["mask"][0, ..., 5:] = False
    dcfg = DiffusionConfig(lambda_vel=1.0, lambda_orient=1.0, lambda_body=1.0,
                           lambda_transl=1.0, body_model="smplx")
    decode = make_rot2xyz(body_model.get_body_model("smplx"), pose_rep="rot6d",
                          jointstype="smplx", translation=True, glob=True, vertstrans=False,
                          num_person=1)
    t = torch.tensor([3, 500, 900])
    prog = losses.training_losses(make_schedule("cosine", 1000), dcfg, lambda *a: out, x0, t,
                                  cond, torch.zeros_like(x0), rot2xyz_fn=decode)["loss"]
    lambdas = {"vel": 1.0, "orient": 1.0, "body": 1.0, "transl": 1.0}
    ref = train.loss_terms({"lambdas": lambdas}, x0, out, cond,
                           torch.tensor(train.synthetic_rest_joints()), "float32")
    assert torch.allclose(prog, ref, rtol=1e-5)


def test_timestep_draw_matches_the_program():
    from regennet_torch.diffusion.resample import UniformSampler

    t, _ = UniformSampler(1000).sample(64, np.random.default_rng(11))
    assert np.array_equal(t, train.uniform_timesteps(np.random.default_rng(11), 64, 1000))


def test_clip_tower_and_tokenizer_match_the_program(tmp_path):
    from regennet_torch.data.clip_bpe import ClipTokenizer
    from regennet_torch.models.clip_text_tower import ClipTextTower

    bpe = tmp_path / "bpe.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in data.BPE_MERGES))
    texts = data.captions(6, 3)
    ours = clip_bpe.ClipTokenizer(str(bpe)).tokenize(texts, 22, truncate=True)
    assert np.array_equal(ours, ClipTokenizer(str(bpe)).tokenize(texts, 22, truncate=True))
    tower = ClipTextTower(vocab_size=600, context_length=77, dim=64, heads=4, num_layers=2,
                          proj_dim=48)
    shapes = {n: tuple(p.shape) for n, p in tower.named_parameters()}
    weights = data.draw_weights(shapes, 1, "cpu")
    tower.load_state_dict(weights)
    tokens = torch.as_tensor(np.pad(ours, ((0, 0), (0, 55)))).long()
    with torch.no_grad():
        prog = tower(tokens)
        ref = model.clip_text(weights, tokens, 4, 2)
    assert torch.allclose(prog, ref, atol=1e-5)
