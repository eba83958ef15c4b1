"""A fresh regennet_torch model draws its parameters as the JAX package's
Flax module draws them.

Each family is built both ways at realistic widths: the Flax module with
`.init`, the port's module with its `random_init_`. The Flax parameters
go through the `from_flax` name maps into the port's names, and so do two
trees of the same structure that hold, entry by entry, the Flax
initialiser's kind and analytic std (Flax's defaults: a Dense, Conv or
ConvTranspose kernel lecun-normal over fan-in = receptive field x input
features, truncated at two stds; a GRUCell's hr, hz, hn kernels
orthogonal; biases, LayerNorm and BatchNorm constant; the parameters a
module declares with `normal(std)`). Then, for both packages:
  (a) the constant entries equal the Flax module's exactly;
  (b) every drawn tensor of at least 1,024 entries has a sample std within
      5 standard errors (5/sqrt(2n), relative) of the analytic std;
  (c) a lecun-normal entry stays within the truncation, 2 std / 0.8796;
  (d) each GRU recurrent gate block of the port is orthogonal.
Two builds from one seed are equal, and two seeds differ.
"""

import argparse
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_torch.convert import from_flax
from regennet_torch.models import actor_cvae, actor_gan, clip_text_tower, cmdm
from regennet_torch.models import gru_classifier, initializers, stgcn, t2m_eval, t2m_gen
from regennet_torch.utils import model_util
from regennet_tpu.models import actor_cvae as jcvae
from regennet_tpu.models import actor_gan as jgan
from regennet_tpu.models import clip_text_flax as jclip
from regennet_tpu.models import cmdm as jcmdm
from regennet_tpu.models import gru_classifier as jgru
from regennet_tpu.models import stgcn as jstgcn
from regennet_tpu.models import t2m_eval as jt2m
from regennet_tpu.models import t2m_gen as jt2m_gen

CONSTANT, LECUN, ORTHOGONAL, NORMAL = 0, 1, 2, 3
MIN_ENTRIES = 1024

# the full capability study's CMDM (scripts/capability_study_torch.py,
# --scale full, through utils/model_util.get_model_args) and the flagship's
STUDY = dict(njoints=56, nfeats=6, num_actions=8, num_frames=60, latent_dim=128,
             ff_size=1024, num_layers=4, num_heads=4, cm_mode="concat",
             cond_mode="action", cond_mask_prob=0.1)
FLAGSHIP = dict(STUDY, latent_dim=512, num_layers=8, num_frames=150)
TEXT = dict(STUDY, njoints=263, nfeats=1, num_actions=1, num_frames=196, latent_dim=512,
            num_layers=8, cm_mode="add", cond_mode="text", arch="trans_enc")
CMDMS = {
    "study-online": dict(STUDY, arch="online"),
    "study-offline": dict(STUDY, arch="offline"),
    "study-gru": dict(STUDY, arch="gru", cm_mode="add"),
    "study-mlp": dict(STUDY, arch="mlp"),
    "text": TEXT,
    "flagship-online": dict(FLAGSHIP, arch="online"),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rule(normal=(), normal_kernels=(), keep=()):
    """The Flax initialiser of a leaf by its path: (kind, std, constant).
    `normal` maps the names of a module's own params to their std,
    `normal_kernels` the Dense layers whose kernel_init is normal(std),
    `keep` names params that start at one."""
    normal, normal_kernels = dict(normal), dict(normal_kernels)

    def rule(path, shape):
        name = path[-1]
        if name in normal:
            return NORMAL, normal[name], 0.0
        if name in keep or name in ("scale", "var"):
            return CONSTANT, 0.0, 1.0
        if name in ("bias", "mean"):
            return CONSTANT, 0.0, 0.0
        assert name == "kernel", path
        for part in path:
            if part in normal_kernels:
                return NORMAL, normal_kernels[part], 0.0
        if path[-2] in ("hr", "hz", "hn"):
            return ORTHOGONAL, 1.0 / np.sqrt(shape[0]), 0.0
        return LECUN, 1.0 / np.sqrt(np.prod(shape[:-1])), 0.0

    return rule


def _trees(variables, rule):
    """(values or None, kinds, stds, constants): numpy trees shaped as the
    Flax variables, the last three broadcast from one entry per leaf.
    `variables` holds arrays, or only their shapes (jax.eval_shape)."""
    real = not isinstance(jax.tree_util.tree_leaves(variables)[0], jax.ShapeDtypeStruct)

    def fill(index):
        def leaf(path, x):
            keys = tuple(getattr(k, "key", getattr(k, "name", None)) for k in path)
            return np.broadcast_to(np.float64(rule(keys, x.shape)[index]), x.shape)
        return jax.tree_util.tree_map_with_path(leaf, variables)

    return (jax.tree_util.tree_map(np.asarray, variables) if real else None,
            fill(0), fill(1), fill(2))


def _flat(sd, prefix=""):
    """A state dict, or a dict of them, as one flat {name: array}."""
    out = {}
    for k, v in sd.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.detach().float().numpy() if torch.is_tensor(v) else v
    return out


def _groups(kind, std):
    """The distinct (kind, std) pairs of one tensor."""
    if (kind == kind.flat[0]).all() and (std == std.flat[0]).all():
        return [(kind.flat[0], std.flat[0])]
    return [(k, s) for k in np.unique(kind) for s in np.unique(std[kind == k])]


def _check(port_sd, variables, convert, rule, what):
    """Hold the port's fresh state dict, and the Flax variables when they
    hold values, through `convert` against the analytic Flax initialisers:
    (a)-(d)."""
    values, kinds, stds, consts = (None if tree is None else _flat(convert(tree))
                                   for tree in _trees(variables, rule))
    port = {k: v for k, v in _flat(port_sd).items() if not k.endswith("num_batches_tracked")}
    assert set(port) == set(kinds), (what, set(port) ^ set(kinds))
    for name, mine in port.items():
        kind, std = kinds[name], stds[name]
        for k, s in _groups(kind, std):
            mask = (kind == k) & (std == s)
            drawn = [("port", mine[mask])]
            if values is not None:
                drawn.append(("jax", values[name][mask]))
            if k == CONSTANT:  # (a)
                for who, x in drawn:
                    np.testing.assert_array_equal(x, consts[name][mask],
                                                  err_msg=f"{what} {name} [{who}]")
                continue
            n = int(mask.sum())
            if n >= MIN_ENTRIES:  # (b)
                tol = 5.0 / np.sqrt(2 * n)
                for who, x in drawn:
                    ratio = float(x.std()) / s
                    assert abs(ratio - 1.0) <= tol, (
                        f"{what} {name} [{who}]: std {x.std():.4g} is {ratio:.3f}x the "
                        f"Flax initialiser's {s:.4g} (n {n}, tolerance {tol:.3f})")
            if k == LECUN:  # (c)
                bound = 2.0 * s / initializers.TRUNCATED_STD * (1 + 1e-6)
                for who, x in drawn:
                    assert np.abs(x).max() <= bound, (what, name, who, float(np.abs(x).max()))
        if ".weight_hh" in name or name.startswith("weight_hh"):  # (d)
            for block in np.split(mine, 3, axis=0):
                err = np.abs(block.astype(np.float64) @ block.T - np.eye(block.shape[0])).max()
                assert err <= 1e-5, (what, name, err)


def _init(module, *inputs, real=True, **kw):
    """The Flax module's `.init` variables as numpy, or with real=False only
    their shapes (jax.eval_shape: the widest models, whose init compiles
    for seconds; their kinds of layer are held with values at the study's
    widths)."""
    init = functools.partial(module.init, jax.random.PRNGKey(0), **kw)
    if not real:
        return jax.eval_shape(init, *inputs)
    return jax.tree_util.tree_map(np.asarray, init(*inputs))


def _cmdm_inputs(kw):
    # the frame count shapes only the mlp trunk's parameters
    T = kw["num_frames"] if kw["arch"] == "mlp" else 8
    x = jnp.zeros((1, kw["njoints"], kw["nfeats"], T))
    cond = {"cmotion": x, "action": jnp.zeros((1, 1), jnp.int32)}
    if kw["cond_mode"] == "text":
        cond = {"cmotion": x, "text_emb": jnp.zeros((1, cmdm.CLIP_DIM))}
    return x, jnp.zeros((1,), jnp.int32), cond


@pytest.mark.parametrize("variant", sorted(CMDMS))
def test_cmdm_draws_as_flax(variant):
    kw = CMDMS[variant]
    params = _init(jcmdm.CMDM(**kw), *_cmdm_inputs(kw), real=variant.startswith("study"))
    params = params["params"]
    port = cmdm.random_init_(cmdm.CMDM(**kw), torch.Generator().manual_seed(0))
    _check(port.state_dict(), params, from_flax.cmdm_state_dict_from_flax,
           _rule(normal={"action_embedding": 1.0}), variant)


def _cvae_inputs():
    x = jnp.zeros((1, 25, 6, 60))
    return x, jnp.zeros((1,), jnp.int32)


@pytest.mark.parametrize("arch", ["transformer", "gru", "autotrans"])
def test_actor_cvae_draws_as_flax(arch):
    """The ACTOR CVAE at train_cvae's defaults (latent 256, 4 layers, 60
    frames, HumanAct12's 25 x 6 and 12 classes)."""
    kw = dict(njoints=25, nfeats=6, num_actions=12, arch=arch, num_frames=60, dropout=0.0)
    params = _init(jcvae.ActorCVAE(**kw), *_cvae_inputs(), real=arch == "transformer",
                   rng=jax.random.PRNGKey(1))["params"]
    port = actor_cvae.random_init_(actor_cvae.ActorCVAE(**kw), torch.Generator().manual_seed(0))
    _check(port.state_dict(), params, from_flax.actor_cvae_state_dict_from_flax,
           _rule(normal={"mu_query": 0.02, "sigma_query": 0.02, "action_biases": 0.02}), arch)


GAN_RULE = _rule(normal={"label_embedding": 0.02, "label_projection": 0.02},
                 normal_kernels={n: 0.02 for n in ("noise_embed", "output_head",
                                                   "frame_embed", "psi")})


@pytest.mark.parametrize("side", ["generator", "discriminator"])
def test_gan_draws_as_flax(side):
    """train_gan's defaults: latent 256, 16 noise tokens of 32 channels, 60
    frames of 25 x 6, 12 classes."""
    label = jnp.zeros((1,), jnp.int32)
    if side == "generator":
        params = _init(jgan.Generator(25, 6, 12, 60), jnp.zeros((1, 32, 1, 16)), label)
        port = actor_gan.Generator(25, 6, 12, 60, noise_dim=32)
    else:
        params = _init(jgan.Discriminator(25, 6, 12), jnp.zeros((1, 25, 6, 60)), label)
        port = actor_gan.Discriminator(25, 6, 12)
    actor_gan.random_init_(port, torch.Generator().manual_seed(0))
    _check(port.state_dict(), params["params"], from_flax.actor_gan_state_dict_from_flax,
           GAN_RULE, side)


def test_stgcn_draws_as_flax():
    """The two-person ST-GCN of eval_cmdm and the capability study at the
    evaluator's channels."""
    spec = dict(in_channels=12, num_class=8, num_person=2, layout="smplx")
    port = stgcn.random_init_(stgcn.STGCN(**spec), torch.Generator().manual_seed(0))
    V, CM = port.num_node, spec["in_channels"]
    variables = _init(jstgcn.STGCN(strategy="spatial", **spec),
                      {"output": jnp.zeros((1, V, CM, 16))}, train=False)
    _check(port.state_dict(), variables, from_flax.stgcn_state_dict_from_flax,
           _rule(keep=[f"edge_importance_{i}" for i in range(10)]), "stgcn")


def test_gru_classifier_draws_as_flax():
    params = _init(jgru.MotionDiscriminator(input_size=72, output_size=12),
                   jnp.zeros((1, 24, 3, 60)), jnp.asarray([60]))
    port = gru_classifier.random_init_(gru_classifier.MotionDiscriminator(output_size=12),
                                       torch.Generator().manual_seed(0))
    _check(port.state_dict(), params, from_flax.gru_classifier_state_dict_from_flax,
           _rule(), "gru classifier")


def _words(T=6):
    return jnp.zeros((1, T, 300)), jnp.zeros((1, T, 15)), jnp.asarray([T])


T2M_NETS = {
    "movement_enc": (lambda: jt2m.MovementConvEncoder(), lambda: (jnp.zeros((1, 16, 259)),),
                     from_flax.movement_encoder_state_dict_from_flax),
    "movement_dec": (lambda: jt2m.MovementConvDecoder(), lambda: (jnp.zeros((1, 4, 512)),),
                     from_flax.movement_decoder_state_dict_from_flax),
    "text_encoder": (lambda: jt2m.TextEncoderBiGRUCo(), _words,
                     lambda p: from_flax._bigru_co(p, p["pos_emb"])),
    "motion_encoder": (lambda: jt2m.MotionEncoderBiGRUCo(),
                       lambda: (jnp.zeros((1, 4, 512)), jnp.asarray([4])), from_flax._bigru_co),
    "estimator": (lambda: jt2m.MotionLenEstimatorBiGRU(), _words,
                  from_flax.length_estimator_state_dict_from_flax),
}


REAL_T2M = ("movement_enc", "movement_dec", "text_encoder")


@pytest.mark.parametrize("name", sorted(T2M_NETS))
def test_t2m_evaluators_draw_as_flax(name):
    """The T2M evaluators and the length estimator at T2M_OPT's widths
    (HumanML3D's 263 features)."""
    make, inputs, convert = T2M_NETS[name]
    params = _init(make(), *inputs(), real=name in REAL_T2M)["params"]
    (port,) = t2m_eval.networks(263, name)
    t2m_eval.random_init_(port, torch.Generator().manual_seed(0))
    _check(port.state_dict(), params, convert, _rule(normal={"hidden": 1.0}), name)


def test_comp_v6_draws_as_flax():
    """comp_v6 at train_t2m_gen's published sizes."""
    T, M = 6, 4
    word, pos, cap_lens = _words(T)
    params = _init(jt2m_gen.CompV6Generator(), word, pos, cap_lens, jnp.zeros((1, M, 512)),
                   jnp.asarray([4 * M]), jnp.zeros((1, 512)), jax.random.PRNGKey(1),
                   jnp.ones(()), real=False)["params"]
    gen = t2m_gen.CompV6Generator()
    t2m_eval.random_init_(gen, torch.Generator().manual_seed(0))
    port = {name: net.state_dict() for name, net in t2m_gen.networks(gen, None).items()}
    _check(port, params, from_flax.comp_v6_state_from_flax,
           _rule(normal={"hidden": 1.0}), "comp_v6")


@pytest.mark.parametrize("widths", ["vit-b-32", "narrow"])
def test_clip_tower_draws_as_flax(widths):
    """The seeded ViT-B/32 text tower that stands in for CLIP's weights (the
    Flax side by its shapes), and a narrow one whose Flax draws are held
    too."""
    kw = {"vit-b-32": {}, "narrow": dict(vocab_size=2048, dim=64, heads=1, num_layers=2,
                                         proj_dim=32)}[widths]
    params = _init(jclip.ClipTextTransformer(**kw), jnp.zeros((1, 77), jnp.int32),
                   real=widths == "narrow")
    tower = clip_text_tower.random_init_(clip_text_tower.ClipTextTower(**kw),
                                         torch.Generator().manual_seed(1))
    rule = _rule(normal={"token_embedding": 0.02, "positional_embedding": 0.01,
                         "text_projection": 0.02})
    _check(tower.state_dict(), params, from_flax.clip_text_state_dict_from_flax, rule, widths)


def test_transposed_convolution_fan_in_is_flax():
    """A ConvTranspose1d's fan-in is in x k, not torch's out x k."""
    conv = torch.nn.ConvTranspose1d(64, 8, 4, 2, 1)
    initializers.init_params_(conv, torch.Generator().manual_seed(0))
    ratio = float(conv.weight.detach().std()) * np.sqrt(64 * 4)  # std / Flax's
    assert abs(ratio - 1.0) < 5 / np.sqrt(2 * conv.weight.numel())


def _state(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


FRESH = {
    "cmdm": lambda g: cmdm.random_init_(cmdm.CMDM(**dict(STUDY, arch="gru", cm_mode="add")), g),
    "actor_cvae": lambda g: actor_cvae.random_init_(
        actor_cvae.ActorCVAE(25, 6, 12, latent_dim=64, num_layers=2), g),
    "gan": lambda g: actor_gan.random_init_(actor_gan.Discriminator(25, 6, 12, latent_dim=64), g),
    "stgcn": lambda g: stgcn.random_init_(stgcn.make_unconstrained_stgcn(), g),
    "gru_classifier": lambda g: gru_classifier.random_init_(
        gru_classifier.MotionDiscriminator(), g),
    "t2m": lambda g: t2m_eval.random_init_(t2m_eval.networks(263, "movement_dec")[0], g),
    "clip": lambda g: clip_text_tower.random_init_(
        clip_text_tower.ClipTextTower(1000, 16, 64, 1, 2, 32), g),
}


@pytest.mark.parametrize("family", sorted(FRESH))
def test_one_seed_gives_one_model(family):
    def build(seed):
        return _state(FRESH[family](torch.Generator().manual_seed(seed)))

    assert _same(build(3), build(3))
    assert not _same(build(3), build(4))


def _train_args(seed):
    return argparse.Namespace(
        seed=seed, dataset="chi3d", body_model="smplx", pose_rep="rot6d", num_frames=60,
        latent_dim=128, layers=4, cond_mask_prob=0.1, arch="online", cm_mode="concat",
        wo_pos_emb=False, emb_trans_dec=False, setting="cmdm", noise_schedule="cosine",
        diffusion_steps=10, sigma_small=True, lambda_vel=0.0, lambda_rcxyz=0.0,
        lambda_fc=0.0, lambda_orient=0.0, lambda_body=0.0, lambda_transl=0.0,
        vel_threshold=0.01)


def test_create_model_and_diffusion_draws_from_the_seed():
    """train_mdm's and the capability study's model factory draws the CMDM
    from torch.Generator(args.seed) by the Flax rules, whatever torch's
    global generator holds."""
    data = argparse.Namespace(num_actions=8)

    def build(seed, global_seed):
        torch.manual_seed(global_seed)
        return _state(model_util.create_model_and_diffusion(_train_args(seed), data)[0])

    first = build(10, 0)
    assert _same(first, build(10, 1))
    assert not _same(first, build(11, 0))
    expected = cmdm.random_init_(cmdm.CMDM(**model_util.get_model_args(_train_args(10), data)),
                                 torch.Generator().manual_seed(10))
    assert _same(first, _state(expected))
