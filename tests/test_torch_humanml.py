"""regennet_torch's HumanML3D / KIT slice against the JAX package's.

* Data: the synthetic writers write the same files; dataset items and
  t2m_collate batches (through get_dataset_loader) are bit-equal when
  Python's `random` and numpy's ambient stream are seeded alike, for
  HumanML (263 features) and KIT (251); the word vectorizer's GloVe and
  hashed routes and the body-part masks are equal.
* Decode: quaternion algebra, recover_from_ric and recover_from_rot
  within 1e-5 x max(1, max|jax|) on random features, T 196 included.
* The text CMDM (cond_mode "text", the offline trunk at 2 layers, latent
  64, 196 frames): the forward at f32 within 1e-5 x max(1, max|jax|) with
  uncond on and off, and one f32 train step on a HumanML batch at dropout
  0 and cond_mask_prob 0 against `make_train_step`, at the tolerances of
  tests/test_torch_training.py.
The JAX CMDM runs its plain XLA attention here (the CPU default).
"""

import os
import pickle
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.data import get_data as jget_data
from regennet_tpu.data.humanml import dataset as jds
from regennet_tpu.data.humanml import humanml_utils as jhu
from regennet_tpu.data.humanml import motion_process as jmp
from regennet_tpu.data.humanml import word_vectorizer as jwv
from regennet_tpu.diffusion import losses as jlosses
from regennet_tpu.diffusion.schedule import DiffusionConfig as JConfig
from regennet_tpu.diffusion.schedule import make_schedule as jmake_schedule
from regennet_tpu.models import cmdm as jcmdm
from regennet_tpu.models.clip_text import hashed_text_embeddings as jhashed
from regennet_tpu.ops import rotations as jgeo
from regennet_tpu.train import training_loop as jtl
from regennet_torch.convert.from_flax import cmdm_state_dict_from_flax, train_state_from_flax
from regennet_torch.data import get_data
from regennet_torch.data.humanml import dataset as ds
from regennet_torch.data.humanml import humanml_utils as hu
from regennet_torch.data.humanml import motion_process as mp
from regennet_torch.data.humanml import word_vectorizer as wv
from regennet_torch.diffusion.schedule import DiffusionConfig, make_schedule
from regennet_torch.models import cmdm
from regennet_torch.models.clip_text import hashed_text_embeddings
from regennet_torch.ops import rotations as geo
from regennet_torch.train import training_loop


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _atol(ref, scale=1e-5):
    return scale * max(1.0, float(np.abs(ref).max()))


# -- data ------------------------------------------------------------------

DATASETS = {"humanml": 263, "kit": 251}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def roots(request, tmp_path_factory):
    """The same synthetic clips written by both packages' writers, plus one
    caption file with a tagged segment (a sub-clip under a random name)."""
    name, dim = request.param, DATASETS[request.param]
    out = {}
    for package, writer in (("jax", jds.write_synthetic_humanml),
                            ("torch", ds.write_synthetic_humanml)):
        root = str(tmp_path_factory.mktemp(f"{name}_{package}"))
        writer(root, num_clips=12, seed=3, dim_pose=dim, min_len=40, max_len=200)
        with open(os.path.join(root, "texts", "000001.txt"), "a") as f:
            f.write("a person jumps#a/DET person/NOUN jumps/VERB#0.5#2.8\n")
        out[package] = root
    return name, out


def test_writers_write_the_same_files(roots):
    _, paths = roots
    files = sorted(os.path.relpath(os.path.join(d, f), paths["jax"])
                   for d, _, fs in os.walk(paths["jax"]) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), paths["torch"])
                           for d, _, fs in os.walk(paths["torch"]) for f in fs)
    for f in files:
        with open(os.path.join(paths["jax"], f), "rb") as a, \
                open(os.path.join(paths["torch"], f), "rb") as b:
            assert a.read() == b.read(), f


def _seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _assert_items_equal(ours, ref):
    assert len(ours) == len(ref) == 7
    for a, b in zip(ours, ref):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_items_are_bit_equal(roots, split):
    name, paths = roots
    jdata = _seeded(5, lambda: jds.Text2MotionDataset(paths["jax"], split, dataset_name=name))
    data = _seeded(5, lambda: ds.Text2MotionDataset(paths["torch"], split, dataset_name=name))
    assert data.name_list == jdata.name_list and len(data) == len(jdata)
    assert data.dim_pose == DATASETS[name]
    np.testing.assert_array_equal(data.length_arr, jdata.length_arr)
    for max_len in (20, 96):  # the pointer skips clips shorter than the window
        jdata.reset_max_len(max_len)
        data.reset_max_len(max_len)
        # two passes: the streams carry on from one item to the next
        ref = _seeded(7, lambda: [jdata[i] for _ in range(2) for i in range(len(jdata))])
        ours = _seeded(7, lambda: [data[i] for _ in range(2) for i in range(len(data))])
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _assert_items_equal(a, b)


def test_t2m_collate_batches_are_bit_equal(roots):
    name, paths = roots

    def batches(loader):  # two epochs
        return _seeded(9, lambda: [b for _ in range(2) for b in loader])

    jloader = _seeded(1, lambda: jget_data.get_dataset_loader(
        name, 4, 60, data_path=paths["jax"], setting="mdm"))
    loader = _seeded(1, lambda: get_data.get_dataset_loader(
        name, 4, 60, data_path=paths["torch"], setting="mdm"))
    assert loader.collate_fn is ds.t2m_collate
    ref, ours = batches(jloader), batches(loader)
    assert len(ours) == len(ref) == 2 * (len(loader.dataset) // 4)
    for (motion, cond), (jmotion, jcond) in zip(ours, ref):
        assert motion.shape == (4, DATASETS[name], 1, 196)
        np.testing.assert_array_equal(motion, jmotion)
        assert set(cond["y"]) == set(jcond["y"])
        for k, v in jcond["y"].items():
            if isinstance(v, np.ndarray):
                assert cond["y"][k].dtype == v.dtype, k
                np.testing.assert_array_equal(cond["y"][k], v, err_msg=k)
            else:
                assert cond["y"][k] == v, k


def test_get_data_routes_the_text_datasets():
    for name in DATASETS:
        assert get_data.get_dataset_class(name) is ds.Text2MotionDataset
        assert get_data.get_collate_fn(name, "mdm") is ds.t2m_collate


TOKENS = ["walk/VERB", "person/NOUN", "left/ADV", "slowly/ADV", "chair/NOUN",
          "the/DET", "zzz/NOUN", "sos/OTHER", "unk/OTHER", "knee/NOUN", "3/NUM"]


def test_word_vectorizer_hashed_route_is_equal():
    with pytest.warns(UserWarning, match="hashed"):
        ours = wv.WordVectorizer("/nonexistent_glove")
    with pytest.warns(UserWarning, match="hashed"):
        ref = jwv.WordVectorizer("/nonexistent_glove")
    assert ours.using_fallback and ref.using_fallback
    for token in TOKENS:
        (e, p), (je, jp) = ours[token], ref[token]
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(p, jp)
    with pytest.raises(FileNotFoundError, match="GloVe"):
        wv.WordVectorizer("/nonexistent_glove", strict=True)


def test_word_vectorizer_glove_route_is_equal(tmp_path):
    words = ["walk", "person", "left", "unk", "chair"]
    vectors = np.random.default_rng(0).normal(size=(len(words), 300)).astype(np.float32)
    np.save(tmp_path / "our_vab_data.npy", vectors)
    with open(tmp_path / "our_vab_words.pkl", "wb") as f:
        pickle.dump(words, f)
    with open(tmp_path / "our_vab_idx.pkl", "wb") as f:
        pickle.dump({w: i for i, w in enumerate(words)}, f)
    ours, ref = wv.WordVectorizer(str(tmp_path)), jwv.WordVectorizer(str(tmp_path))
    for token in TOKENS:
        (e, p), (je, jp) = ours[token], ref[token]
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(p, jp)


def test_body_part_masks_are_equal():
    for name in ("HML_LOWER_BODY_MASK", "HML_UPPER_BODY_MASK", "HML_ROOT_BINARY",
                 "HML_ROOT_MASK"):
        np.testing.assert_array_equal(getattr(hu, name), getattr(jhu, name))
    assert hu.HML_FEATURE_DIM == 263


# -- decode ----------------------------------------------------------------

def test_quaternion_algebra_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
    p = rng.normal(size=(5, 7, 3)).astype(np.float32)
    for ours, ref in (
            (geo.quaternion_multiply(torch.tensor(a), torch.tensor(b)),
             jgeo.quaternion_multiply(jnp.asarray(a), jnp.asarray(b))),
            (geo.quaternion_invert(torch.tensor(a)), jgeo.quaternion_invert(jnp.asarray(a))),
            (geo.quaternion_apply(torch.tensor(a), torch.tensor(p)),
             jgeo.quaternion_apply(jnp.asarray(a), jnp.asarray(p)))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=_atol(ref))


def _features(T, dim, seed):
    f = np.random.default_rng(seed).normal(scale=0.3, size=(2, T, dim)).astype(np.float32)
    f[..., 0] *= 0.1  # root angular velocity: a few degrees a frame
    return f


@pytest.mark.parametrize("T", [12, 196])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_recover_from_ric_matches_jax(name, T):
    joints = 22 if name == "humanml" else 21
    f = _features(T, DATASETS[name], T)
    ref = np.asarray(jmp.recover_from_ric(jnp.asarray(f), joints))
    ours = mp.recover_from_ric(torch.tensor(f), joints).numpy()
    assert ours.shape == (2, T, joints, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=_atol(ref))


@pytest.mark.parametrize("T", [12, 196])
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_recover_from_rot_matches_jax(name, T):
    joints = 22 if name == "humanml" else 21
    chain = mp.T2M_KINEMATIC_CHAIN if name == "humanml" else mp.KIT_KINEMATIC_CHAIN
    jchain = jmp.T2M_KINEMATIC_CHAIN if name == "humanml" else jmp.KIT_KINEMATIC_CHAIN
    assert chain == jchain
    f = _features(T, DATASETS[name], T + 1)
    offsets = np.random.default_rng(2).normal(scale=0.2, size=(joints, 3)).astype(np.float32)
    ref = np.asarray(jmp.recover_from_rot(jnp.asarray(f), joints, offsets, jchain))
    ours = mp.recover_from_rot(torch.tensor(f), joints, offsets, chain).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=_atol(ref))
    ref6 = np.asarray(jmp.recover_rot6d(jnp.asarray(f), joints))
    np.testing.assert_allclose(mp.recover_rot6d(torch.tensor(f), joints).numpy(), ref6,
                               rtol=0, atol=_atol(ref6))


# -- the text CMDM -----------------------------------------------------------

B, J, F, T = 3, 263, 1, 196
MODEL = dict(njoints=J, nfeats=F, num_actions=1, num_frames=T, latent_dim=64, ff_size=128,
             num_layers=2, num_heads=4, arch="trans_enc", cm_mode="concat",
             cond_mode="text", cond_mask_prob=0.1, data_rep="hml_vec")
CAPTIONS = ["a person walks forward", "a person jumps", "a person turns left"]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, J, F, T)).astype(np.float32)
    return x, np.array([3, 500, 999]), jhashed(CAPTIONS)


def _pair(**over):
    kw = {**MODEL, **over}
    jm = jcmdm.CMDM(**kw)
    x, t, text_emb = _inputs(0)
    cond = {"cmotion": jnp.zeros_like(jnp.asarray(x)), "text_emb": jnp.asarray(text_emb)}
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), cond)["params"]
    sd = cmdm_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    tm = cmdm.CMDM(**kw)
    tm.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return jm, params, tm.eval()


def test_hashed_text_embeddings_are_the_jax_package_s():
    np.testing.assert_array_equal(hashed_text_embeddings(CAPTIONS), jhashed(CAPTIONS))


@pytest.mark.parametrize("uncond", [False, True])
def test_text_forward_matches_flax(uncond):
    jm, params, tm = _pair()
    assert "embed_text.weight" in tm.state_dict()
    x, t, text_emb = _inputs(1)
    jcond = {"cmotion": jnp.zeros_like(jnp.asarray(x)), "text_emb": jnp.asarray(text_emb),
             "uncond": jnp.asarray(uncond)}
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jcond))
    tcond = {"cmotion": torch.zeros(x.shape), "text_emb": torch.tensor(text_emb),
             "uncond": torch.tensor(uncond)}
    with torch.no_grad():
        ours = tm(torch.tensor(x), torch.tensor(t), tcond)
    assert ours.shape == (B, J, F, T)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=_atol(ref))


def test_text_cfg_model_fn_matches_flax():
    jm, params, tm = _pair()
    x, t, text_emb = _inputs(2)
    jfn = jcmdm.make_cfg_model_fn(jm, params, 2.5)
    jcond = jfn.prepare({"cmotion": jnp.zeros_like(jnp.asarray(x)),
                         "text_emb": jnp.asarray(text_emb)})
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t), jcond))
    fn = cmdm.make_cfg_model_fn(tm, 2.5)
    ours = fn(torch.tensor(x), torch.tensor(t),
              fn.prepare({"cmotion": torch.zeros(x.shape), "text_emb": torch.tensor(text_emb)}))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=_atol(ref) * 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_train_step_matches_jax(tmp_path, dtype):
    """The second step from the JAX state after one, on t2m_collate
    batches of synthetic HumanML, at dropout 0 and cond_mask_prob 0: f32 at
    the tolerances of tests/test_torch_training.py; bf16 (the port's
    --compute_dtype bfloat16 against CMDM(dtype=jnp.bfloat16): 263
    features, the CLIP condition, 197 tokens, non-causal, the padding mask
    on the loss) at those of tests/test_torch_training_bf16.py, the Chi3D
    trunks' bound of 2^-6."""
    from tests.test_torch_training_bf16 import hold_bf16_second_step

    bf16 = dtype == "bfloat16"
    root = ds.write_synthetic_humanml(str(tmp_path), num_clips=8, seed=1, min_len=40,
                                      max_len=200)
    data = _seeded(0, lambda: ds.Text2MotionDataset(root, "train"))
    batches = []
    for start in (0, 3):
        motion, cond = ds.t2m_collate([data[i] for i in range(start, start + B)])
        batches.append({
            "motion": motion, "t": np.array([7, 420, 990], np.int32),
            "weights": np.array([1.0, 0.7, 1.3], np.float32),
            "cond": {"mask": cond["y"]["mask"], "cmotion": np.zeros_like(motion),
                     "text_emb": jhashed(cond["y"]["text"])}})
    b1, b2 = batches
    assert not b2["cond"]["mask"].all()  # padded frames are masked out of the loss
    lr, wd, anneal, ema_rate = 1e-3, 0.1, 10, 0.99
    kw = {**MODEL, "dropout": 0.0, "cond_mask_prob": 0.0}
    jm32 = jcmdm.CMDM(**kw)
    jm = jcmdm.CMDM(**kw, dtype=jnp.bfloat16) if bf16 else jm32
    params = jm32.init(jax.random.PRNGKey(0), jnp.asarray(b1["motion"]),
                       jnp.asarray(b1["t"]),
                       {k: jnp.asarray(v) for k, v in b1["cond"].items()})["params"]
    cfg = dict(data_rep="hml_vec", lambda_rcxyz=0.0, lambda_vel=0.0, lambda_fc=0.0,
               lambda_orient=0.0, lambda_body=0.0, lambda_transl=0.0)
    jsched, jcfg = jmake_schedule("cosine", 1000), JConfig(**cfg)
    opt = jtl.make_optimizer(lr, wd, anneal)
    step_fn = jax.jit(jtl.make_train_step(jm, jsched, jcfg, opt, None, ema_rate=ema_rate))
    state0 = dict(params=params, opt_state=opt.init(params),
                  ema_params=jax.tree_util.tree_map(jnp.array, params),
                  step=jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(7)
    state1 = jax.device_get(step_fn(state0, b1, rng)[0])
    state2, jm2 = jax.device_get(step_fn(state1, b2, rng))

    drng, crng, nrng = jax.random.split(jax.random.fold_in(rng, 1), 3)
    noise = np.asarray(jax.random.normal(nrng, b2["motion"].shape, jnp.float32))

    def jloss(p):  # the f32 loss of the second step
        def model_fn(x, t, cond):
            return jm32.apply({"params": p}, x, t, cond, train=True,
                              rngs={"dropout": drng, "cond_mask": crng})
        terms = jlosses.training_losses(jsched, jcfg, model_fn, b2["motion"], b2["t"],
                                        b2["cond"], nrng)
        return jnp.mean(terms["loss"] * b2["weights"])

    jgrads32 = cmdm_state_dict_from_flax(
        jax.device_get(jax.jit(jax.grad(jloss))(state1["params"])))

    model = cmdm.CMDM(**kw)
    optimizer = training_loop.make_optimizer(model.parameters(), lr, wd)
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate = train_state_from_flax(state1)
    training_loop.load_train_state(model, optimizer, ema, tstate)
    before = {n: p.detach().double().clone() for n, p in model.named_parameters()}
    step = training_loop.make_train_step(
        model, make_schedule("cosine", 1000), DiffusionConfig(**cfg), optimizer, None, ema,
        ema_rate=ema_rate, lr_schedule=lambda s: training_loop.learning_rate(lr, anneal, s),
        dtype=torch.bfloat16 if bf16 else torch.float32)
    tb2 = {"motion": torch.tensor(b2["motion"]), "t": torch.tensor(b2["t"]).long(),
           "weights": torch.tensor(b2["weights"]),
           "cond": {k: torch.tensor(v) for k, v in b2["cond"].items()}}
    metrics = step(tb2, torch.Generator().manual_seed(0), tstate["step"],
                   noise=torch.tensor(noise))
    named = dict(model.named_parameters())
    assert set(named) == set(jgrads32) and "embed_text.weight" in named

    if bf16:
        # the bf16 step's gradients from its first moment: mu' = 0.9 mu + 0.1 g
        jgrads = cmdm_state_dict_from_flax(jax.tree_util.tree_map(
            lambda m1, m0: (np.asarray(m1, np.float64) - 0.9 * np.asarray(m0, np.float64))
            / 0.1, state2["opt_state"][0].mu, state1["opt_state"][0].mu))
        hold_bf16_second_step(model, optimizer, ema, before, metrics, jm2, state2, jgrads,
                              jgrads32, training_loop.learning_rate(lr, anneal, 1), wd=wd,
                              ema_rate=ema_rate)
        return
    for name, ref in jm2.items():
        rtol = 1e-5
        if name == "loss_per_elem":
            np.testing.assert_allclose(metrics[name].numpy(), ref, rtol=rtol)
        else:
            np.testing.assert_allclose(float(metrics[name]), float(ref), rtol=rtol,
                                       err_msg=name)
    want = {k: cmdm_state_dict_from_flax(v) for k, v in (
        ("params", state2["params"]), ("ema", state2["ema_params"]),
        ("mu", state2["opt_state"][0].mu))}
    flips = 0
    for name, p in named.items():
        g, jg = p.grad.numpy(), jgrads32[name]
        np.testing.assert_allclose(g, jg, rtol=0, atol=2e-5 * max(1.0, np.abs(jg).max()),
                                   err_msg=name)
        np.testing.assert_allclose(optimizer.state[p]["exp_avg"].numpy(), want["mu"][name],
                                   rtol=0, atol=2e-5 * max(1.0, np.abs(want["mu"][name]).max()))
        # as tests/test_torch_training.py: parameters within 1e-6 where the
        # gradient is above the rounding noise, within lr elsewhere
        diff = np.abs(p.detach().numpy() - want["params"][name])
        noise_level = np.abs(jg) < 1e-6 * np.abs(jg).max()
        assert (diff[~noise_level] <= 1e-6).all(), name
        assert (diff <= lr * 1.01).all(), name
        flips += int((diff > 1e-6).sum())
        ema_diff = np.abs(ema[name].numpy() - want["ema"][name])
        assert (ema_diff <= 1e-6 + (1 - ema_rate) * diff).all(), name
    assert flips <= 200, flips
