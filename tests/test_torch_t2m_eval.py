"""regennet_torch.models.t2m_eval against regennet_tpu.models.t2m_eval.

Each network of the text-to-motion evaluation, on the same numpy-seeded
inputs, with weights from the JAX init carried across by
convert.from_flax, and the other way, from a port state dict through
regennet_tpu.convert.torch_ckpt (whose key-coverage check must pass):
the movement encoder and decoder (the transposed convolutions through the
flipped kernel layout), the text and motion BiGRU towers and the length
estimator at varied lengths (1 and the full length among them), all at
f32 within 1e-5 x max(1, max|jax|); the wrapper's co-embeddings (both
packages' T2M_OPT cut to small widths; chip_smoke's phase 12 runs the
published ones); contrastive_loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_torch.convert import from_flax
from regennet_torch.models import t2m_eval
from regennet_tpu.convert import torch_ckpt
from regennet_tpu.models import t2m_eval as jt2m


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL_WIDTHS = dict(dim_text_hidden=32, dim_coemb_hidden=16, dim_motion_hidden=48,
                    dim_movement_enc_hidden=32, dim_movement_latent=24)


@pytest.fixture(scope="module", autouse=True)
def small_widths():
    """Both packages' evaluators at small widths (T2M_OPT is read when a
    network is built): the published ones make each JAX compile slow.
    Yields the published ones."""
    published = dict(t2m_eval.T2M_OPT), dict(jt2m.T2M_OPT)
    with pytest.MonkeyPatch.context() as mp:
        for opt in (t2m_eval.T2M_OPT, jt2m.T2M_OPT):
            for key, value in SMALL_WIDTHS.items():
                mp.setitem(opt, key, value)
        yield published


def test_published_widths_are_the_jax_packages(small_widths):
    ours, theirs = small_widths
    assert ours == theirs
    assert (ours["dim_text_hidden"], ours["dim_motion_hidden"],
            ours["dim_movement_latent"]) == (512, 1024, 512)


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def _load(module, sd):
    module.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})
    return module.eval()


def _numpy(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _word_inputs(rng, B, T):
    word = rng.normal(size=(B, T, 300)).astype(np.float32)
    pos = np.eye(15, dtype=np.float32)[rng.integers(0, 15, size=(B, T))]
    return word, pos


LENGTHS = np.asarray([1, 7, 12, 4])  # 1 and the full length among them


def test_movement_encoder_matches_flax():
    x = np.random.default_rng(0).normal(size=(3, 32, 40)).astype(np.float32)
    enc = jt2m.MovementConvEncoder(24, 16)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = enc.apply({"params": params}, jnp.asarray(x))
    ours = _load(t2m_eval.MovementConvEncoder(40, 24, 16),
                 from_flax.movement_encoder_state_dict_from_flax(params))
    with torch.no_grad():
        out = ours(torch.tensor(x))
    assert out.shape == (3, 8, 16)
    _close(out, ref)


def test_movement_decoder_matches_flax_through_the_flipped_kernel():
    lat = np.random.default_rng(1).normal(size=(2, 9, 16)).astype(np.float32)
    dec = jt2m.MovementConvDecoder(24, 30)
    params = dec.init(jax.random.PRNGKey(1), jnp.asarray(lat))["params"]
    ref = dec.apply({"params": params}, jnp.asarray(lat))
    sd = from_flax.movement_decoder_state_dict_from_flax(params)
    ours = _load(t2m_eval.MovementConvDecoder(16, 24, 30), sd)
    with torch.no_grad():
        out = ours(torch.tensor(lat))
    assert out.shape == (2, 36, 30)
    _close(out, ref)
    # the layout torch_ckpt reads back is the flax kernel it came from
    back = torch_ckpt._conv_transpose1d(sd, "main.0")
    np.testing.assert_array_equal(back["kernel"], np.asarray(params["deconv1"]["kernel"]))


@pytest.mark.parametrize("tower", ["text", "motion"])
def test_towers_match_flax(tower):
    rng = np.random.default_rng(2)
    B, T = len(LENGTHS), int(LENGTHS.max())
    if tower == "text":
        word, pos = _word_inputs(rng, B, T)
        inputs = (word, pos, LENGTHS)
        jmod = jt2m.TextEncoderBiGRUCo(hidden_size=24, output_size=16)
        ours = t2m_eval.TextEncoderBiGRUCo(300, 15, 24, 16)
    else:
        inputs = (rng.normal(size=(B, T, 20)).astype(np.float32), LENGTHS)
        jmod = jt2m.MotionEncoderBiGRUCo(input_size=20, hidden_size=32, output_size=16)
        ours = t2m_eval.MotionEncoderBiGRUCo(20, 32, 16)
    params = jmod.init(jax.random.PRNGKey(2), *map(jnp.asarray, inputs))["params"]
    ref = jmod.apply({"params": params}, *map(jnp.asarray, inputs))
    sd = from_flax._bigru_co(params, params.get("pos_emb"))
    _load(ours, sd)
    with torch.no_grad():
        out = ours(*(torch.tensor(a) for a in inputs))
    _close(out, ref)
    # a sequence's embedding does not depend on the padding past its length
    padded = [np.array(a) for a in inputs]
    for a in padded[:-1]:
        a[0, 1:] = 7.0
    with torch.no_grad():
        again = ours(*(torch.tensor(a) for a in padded))
    _close(again[0], out[0])


def test_length_estimator_matches_flax_both_ways():
    rng = np.random.default_rng(3)
    word, pos = _word_inputs(rng, len(LENGTHS), int(LENGTHS.max()))
    est = jt2m.MotionLenEstimatorBiGRU(hidden_size=24, output_size=50)
    params = est.init(jax.random.PRNGKey(3), jnp.asarray(word), jnp.asarray(pos),
                      jnp.asarray(LENGTHS))["params"]
    ref = est.apply({"params": params}, jnp.asarray(word), jnp.asarray(pos),
                    jnp.asarray(LENGTHS))
    ours = _load(t2m_eval.MotionLenEstimatorBiGRU(300, 15, 24, 50),
                 from_flax.length_estimator_state_dict_from_flax(params))
    with torch.no_grad():
        out = ours(torch.tensor(word), torch.tensor(pos), torch.tensor(LENGTHS))
    assert out.shape == (len(LENGTHS), 50)
    _close(out, ref)

    # a port state dict, in the released layout, through torch_ckpt
    port = t2m_eval.random_init_(t2m_eval.MotionLenEstimatorBiGRU(300, 15, 24, 50),
                                 torch.Generator().manual_seed(4)).eval()
    converted = torch_ckpt.convert_length_estimator({"estimator": port.state_dict()})
    ref = est.apply(converted, jnp.asarray(word), jnp.asarray(pos), jnp.asarray(LENGTHS))
    with torch.no_grad():
        _close(port(torch.tensor(word), torch.tensor(pos), torch.tensor(LENGTHS)), ref)


def _batch(dataset_name, B=4, T=24):
    rng = np.random.default_rng(5)
    word, pos = _word_inputs(rng, B, 8)
    cap_lens = np.asarray([8, 3, 1, 5])
    motions = rng.normal(size=(B, T, t2m_eval.dim_pose(dataset_name))).astype(np.float32)
    m_lens = np.asarray([T, 4, 13, 20])  # the towers read m_lens // 4
    return word, pos, cap_lens, motions, m_lens


@pytest.mark.parametrize("dataset_name", ["humanml", "kit"])
def test_wrapper_co_embeddings_match_jax(dataset_name):
    """JAX's random evaluators carried into the port's wrapper, and the
    port's random evaluators (finest.tar layout) carried into JAX's through
    convert_t2m_evaluator."""
    batch = _batch(dataset_name)
    jwrap = jt2m.T2MEvaluatorWrapper(dataset_name)
    state = from_flax.t2m_evaluator_state_from_flax(jwrap.variables)
    ours = t2m_eval.T2MEvaluatorWrapper(dataset_name, state=state)
    ref_text, ref_motion = jwrap.get_co_embeddings(*batch)
    text, motion = ours.get_co_embeddings(*batch)
    assert text.shape == motion.shape == (4, SMALL_WIDTHS["dim_coemb_hidden"])
    assert text.dtype == np.float32
    _close(text, ref_text)
    _close(motion, ref_motion)
    _close(ours.get_motion_embeddings(batch[3], batch[4]), ref_motion)

    port = t2m_eval.T2MEvaluatorWrapper(dataset_name, seed=1)
    jport = jt2m.T2MEvaluatorWrapper(
        dataset_name, variables=torch_ckpt.convert_t2m_evaluator(
            t2m_eval.evaluator_state(port)))
    for a, b in zip(port.get_co_embeddings(*batch), jport.get_co_embeddings(*batch)):
        _close(a, b)


def test_wrapper_loads_a_released_layout_file(tmp_path):
    """A finest.tar-layout file (with the extra entries a released one
    carries) loads as it is, and the seed decides the random networks."""
    port = t2m_eval.T2MEvaluatorWrapper("humanml", seed=2)
    path = tmp_path / "finest.tar"
    torch.save({**t2m_eval.evaluator_state(port), "epoch": 7}, path)
    loaded = t2m_eval.T2MEvaluatorWrapper("humanml", state=str(path))
    batch = _batch("humanml")
    for a, b in zip(loaded.get_co_embeddings(*batch), port.get_co_embeddings(*batch)):
        np.testing.assert_array_equal(a, b)
    other = t2m_eval.T2MEvaluatorWrapper("humanml", seed=3)
    assert not np.allclose(other.get_co_embeddings(*batch)[0],
                           port.get_co_embeddings(*batch)[0])


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(6)
    x, y = (rng.normal(scale=3.0, size=(8, 16)).astype(np.float32) for _ in range(2))
    y[0] = x[0]  # d = 0: the 1e-12 under the root
    label = (np.arange(8) % 2).astype(np.float32)
    for margin in (10.0, 1.0):
        ref = jt2m.contrastive_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(label),
                                    margin)
        ours = t2m_eval.contrastive_loss(torch.tensor(x), torch.tensor(y),
                                         torch.tensor(label), margin)
        _close(ours, ref)
