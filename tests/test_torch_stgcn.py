"""regennet_torch's ST-GCN classifier against the JAX package's STGCN on
shared variables (carried over with stgcn_state_dict_from_flax).

The batch statistics and BatchNorm affines are drawn at random, so the
eval-mode BatchNorms are exercised. Tolerance 1e-4 x max(1, max|jax|): f32
convolutions summed in other orders through up to ten blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regennet_tpu.convert.torch_ckpt import convert_stgcn
from regennet_tpu.models.stgcn import STGCN as JSTGCN
from regennet_tpu.models.stgcn_graph import Graph as JGraph
from regennet_torch.convert.from_flax import stgcn_state_dict_from_flax
from regennet_torch.models.stgcn import STGCN, random_init_
from regennet_torch.models.stgcn_graph import Graph
from regennet_torch.train import checkpoint

REDUCED = dict(channels=(16, 16, 32), strides=(1, 2, 1))


@pytest.mark.parametrize("layout", ["smpl", "smplx", "smpl_noglobal", "ntu-rgb+d", "ntu_edge"])
def test_graph_matches_jax(layout):
    ours, ref = Graph(layout), JGraph(layout, "spatial")
    assert ours.num_node == ref.num_node
    np.testing.assert_array_equal(ours.A, ref.A)


def _variables(jm, x, seed):
    """Flax variables with random BatchNorm statistics and affines."""
    variables = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), {"output": jnp.asarray(x)}))
    rng = np.random.default_rng(seed)

    def perturb(tree, kind):
        if isinstance(tree, dict):
            return {k: perturb(v, k if k in ("mean", "var", "scale") else kind)
                    for k, v in tree.items()}
        if kind == "var":
            return rng.uniform(0.5, 2.0, tree.shape).astype(np.float32)
        if kind in ("mean", "scale"):
            return (tree + rng.normal(size=tree.shape) * 0.2).astype(np.float32)
        return tree

    stats = perturb(variables["batch_stats"], None)
    params = dict(variables["params"])
    for name in list(params):
        if name.startswith("edge_importance_"):
            params[name] = (params[name] * rng.uniform(0.5, 1.5, params[name].shape)
                            ).astype(np.float32)
    params = {k: (perturb(v, None) if isinstance(v, dict) else v) for k, v in params.items()}
    return {"params": params, "batch_stats": stats}


def _port(variables, **kw):
    model = STGCN(in_channels=12, num_class=8, num_person=2, layout="smplx", **kw)
    checkpoint.load_classifier_state(model, stgcn_state_dict_from_flax(variables))
    return model.eval()


@pytest.mark.parametrize("size,T", [("reduced", 30), ("default", 16)])
def test_features_and_logits_match_jax(size, T):
    kw = REDUCED if size == "reduced" else {}
    x = np.random.default_rng(1).normal(size=(3, 56, 12, T)).astype(np.float32)
    jm = JSTGCN(in_channels=12, num_class=8, num_person=2, layout="smplx",
                **{k: tuple(v) for k, v in kw.items()})
    variables = _variables(jm, x, seed=2)
    ref = jm.apply(variables, {"output": jnp.asarray(x)})
    with torch.no_grad():
        ours = _port(variables, **kw)(torch.tensor(x))
    for key in ("features", "yhat"):
        r = np.asarray(ref[key])
        assert ours[key].shape == r.shape
        np.testing.assert_allclose(ours[key].numpy(), r, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(r).max())), err_msg=key)


def test_state_dict_round_trips_through_convert_stgcn():
    x = np.zeros((1, 56, 12, 16), np.float32)
    jm = JSTGCN(in_channels=12, num_class=8, num_person=2, layout="smplx")
    variables = _variables(jm, x, seed=3)
    sd = stgcn_state_dict_from_flax(variables)
    back = convert_stgcn(dict(sd))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    # the port module's own state dict, in the same names
    port = _port(variables)
    assert set(sd) == {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    back2 = convert_stgcn({k: v.numpy() for k, v in port.state_dict().items()})
    for a, b in zip(jax.tree_util.tree_leaves(back2), jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)


def test_released_style_file_loads(tmp_path):
    """A reference-layout file with the adjacency buffer and BatchNorm
    counters, wrapped as {"model": ...}, loads; one that lacks a weight
    raises."""
    src = random_init_(STGCN(12, 8, layout="smplx", **REDUCED), torch.Generator().manual_seed(0))
    sd = dict(src.state_dict())
    sd["A"] = src.A.clone()
    path = tmp_path / "checkpoint_0100.pth.tar"
    torch.save({"model": sd}, path)
    dst = checkpoint.load_classifier_state(STGCN(12, 8, layout="smplx", **REDUCED), str(path))
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    del sd["fcn.bias"]
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.load_classifier_state(STGCN(12, 8, layout="smplx", **REDUCED), sd)


def test_random_init_is_seeded():
    a, b, c = (random_init_(STGCN(12, 8, layout="smpl", **REDUCED),
                            torch.Generator().manual_seed(s)) for s in (4, 4, 5))
    x = torch.randn(2, 25, 12, 16)
    with torch.no_grad():
        ya, yb, yc = (m.eval()(x)["yhat"] for m in (a, b, c))
    torch.testing.assert_close(ya, yb, rtol=0, atol=0)
    assert not torch.equal(ya, yc)
