"""PyTorch model blocks against their flax counterparts on converted
weights, and the flax -> state_dict converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
from vae_teb_tpu.models import blocks as jb
from vae_teb_tpu_torch.convert import (flax_to_state_dict, load_flax_variables,
                                       to_torch_layout, torch_key)
from vae_teb_tpu_torch.models import SeqVaeTeb, blocks as tb

torch.set_num_threads(2)

# fp32 on both sides; only summation order differs
RTOL, ATOL = 1e-5, 1e-5


def _randomize(variables, seed):
    """Every leaf replaced by seeded numpy values (variances positive), so
    each converted parameter and running statistic matters."""
    r = np.random.default_rng(seed)

    def leaf(path, x):
        v = r.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return np.abs(v) + 0.5
        return 0.5 * v

    return jax.tree_util.tree_map_with_path(leaf, variables)


def _run_pair(flax_module, torch_module, x, seed, **apply_kw):
    """Init the flax module, randomize and convert its variables into the
    torch module, and return both outputs on x as numpy."""
    variables = _randomize(flax_module.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), **apply_kw), seed)
    want = np.asarray(flax_module.apply(variables, jnp.asarray(x), **apply_kw))
    load_flax_variables(torch_module, variables).eval()   # flax train=False
    with torch.no_grad():
        got = torch_module(torch.as_tensor(x)).numpy()
    return got, want


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_geometric_schedule_matches_jax():
    for args in [(43, 16, 4), (44, 16, 4), (130, 32, 5), (64, 32, 8),
                 (32, 32, 32), (32, 50, 5), (50, 87, 5), (64, 32, 5)]:
        assert tb.geometric_schedule(*args) == jb.geometric_schedule(*args)


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("final,skip,in_f", [(False, True, 20), (True, True, 12),
                                             (False, False, 20), (True, True, 16)])
@pytest.mark.parametrize("scale", [1.0, 1e-3])
def test_residual_mlp(act, final, skip, in_f, scale):
    """Covers the skip projection (widths differ), the identity skip, no
    skip, gelu's tanh form and LayerNorm's eps (1e-6: inputs of scale 1e-3
    have variance 1e-6, where torch's default 1e-5 would show)."""
    dims = (18, 16)
    f_act, t_act = {"gelu": (nn.gelu, tb.gelu), "relu": (nn.relu, F.relu)}[act]
    got, want = _run_pair(
        jb.ResidualMLP(dims, final_activation=final, activation=f_act,
                       use_skip_connection=skip),
        tb.ResidualMLP(in_f, dims, final_activation=final, activation=t_act,
                       use_skip_connection=skip),
        _x((2, 5, in_f), 1, scale), seed=2)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [3, 7])
def test_causal_conv1d(k):
    got, want = _run_pair(jb.CausalConv1d(6, k, use_bias=False),
                          tb.CausalConv1d(4, 6, k), _x((2, 9, 4), 3), seed=4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_causal_conv_block(k):
    """Eval mode: BatchNorm on (randomized) running statistics."""
    got, want = _run_pair(jb.CausalConvBlock(6, k), tb.CausalConvBlock(4, 6, k),
                          _x((2, 9, 4), 5), seed=6, train=False)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s,k,up", [(12, 5, False), (12, 11, True),
                                    (2, 5, False),    # S <= p: edge
                                    (1, 3, True),     # S <= p: edge
                                    (3, 3, False)])
def test_reflect_conv_block(s, k, up):
    got, want = _run_pair(jb.ReflectConvBlock(6, k, up_sampling=up),
                          tb.ReflectConvBlock(4, 6, k, up_sampling=up),
                          _x((2, s, 4), 7), seed=8, train=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_linear_upsample_matches_jax():
    x = _x((2, 7, 3), 9)
    want = np.asarray(jb.linear_upsample(jnp.asarray(x), 2))
    got = tb.linear_upsample(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def small_flax_tree():
    """The full flax variable tree of a small SeqVaeTeb (from eval_shape:
    no compile), filled with seeded values."""
    m = JaxSeqVaeTeb(lstm_hidden_dim=8, lstm_num_layers=2)
    S = 4
    shapes = jax.eval_shape(lambda: m.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        jnp.zeros((1, S, 43)), jnp.zeros((1, S, 44)), jnp.zeros((1, S, 130)),
        train=False))
    tree = _randomize(shapes, 10)
    return jax.tree_util.tree_map(np.asarray, tree), S


def _port_model(S):
    return SeqVaeTeb(lstm_hidden_dim=8, lstm_num_layers=2, seq_len=S)


def _leaves(tree):
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree[coll]):
            yield tuple(p.key for p in path), leaf


def test_convert_round_trip_and_coverage(small_flax_tree):
    """Every flax leaf lands, unchanged up to layout, in exactly one model
    entry, and every model entry receives a leaf."""
    tree, S = small_flax_tree
    model = load_flax_variables(_port_model(S), tree)
    sd = model.state_dict()
    keys = set()
    for path, leaf in _leaves(tree):
        key = torch_key(path)
        keys.add(key)
        np.testing.assert_array_equal(sd[key].numpy(),
                                      to_torch_layout(path[-1], leaf))
    assert keys == set(sd)
    # spot-check the layout rules
    k = tree["params"]["decoder"]["conv_0"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.conv_0.conv.weight"].numpy(),
                                  k.transpose(2, 1, 0))
    d = tree["params"]["decoder"]["output_mu"]["Dense_1"]["kernel"]
    np.testing.assert_array_equal(sd["decoder.output_mu.dense.1.weight"].numpy(),
                                  d.T)
    v = tree["batch_stats"]["source_encoder"]["conv_2"]["BatchNorm_0"]["var"]
    np.testing.assert_array_equal(
        sd["source_encoder.conv_2.bn.running_var"].numpy(), v)
    w = tree["params"]["target_encoder"]["lstm"]["w_ih_1"]
    np.testing.assert_array_equal(sd["target_encoder.lstm.w_ih_1"].numpy(), w)


def test_convert_fails_loudly(small_flax_tree):
    tree, S = small_flax_tree
    model = _port_model(S)
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["params"]["decoder"]["linear_0"]["skip_proj"]
    with pytest.raises(KeyError, match="skip_proj"):
        flax_to_state_dict(missing, model)
    extra = jax.tree_util.tree_map(lambda a: a, tree)
    extra["params"]["decoder"]["linear_0"]["Dense_9"] = {
        "kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(KeyError, match="Dense_9"):
        flax_to_state_dict(extra, model)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["params"]["source_encoder"]["lstm"]["w_hh_0"] = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError, match="w_hh_0"):
        flax_to_state_dict(bad, model)
