"""The port's training step against the JAX package at a small size:
train-mode BatchNorm and the conv blocks around it, the clipped AdamW chain
against optax, the schedules, the model's loss and every parameter gradient
on weights converted from the flax init, and three Trainer steps against
the JAX Trainer with the same noise.

Noise: jax.random and torch.Generator differ, so the sampled tests hand the
port the JAX draw of eps (the JAX model's own make_rng("sample") key,
replayed through `apply(method=...)`), which the port's forward and
train_step take as `eps`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
from vae_teb_tpu.models import blocks as jb
from vae_teb_tpu.parallel import data_parallel_mesh
from vae_teb_tpu.train import schedules as js
from vae_teb_tpu.train.trainer import Trainer as JaxTrainer
from vae_teb_tpu.train.trainer import TrainState
from vae_teb_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
from vae_teb_tpu_torch.convert import load_flax_variables, to_torch_layout, torch_key
from vae_teb_tpu_torch.models import blocks as tb
from vae_teb_tpu_torch.models import compute_loss
from vae_teb_tpu_torch.train import (beta_schedule, cosine_warm_restarts,
                                     make_optimizer)

torch.set_num_threads(2)

FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")


def _x(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _flat(tree):
    """(path tuple, numpy leaf) of a nested dict of arrays."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        yield tuple(p.key for p in path), np.asarray(leaf)


def _assert_tree_matches(module, tree, kind, rel, what):
    """Every leaf of the flax `tree` (params, grads or batch_stats) against
    the module's counterpart: max-abs <= rel * max|flax leaf|, or
    rel(max|flax leaf|) when rel is a function."""
    bar = rel if callable(rel) else (lambda scale: rel * scale)
    named = dict(module.named_parameters())
    named.update(module.named_buffers())
    n = 0
    for path, want in _flat(tree):
        key = torch_key(path)
        t = named[key]
        got = (t.grad if kind == "grad" else t).detach().numpy()
        want = to_torch_layout(path[-1], want)
        assert got.shape == want.shape, key
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got - want).max()
        assert err <= bar(scale), f"{what} {key}: {err} > {bar(scale)}"
        n += 1
    return n


# ---------------------------------------------------------------------------
# train-mode BatchNorm and the conv blocks
# ---------------------------------------------------------------------------

def _train_pair(flax_module, torch_module, x, seed):
    """One train-mode application on both sides from the same randomized
    variables: (torch output, flax output, flax updated batch_stats)."""
    variables = flax_module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    r = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, v: (np.abs(r.standard_normal(v.shape)) + 0.5
                      if p[-1].key == "var" else 0.5 * r.standard_normal(v.shape)
                      ).astype(np.float32), variables)
    want, upd = flax_module.apply(variables, jnp.asarray(x),
                                  mutable=["batch_stats"])
    load_flax_variables(torch_module, variables).train()
    got = torch_module(torch.as_tensor(x))
    return got.detach().numpy(), np.asarray(want), upd["batch_stats"]


@pytest.mark.parametrize("shape,scale,shift", [((3, 11, 6), 1.0, 0.0),
                                               ((2, 5, 4), 0.3, 1.0)])
def test_batch_norm_train_mode(shape, scale, shift):
    """Batch mean and biased variance E[x^2] - E[x]^2 over (B, S) and the
    running update 0.1 * running + 0.9 * batch, as flax with momentum 0.1
    (the second case has a mean three times its spread). rtol 1e-5 (fp32,
    only reduction order differs)."""
    x = _x(shape, 1, scale, shift)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=jb.BN_MOMENTUM)
    got, want, stats = _train_pair(flax_bn, tb.BatchNorm(shape[-1]), x, 2)
    atol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)
    bn = tb.BatchNorm(shape[-1])
    load_flax_variables(bn, flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    bn.train()(torch.as_tensor(x))
    flax_stats = flax_bn.apply(
        flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x),
        mutable=["batch_stats"])[1]["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(flax_stats["mean"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(flax_stats["var"]), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("block", ["causal", "reflect", "reflect_up"])
def test_conv_blocks_train_mode(block):
    """Outputs and updated batch_stats of CausalConvBlock and
    ReflectConvBlock in train mode against flax mutable=["batch_stats"]:
    rtol 1e-5 (fp32)."""
    flax_module, torch_module = {
        "causal": (jb.CausalConvBlock(6, 5), tb.CausalConvBlock(4, 6, 5)),
        "reflect": (jb.ReflectConvBlock(6, 5), tb.ReflectConvBlock(4, 6, 5)),
        "reflect_up": (jb.ReflectConvBlock(6, 3, up_sampling=True),
                       tb.ReflectConvBlock(4, 6, 3, up_sampling=True)),
    }[block]
    got, want, stats = _train_pair(flax_module, torch_module, _x((2, 9, 4), 3),
                                   4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert _assert_tree_matches(torch_module, stats, "buffer", 1e-5,
                                "batch_stats") == 2


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment", ["fp32", "bf16"])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-3])   # clipped / unclipped
@pytest.mark.parametrize("t0", [0, 3])                # constant lr / cosine
def test_optimizer_matches_optax(moment, grad_scale, t0):
    """make_optimizer against the JAX package's make_optimizer (the flat-
    packed optax chain) for 5 steps, as tests/test_train.py::
    test_adam_moment_dtype drives it: gradients sin(p * (i + 1)) *
    grad_scale, whose global norm is ~30 (clipped to 0.5) or ~0.03 (left
    alone). Parameters within 1e-6 absolute (fp32 moments: the same
    elementwise arithmetic, the norm summed in another order) or 2e-6 (bf16
    moments: a moment rounded to the other side of a bf16 tie moves that
    element's step by up to 2^-8 of lr)."""
    r = np.random.default_rng(0)
    params = {"a": r.standard_normal((64, 32)).astype(np.float32),
              "b": r.standard_normal((7,)).astype(np.float32)}
    lr = 1e-3
    j_lr = js.cosine_warm_restarts(lr, t0) if t0 else lr
    t_lr = cosine_warm_restarts(lr, t0) if t0 else lr
    tx = js.make_optimizer(j_lr, 0.5, 1e-4, moment_dtype=(
        jnp.bfloat16 if moment == "bf16" else None))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    s = tx.init(p)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = make_optimizer(list(tp.values()), t_lr, 0.5, 1e-4, moment_dtype=(
        torch.bfloat16 if moment == "bf16" else None))
    import optax
    for i in range(5):
        g = jax.tree.map(lambda x: jnp.sin(x * (i + 1)) * grad_scale, p)
        for k in tp:
            tp[k].grad = torch.as_tensor(np.array(g[k]))
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        u, s = tx.update(g, s, p)
        p = optax.apply_updates(p, u)
    atol = 2e-6 if moment == "bf16" else 1e-6
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(p[k]),
                                   rtol=0, atol=atol)
    if moment == "bf16":
        assert opt.state[tp["a"]]["mu"].dtype == torch.bfloat16
        assert opt.state[tp["a"]]["nu"].dtype == torch.bfloat16


def test_schedules_match_jax():
    """beta_schedule per epoch (exact: the same double arithmetic) and
    cosine_warm_restarts per step (rtol 1e-6: both evaluate in fp32)."""
    for args in [("linear", 0.0, 1.0, 10, 1000, 1.0),
                 ("cyclic", 0.1, 0.9, 100, 7, 1.0),
                 ("constant", 0.0, 1.0, 100, 1000, 1e-5)]:
        got, want = beta_schedule(*args), js.beta_schedule(*args)
        for epoch in range(0, 25, 3):
            assert got(epoch) == want(epoch), (args, epoch)
    with pytest.raises(ValueError):
        beta_schedule("sigmoid")
    for t0, ratio in [(7, 0.01), (1, 0.5), (0, 0.01)]:
        got, want = cosine_warm_restarts(3e-4, t0, ratio), \
            js.cosine_warm_restarts(3e-4, t0, ratio)
        for step in range(20):
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


# ---------------------------------------------------------------------------
# the model and the train step
# ---------------------------------------------------------------------------

S, B = 8, 3
SMALL = dict(lstm_hidden_dim=8, lstm_num_layers=2)


def _batch(seed, b=B):
    return {"fhr_st": _x((b, S, 43), seed), "fhr_ph": _x((b, S, 44), seed + 1),
            "fhr_up_ph": _x((b, S, 130), seed + 2),
            "fhr": _x((b, 16 * S), seed + 3)}


@pytest.fixture(scope="module")
def small_pair():
    """The JAX small model (wavefront_pallas schedule: its LSTMs run the
    Pallas kernels, in interpret mode here) and a flax variable tree holding
    the port's seeded initialization (the tree's structure from eval_shape,
    so nothing compiles)."""
    jm = JaxSeqVaeTeb(**SMALL, lstm_schedule="wavefront_pallas")
    zeros = [jnp.zeros((1, S, c)) for c in (43, 44, 130)]
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        *zeros, train=False))
    sd = init_parameters(SeqVaeTeb(**SMALL, seq_len=S), seed=1).state_dict()
    variables = jax.tree_util.tree_map_with_path(
        lambda path, _: to_torch_layout(path[-1].key, sd[torch_key(
            tuple(p.key for p in path[1:]))].numpy()), shapes)
    return jm, variables


def _port_model(variables):
    return load_flax_variables(SeqVaeTeb(**SMALL, seq_len=S), variables)


def _grad_bar(grads):
    """Per-leaf bar for gradient comparisons: 1e-4 of the leaf's largest
    entry, or 1e-6 of the largest entry of any leaf (about 8 fp32 ulps at
    the model's gradient scale), whichever is larger. The floor is for
    leaves whose gradient cancels: the decoder's last BatchNorm feeds the
    heads through a row LayerNorm that makes its scale and (up to the ReLU)
    its shift invariant, so their gradients are sums that cancel to ~1e-10
    and ~1e-3 of the largest and carry the rounding of their terms."""
    top = max(np.abs(np.asarray(leaf)).max() for _, leaf in _flat(grads))
    return lambda scale: max(1e-4 * scale, 1e-6 * top)


# XLA compiles bf16 with excess precision by default: it computes a fused
# chain of bf16 operations in float32 and rounds once, at the fusion's end.
# PyTorch rounds every operation's result to bf16, as JAX does when it runs
# eagerly. The JAX side of the bf16 comparisons is compiled without excess
# precision, so that both sides round at the same points.
STRICT_BF16 = {"xla_allow_excess_precision": False}


def _jax_eps(jm, variables, key, shape, dtype=jnp.float32):
    """The standard-normal draw SeqVaeTeb.__call__ takes from
    make_rng("sample") under rngs={"sample": key}, in the compute dtype,
    as float32 numpy."""
    return np.asarray(jm.apply(variables, rngs={"sample": key}, method=(
        lambda m: jax.random.normal(m.make_rng("sample"), shape, dtype))),
        np.float32)


def _global_norm(leaves):
    return float(np.sqrt(sum((np.asarray(leaf, np.float64) ** 2).sum()
                             for leaf in leaves)))


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_model_loss_and_grads_match_jax(small_pair, precision):
    """Train-mode forward with sampled z, the ELBO and every parameter
    gradient against jax.value_and_grad of the JAX model on the same
    weights, coefficients and eps.

    fp32: losses rtol 1e-5; each gradient leaf within 1e-4 of its largest
    entry (fp32 through ~60 layers and a 9-step recurrence and its reverse;
    summation orders differ everywhere; the worst other leaf measured
    4e-5), see `_grad_bar` for the floor. The updated batch_stats within
    1e-5 of their largest entry.

    bf16 (SeqVaeTeb(dtype=bf16) on both sides, the JAX step compiled with
    STRICT_BF16, the noise drawn in bf16), on a batch whose forward the two
    round identically: every output is asserted equal bit for bit. (On
    other batches a bf16 product whose float32 sum lies at a rounding
    boundary rounds a ulp apart, because PyTorch and XLA sum in other
    orders; the target encoder's 33-layer mu_layer and the heads' row
    LayerNorm amplify that ulp.) So what is compared below is the
    backward's own rounding. Bars, with measured values: losses rtol 1e-6
    (2.1e-7); each gradient leaf within 1.5e-1 of its largest entry (worst
    8.7e-2, in the mu_layer's middle layers; the wavefront LSTM's leaves
    2.6e-2; the median leaf 1.4e-2) and within 1e-1 relative L2 (worst
    7.2e-2); the global gradient norm rtol 1e-2 (188.47 against 188.98,
    2.7e-3); batch_stats within 1e-5 of their largest entry (1.9e-6).

    The witness that rounding points, not the port, parted the bf16
    gradient norms of the trajectory test before: the same JAX function
    compiled with XLA's defaults (excess precision on) gives a gradient
    norm more than 1e-1 away from the strict compile's (130.20 against
    188.98, 31%)."""
    jm, variables = small_pair
    bf16 = precision == "bf16"
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:
        jm = JaxSeqVaeTeb(**SMALL, lstm_schedule="wavefront_pallas",
                          dtype=dtype)
    batch = _batch(30 if bf16 else 20)
    key = jax.random.PRNGKey(5)
    beta = 0.3
    cols = [jnp.asarray(batch[k]) for k in FIELDS]

    def loss_fn(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            *cols[:3], train=True, rngs={"sample": key},
                            mutable=["batch_stats"])
        losses = jm.compute_loss(out, *cols[:2], cols[3], beta=beta)
        return losses["total_loss"], (losses, out, upd["batch_stats"])

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, (want, out_j, stats)), grads = step.lower(variables["params"]).compile(
        STRICT_BF16 if bf16 else None)(variables["params"])
    eps = _jax_eps(jm, variables, key, out_j["z"].shape, dtype)
    z = (out_j["mu_post"] + jnp.asarray(eps, dtype) * jnp.exp(
        0.5 * out_j["logvar_post"]))      # eagerly, in the compute dtype
    np.testing.assert_allclose(   # the replayed draw is the model's draw
        np.asarray(z, np.float32), np.asarray(out_j["z"], np.float32),
        rtol=1e-6, atol=1e-6)

    model = load_flax_variables(SeqVaeTeb(
        **SMALL, seq_len=S, dtype=torch.bfloat16 if bf16 else None),
        variables).train()
    t = [torch.as_tensor(batch[k]) for k in FIELDS]
    out = model(*t[:3], deterministic=False, eps=torch.tensor(eps))
    got = compute_loss(out, *t[:2], t[3], beta=beta)
    got["total_loss"].backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-6 if bf16 else 1e-5)
    n_params = sum(1 for _ in model.parameters())
    _assert_tree_matches(model, stats, "buffer", 1e-5, "batch_stats")
    if not bf16:
        n = _assert_tree_matches(model, grads, "grad", _grad_bar(grads),
                                 "grad")
        assert n == n_params
        return
    for k in out_j:
        assert torch.equal(out[k].detach(),
                           torch.as_tensor(np.asarray(out_j[k], np.float32))
                           .to(torch.bfloat16)), k
    assert _assert_tree_matches(model, grads, "grad", 1.5e-1, "grad") \
        == n_params
    named = dict(model.named_parameters())
    for path, w in _flat(grads):
        key_ = torch_key(path)
        w = to_torch_layout(path[-1], w)
        d = named[key_].grad.numpy() - w
        assert np.linalg.norm(d) <= 1e-1 * np.linalg.norm(w), key_
    norm = _global_norm(leaf for _, leaf in _flat(grads))
    np.testing.assert_allclose(
        _global_norm(p.grad.numpy() for p in model.parameters()), norm,
        rtol=1e-2)
    _, default = step(variables["params"])
    assert abs(_global_norm(jax.tree_util.tree_leaves(default)) / norm - 1) \
        > 1e-1


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_steps_match_jax_trainer(small_pair, precision):
    """Trainer.train_step calls against steps of the JAX Trainer (one-device
    mesh, default lr 1e-4) from the same weights, with the JAX noise, then
    eval_step.

    fp32: three steps on three batches. Bars, with their reasons:

    - every loss at every step, and eval_step's: rtol 1e-4 (measured 7e-6);
    - grad_norm: rtol 1e-4 at step 1 (measured 5e-6), 1e-2 after it. At
      B * S = 24 positions a ReLU whose input lies within rounding of 0
      can fall on either side, and one flip moves a gradient by ~1/24;
      this happened at step 3 (2.6e-3). test_model_loss_and_grads_match_jax
      holds the gradients themselves;
    - parameters: Adam steps each element by ~lr * sign(g), so an element
      whose gradient is rounding noise, or is moved by such a flip, can step
      the other way (up to 2 * lr apart; measured 1.3 * lr). Held instead:
      the share of elements more than lr / 100 apart <= 2e-2 (measured
      6.1e-3) and the relative L2 of the difference over the update <= 2e-2
      (measured 2.8e-3);
    - running statistics within 1e-4 of the leaf's largest entry
      (measured 3.6e-5).

    bf16 (the production policy: SeqVaeTeb(dtype=bf16) on both sides, bf16
    Adam moments, the noise drawn in bf16, lr 1e-3, the JAX steps compiled
    with STRICT_BF16): four steps on one batch, from a seed whose first
    draw the two forwards round identically (seed 3's draw puts a decoder
    product at a bf16 rounding boundary, see
    test_model_loss_and_grads_match_jax, which moves the first grad_norm by
    5e-2). Bars, with measured values:

    - step 1: every loss rtol 1e-6 (measured 2.1e-7), grad_norm rtol 1e-2
      (119.17 against 119.54, 3.1e-3);
    - step 2: every loss rtol 2e-2 (4.1e-3), grad_norm rtol 1e-1 (2.7e-2);
    - steps 3 and 4 and eval_step: the total loss within 1e-1 (measured
      5.5e-2), the other metrics finite, and the total loss falls over the
      four steps on both sides (3.328 -> 2.875 and 3.328 -> 2.970). Adam's
      first step moves every element by ~lr * sign(g), and an element whose
      bf16 gradient is within rounding of 0 steps either way, so the two
      runs' parameters part from the first update on (after four steps 95%
      of the elements are more than lr / 100 apart, and the difference is
      0.73 of the update in relative L2); by step 3 the gradient norms
      differ by 0.55. test_model_loss_and_grads_match_jax holds the bf16
      gradients leaf by leaf.
    """
    jm, variables = small_pair
    bf16 = precision == "bf16"
    if bf16:
        jm = JaxSeqVaeTeb(**SMALL, lstm_schedule="wavefront_pallas",
                          dtype=jnp.bfloat16)
    cfg = dict(seed=4 if bf16 else 3, precision=precision,
               moment_dtype=precision, lr=1e-3 if bf16 else 1e-4)
    jt = (JaxTrainer(jm, JaxTrainerConfig(**cfg, prefetch=0),
                     mesh=data_parallel_mesh(devices=jax.devices("cpu")[:1]))
          if bf16 else _jax_trainer(jm, cfg))
    batches = ([_batch(30)] * 4 if bf16
               else [_batch(30 + 10 * i) for i in range(3)])
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]),
                       rng=jax.random.PRNGKey(cfg["seed"]))
    model = load_flax_variables(
        SeqVaeTeb(**SMALL, seq_len=S,
                  dtype=torch.bfloat16 if bf16 else None), variables)
    trainer = Trainer(model, TrainerConfig(**cfg), device="cpu")
    if bf16:
        args = (state, *jt._put(batches[0]).values(), 1e-5)
        jt._train_step = jt._train_step.lower(*args).compile(STRICT_BF16)
        jt._eval_step = jt._eval_step.lower(*args).compile(STRICT_BF16)
    totals = []
    for step, batch in enumerate(batches):
        sample_key = jax.random.split(state.rng)[1]
        eps = _jax_eps(jm, {"params": state.params}, sample_key, (B, S, 32),
                       jnp.bfloat16 if bf16 else jnp.float32)
        state, want = jt.train_step(state, batch, 1e-5)
        got = trainer.train_step(batch, 1e-5, eps=torch.tensor(eps))
        assert set(got) == set(want)
        for k in want:
            if bf16:
                rtol = ([{"grad_norm": 1e-2}.get(k, 1e-6),
                         {"grad_norm": 1e-1}.get(k, 2e-2)][step] if step < 2
                        else {"total_loss": 1e-1}.get(k))
            else:
                rtol = 1e-2 if k == "grad_norm" and step else 1e-4
            assert np.isfinite(got[k].item())
            if rtol is not None:
                np.testing.assert_allclose(got[k].item(), float(want[k]),
                                           rtol=rtol,
                                           err_msg=f"{k}, step {step}")
        totals.append((got["total_loss"].item(), float(want["total_loss"])))
    want = jt.eval_step(state, batches[0], 1e-5)
    got = trainer.eval_step(batches[0], 1e-5)
    for k in (("total_loss",) if bf16 else want):
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   rtol=1e-1 if bf16 else 1e-4)
    if bf16:
        assert all(np.isfinite(v.item()) for v in got.values())
        assert totals[-1][0] < totals[0][0] and totals[-1][1] < totals[0][1]
        return
    _assert_fp32_state_close(model, state, variables)


def _param_distance(got, want, start):
    """(share of elements more than lr / 100 apart, relative L2 of the
    difference over want's update from start) of two flax param trees."""
    lr = TrainerConfig().lr
    n = far = num = den = 0
    for (_, a), (_, b), (_, s0) in zip(_flat(got), _flat(want), _flat(start)):
        d = a - b
        n += d.size
        far += int((np.abs(d) > lr / 100).sum())
        num += float((d * d).sum())
        den += float(((b - s0) ** 2).sum())
    return far / n, (num / den) ** 0.5


def _port_params(model, like):
    """The module's parameters as a flax tree shaped as `like`."""
    named = dict(model.named_parameters())
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: to_torch_layout(path[-1].key, named[torch_key(
            tuple(p.key for p in path))].detach().numpy()), like)


def _assert_fp32_state_close(model, state, variables):
    """The fp32 trajectory bars of test_train_steps_match_jax_trainer on the
    state after the steps: the share of parameter elements more than lr /
    100 apart <= 2e-2 and the relative L2 of the difference over the update
    <= 2e-2; running statistics within 1e-4 of the leaf's largest entry."""
    far, l2 = _param_distance(_port_params(model, state.params), state.params,
                              variables["params"])
    assert far <= 2e-2 and l2 <= 2e-2
    _assert_tree_matches(model, state.batch_stats, "buffer", 1e-4,
                         "batch_stats")


_JAX_TRAINERS = {}


def _jax_trainer(jm, cfg):
    """The JAX Trainer of an fp32 config on the one-device CPU mesh, one per
    config and process, so the tests that share it compile its per-step
    program once."""
    key = tuple(sorted(cfg.items()))
    if key not in _JAX_TRAINERS:
        _JAX_TRAINERS[key] = JaxTrainer(
            jm, JaxTrainerConfig(**cfg, prefetch=0),
            mesh=data_parallel_mesh(devices=jax.devices("cpu")[:1]))
    return _JAX_TRAINERS[key]


def test_train_multi_step_matches_jax_trainer(small_pair):
    """Trainer.train_multi_step over a (3, B, ...) stack of the three batches
    of test_train_steps_match_jax_trainer's fp32 case, from the same weights
    and seed, against the JAX Trainer's train_multi_step (one lax.scan
    dispatch of the step on the one-device mesh, default lr 1e-4), with the
    JAX noise of each step (the scan splits the state's key as the per-step
    program does, so each draw is replayed from the key chain).

    That test's bars: every loss at every step rtol 1e-4, grad_norm rtol
    1e-4 at step 1 and 1e-2 after it; the step count 3 on both sides. The
    state after the three steps is held at that test's bars (share of
    parameter elements more than lr / 100 apart <= 2e-2, relative L2 of
    the difference over the update <= 2e-2, running statistics within 1e-4
    of the leaf's largest entry) against the JAX per-step program's
    trajectory (its three train_step calls). Against the scan, whose third
    step meets a ReLU kink on the other side from JAX's own per-step
    program (grad_norm 80.43 against 80.90; the two JAX programs' states
    are 22% of elements and 9.5e-3 relative L2 apart), the port's state
    is held to no further from the scan than the JAX per-step program is,
    plus those bars (measured: 21.8% and 9.7e-3), and the running
    statistics within 1e-4."""
    jm, variables = small_pair
    cfg = dict(seed=3, precision="fp32", moment_dtype="fp32", lr=1e-4)
    jt = _jax_trainer(jm, cfg)
    batches = [_batch(30 + 10 * i) for i in range(3)]

    def start():
        return TrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=jt.tx.init(variables["params"]),
                          rng=jax.random.PRNGKey(cfg["seed"]))

    rng, eps = start().rng, []
    for _ in batches:
        rng, key = jax.random.split(rng)
        eps.append(_jax_eps(jm, variables, key, (B, S, 32)))
    stacked = {k: np.stack([b[k] for b in batches]) for k in FIELDS}
    model = load_flax_variables(SeqVaeTeb(**SMALL, seq_len=S), variables)
    trainer = Trainer(model, TrainerConfig(**cfg, steps_per_execution=3),
                      device="cpu")
    state, want = jt.train_multi_step(start(), stacked, 1e-5)
    per_step = start()
    for batch in batches:
        per_step, _ = jt.train_step(per_step, batch, 1e-5)
    got = trainer.train_multi_step(stacked, 1e-5,
                                   eps=torch.tensor(np.stack(eps)))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.shape(want[k]) == (3,)
        for step in range(3):
            rtol = 1e-2 if k == "grad_norm" and step else 1e-4
            np.testing.assert_allclose(got[k][step].item(),
                                       float(want[k][step]), rtol=rtol,
                                       err_msg=f"{k}, step {step}")
    assert int(state.step) == trainer.step == 3
    _assert_fp32_state_close(model, per_step, variables)
    port = _port_params(model, state.params)
    far, l2 = _param_distance(port, state.params, variables["params"])
    jax_far, jax_l2 = _param_distance(per_step.params, state.params,
                                      variables["params"])
    assert far <= jax_far + 2e-2 and l2 <= jax_l2 + 2e-2
    _assert_tree_matches(model, state.batch_stats, "buffer", 1e-4,
                         "batch_stats")


def test_trainer_config_precision_knob():
    """precision "bf16" is the bf16 policy and "fp32" the float32 path; an
    unknown precision or moment dtype raises ValueError, as the JAX
    package's test_trainer_config_precision_knob asks; so does a model
    whose compute dtype is not the config's."""
    assert TrainerConfig(precision="bf16").model_dtype() == torch.bfloat16
    assert TrainerConfig(precision="fp32").model_dtype() is None
    with pytest.raises(ValueError):
        TrainerConfig(precision="fp8").model_dtype()
    with pytest.raises(ValueError, match="precision"):
        Trainer(SeqVaeTeb(**SMALL, seq_len=S), TrainerConfig(precision="fp8"),
                device="cpu")
    with pytest.raises(ValueError, match="moment_dtype"):
        Trainer(SeqVaeTeb(**SMALL, seq_len=S), TrainerConfig(moment_dtype="fp8"),
                device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        Trainer(SeqVaeTeb(**SMALL, seq_len=S), TrainerConfig(precision="bf16"),
                device="cpu")


def test_train_step_uses_the_generator():
    """Without eps, the step draws z's noise from the trainer's generator:
    two trainers with the same seed take identical steps."""
    torch.manual_seed(0)
    ref = init_parameters(SeqVaeTeb(**SMALL, seq_len=S), seed=1)
    runs = []
    for _ in range(2):
        model = SeqVaeTeb(**SMALL, seq_len=S)
        model.load_state_dict(ref.state_dict())
        trainer = Trainer(model, TrainerConfig(seed=7), device="cpu")
        m = trainer.train_step(_batch(40), 1e-5)
        runs.append((m["total_loss"].item(),
                     [p.detach().clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_entry_points_default_to_the_card(monkeypatch):
    """Trainer and InferenceServer run on the CUDA card unless the caller
    names another device: without a card the default raises (nothing
    falls back to the CPU), and device="cpu" runs on the CPU."""
    from vae_teb_tpu_torch import InferenceServer, PhaseScattering1D
    from vae_teb_tpu_torch.device import resolve_device
    model = SeqVaeTeb(**SMALL, seq_len=S)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, TrainerConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(model, PhaseScattering1D(6, 2, 8, 1024, max_order=1,
                                                 reduced_rate=True))
    trainer = Trainer(model, TrainerConfig(), device="cpu")
    assert trainer.device == torch.device("cpu")
    assert all(p.device.type == "cpu" for p in trainer.model.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
