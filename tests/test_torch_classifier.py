"""The classifier slice against the JAX package on the CPU: the
cross-entropy loss, InceptionTimeClassifier with and without attention,
SeqVaeTebClassifier frozen and joint (outputs, losses, gradients), one
ClassifierTrainer step against the JAX trainer's (the frozen VAE moving by
optax's decay alone), transfer_params, train_and_test_folds, the
classification metrics, and prediction_accuracy_test on the predict-st
model.

Inputs come from numpy seeds; weights are the port's seeded init in a
flax tree (structure from `eval_shape`), loaded on the port's side with
`load_flax_variables`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_teb_tpu.eval import classification as jcls
from vae_teb_tpu.models import inception_time as jit_
from vae_teb_tpu.models import variants as jv
from vae_teb_tpu_torch import init_parameters
from vae_teb_tpu_torch.convert import load_flax_variables, to_torch_layout, torch_key
from vae_teb_tpu_torch.eval import classification as tcls
from vae_teb_tpu_torch.models import inception_time as tit
from vae_teb_tpu_torch.models import variants as tv
from vae_teb_tpu_torch.models.inception_time import dropout
from vae_teb_tpu_torch.train import (ClassifierConfig, ClassifierTrainer,
                                     train_and_test_folds, transfer_params)

torch.set_num_threads(2)

S = 16


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _flat(tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        yield tuple(p.key for p in path), np.asarray(leaf)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _flax_variables(jax_module, port_module, *args, **kwargs):
    """The port module's seeded init as a flax tree of jax_module's
    structure (from eval_shape: nothing compiles for init)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jax_module.init(
        {"params": key, "sample": key, "dropout": key},
        *map(jnp.asarray, args), **kwargs))
    sd = init_parameters(port_module, seed=4).state_dict()
    return jax.tree_util.tree_map_with_path(
        lambda path, _: to_torch_layout(
            path[-1].key, sd[torch_key(tuple(p.key for p in path[1:]))].numpy(),
            tuple(p.key for p in path[1:])), shapes)


def _grads_match(module, grads, what):
    """Every flax gradient leaf against the module's: within 1e-4 of the
    leaf's largest entry, or 1e-6 of the largest entry of any leaf
    (tests/test_torch_train.py's bar). Returns the count."""
    named = dict(module.named_parameters())
    top = max(np.abs(leaf).max() for _, leaf in _flat(grads))
    n = 0
    for path, want in _flat(grads):
        got = named[torch_key(path)].grad.numpy()
        want = to_torch_layout(path[-1], want, path)
        err = np.abs(got - want).max()
        bar = max(1e-4 * np.abs(want).max(), 1e-6 * top)
        assert err <= bar, f"{what} {path}: {err} > {bar}"
        n += 1
    return n


def test_cross_entropy_matches_jax():
    logits = _x((9, 4), 1)
    labels = np.random.default_rng(2).integers(0, 4, 9).astype(np.int32)
    want = float(jit_.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(labels)))
    got = tit.cross_entropy_loss(torch.as_tensor(logits),
                                 torch.as_tensor(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_dropout_masks():
    """flax's Dropout: kept elements scaled by 1 / (1 - rate), none dropped
    in eval mode; a broadcast mask shape drops the same (q, k) entries in
    every batch row and head (the attention's broadcast_dropout)."""
    x = torch.ones(3, 4, 5, 5)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(dropout(x, 0.5, False, g), x)
    y = dropout(x, 0.5, True, g, (1, 1, 5, 5))
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    assert (y == y[:1, :1]).all() and 0 < (y == 0).sum() < y.numel()


@pytest.mark.parametrize("attention", [True, False])
def test_inception_classifier_matches_jax(attention):
    """InceptionTimeClassifier (depth 6: two residual blocks; SAME convs
    k = 1 / 5 / 15 / 40, the k=40 one padded 19 / 20; the -inf max-pool
    branch; with attention, flax's SelfAttention over 4 heads) in train
    mode with dropout 0: logits within 1e-5 of their max, every gradient
    at tests/test_torch_train.py's bar, the updated running statistics
    within 1e-5 of their max; then eval mode's logits (fp32)."""
    jm = jit_.InceptionTimeClassifier(input_size=8, num_classes=3, filters=4,
                                      depth=6, dropout=0.0,
                                      use_attention=attention)
    model = tit.InceptionTimeClassifier(input_size=8, num_classes=3,
                                        filters=4, depth=6, dropout=0.0,
                                        use_attention=attention)
    x = _x((3, 20, 8), 3)
    variables = _flax_variables(jm, model, x, train=False)
    w = _x((3, 3), 4)

    def loss_fn(params):
        out, upd = jm.apply({"params": params,
                             "batch_stats": variables["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    model = load_flax_variables(model, variables).train()
    got = model(torch.as_tensor(x))
    (got * torch.as_tensor(w)).sum().backward()
    _close(got.detach().numpy(), want, 1e-5, "train logits")
    assert _grads_match(model, grads, "grad") == sum(
        1 for _ in model.parameters())
    named = dict(model.named_buffers())
    for path, leaf in _flat(stats):
        _close(named[torch_key(path)].numpy(), leaf, 1e-5, str(path))
    want = jax.jit(jm.apply, static_argnames="train")(
        {"params": variables["params"], "batch_stats": stats},
        jnp.asarray(x), train=False)
    with torch.no_grad():
        _close(model.eval()(torch.as_tensor(x)).numpy(), want, 1e-5,
               "eval logits")


def _cls_batch(seed, b=2, joint=False):
    batch = {"fhr_st": _x((b, S, 43), seed), "fhr_ph": _x((b, S, 44), seed + 1),
             "fhr_up_ph": _x((b, S, 130), seed + 2),
             "label": np.random.default_rng(seed + 3).integers(0, 2, b
                                                               ).astype(np.int32)}
    if joint:
        batch["fhr"] = _x((b, 16 * S), seed + 4)
    return batch


CLS = dict(classifier_depth=3, classifier_filters=8, classifier_dropout=0.0)


def test_seq_vae_teb_classifier_joint_matches_jax():
    """SeqVaeTebClassifier(freeze_vae=False) at S=16, B=2 (the JAX
    wrapper's full-size VAE), train mode with z the posterior mean:
    logits and the latent within 1e-5 of their max, CE + 0.1 * ELBO rtol
    1e-5, every gradient (the VAE's included) at tests/test_torch_train.
    py's bar (fp32). The frozen wrapper is held by
    test_classifier_trainer_step_matches_jax."""
    jm = jit_.SeqVaeTebClassifier(freeze_vae=False, **CLS)
    model = tit.SeqVaeTebClassifier(freeze_vae=False, seq_len=S, **CLS)
    batch = _cls_batch(5, joint=True)
    cols = [batch[k] for k in ("fhr_st", "fhr_ph", "fhr_up_ph")]
    variables = _flax_variables(jm, model, *cols, train=False)

    def loss_fn(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]},
                          *map(jnp.asarray, cols), train=True,
                          deterministic_latent=True, mutable=["batch_stats"])
        losses = jit_.SeqVaeTebClassifier.compute_loss(
            out, jnp.asarray(batch["label"]), jnp.asarray(cols[0]),
            jnp.asarray(cols[1]), jnp.asarray(batch["fhr"]),
            compute_vae_loss=True, vae_loss_weight=0.1)
        return losses["total_loss"], (losses, out)

    (_, (want, out_j)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    model = load_flax_variables(model, variables).train()
    t = [torch.as_tensor(c) for c in cols]
    out = model(*t, deterministic_latent=True)
    got = tit.SeqVaeTebClassifier.compute_loss(
        out, torch.as_tensor(batch["label"]), t[0], t[1],
        torch.as_tensor(batch["fhr"]), compute_vae_loss=True,
        vae_loss_weight=0.1)
    got["total_loss"].backward()
    for k in ("logits", "probabilities", "latent_z"):
        _close(out[k].detach().numpy(), out_j[k], 1e-5, k)
    np.testing.assert_array_equal(out["predictions"].numpy(),
                                  np.asarray(out_j["predictions"]))
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    assert _grads_match(model, grads, "grad") == sum(
        1 for _ in model.parameters())


def test_classifier_trainer_step_matches_jax(cpu_mesh_devices):
    """One ClassifierTrainer step against one step of the JAX trainer (a
    one-device mesh), frozen VAE, CE, lr 1e-3, on the same weights and
    the JAX draw of eps: metrics rtol 1e-5; the head's updated parameters
    as tests/test_torch_train.py holds Adam's first step (the share of
    elements more than lr / 100 apart <= 2e-2, the difference within 2e-2
    of the update in relative L2) and its running statistics within 1e-4
    of their max. (The attention's key bias has a zero gradient up to
    rounding, so Adam steps its elements either way: the share and the
    L2 are taken over the head's parameters together.) The frozen VAE's
    parameters move by optax's decay alone,
    p (1 - lr * weight_decay), within 2 fp32 ulps of JAX's and of that
    product; its running statistics do not move. torch.optim would not
    move them at all (no gradient)."""
    from vae_teb_tpu.parallel import data_parallel_mesh
    from vae_teb_tpu.train.classifier import ClassifierConfig as JaxConfig
    from vae_teb_tpu.train.classifier import ClassifierTrainer as JaxTrainer
    from vae_teb_tpu.train.trainer import TrainState

    lr, wd = 1e-3, 1e-4
    jm = jit_.SeqVaeTebClassifier(freeze_vae=True, **CLS)
    model = tit.SeqVaeTebClassifier(freeze_vae=True, seq_len=S, **CLS)
    batch = _cls_batch(7, b=4)
    cols = [batch[k] for k in ("fhr_st", "fhr_ph", "fhr_up_ph")]
    variables = _flax_variables(jm, model, *cols, train=False)
    jt = JaxTrainer(jm, JaxConfig(lr=lr, weight_decay=wd),
                    mesh=data_parallel_mesh(devices=cpu_mesh_devices[:1]))
    rng = jax.random.PRNGKey(9)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=jt.tx.init(variables["params"]), rng=rng)
    new_state, m_j = jt.train_step(state, batch)
    # the noise the JAX step drew: its sample key, through vae_model's
    # make_rng("sample")
    _, k_sample, _ = jax.random.split(rng, 3)
    eps = np.asarray(jm.apply(variables, rngs={"sample": k_sample}, method=(
        lambda m: jax.random.normal(m.vae_model.make_rng("sample"),
                                    (4, S, 32)))))

    model = load_flax_variables(model, variables)
    trainer = ClassifierTrainer(model, ClassifierConfig(lr=lr, weight_decay=wd),
                                device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m_t = trainer.train_step(batch, eps=torch.as_tensor(eps))
    for k in m_j:
        np.testing.assert_allclose(m_t[k].item(), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    sd = model.state_dict()
    far = n_head = d2 = u2 = 0
    for path, want in _flat({"params": new_state.params,
                             "batch_stats": new_state.batch_stats}):
        key = torch_key(path[1:])
        want = to_torch_layout(path[-1], want, path[1:])
        got, old = sd[key].numpy(), before[key].numpy()
        if path[1] == "vae_model":
            decayed = old * np.float32(1 - lr * wd) if path[0] == "params" \
                else old
            for ref in (want, decayed):
                np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=0,
                                           err_msg=key)
            if path[0] == "params" and np.any(old):
                assert not np.array_equal(got, old), key
        elif path[0] == "batch_stats":
            _close(got, want, 1e-4, key)
        else:   # summed over the head: the attention's key bias has a
            # zero gradient up to rounding, so Adam steps it either way
            diff, upd = got - want, want - old
            far += (np.abs(diff) > lr / 100).sum()
            n_head += diff.size
            d2 += np.square(diff, dtype=np.float64).sum()
            u2 += np.square(upd, dtype=np.float64).sum()
    assert far / n_head <= 2e-2
    assert np.sqrt(d2 / u2) <= 2e-2


def test_joint_mode_rejects_frozen_vae():
    model = tit.SeqVaeTebClassifier(classifier_depth=3, seq_len=S,
                                    lstm_hidden_dim=8, lstm_num_layers=2)
    with pytest.raises(ValueError, match="freeze_vae"):
        ClassifierTrainer(model, ClassifierConfig(vae_loss_weight=0.1),
                          device="cpu")
    with pytest.raises(ValueError, match="cls_num_list"):
        ClassifierTrainer(model, ClassifierConfig(loss="ldam"), device="cpu")


def test_transfer_params_matches_jax():
    """State-dict surgery against the JAX function on the same weights: a
    VAE into the classifier wrapper copies every parameter JAX copies
    (same values), plus the BatchNorm running statistics, which JAX's
    params-only tree does not hold; src_prefix / dst_prefix select
    subtrees; strict raises on a missing entry and on a shape mismatch."""
    from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
    from vae_teb_tpu.train.checkpoint import transfer_params as jax_transfer
    from vae_teb_tpu_torch.models import SeqVaeTeb

    small = dict(lstm_hidden_dim=8, lstm_num_layers=2)
    vae = SeqVaeTeb(seq_len=S, **small)
    cls = tit.SeqVaeTebClassifier(seq_len=S, **small, **CLS)
    cols = [_x((1, S, c), 10 + i) for i, c in enumerate((43, 44, 130))]
    v_vae = _flax_variables(JaxSeqVaeTeb(**small), vae, *cols, train=False)
    init_parameters(cls, seed=8)

    class _JaxCls(jit_.SeqVaeTebClassifier):   # the wrapper's small VAE
        def setup(self):
            self.vae_model = JaxSeqVaeTeb(latent_dim_z=self.latent_dim_z,
                                          **small)
            self.classifier = jit_.InceptionTimeClassifier(
                input_size=self.latent_dim_z, num_classes=self.num_classes,
                filters=self.classifier_filters, depth=self.classifier_depth,
                dropout=self.classifier_dropout,
                use_attention=self.use_attention)

    v_cls = _flax_variables(_JaxCls(**CLS), cls, *cols, train=False)
    new, copied = transfer_params(vae.state_dict(), cls.state_dict(),
                                  dst_prefix=("vae_model",))
    new_j, copied_j = jax_transfer(v_vae["params"], v_cls["params"],
                                   dst_prefix=("vae_model",))
    keys_j = {torch_key(tuple(p.split("/"))) for p in copied_j}
    buffers = {k for k in vae.state_dict() if "running" in k}
    assert set(copied) == keys_j | {f"vae_model.{k}" for k in buffers}
    for path, want in _flat(new_j):
        np.testing.assert_array_equal(
            new[torch_key(path)].numpy(), to_torch_layout(path[-1], want, path))
    assert len(copied) == len(vae.state_dict())

    # a subtree to a subtree, and the strict rules
    sub, got = transfer_params(cls.state_dict(), vae.state_dict(),
                               src_prefix=("vae_model", "source_encoder"),
                               dst_prefix=("source_encoder",))
    assert got and all(k.startswith("source_encoder.") for k in got)
    with pytest.raises(KeyError, match="missing"):
        transfer_params({}, vae.state_dict(), strict=True)
    wrong = {k: v[..., :1] if v.dim() else v
             for k, v in vae.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        transfer_params(wrong, vae.state_dict(), strict=True)
    kept, some = transfer_params(wrong, vae.state_dict())
    assert set(some) == {k for k, v in wrong.items()
                         if v.shape == vae.state_dict()[k].shape}


class _Windows:
    """A small in-memory dataset: windows of 3 GUIDs, `collate` stacking
    them into a batch with integer labels."""

    def __init__(self, n=12):
        self.items = [dict(_cls_batch(20 + i, b=1), guid=f"g{i % 3}")
                      for i in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def collate(self, idx):
        out = {k: np.concatenate([self.items[i][k] for i in idx])
               for k in ("fhr_st", "fhr_ph", "fhr_up_ph", "label")}
        out["guid"] = [self.items[i]["guid"] for i in idx]
        return out


def test_train_and_test_folds():
    """The k-fold workflow on a small model (one epoch, batch 2): one entry
    per fold with test windows, the test windows' probabilities (rows
    summing to 1) and labels; a fold without test windows is skipped."""
    data = _Windows()
    folds = {"fold_0": {"train": {"a": ["g0", "g1"]}, "test": {"a": ["g2"]}},
             "fold_1": {"train": {"a": ["g1", "g2"]}, "test": {"a": ["g0"]}},
             "fold_2": {"train": {"a": ["g0"]}, "test": {"a": ["gx"]}}}
    make = lambda: tit.SeqVaeTebClassifier(
        classifier_depth=3, classifier_filters=4, use_attention=False,
        seq_len=S, lstm_hidden_dim=8, lstm_num_layers=2)
    logs = []
    res = train_and_test_folds(make, data, folds,
                               lambda b: np.asarray(b["label"]),
                               ClassifierConfig(epochs=1), batch_size=2,
                               device="cpu", log_fn=logs.append)
    assert set(res) == {"fold_0", "fold_1"}
    for name, r in res.items():
        g = "g2" if name == "fold_0" else "g0"
        idx = [i for i in range(len(data)) if data[i]["guid"] == g]
        np.testing.assert_array_equal(r["test_indices"], idx)
        assert r["probabilities"].shape == (len(idx), 2)
        np.testing.assert_allclose(r["probabilities"].sum(1), 1.0, rtol=1e-6)
        np.testing.assert_array_equal(
            r["labels"], [data[i]["label"][0] for i in idx])
    agg = tcls.aggregate_fold_results(res)
    assert set(agg["per_fold"]) == set(res)


def _nested_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _nested_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _nested_equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_classification_functions_match_jax(tmp_path):
    """Every function of eval/classification.py against the JAX package's
    on the same inputs: equal results (the same numpy code), and the same
    files from the sweep and the plot."""
    import pandas as pd
    r = np.random.default_rng(0)
    labels = r.integers(0, 2, 200)
    scores = labels * 0.4 + r.random(200) * 0.6
    for name in ("roc_curve",):
        _nested_equal(getattr(tcls, name)(labels, scores),
                      getattr(jcls, name)(labels, scores))
    fpr, tpr, _ = tcls.roc_curve(labels, scores)
    assert tcls.auc(fpr, tpr) == jcls.auc(fpr, tpr)
    _nested_equal(tcls.confusion_at_threshold(labels, scores, 0.6),
                  jcls.confusion_at_threshold(labels, scores, 0.6))
    _nested_equal(tcls.binary_classification_report(labels, scores, 0.4),
                  jcls.binary_classification_report(labels, scores, 0.4))
    _nested_equal(tcls.strike_rate_analysis(labels, scores),
                  jcls.strike_rate_analysis(labels, scores))
    folds = {f"fold_{i}": {"probabilities": np.stack([1 - s, s], 1),
                           "labels": lab}
             for i, (lab, s) in enumerate(((labels[:100], scores[:100]),
                                           (labels[100:], scores[100:])))}
    _nested_equal(tcls.aggregate_fold_results(folds),
                  jcls.aggregate_fold_results(folds))
    latents = r.standard_normal((200, 6, 4)) + labels[:, None, None]
    _nested_equal(tcls.latent_class_statistics(latents, labels),
                  jcls.latent_class_statistics(latents, labels))
    table = {"guid": ["g"] * 200, "epoch_num": np.repeat(np.arange(4), 50),
             "prob_class_1": scores, "predicted_class": scores > 0.5,
             "true_label": labels}
    got = tcls.classification_epoch_sweep(table, str(tmp_path / "t"))
    want = jcls.classification_epoch_sweep(table, str(tmp_path / "j"))
    _nested_equal(got["overall"], want["overall"])
    pd.testing.assert_frame_equal(got["by_epoch"], want["by_epoch"])
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        p.name for p in (tmp_path / "j").iterdir())
    with pytest.raises(ValueError, match="missing"):
        tcls.classification_epoch_sweep({"epoch_num": [0]}, str(tmp_path))
    tcls.plot_roc_pr_curves(labels, scores, str(tmp_path / "roc.png"))
    assert (tmp_path / "roc.png").stat().st_size > 0


def test_prediction_accuracy_test_matches_jax():
    """The chained future-coefficient battery on SeqVaeTebPredictSt (S=16,
    horizon 4, prediction_idx 4: three chunks), two batches, against the
    JAX function on the same weights (the JAX model jitted): every entry
    within 1e-4 of its largest magnitude (fp32; the predictions differ by
    rounding, and the battery's ratios and logs carry it)."""
    from vae_teb_tpu.eval import prediction_accuracy_test as jax_battery
    from vae_teb_tpu_torch.eval import prediction_accuracy_test
    small = dict(lstm_hidden_dim=8, lstm_num_layers=2)
    jm = jv.SeqVaeTebPredictSt(prediction_horizon=4, **small)
    model = tv.SeqVaeTebPredictSt(prediction_horizon=4, seq_len=S, **small)
    batches = [_cls_batch(30), _cls_batch(40)]
    cols = [batches[0][k] for k in ("fhr_st", "fhr_ph", "fhr_up_ph")]
    variables = _flax_variables(jm, model, *cols, train=False,
                                deterministic=True)

    class _Jitted:   # the JAX battery applies the model eagerly
        apply = staticmethod(jax.jit(jm.apply, static_argnames=(
            "train", "deterministic")))

    want = jax_battery(_Jitted, variables, batches, prediction_idx=4)
    got = prediction_accuracy_test(load_flax_variables(model, variables),
                                   batches, prediction_idx=4)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], 1e-4, k)
    assert got["scattering_mse"].shape == (4, 43)
    assert got["phase_vaf"].shape == (44,)
    with pytest.raises(ValueError, match="too short"):
        prediction_accuracy_test(model, batches, prediction_idx=14)
