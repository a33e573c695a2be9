"""The bf16 compute policy of the port against the JAX package's at a small
size: the whole forward on identical coefficients and weights (converted
from one flax tree), the dtypes the policy gives parameters, layers, the
wavefront's operands, losses and gradients, and, marked `cuda`, the
policy on the card against the CPU. JAX is imported only inside the tests
that compare with it, so the `cuda` tests run on a machine without it.

The JAX model runs without jit here: applied eagerly, every operation
rounds its result to bf16, as the port's PyTorch operations do. Under jit
XLA fuses elementwise chains and rounds once per fusion, so the jitted JAX
model differs from the eager one by as much as the port does (PERF.md
section 6 gives both).
"""

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch import SeqVaeTeb, Trainer, TrainerConfig, init_parameters
from vae_teb_tpu_torch.convert import (load_flax_variables, to_torch_layout,
                                       torch_key)
from vae_teb_tpu_torch.models import compute_loss

torch.set_num_threads(2)

S, B = 8, 3
SMALL = dict(lstm_hidden_dim=8, lstm_num_layers=2)
OUT_KEYS = ("z", "linear_output", "mu_pr", "logvar_pr", "mu_x", "mu_prior",
            "logvar_prior", "mu_post", "logvar_post")
HEADS = ("mu_pr", "logvar_pr")
FIELDS = ("fhr_st", "fhr_ph", "fhr_up_ph", "fhr")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _coeffs(seed):
    return [_x((B, S, c), seed + i) for i, c in enumerate((43, 44, 130))]


def _batch(seed):
    return dict(zip(FIELDS, _coeffs(seed) + [_x((B, 16 * S), seed + 3)]))


@pytest.fixture(scope="module")
def bf16_pair():
    """The JAX small model under the bf16 policy (wavefront_pallas: its LSTMs
    run the Pallas kernels, in interpret mode here) and a flax tree of the
    port's seeded weights with randomized running statistics (so that
    eval-mode BatchNorm is not the identity)."""
    import jax
    import jax.numpy as jnp
    from vae_teb_tpu.models import SeqVaeTeb as JaxSeqVaeTeb
    jm = JaxSeqVaeTeb(**SMALL, lstm_schedule="wavefront_pallas",
                      dtype=jnp.bfloat16)
    zeros = [jnp.zeros((1, S, c)) for c in (43, 44, 130)]
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(0)},
        *zeros, train=False))
    sd = init_parameters(SeqVaeTeb(**SMALL, seq_len=S), seed=1).state_dict()
    r = np.random.default_rng(5)

    def leaf(path, _):
        v = sd[torch_key(tuple(p.key for p in path[1:]))].numpy()
        if path[0].key == "batch_stats":
            v = (r.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
                 else 0.1 * r.standard_normal(v.shape)).astype(np.float32)
        return to_torch_layout(path[-1].key, v)

    return jm, jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_forward_matches_jax(bf16_pair, train):
    """SeqVaeTeb(dtype=bf16) against SeqVaeTeb(dtype=jnp.bfloat16) on the
    same coefficients and weights, deterministic, in eval mode (running
    statistics) and train mode (batch statistics). Bars, of each output's
    max: 3e-2 for the encoders' outputs and linear_output (measured 0 but
    for linear_output in train mode, 1.2e-3: a bf16 convolution output of
    the XLA CPU kernels a ulp from the port's); 1e-1, the JAX package's own
    bar, for the raw heads mu_pr and logvar_pr (measured 0 in eval mode,
    4.4e-2 and 2.4e-2 in train mode: such a one-ulp difference before the
    decoder's last BatchNorm/ReLU meets the row LayerNorm of the 16S-wide
    heads, which amplifies it). The updated running statistics (train mode)
    within 1e-2 of their max (measured 2.8e-3, under one bf16 ulp: the fp32
    batch mean of bf16 convolution outputs, a few of them a ulp apart)."""
    import jax
    jm, variables = bf16_pair
    x = _coeffs(10)
    want = jm.apply(variables, *x, train=train, deterministic=True,
                    mutable=["batch_stats"] if train else False)
    if train:
        want, updates = want
    model = load_flax_variables(SeqVaeTeb(**SMALL, seq_len=S,
                                          dtype=torch.bfloat16), variables)
    model.train(train)
    with torch.no_grad():
        got = model(*[torch.as_tensor(a) for a in x], deterministic=True)
    for k in OUT_KEYS:
        assert got[k].dtype == torch.bfloat16, k
        g, w = got[k].float().numpy(), np.asarray(want[k], np.float32)
        assert g.shape == w.shape, k
        bar = 1e-1 if k in HEADS else 3e-2
        assert np.abs(g - w).max() <= bar * np.abs(w).max(), k
        if k not in HEADS:
            assert np.abs(w).max() > 0, k
    if train:
        named = dict(model.named_buffers())
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                updates["batch_stats"]):
            key = torch_key(tuple(p.key for p in path))
            w = np.asarray(leaf)
            assert np.abs(named[key].numpy() - w).max() <= \
                1e-2 * np.abs(w).max(), key


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_policy_dtypes(precision):
    """Under TrainerConfig(precision=p, moment_dtype=p): the parameters, the
    BatchNorm statistics and every gradient stay float32; the wavefront's
    five float operands, the model's outputs and the Adam moments take the
    policy's dtype; the losses and grad_norm are float32."""
    cfg = TrainerConfig(precision=precision, moment_dtype=precision)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = init_parameters(SeqVaeTeb(**SMALL, seq_len=S,
                                      dtype=cfg.model_dtype()), seed=1)
    seen = []
    recurrence = model.recurrence

    def spy(*args):
        seen.append([a.dtype for a in args[:5]])
        return recurrence(*args)

    model.recurrence = spy
    trainer = Trainer(model, cfg, device="cpu")
    metrics = trainer.train_step(_batch(3), 1e-5)
    assert seen == [[dtype] * 5]
    assert all(v.dtype == torch.float32 for v in metrics.values())
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all()
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert {st["mu"].dtype for st in trainer.optimizer.state.values()} \
        == {dtype}
    with torch.no_grad():
        t = [torch.as_tensor(a) for a in _batch(4).values()]
        out = model.eval()(*t[:3], deterministic=True)
        losses = compute_loss(out, *t[:2], t[3])
    assert {out[k].dtype for k in OUT_KEYS} == {dtype}
    assert {v.dtype for v in losses.values()} == {torch.float32}


def test_bf16_noise_is_drawn_in_the_compute_dtype():
    """Under the policy, eps is drawn in bf16 from the generator, or the
    caller's eps is cast to bf16, and z = mu + eps * exp(logvar / 2) is
    formed in bf16, as the JAX package draws and forms it."""
    model = init_parameters(SeqVaeTeb(**SMALL, seq_len=S,
                                      dtype=torch.bfloat16), seed=1).eval()
    c = [torch.as_tensor(a) for a in _coeffs(6)]
    eps = torch.as_tensor(_x((B, S, 32), 9))
    with torch.no_grad():
        out = model(*c, deterministic=False, eps=eps)
        mu, logvar = out["mu_post"], out["logvar_post"]
        want = mu + eps.to(torch.bfloat16) * torch.exp(0.5 * logvar)
        drawn = model(*c, deterministic=False,
                      generator=torch.Generator().manual_seed(2))
        again = torch.randn(mu.shape, generator=torch.Generator()
                            .manual_seed(2), dtype=torch.bfloat16)
    assert out["z"].dtype == torch.bfloat16
    assert torch.equal(out["z"], want)
    assert torch.equal(drawn["z"], mu + again * torch.exp(0.5 * logvar))


@pytest.mark.parametrize("steps", [1, 2, 300])
def test_bf16_linear_upsample_is_interpolate(steps):
    """Below float32, blocks.linear_upsample writes the 2x linear upsample
    out (so its backward needs no atomic adds on the card); forward and
    backward equal F.interpolate's bit for bit on bf16 inputs, edges
    included."""
    import torch.nn.functional as F
    from vae_teb_tpu_torch.models.blocks import linear_upsample
    g = torch.Generator().manual_seed(steps)
    x = (10 * torch.randn(3, steps, 7, generator=g)).to(torch.bfloat16)
    cot = torch.randn(3, 2 * steps, 7, generator=g).to(torch.bfloat16)
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    got = linear_upsample(a)
    want = F.interpolate(b.transpose(1, 2), size=2 * steps, mode="linear",
                         align_corners=False).transpose(1, 2)
    got.backward(cot)
    want.backward(cot)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert torch.equal(a.grad, b.grad)


# ---------------------------------------------------------------------------
# the policy on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_bf16_forward_on_card_matches_cpu(cuda_device):
    """The bf16 forward on the card launches wavefront_fwd_bf16 once and
    agrees with the CPU's plain path in the same policy within 1e-1 of
    each output's max (chip_smoke.py's bar; cuBLAS and the CPU round their
    bf16 products at other points)."""
    from vae_teb_tpu_torch.kernels import wavefront_fwd
    cpu = init_parameters(SeqVaeTeb(**SMALL, seq_len=S,
                                    dtype=torch.bfloat16), seed=1).eval()
    card = SeqVaeTeb(**SMALL, seq_len=S, dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    card = card.to(cuda_device).eval()
    c = [torch.as_tensor(a) for a in _coeffs(12)]
    wavefront_fwd.entry_launches.clear()
    with torch.no_grad():
        want = cpu(*c, deterministic=True)
        got = card(*[a.to(cuda_device) for a in c], deterministic=True)
    torch.cuda.synchronize()
    assert dict(wavefront_fwd.entry_launches) == {"wavefront_fwd_bf16": 1}
    for k in OUT_KEYS:
        g, w = got[k].float().cpu(), want[k].float()
        assert (g - w).abs().max() <= 1e-1 * w.abs().max().clamp_min(1e-30), k


@pytest.mark.cuda
def test_bf16_train_step_on_card(cuda_device, monkeypatch):
    """One bf16 train step on the card launches wavefront_fwd_res_bf16 and
    wavefront_bwd_bf16 once each; its losses agree with the CPU's step on
    the same batch and noise within 5e-2 relative, and every gradient is
    float32 and finite. The gradients are held against the same step on
    the card with the plain reverse wavefront behind the kernel forward,
    so that both share a bit-identical forward: each leaf's max-abs
    difference within 1e-1 of its largest entry (floored at 1e-2 of the
    largest entry of any leaf, as chip_smoke.py's grad_report does) and
    the model-wide relative L2 within 1e-2. Against the CPU the gradients
    are not held: cuBLAS and the CPU sum bf16 products in other orders, and
    the bf16 gradient moves as much between the two as under a half-ulp
    change of the inputs on one device (PERF.md section 6)."""
    import copy
    import sys
    from vae_teb_tpu_torch.kernels import (wavefront_bwd, wavefront_bwd_plain,
                                           wavefront_fwd)
    cfg = TrainerConfig(precision="bf16", moment_dtype="bf16")
    cpu = init_parameters(SeqVaeTeb(**SMALL, seq_len=S,
                                    dtype=torch.bfloat16), seed=1)
    card = SeqVaeTeb(**SMALL, seq_len=S, dtype=torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    plain = copy.deepcopy(card).to(cuda_device)
    batch, eps = _batch(7), torch.as_tensor(_x((B, S, 32), 8))
    wavefront_fwd.entry_launches.clear()
    wavefront_bwd.entry_launches.clear()
    got = Trainer(card, cfg, cuda_device).train_step(
        batch, 1e-5, eps=eps.to(cuda_device))
    torch.cuda.synchronize()
    launched = dict(wavefront_fwd.entry_launches)
    launched.update(wavefront_bwd.entry_launches)
    assert launched == {"wavefront_fwd_res_bf16": 1, "wavefront_bwd_bf16": 1}
    want = Trainer(cpu, cfg, "cpu").train_step(batch, 1e-5, eps=eps)
    for k in ("total_loss", "mse_loss", "nll_loss", "kld_loss"):
        np.testing.assert_allclose(got[k].item(), want[k].item(), rtol=5e-2)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in card.parameters())
    monkeypatch.setattr(sys.modules["vae_teb_tpu_torch.kernels.wavefront"],
                        "wavefront_bwd", wavefront_bwd_plain)
    Trainer(plain, cfg, cuda_device).train_step(batch, 1e-5,
                                                eps=eps.to(cuda_device))
    ref = dict(plain.named_parameters())
    top = max(p.grad.abs().max().item() for p in ref.values())
    num = den = 0.0
    for k, p in card.named_parameters():
        w = ref[k].grad
        d = p.grad - w
        scale = max(w.abs().max().item(), 1e-2 * top)
        assert d.abs().max().item() <= 1e-1 * scale, k
        num += d.square().sum().item()
        den += w.square().sum().item()
    assert (num / den) ** 0.5 <= 1e-2
