"""The forward wavefront LSTM recurrence: the port's run_lstm_streams (plain
version on the CPU) against the JAX package's Pallas kernel in interpret
mode, the packing steps against JAX, and the CUDA kernel against its plain
version on a card.

JAX is imported inside the tests that compare with it, so the CUDA case
also runs where JAX is not installed:
    python -m pytest tests/test_torch_wavefront.py -m cuda
"""

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch.kernels import wavefront_fwd, wavefront_fwd_plain
from vae_teb_tpu_torch.models.blocks import (LSTMStream, _wavefront_meta,
                                             _wavefront_pack, _wavefront_xs,
                                             run_lstm_streams)

torch.set_num_threads(2)

B, S, H = 3, 17, 8
DEPTHS = (4, 2)   # heterogeneous stream depths


def _stream_arrays(seed, n_layers, b=B, s=S, h=H):
    """Numpy weights, projected inputs and non-zero initial states of one
    stream, as tests/test_models.py builds them."""
    r = np.random.default_rng(seed)
    f32 = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return dict(xp=f32(b, s, 4 * h),
                w_ih=[f32(h if l else 12, 4 * h) * 0.3 for l in range(n_layers)],
                w_hh=[f32(h, 4 * h) * 0.3 for _ in range(n_layers)],
                b=[f32(4 * h) * 0.1 for _ in range(n_layers)],
                h0=[f32(b, h) * 0.2 for _ in range(n_layers)],
                c0=[f32(b, h) * 0.2 for _ in range(n_layers)])


def _streams(cls, wrap, arrays):
    return [cls(wrap(a["xp"]), [wrap(w) for w in a["w_ih"]],
                [wrap(w) for w in a["w_hh"]], [wrap(v) for v in a["b"]],
                (tuple(wrap(h) for h in a["h0"]), tuple(wrap(c) for c in a["c0"])))
            for a in arrays]


def _operands(streams):
    return [{"xs": st.x_proj.swapaxes(0, 1), "w_ih_rest": tuple(st.w_ih[1:]),
             "w_hh": tuple(st.w_hh), "b_rest": tuple(st.biases[1:]),
             "init_h": st.init[0], "init_c": st.init[1]} for st in streams]


ARRAYS = [_stream_arrays(1, DEPTHS[0]), _stream_arrays(2, DEPTHS[1])]


def test_run_lstm_streams_matches_pallas_interpret():
    """Outputs and final states to rtol 1e-5 / atol 1e-6 (fp32, the same
    cell math; only the gate sums' order differs)."""
    import jax.numpy as jnp
    from vae_teb_tpu.models.blocks import LSTMStream as JaxStream
    from vae_teb_tpu.models.blocks import run_lstm_streams as jax_run
    want = jax_run(_streams(JaxStream, jnp.asarray, ARRAYS),
                   schedule="wavefront_pallas")
    got = run_lstm_streams(_streams(LSTMStream, torch.as_tensor, ARRAYS))
    for (ys_w, (h_w, c_w)), (ys_g, (h_g, c_g)) in zip(want, got):
        for w, g in ((ys_w, ys_g), (h_w, h_g), (c_w, c_g)):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)


def test_pack_and_xs_match_jax():
    """W_eff, the packed biases and xs_wave are data movement: equal."""
    import jax.numpy as jnp
    from vae_teb_tpu.models import blocks as jb
    ops_j = _operands(_streams(jb.LSTMStream, jnp.asarray, ARRAYS))
    ops_t = _operands(_streams(LSTMStream, torch.as_tensor, ARRAYS))
    meta = _wavefront_meta(ops_t)
    H_, depths, offsets, U, D, lvec = meta
    np.testing.assert_array_equal(lvec, jb._wavefront_meta(ops_j)[5])
    K = S + D - 1
    for got, want in zip(_wavefront_pack(ops_t, H_, depths, offsets, U),
                         jb._wavefront_pack(ops_j, H_, depths, offsets, U)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        _wavefront_xs(ops_t, H_, depths, offsets, U, K, S).numpy(),
        np.asarray(jb._wavefront_xs(ops_j, H_, depths, offsets, U, K, S)))


def _recurrence_inputs(seed, b, s, h, depths, dtype=torch.float32,
                       device="cpu"):
    """Random wavefront operands: W_eff, b, xs_wave, h0, c0, lvec."""
    r = np.random.default_rng(seed)
    U = sum(depths)
    UH, K = U * h, s + max(depths) - 1
    lvec = np.concatenate([np.arange(d) for d in depths]).astype(np.int32)
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=device).to(dtype)
    return (t(r.standard_normal((UH, 4 * UH)) / np.sqrt(UH)),
            t(r.standard_normal(4 * UH) * 0.1),
            t(r.standard_normal((K, b, 4 * UH))),
            t(r.standard_normal((b, UH)) * 0.2),
            t(r.standard_normal((b, UH)) * 0.2),
            torch.as_tensor(lvec, device=device))


def test_plain_bf16_storage_tracks_fp32():
    """bf16 storage rounds h and c every step; the states stay within a
    few bf16 ulps of 1.0 of the fp32 run (loose: 4e-2)."""
    args = _recurrence_inputs(3, B, S, H, DEPTHS)
    h32 = wavefront_fwd_plain(*args, S)
    bf = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
    h16 = wavefront_fwd_plain(*bf, S)
    for a, b in zip(h32, h16):
        assert b.dtype == torch.bfloat16
        assert (a - b.float()).abs().max().item() <= 4e-2


def test_dispatch_by_device():
    """CPU tensors take the plain version without counting a launch; other
    non-CUDA devices raise."""
    args = _recurrence_inputs(4, B, S, H, DEPTHS)
    before = wavefront_fwd.launches
    for got, want in zip(wavefront_fwd(*args, S), wavefront_fwd_plain(*args, S)):
        assert torch.equal(got, want)
    assert wavefront_fwd.launches == before
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no implementation"):
        wavefront_fwd(*meta, S)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("depths,h,b,s", [((4, 4), 64, 32, 300),
                                          ((4, 2), 64, 5, 40),
                                          ((4, 2), 8, 3, 17)])
def test_kernel_matches_plain(cuda_device, dtype, tol, depths, h, b, s):
    """The CUDA kernel against its plain version on the card: max-abs 1e-5
    in fp32, 1.6e-2 (two bf16 ulps at 1.0) in bf16 storage."""
    args = _recurrence_inputs(5, b, s, h, depths, dtype, cuda_device)
    before = wavefront_fwd.launches
    got = wavefront_fwd(*args, s)
    torch.cuda.synchronize()
    assert wavefront_fwd.launches == before + 1
    want = wavefront_fwd_plain(*args, s)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda_device):
    args = list(_recurrence_inputs(6, B, S, H, DEPTHS, device=cuda_device))
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        wavefront_fwd(*args, S)
