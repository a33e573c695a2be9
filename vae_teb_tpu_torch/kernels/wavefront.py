"""Dispatch for the wavefront LSTM recurrences, and their autograd Function.

`wavefront_fwd` and `wavefront_bwd` pick by the device of their inputs: a
CPU tensor takes the plain PyTorch version (`wavefront_ref`), a CUDA tensor
launches the hand-written kernel (`wavefront_fwd.cu`, `wavefront_bwd.cu`),
anything else raises. Each kernel launch adds one to its wrapper's count:
`wavefront_fwd.launches` (serving forward), `wavefront_fwd.residual_launches`
(training forward, which also stores the residuals) and
`wavefront_bwd.launches`; and to the count of the entry point it launched,
by name (`wavefront_fwd_res_bf16`, ...), in the wrapper's `entry_launches`
Counter.

The serving forward is also the operator
`torch.ops.vae_teb_tpu_torch.wavefront_fwd` (`wavefront_fwd_op`), which
`wavefront_fwd` calls: `torch.export` keeps it as one node, and an exported
program dispatches it by device when it runs, counting its launches as the
wrapper does.

The kernels run one thread-block cluster of U CTAs (one per unit) per
group of M batch rows, each CTA holding its unit's weight blocks in shared
memory for all K steps (`unit_blocks`, `_launch_plan`). Shapes no cluster
takes (more than 8 units, 4H over 256 threads, a unit's weights over the
shared memory of a CTA) run on the grid kernels (`wavefront_grid_fwd.cu`,
`wavefront_grid_bwd.cu`): one cooperative launch of U * H / N CTAs, each
owning N state columns of one unit, one grid-wide barrier per step. Their
entry points are `wavefront_grid_{fwd,fwd_res,bwd}_{f32,bf16}`, counted in
the same `entry_launches` and in the same totals.

`wavefront_recurrence` is the differentiable recurrence the model calls:
the serving forward alone (the operator) when no gradient is wanted,
otherwise `WavefrontFunction`, whose backward runs the reverse wavefront
and forms the weight gradients outside the recurrence, as the JAX
package's custom VJP does (`vae_teb_tpu/models/blocks.py::_wavefront_core`).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import build
from .wavefront_ref import wavefront_bwd_plain, wavefront_fwd_plain

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_UNITS = 8           # the portable cluster size: one CTA per unit
_MAX_THREADS = 256       # 4H threads a CTA; the kernels are built for 256
_SMEM_LIMIT = 232448     # 227 KB of shared memory per block on Hopper
_SMS = 132               # H100 SXM
_MAX_ROWS = 10           # batch rows per cluster the kernels are built for


_GRID_COLS = (8, 16, 32)  # state columns a grid CTA may own
_GRID_FWD_ROWS = 16      # batch rows a chunk of the grid kernels' products
_GRID_BWD_ROWS = 8       # (16 would leave fp32 H=256 no 16-column plan)
_WARPS = 8               # depth slices of a grid CTA's product


class LaunchPlan(NamedTuple):
    rows: int        # cluster: M, batch rows per cluster; grid: 0
    clusters: int    # cluster: ceil(B / M), each of U CTAs; grid: 0
    fwd_smem: int    # dynamic shared memory of a forward CTA, bytes
    bwd_smem: int    # ... of a reverse-wavefront CTA
    kind: str = "cluster"   # "cluster" or "grid"
    cols: int = 0    # grid: N, state columns of one unit a CTA owns
    ctas: int = 0    # grid: U * H / N CTAs in the cooperative launch


def _smem(M: int, H: int, item: int) -> Tuple[int, int]:
    """Shared memory of a forward and a reverse-wavefront CTA, as the
    kernels lay it out: two mbarriers and the unit's 8H^2 weights in the
    storage type; then h (fp32) and the prefetched xs rows, each
    double-buffered, and the four depth slices' partial gates (forward);
    or the dgates (fp32, double-buffered), one step's prefetched residual
    rows (7 of H) and the 16 depth slices' partial dz (backward)."""
    base = 16 + 8 * H * H * item          # two mbarriers, the weights
    fwd = base + 2 * M * 2 * H * 4 + 2 * M * 4 * H * item + 16 * M * H * 4
    bwd = base + 2 * M * 8 * H * 4 + M * 7 * H * item + 16 * M * H * 4
    return fwd, bwd


def _grid_smem(N: int, H: int, item: int) -> Tuple[int, int]:
    """Shared memory of a forward and a reverse grid CTA owning N columns,
    as the grid kernels lay it out: the weight slice (2H x 4N forward, 8H
    x N reverse) and one chunk of h rows (16 of 2H) or dgates rows (8 of
    8H), both in the storage type, each row padded by 16 bytes, and the
    8 depth slices' partial sums (fp32)."""
    pad = 16 // item
    fwd = (2 * H * 4 * N * item + _GRID_FWD_ROWS * (2 * H + pad) * item
           + _WARPS * _GRID_FWD_ROWS * 4 * N * 4)
    bwd = (8 * H * N * item + _GRID_BWD_ROWS * (8 * H + pad) * item
           + _WARPS * _GRID_BWD_ROWS * N * 4)
    return fwd, bwd


def _grid_plan(U: int, H: int, item: int,
               resident: Optional[Callable[[int, int, int], int]]
               ) -> LaunchPlan:
    """The grid kernels' plan: the fewest columns N (8, 16, 32, dividing
    H) with which all U * H / N CTAs are resident at once;
    `resident(N, fwd_smem, bwd_smem)` says how many CTAs the card holds
    (the CUDA wrappers ask the card), by default one per SM of 132. Raises
    when no N fits: a cooperative launch cannot run in waves."""
    tried = []
    for N in _GRID_COLS:
        if H % N:
            continue
        fwd, bwd = _grid_smem(N, H, item)
        if max(fwd, bwd) > _SMEM_LIMIT:
            tried.append(f"N={N}: {max(fwd, bwd)} bytes of shared memory")
            break
        ctas = U * H // N
        held = resident(N, fwd, bwd) if resident else _SMS
        if ctas <= held:
            return LaunchPlan(0, 0, fwd, bwd, "grid", N, ctas)
        tried.append(f"N={N}: {ctas} CTAs, the card holds {held}")
    raise ValueError(f"{U} units of H={H}: no kernel takes this shape (the "
                     f"cluster kernels: more than {_MAX_UNITS} units, 4H "
                     f"over {_MAX_THREADS} threads or over {_SMEM_LIMIT} "
                     f"bytes of shared memory; the grid kernels: "
                     f"{'; '.join(tried)})")


def _launch_plan(B: int, U: int, H: int, dtype: torch.dtype,
                 resident: Optional[Callable[[int, int, int], int]] = None,
                 grid_resident: Optional[Callable[[int, int, int], int]]
                 = None) -> LaunchPlan:
    """How the kernels split a batch of B rows over U units of width H.

    The cluster kernels take up to 8 units with 4H <= 256 threads a CTA
    (so that a thread may hold up to 255 registers) and a unit's 8H^2
    weights in one CTA's 227 KB of shared memory. M is the fewest rows per
    cluster with which all ceil(B/M) clusters are resident at once;
    `resident(M, fwd_smem, bwd_smem)` says how many clusters of U CTAs the
    card holds (the CUDA wrappers ask the card,
    cudaOccupancyMaxActiveClusters); by default one CTA per SM of 132. When
    no M up to 10 fits, the largest that the shared memory takes runs the
    clusters in waves.

    Any other shape takes the grid kernels (`_grid_plan`, with
    `grid_resident`), which raise when their CTAs cannot all be resident.
    Both refuse H not a multiple of 8 (16-byte copies of a unit's row
    segment; the grid CTAs' 8 columns) and a storage dtype other than
    float32 or bfloat16.
    """
    if dtype not in _DTYPES:
        raise TypeError(f"the wavefront kernels take float32 or bfloat16, "
                        f"got {dtype}")
    if U < 1:
        raise ValueError(f"bad unit count {U}")
    if H < 8 or H % 8:
        raise ValueError(f"hidden size {H}: the kernels need a multiple of 8")
    if B < 1:
        raise ValueError(f"bad batch {B}")
    item = torch.empty((), dtype=dtype).element_size()
    if (U > _MAX_UNITS or 4 * H > _MAX_THREADS
            or max(_smem(1, H, item)) > _SMEM_LIMIT):
        return _grid_plan(U, H, item, grid_resident)
    plan = None
    for M in range(1, _MAX_ROWS + 1):
        fwd, bwd = _smem(M, H, item)
        if max(fwd, bwd) > _SMEM_LIMIT:
            break
        plan = LaunchPlan(M, -(-B // M), fwd, bwd)
        held = resident(M, fwd, bwd) if resident else _SMS // U
        if plan.clusters <= held:
            break
    return plan


_held: Dict[tuple, int] = {}


def _card_resident(device: torch.device, dtype: torch.dtype, U: int, H: int
                   ) -> Callable[[int, int, int], int]:
    """`resident` for `_launch_plan` on a card: the clusters of U CTAs that
    both kernels can hold at once at M rows (cudaOccupancyMaxActiveClusters),
    asked once per shape."""
    def held(M: int, fwd_smem: int, bwd_smem: int) -> int:
        key = (device, dtype, U, H, M)
        if key not in _held:
            with torch.cuda.device(device):
                n = min(_max_clusters(kind)(int(dtype == torch.bfloat16), M,
                                            U, H, M, smem)
                        for kind, smem in (("fwd", fwd_smem),
                                           ("bwd", bwd_smem)))
            if n < 1:
                raise RuntimeError(f"the card holds no cluster of {U} CTAs "
                                   f"with {max(fwd_smem, bwd_smem)} bytes of "
                                   f"shared memory (CUDA error {-n})")
            _held[key] = n
        return _held[key]
    return held


_grid_held: Dict[tuple, int] = {}


def _card_grid_resident(device: torch.device, dtype: torch.dtype
                        ) -> Callable[[int, int, int], int]:
    """`grid_resident` for `_launch_plan` on a card: the CTAs of N columns
    that both grid kernels can hold at once (blocks per SM by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, times the SMs), asked
    once per shape."""
    def held(N: int, fwd_smem: int, bwd_smem: int) -> int:
        key = (device, dtype, N, fwd_smem, bwd_smem)
        if key not in _grid_held:
            with torch.cuda.device(device):
                n = min(_max_ctas(kind)(int(dtype == torch.bfloat16), N, smem)
                        for kind, smem in (("fwd", fwd_smem),
                                           ("bwd", bwd_smem)))
            if n < 1:
                raise RuntimeError(f"the card holds no grid CTA with "
                                   f"{max(fwd_smem, bwd_smem)} bytes of "
                                   f"shared memory (CUDA error {-n})")
            _grid_held[key] = n
        return _grid_held[key]
    return held


def unit_blocks(W_eff: torch.Tensor, lvec: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-unit weight blocks the kernels keep resident.

    W_eff (UH, 4UH) is block-bidiagonal as `_wavefront_pack` makes it; its
    other entries are ignored. Viewed as (U, H, 4, U, H) = (row unit, row,
    gate, column unit, column), block [v, :, :, u, :] maps unit v's h to
    unit u's gates. Returns
      Wf (U, 2H, 4H): unit u's recurrent block [u, :, :, u, :] over its
        feed block [u-1, :, :, u, :] (zeros when lvec[u] == 0), the rows
        the forward multiplies [h_u | h_{u-1}] with;
      Wb (U, H, 8H): row block u of W_eff, the recurrent block beside the
        feed block into unit u+1 [u, :, :, u+1, :] (zeros unless
        lvec[u+1] > 0), the columns the reverse wavefront multiplies
        [dgates_u | dgates_{u+1}] with.
    Gate columns are gate-major within a unit (q * H + t).
    """
    U = lvec.numel()
    H = W_eff.shape[0] // U
    blk = W_eff.view(U, H, 4, U, H)
    idx = torch.arange(U, device=W_eff.device)
    own = blk[idx, :, :, idx]                                # (U, H, 4, H)
    feed = torch.zeros_like(own)                             # into unit u
    feed[1:] = blk[idx[:-1], :, :, idx[1:]]
    feed = torch.where((lvec > 0).view(U, 1, 1, 1), feed, 0)
    wf = torch.cat([own, feed], 1).reshape(U, 2 * H, 4 * H)
    out = torch.cat([feed[1:], torch.zeros_like(feed[:1])])  # out of unit u
    wb = torch.cat([own.reshape(U, H, 4 * H), out.reshape(U, H, 4 * H)], 2)
    return wf, wb


_indices: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def _block_index(U: int, H: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat indices into W_eff of what the kernels keep resident, (U * 8H^2,)
    each: `_fwd_layout` of Wf and `_bwd_layout` of Wb, so that one gather
    per call forms them. Built once per shape by running `unit_blocks` on
    the indices themselves. Every feed half points at the neighbouring
    unit's block whatever lvec says (index 0 where there is no neighbour):
    a kernel reads a unit's feed half only when lvec gives it one."""
    key = (U, H, device)
    if key not in _indices:
        UH = U * H
        ar = torch.arange(UH * 4 * UH, device=device).view(UH, 4 * UH)
        wf, wb = unit_blocks(ar, torch.ones(U, dtype=torch.int32,
                                            device=device))
        _indices[key] = (_fwd_layout(wf).view(-1), _bwd_layout(wb).view(-1))
    return _indices[key]


def _fwd_layout(wf: torch.Tensor) -> torch.Tensor:
    """Wf (U, 2H, 4H) as wavefront_fwd.cu keeps it in shared memory,
    [U][2H/4][4][H][4] = (unit, d4, e, state column t, gate q) for depth
    4 d4 + e: thread t reads the four gates of one depth as one 16-byte
    word at offset ((d4 * 4 + e) * H + t) * 4."""
    U, D, G = wf.shape
    return wf.view(U, D // 4, 4, 4, G // 4).permute(0, 1, 2, 4, 3).contiguous()


def _bwd_layout(wb: torch.Tensor) -> torch.Tensor:
    """Wb (U, H, 8H) as wavefront_bwd.cu keeps it in shared memory,
    [U][8H][H] = (unit, depth, state column): a thread reads four
    neighbouring columns of one depth as one 16-byte word."""
    return wb.transpose(1, 2).contiguous()


def _max_clusters(kind: str):
    """wavefront_{kind}_max_clusters(bf16, B, U, H, M, smem) -> int."""
    fn = build.load(f"wavefront_{kind}.cu")[f"wavefront_{kind}_max_clusters"]
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


def _max_ctas(kind: str):
    """wavefront_grid_{kind}_max_ctas(bf16, N, smem) -> int."""
    fn = build.load(f"wavefront_grid_{kind}.cu")[
        f"wavefront_grid_{kind}_max_ctas"]
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


def _kernel(source: str, entry: str, n_ptr: int):
    fn = getattr(build.load(source), entry)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, tensors, lvec: torch.Tensor, seq: torch.Tensor
           ) -> LaunchPlan:
    """The CUDA wrappers' input contract: one storage dtype (float32 or
    bfloat16), an int32 lvec, one device, contiguous, a packed width 4UH
    that the units divide, and a shape `_launch_plan` takes."""
    dtype = seq.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    if any(x.dtype != dtype for x in tensors) or lvec.dtype != torch.int32:
        raise TypeError(f"{name} needs one storage dtype for its float "
                        "inputs and an int32 lvec")
    if any(x.device != seq.device for x in tensors + (lvec,)):
        raise ValueError(f"{name} inputs lie on different devices")
    if not all(x.is_contiguous() for x in tensors + (lvec,)):
        raise ValueError(f"{name} needs contiguous inputs")
    if any(x.data_ptr() % 16 for x in tensors):   # 16-byte cp.async copies
        raise ValueError(f"{name} needs 16-byte aligned inputs")
    K, B, G = seq.shape
    UH, U = G // 4, lvec.numel()
    if G != 4 * UH or U < 1 or UH % U:
        raise ValueError(f"{name}: bad packed width 4*UH={G} for {U} units")
    if not 0 < B < 2 ** 31 or K < 1:
        raise ValueError(f"{name}: bad batch {B} or step count {K}")
    H = UH // U
    return _launch_plan(B, U, H, dtype,
                        _card_resident(seq.device, dtype, U, H),
                        _card_grid_resident(seq.device, dtype))


def _launch(kind: str, entry: str, plan: LaunchPlan, ptrs, K: int, B: int,
            U: int, H: int, S: int, device: torch.device) -> str:
    """Launch `entry` of the cluster or the grid kernel of `kind` ("fwd" or
    "bwd") as `plan` says; raises on a CUDA error. Returns the entry point's
    name as counted: the grid kernels' carry `grid_` after `wavefront_`."""
    smem = plan.fwd_smem if kind == "fwd" else plan.bwd_smem
    if plan.kind == "grid":
        entry = entry.replace("wavefront_", "wavefront_grid_", 1)
        source, split = f"wavefront_grid_{kind}.cu", plan.cols
        # the grid barrier's arrival counter, zero at the start
        bar = torch.zeros(1, dtype=torch.int32, device=device)
        ptrs = list(ptrs) + [bar.data_ptr()]
    else:
        source, split = f"wavefront_{kind}.cu", plan.rows
    with torch.cuda.device(device):
        err = _kernel(source, entry, len(ptrs))(
            *ptrs, K, B, U, H, S, split, smem,
            torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return entry


def _device_type(name: str, x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} has no implementation for {x.device}")
    return x.device.type


def _fwd_cuda(W_eff: torch.Tensor, b_packed: torch.Tensor,
              xs_wave: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              lvec: torch.Tensor, S: int, with_residuals: bool
              ) -> Tuple[torch.Tensor, ...]:
    """Launch the forward kernel on CUDA tensors and count the launch."""
    tensors = (W_eff, b_packed, xs_wave, h0, c0)
    plan = _check("wavefront_fwd", tensors, lvec, xs_wave)
    K, B, G = xs_wave.shape
    UH = G // 4
    if (W_eff.shape != (UH, G) or b_packed.shape != (G,)
            or h0.shape != (B, UH) or c0.shape != (B, UH)):
        raise ValueError("wavefront_fwd: W_eff, b_packed, h0 or c0 does not "
                         f"match xs_wave {tuple(xs_wave.shape)}")
    dtype, device = xs_wave.dtype, xs_wave.device
    U = lvec.numel()
    H = UH // U
    wf = W_eff.view(-1)[_block_index(U, H, device)[0]]
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    h_seq, h_fin, c_fin = new(K, B, UH), new(B, UH), new(B, UH)
    ptrs = [x.data_ptr() for x in (wf,) + tensors[1:] + (lvec, h_seq)]
    if with_residuals:
        gates_seq, c_seq = new(K, B, G), new(K, B, UH)
        ptrs += [gates_seq.data_ptr(), c_seq.data_ptr()]
        entry = f"wavefront_fwd_res_{_DTYPES[dtype]}"
    else:
        entry = f"wavefront_fwd_{_DTYPES[dtype]}"
    ptrs += [h_fin.data_ptr(), c_fin.data_ptr()]
    entry = _launch("fwd", entry, plan, ptrs, K, B, U, H, S, device)
    wavefront_fwd.entry_launches[entry] += 1
    if with_residuals:
        wavefront_fwd.residual_launches += 1
        return h_seq, h_fin, c_fin, gates_seq, c_seq
    wavefront_fwd.launches += 1
    return h_seq, h_fin, c_fin


@torch.library.custom_op("vae_teb_tpu_torch::wavefront_fwd", mutates_args=())
def wavefront_fwd_op(W_eff: torch.Tensor, b_packed: torch.Tensor,
                     xs_wave: torch.Tensor, h0: torch.Tensor,
                     c0: torch.Tensor, lvec: torch.Tensor, S: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The serving forward as one operator, `vae_teb_tpu_torch::wavefront_fwd`:
    (h_seq (K, B, UH), h_fin, c_fin (B, UH)).

    `torch.export` keeps it as one node of the graph whatever K is (its
    fake implementation gives the output shapes from the inputs', a
    symbolic batch included), and a program that holds it picks the
    implementation by device when it runs: the plain version for CPU
    tensors, the kernel for CUDA tensors (counted in
    `wavefront_fwd.launches`), and raises for any other device. Loading
    such a program needs this module imported, which registers the op.
    """
    if _device_type("wavefront_fwd", xs_wave) == "cpu":
        return wavefront_fwd_plain(W_eff, b_packed, xs_wave, h0, c0, lvec, S)
    return _fwd_cuda(W_eff, b_packed, xs_wave, h0, c0, lvec, S, False)


@wavefront_fwd_op.register_fake
def _wavefront_fwd_fake(W_eff, b_packed, xs_wave, h0, c0, lvec, S):
    K, B, G = xs_wave.shape
    new = lambda *shape: xs_wave.new_empty(shape)
    return new(K, B, G // 4), new(B, G // 4), new(B, G // 4)


def wavefront_fwd(W_eff: torch.Tensor, b_packed: torch.Tensor,
                  xs_wave: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  lvec: torch.Tensor, S: int, with_residuals: bool = False
                  ) -> Tuple[torch.Tensor, ...]:
    """Forward wavefront: (h_seq (K, B, UH), h_fin, c_fin (B, UH)), and with
    with_residuals also (gates_seq (K, B, 4UH), c_seq (K, B, UH)).

    Arguments as in `wavefront_fwd_plain`. On CUDA all tensors must be
    contiguous, on one device, of one storage dtype (float32 or bfloat16),
    with lvec int32, and the kernel reads only the blocks of W_eff that
    `_wavefront_pack` fills (`unit_blocks`): W_eff must be block-bidiagonal
    as that function makes it, and its other entries are ignored. The
    serving variant (no residuals) is the operator `wavefront_fwd_op`.
    Records no autograd graph (see `wavefront_recurrence`).
    """
    device = _device_type("wavefront_fwd", xs_wave)   # raises off CPU/CUDA
    if not with_residuals:
        return wavefront_fwd_op(W_eff, b_packed, xs_wave, h0, c0, lvec, S)
    if device == "cpu":
        return wavefront_fwd_plain(W_eff, b_packed, xs_wave, h0, c0, lvec, S,
                                   True)
    return _fwd_cuda(W_eff, b_packed, xs_wave, h0, c0, lvec, S, True)


wavefront_fwd.launches = 0
wavefront_fwd.residual_launches = 0
wavefront_fwd.entry_launches = Counter()


def wavefront_bwd(W_eff: torch.Tensor, gates_seq: torch.Tensor,
                  c_seq: torch.Tensor, c_prev_seq: torch.Tensor,
                  dY: torch.Tensor, dh0: torch.Tensor, dc0: torch.Tensor,
                  lvec: torch.Tensor, S: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reverse wavefront: (dgates_seq (K, B, 4UH), dh_fin, dc_fin (B, UH)).

    Arguments as in `wavefront_bwd_plain`; on CUDA the same contract as
    `wavefront_fwd`, W_eff's block structure included: the kernel reads
    only the row blocks `unit_blocks` returns as Wb.
    """
    if _device_type("wavefront_bwd", gates_seq) == "cpu":
        return wavefront_bwd_plain(W_eff, gates_seq, c_seq, c_prev_seq, dY,
                                   dh0, dc0, lvec, S)
    tensors = (W_eff, gates_seq, c_seq, c_prev_seq, dY, dh0, dc0)
    plan = _check("wavefront_bwd", tensors, lvec, gates_seq)
    K, B, G = gates_seq.shape
    UH = G // 4
    if (W_eff.shape != (UH, G) or dh0.shape != (B, UH) or dc0.shape != (B, UH)
            or any(x.shape != (K, B, UH) for x in (c_seq, c_prev_seq, dY))):
        raise ValueError("wavefront_bwd: W_eff, c_seq, c_prev_seq, dY, dh0 or "
                         f"dc0 does not match gates_seq {tuple(gates_seq.shape)}")
    dtype, device = gates_seq.dtype, gates_seq.device
    U = lvec.numel()
    H = UH // U
    wb = W_eff.view(-1)[_block_index(U, H, device)[1]]
    dgates_seq = torch.empty((K, B, G), dtype=dtype, device=device)
    dh_fin = torch.empty((B, UH), dtype=dtype, device=device)
    dc_fin = torch.empty((B, UH), dtype=dtype, device=device)
    entry = f"wavefront_bwd_{_DTYPES[dtype]}"
    ptrs = [x.data_ptr() for x in (wb,) + tensors[1:] + (lvec, dgates_seq,
                                                        dh_fin, dc_fin)]
    entry = _launch("bwd", entry, plan, ptrs, K, B, U, H, S, device)
    wavefront_bwd.launches += 1
    wavefront_bwd.entry_launches[entry] += 1
    return dgates_seq, dh_fin, dc_fin


wavefront_bwd.launches = 0
wavefront_bwd.entry_launches = Counter()


class WavefrontFunction(torch.autograd.Function):
    """The forward wavefront with the JAX package's hand-written backward.

    Differentiable inputs: W_eff, b_packed, xs_wave, h0, c0. The backward
    runs the reverse wavefront (`wavefront_bwd`) for dgates_seq and the
    cotangents of h0 and c0, then forms the weight gradients outside the
    recurrence (`blocks._wavefront_weight_grads`): dW_eff is one product of
    the shifted h_seq against dgates_seq over the (K*B) axis with fp32
    accumulation, db the fp32 sum of dgates over (K, B), and dxs_wave is
    dgates_seq itself. Unused outputs reach the backward as zeros.
    """

    @staticmethod
    def forward(ctx, W_eff, b_packed, xs_wave, h0, c0, lvec, S):
        h_seq, h_fin, c_fin, gates_seq, c_seq = wavefront_fwd(
            W_eff, b_packed, xs_wave, h0, c0, lvec, S, with_residuals=True)
        ctx.save_for_backward(W_eff, h0, c0, lvec, h_seq, gates_seq, c_seq)
        ctx.S = S
        return h_seq, h_fin, c_fin

    @staticmethod
    def backward(ctx, dY, dh_fin, dc_fin):
        W_eff, h0, c0, lvec, h_seq, gates_seq, c_seq = ctx.saved_tensors
        dtype = gates_seq.dtype
        K, B, G = gates_seq.shape
        UH = G // 4
        c_prev_seq = torch.cat([c0[None], c_seq[:-1]])
        dgates_seq, dh0, dc0 = wavefront_bwd(
            W_eff, gates_seq, c_seq, c_prev_seq,
            dY.to(dtype).contiguous(), dh_fin.to(dtype).contiguous(),
            dc_fin.to(dtype).contiguous(), lvec, ctx.S)
        acc = torch.float64 if dtype == torch.float64 else torch.float32
        dW_eff = db = None
        if ctx.needs_input_grad[0]:
            h_prev = torch.cat([h0[None], h_seq[:-1]]).reshape(K * B, UH)
            dW_eff = (h_prev.to(acc).t() @ dgates_seq.reshape(K * B, G).to(acc)
                      ).to(dtype)
        if ctx.needs_input_grad[1]:
            db = dgates_seq.to(acc).sum((0, 1)).to(dtype)
        return dW_eff, db, dgates_seq, dh0, dc0, None, None


def wavefront_recurrence(W_eff: torch.Tensor, b_packed: torch.Tensor,
              xs_wave: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
              lvec: torch.Tensor, S: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The differentiable forward wavefront: (h_seq, h_fin, c_fin).

    Without a gradient to record (inference mode, no_grad, or no input that
    requires one) this is the residual-free `wavefront_fwd`, the operator
    `wavefront_fwd_op`; otherwise
    `WavefrontFunction`, which stores the residuals for its backward.
    """
    tensors = (W_eff, b_packed, xs_wave, h0, c0)
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        return WavefrontFunction.apply(W_eff, b_packed, xs_wave, h0, c0,
                                       lvec, S)
    return wavefront_fwd(W_eff, b_packed, xs_wave, h0, c0, lvec, S)
