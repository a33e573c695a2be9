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
`wavefront_grid_bwd.cu`): one cooperative launch of U * H / N CTAs in
thread-block clusters of CTAs of one unit, each CTA owning N state columns
of one unit, the units handing each step over through per-unit step flags
(`_grid_plan`). Their entry points are
`wavefront_grid_{fwd,fwd_res,bwd}_{f32,bf16}`, counted in the same
`entry_launches` and in the same totals.

Where no grid plan keeps a CTA's weight slice in shared memory with all
CTAs resident (a unit's 2H x 4N slice over 227 KB at every N: fp32 H over
520, bf16 over 1056; or a unit's CTAs at N <= 32 over the card's
residency), the grid kernels run in their streamed mode (`_stream_plan`,
entry points `wavefront_grid_{fwd,fwd_res,bwd}_stream_{f32,bf16}`): the
wrapper packs every CTA's slice into tiles in mma-fragment order, one
gather a call (`_stream_tiles`); each CTA keeps as many of its chunks
resident in shared memory as the 227 KB hold beside its rings, and each
step streams the others from L2 through a ring of shared-memory slots,
ahead of the step's hand-off, and its rows through a second ring, one
tensor-map copy a chunk.

The kernels refuse a hidden size that is not a multiple of 8, and a stack
whose grid CTAs the card cannot hold at once even at N = 64. The model
never hands them either: it packs each unit zero-padded to a multiple of 8
(`models.blocks.padded_width`), and runs a stack too wide for one launch
as depth groups, runs of consecutive layers each launched alone
(`depth_groups`, `wavefront_groups`); a streamed group holds no more
layers than keep a step's streamed weights within `_L2_BUDGET`. A unit
that fits no launch at all (more than 64 x 132 state columns) raises.

Inside a CUDA-graph capture a launch is recorded, not run, and reads no
host value that a replay would freeze: the shape caches `_held`,
`_grid_held`, `_indices`, `_tile_index`, `_feeds_of`, `_groups` and the
built libraries are filled by an eager launch of the same shape first (the
streamed tiles are gathered on the stream, so a graph records the gather); the grid kernels' step flags are
zeroed on the stream, which the graph replays; the launchers'
cudaFuncSetAttribute
is accepted during a capture, and the cluster-dimension and cooperative
launch attributes are recorded with the kernel node (an H100, torch
2.11.0+cu128, CUDA 12.8). `launches.launch_counts` and
`launches.add_launch_counts` let a graph count its replays' launches.

`wavefront_recurrence` is the differentiable recurrence the model calls:
the serving forward alone (the operator) when no gradient is wanted,
otherwise `WavefrontFunction`, whose backward runs the reverse wavefront
and forms the weight gradients outside the recurrence, as the JAX
package's custom VJP does (`vae_teb_tpu/models/blocks.py::_wavefront_core`).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import build
from .launches import counted
from .wavefront_ref import wavefront_bwd_plain, wavefront_fwd_plain

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_UNITS = 8           # the portable cluster size: one CTA per unit
_MAX_THREADS = 256       # 4H threads a CTA; the kernels are built for 256
_SMEM_LIMIT = 232448     # 227 KB of shared memory per block on Hopper
_SMS = 132               # H100 SXM
_MAX_ROWS = 10           # batch rows per cluster the kernels are built for


_GRID_COLS = (8, 16, 32)      # state columns a grid CTA may own
_GRID_CLUSTERS = (8, 4, 2, 1)  # CTAs of one unit a cluster may hold
_GRID_ROWS = 32              # batch rows a pass of the grid kernels
_GRID_BUFS = (2, 8)          # most stage buffers: forward, reverse
_FLAG_STRIDE = 32            # int32 words from a unit's step flag to the next
_WARPS = 8                   # consumer warps of a grid CTA
_STREAM_COLS = (8, 16, 32, 64)   # state columns a streamed CTA may own
_STREAM_ROW_BYTES = 2048    # most bytes a row of a weight or rows chunk holds
_STREAM_BUFS = 2            # slots of each of a streamed CTA's two rings
# The most weight bytes a step of a streamed depth group may stream (its
# resident chunks not counted), so that they can stay in the H100's 50 MB
# L2 from one step to the next. With nothing resident and one ring, on an
# H100 (700 W; chip_smoke.py phase 15 (d), B=32, K=303, fp32) a group of
# one layer of both encoder streams at H=1024, 33.5 MB a step, runs its
# forward in 5.39 ms and its reverse in 8.02 ms; a group of two layers of
# both with their two feed blocks, 100.7 MB a step, in 16.56 / 18.95 ms,
# against 10.78 / 16.04 ms for the two groups it replaces: over the L2 a
# launch is 1.54x (forward) and 1.18x (reverse) slower. 40 MiB keeps one
# layer of both streams together at fp32 H=1024 and bf16 H=1536 (37.7 MB).
_L2_BUDGET = 40 * 2 ** 20


class LaunchPlan(NamedTuple):
    rows: int        # cluster: M, batch rows per cluster; grid: rows a pass
    clusters: int    # cluster: ceil(B / M), each of U CTAs; grid: clusters
    fwd_smem: int    # dynamic shared memory of a forward CTA, bytes
    bwd_smem: int    # ... of a reverse-wavefront CTA
    kind: str = "cluster"   # "cluster", "grid" or "stream"
    cols: int = 0    # grid: N, state columns of one unit a CTA owns
    ctas: int = 0    # grid: U * H / N CTAs in the cooperative launch
    cluster: int = 0   # grid: CTAs a thread-block cluster (of one unit)
    fwd_bufs: int = 0  # grid: stage buffers of a forward CTA's ring (stream:
    bwd_bufs: int = 0  # slots of each of its rings); ... of a reverse CTA's
    flags: int = 0     # grid: int32 words of the step flags, U * 32
    fwd_chunk: int = 0   # stream: depths of a forward chunk (a tile, a slot)
    bwd_chunk: int = 0   # ... of a reverse chunk
    fwd_resident: int = 0   # stream: chunks of a forward CTA's step that
    bwd_resident: int = 0   # stay in shared memory; ... of a reverse CTA's
    fwd_row_chunk: int = 0  # stream: depths of a forward rows chunk (a
    bwd_row_chunk: int = 0  # rows slot, whole weight chunks); ... reverse


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


def _up128(x: int) -> int:
    return -(-x // 128) * 128


def _grid_layout(fwd: bool, N: int, H: int, item: int, rows: int,
                 bufs: int) -> int:
    """Bytes of shared memory of a forward or reverse grid CTA owning N
    columns, for `rows` batch rows a pass and a ring of `bufs` stage
    buffers, as wavefront_grid.cuh::grid_layout lays it out (each region
    128-byte aligned): 256 bytes of mbarriers; the weight slice as mma
    fragments (2H x 4N forward, 8H x N reverse, the depth of each of 2 or 8
    stages rounded up to the mma's 8 (tf32) or 16 (bf16)); the ring, each
    buffer the pass's rows (rounded up to 8 forward, 16 reverse) of H
    storage values plus 16 bytes; the depth slices' sums (fp32, 8 / m-tiles
    slices of those rows by 4N + 8 or N columns); two steps' inputs (4 or 7
    segments of N a row); the forward's bias (fp32, 4N); the carried state
    (fp32, 2 or 3 of rows x N)."""
    kw = 8 if item == 4 else 16
    kts = -(-H // kw)
    rs = kts * kw + 16 // item
    stages = 2 if fwd else 8
    padded = -(-rows // 8) * 8 if fwd else -(-rows // 16) * 16
    mt = N // 4 if fwd else padded // 16
    nt = padded // 8 if fwd else N // 8
    off = _up128(256 + (mt if fwd else nt) * stages * kts * 32
                 * (16 if fwd else 8))
    return _layout_tail(fwd, N, item, rows, off + bufs * padded * rs * item)


def _layout_tail(fwd: bool, N: int, item: int, rows: int, off: int) -> int:
    """The regions after the ring, from byte `off` (wavefront_grid.cuh::
    layout_tail): the depth slices' sums (8 / m-tiles slices, at least
    one), two steps' inputs, the forward's bias, the carried state; the
    total bytes."""
    padded = -(-rows // 8) * 8 if fwd else -(-rows // 16) * 16
    ks = max(1, _WARPS // (N // 4 if fwd else padded // 16))
    off = _up128(_up128(off) + ks * padded * (4 * N + 8 if fwd else N) * 4)
    off = _up128(off + 2 * rows * (4 if fwd else 7) * N * item)
    off = _up128(off + (16 * N if fwd else 0))
    return _up128(off + (2 if fwd else 3) * rows * N * 4)


def _grid_smem(N: int, H: int, item: int, rows: int, fwd_bufs: int,
               bwd_bufs: int) -> Tuple[int, int]:
    """Shared memory of a forward and a reverse grid CTA (`_grid_layout`)."""
    return (_grid_layout(True, N, H, item, rows, fwd_bufs),
            _grid_layout(False, N, H, item, rows, bwd_bufs))


def _grid_plan(B: int, U: int, H: int, item: int,
               resident: Optional[Callable[[int, int, int, int], int]]
               ) -> LaunchPlan:
    """The grid kernels' plan. Rows a pass: min(B, 32), passes one after
    another in one launch. Columns N (8, 16, 32, dividing H), the fewest
    first, whose CTAs' shared memory fits 227 KB with a ring of at least
    one stage buffer (the most up to 2 forward, 8 reverse); then clusters
    of CS CTAs of one unit (8, 4, 2, 1 dividing H / N), the largest
    first; the first (N, CS) with which all U * H / N CTAs are resident
    at once wins. For bf16 storage every (N, CS >= 4) comes before the
    smaller clusters: its products are cheap, and a reverse step's eight
    stages of rows cost less in clusters of 8 of N = 16 than in clusters
    of 2 of N = 8 (2.205 against 3.024 ms at U=8, H=128, B=32 on an
    H100, each plan forced through `resident`); fp32, whose 3xTF32
    products want the most CTAs, keeps N = 8 (2.866-2.993 against 3.189
    ms there, 3.460-3.560 against 5.832 ms at U=3, H=256).
    `resident(N, CS, fwd_smem, bwd_smem)` says how many CTAs the card holds
    in clusters of CS (the CUDA wrappers ask the card,
    cudaOccupancyMaxActiveClusters), by default whole clusters on 132 SMs.
    Raises when nothing fits: a cooperative launch cannot run in waves."""
    rows = min(B, _GRID_ROWS)
    tried, fits = [], []
    for N in _GRID_COLS:
        if H % N:
            continue
        bufs = [next((n for n in range(most, 0, -1) if _grid_layout(
            fwd, N, H, item, rows, n) <= _SMEM_LIMIT), 0)
            for fwd, most in zip((True, False), _GRID_BUFS)]
        if not all(bufs):
            tried.append(f"N={N}: over {_SMEM_LIMIT} bytes of shared memory")
            continue
        fits += [(N, CS, bufs) for CS in _GRID_CLUSTERS if (H // N) % CS == 0]
    if item == 2:
        fits.sort(key=lambda f: f[1] < 4)   # stable: N order kept
    for N, CS, bufs in fits:
        fwd, bwd = _grid_smem(N, H, item, rows, *bufs)
        ctas = U * H // N
        held = resident(N, CS, fwd, bwd) if resident else _SMS // CS * CS
        if ctas <= held:
            return LaunchPlan(rows, ctas // CS, fwd, bwd, "grid", N, ctas,
                              CS, bufs[0], bufs[1], U * _FLAG_STRIDE)
        tried.append(f"N={N} in clusters of {CS}: {ctas} CTAs, the card "
                     f"holds {held}")
    raise ValueError(f"{U} units of H={H}: no kernel takes this shape (the "
                     f"cluster kernels: more than {_MAX_UNITS} units, 4H "
                     f"over {_MAX_THREADS} threads or over {_SMEM_LIMIT} "
                     f"bytes of shared memory; the grid kernels: "
                     f"{'; '.join(tried)})")


def _up1024(x: int) -> int:
    return -(-x // 1024) * 1024


def _stream_layout(fwd: bool, N: int, item: int, rows: int, CS: int,
                   bufs: int, kc: int, rc: int, kr: int) -> int:
    """Bytes of shared memory of a forward or reverse CTA of the streamed
    mode, as wavefront_grid.cuh::stream_layout lays it out: 1024 bytes of
    mbarriers; the rows' ring of `bufs` slots, each CS parts (1024-byte
    aligned) of the pass's rows (rounded up to 8 forward, 16 reverse) / CS
    by rc storage values, as the 128-byte swizzled tensor copies land them;
    the weight ring of `bufs` slots, each a chunk's tile (4N x kc
    forward, kc x N reverse); `kr` resident tiles; then as `_grid_layout`
    (each region 128-byte aligned): the depth slices' sums (8 / m-tiles
    slices, one where the forward's 4N / 16 m-tiles are 8 or more), two
    steps' inputs, the forward's bias, the carried state. Nothing here
    grows with H."""
    padded = -(-rows // 8) * 8 if fwd else -(-rows // 16) * 16
    rank = _up1024(rc * item * (padded // CS))
    tile = (4 * N if fwd else N) * kc * item
    return _layout_tail(fwd, N, item, rows, 1024 + bufs * (CS * rank + tile)
                        + kr * tile)


def _stream_ring(fwd: bool, N: int, H: int, item: int, rows: int, CS: int
                 ) -> Optional[Tuple[int, int, int]]:
    """(weight chunk depths, rows chunk depths, resident chunks) of a
    forward or reverse CTA of the streamed mode: the deepest weight chunk
    of `_STREAM_ROW_BYTES`, 1/2, ... 1/16 of it a row (at least the tensor
    copies' 128-byte pieces) whose rings of `_STREAM_BUFS` slots fit 227
    KB; rows chunks of as many whole weight chunks as `_STREAM_ROW_BYTES`
    a row hold (fewer where H is shorter, half as many where that does not
    fit); then as many resident chunks as the rest of 227 KB holds, up to
    a step's most (2 stages forward, 8 reverse, of ceil(H / kc) chunks).
    Deeper chunks, not deeper rings or more resident chunks, are what
    shortened a step (`PERF.md` section 6). None where no ring
    fits."""
    fits = lambda kc, rc: _stream_layout(
        fwd, N, item, rows, CS, _STREAM_BUFS, kc, rc, 0) <= _SMEM_LIMIT
    for kc in (_STREAM_ROW_BYTES // item >> k for k in range(5)
               if _STREAM_ROW_BYTES >> k >= 128):
        per = max(1, min(_STREAM_ROW_BYTES // item // kc, -(-H // kc)))
        while per > 1 and not fits(kc, kc * per):
            per //= 2
        if not fits(kc, kc * per):
            continue
        tile = (4 * N if fwd else N) * kc * item
        free = _SMEM_LIMIT - _stream_layout(fwd, N, item, rows, CS,
                                            _STREAM_BUFS, kc, kc * per, 0)
        return kc, kc * per, min((2 if fwd else 8) * -(-H // kc),
                                 free // tile)
    return None


def _stream_plan(B: int, U: int, H: int, item: int,
                 resident: Optional[Callable[[int, int, int, int], int]],
                 why: str) -> LaunchPlan:
    """The streamed mode's plan, for a shape no resident grid plan takes
    (`why` says why). Rows a pass min(B, 32). Columns N (8, 16, 32, 64;
    ceil(H / N) CTAs a unit, the last owning H mod N columns where N does
    not divide H), the fewest first; then clusters of CS CTAs of one unit
    (8, 4, 2, 1 dividing ceil(H / N)), the largest first, so that a step's
    rows cross from L2 once a cluster, but each CTA's part of the pass's
    rows at least 8 (ldmatrix reads 8 rows of one part, whose swizzles
    then differ); for each direction the chunks and the resident share
    (`_stream_ring`); the first (N, CS) with which all its CTAs are
    resident at once wins (`resident` as `_grid_plan` takes it, asked of
    the streamed kernels).

    The resident share is what the shared memory holds: a CTA keeps the
    last min(kr, chunks) chunks of its step for all K steps and streams
    the others, each step, from L2 (chip_smoke.py phase 15 (d) times the
    plan against a share of 0 and against clusters of 2). Raises when
    nothing fits."""
    rows = min(B, _GRID_ROWS)
    tried = []
    for N in _STREAM_COLS:
        per_unit = -(-H // N)     # the last CTA of a unit may own fewer
        ctas = U * per_unit
        for CS in _GRID_CLUSTERS:
            if per_unit % CS or -(-rows // 8) * 8 < 8 * CS:
                continue
            rings = (_stream_ring(True, N, H, item, rows, CS),
                     _stream_ring(False, N, H, item, rows, CS))
            if None in rings:
                tried.append(f"streamed N={N}: no rings of {_STREAM_BUFS} "
                             f"slots in {_SMEM_LIMIT} bytes")
                break
            (fkc, frc, fkr), (bkc, brc, bkr) = rings
            fwd = _stream_layout(True, N, item, rows, CS, _STREAM_BUFS, fkc,
                                 frc, fkr)
            bwd = _stream_layout(False, N, item, rows, CS, _STREAM_BUFS, bkc,
                                 brc, bkr)
            held = resident(N, CS, fwd, bwd) if resident else _SMS // CS * CS
            if ctas <= held:
                return LaunchPlan(rows, ctas // CS, fwd, bwd, "stream", N,
                                  ctas, CS, _STREAM_BUFS, _STREAM_BUFS,
                                  U * _FLAG_STRIDE, fkc, bkc, fkr, bkr, frc,
                                  brc)
            tried.append(f"streamed N={N} in clusters of {CS}: {ctas} CTAs, "
                         f"the card holds {held}")
    raise ValueError(f"{why[:-1]}; the streamed grid kernels: "
                     f"{'; '.join(tried)})")


def _launch_plan(B: int, U: int, H: int, dtype: torch.dtype,
                 resident: Optional[Callable[[int, int, int], int]] = None,
                 grid_resident: Optional[Callable[[int, int, int, int], int]]
                 = None,
                 stream_resident: Optional[Callable[[int, int, int, int], int]]
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
    `grid_resident`), with their weight slices resident where a plan fits,
    else streamed (`_stream_plan`, with `stream_resident`, by default
    `grid_resident`), which raise when their CTAs cannot all be resident.
    All refuse H not a multiple of 8 (16-byte copies of a unit's row
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
        try:
            return _grid_plan(B, U, H, item, grid_resident)
        except ValueError as e:
            return _stream_plan(B, U, H, item, stream_resident
                                or grid_resident, str(e))
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


def _card_grid_resident(device: torch.device, dtype: torch.dtype,
                        stream: bool = False
                        ) -> Callable[[int, int, int, int], int]:
    """`grid_resident` for `_launch_plan` on a card: the CTAs that both grid
    kernels (with `stream`, their streamed mode: `stream_resident`) can hold
    at once in clusters of CS (cudaOccupancyMaxActiveClusters times CS),
    asked once per shape; raises on a CUDA error."""
    mode = "_stream" if stream else ""

    def held(N: int, CS: int, fwd_smem: int, bwd_smem: int) -> int:
        key = (device, dtype, stream, CS, fwd_smem, bwd_smem)
        if key not in _grid_held:
            with torch.cuda.device(device):
                n = min(_max_ctas(kind + mode)(int(dtype == torch.bfloat16),
                                               CS, smem)
                        for kind, smem in (("fwd", fwd_smem),
                                           ("bwd", bwd_smem)))
            if n < 0:
                raise RuntimeError(f"the card's residency of grid CTAs with "
                                   f"{max(fwd_smem, bwd_smem)} bytes of "
                                   f"shared memory in clusters of {CS}: "
                                   f"CUDA error {-n}")
            _grid_held[key] = n
        return _grid_held[key]
    return held


# A depth group: (stream, first layer, end layer) for each stream it holds
Group = Tuple[Tuple[int, int, int], ...]


def _step_bytes(plan: LaunchPlan, units: int, feeds: int, H: int,
                item: int) -> int:
    """Weight bytes a step of a streamed launch reads from L2, the larger
    of the forward's and the reverse's: each CTA's chunks (the forward's
    1 or, with a feed block, 2 stages of ceil(H / kc); the reverse's 4 or,
    feeding a unit above, 8) but its resident ones, a tile each. `feeds`
    units have a feed block in and as many one out."""
    per_unit = -(-H // plan.cols)
    most = 0
    for fwd in (True, False):
        kc = plan.fwd_chunk if fwd else plan.bwd_chunk
        kr = plan.fwd_resident if fwd else plan.bwd_resident
        lo = (1 if fwd else 4) * -(-H // kc)
        tile = (4 if fwd else 1) * plan.cols * kc * item
        chunks = ((units - feeds) * max(0, lo - kr)
                  + feeds * max(0, 2 * lo - kr))
        most = max(most, per_unit * chunks * tile)
    return most


def depth_groups(depths: Tuple[int, ...], H: int, dtype: torch.dtype,
                 grid_resident: Optional[Callable[[int, int, int, int], int]]
                 = None,
                 stream_resident: Optional[Callable[[int, int, int, int], int]]
                 = None) -> Tuple[Group, ...]:
    """Partition a stack of LSTM streams (`depths` layers each, hidden
    size H, a multiple of 8) into the fewest runs of consecutive layers
    whose units all fit one launch, each run one wavefront of its own.

    Layer l of every stream goes in one group (the streams are
    independent); a group of layers [l0, l1) holds, for every stream
    deeper than l0, its layers [l0, min(depth, l1)). Where even one layer
    of all streams fits no launch, each stream is partitioned alone,
    stream after stream. A run fits when `_launch_plan` takes its units
    with their weight slices resident (a cluster or a resident grid plan)
    at 32 rows (the grid kernels' most rows a pass, so any batch fits
    what 32 rows fit: the partition never depends on B), with
    `grid_resident` as `_launch_plan` takes it. Greedy is fewest: a run
    inside a run that fits fits too.

    Where not even one unit fits a resident plan, the groups are streamed
    (`_stream_plan`, with `stream_resident`, by default `grid_resident`):
    a run fits when a streamed plan takes it and the weights a step
    streams (`_step_bytes`: each unit's recurrent block and each feed block
    inside the run, but the chunks its CTAs keep resident) are at most
    `_L2_BUDGET` bytes, so that they come from L2 and not from device
    memory; a single unit always fits if any plan takes it. Raises when one unit fits no launch (more CTAs than the card
    holds at every N), naming the limit, the shape and the dtype."""
    depths = tuple(depths)
    item = torch.empty((), dtype=dtype).element_size()
    tried: Dict[int, Optional[str]] = {}

    def refused(U):   # why U units fit no launch, or None
        if U not in tried:
            try:
                tried[U] = (_launch_plan(_GRID_ROWS, U, H, dtype,
                                         grid_resident=grid_resident,
                                         stream_resident=stream_resident),
                            None)
            except ValueError as e:
                tried[U] = None, str(e)
        return tried[U][1]

    def resident(units, feeds):
        return refused(units) is None and tried[units][0].kind != "stream"

    def streamed(units, feeds):
        return refused(units) is None and (units == 1 or _step_bytes(
            tried[units][0], units, feeds, H, item) <= _L2_BUDGET)

    def runs(streams, fits):   # greedy runs of layers over (stream, depth)
        units = lambda l0, l1: sum(max(0, min(d, l1) - l0) for _, d in streams)
        feeds = lambda l0, l1: units(l0, l1) - sum(d > l0 for _, d in streams)
        out, l0, D = [], 0, max(d for _, d in streams)
        while l0 < D:
            l1 = l0 + 1
            while l1 < D and fits(units(l0, l1 + 1), feeds(l0, l1 + 1)):
                l1 += 1
            out.append(tuple((s, l0, min(d, l1)) for s, d in streams
                             if d > l0))
            l0 = l1
        return out

    streams = list(enumerate(depths))
    if resident(len(depths), 0):
        return tuple(runs(streams, resident))
    if resident(1, 0):
        return tuple(g for s in streams for g in runs([s], resident))
    why = refused(1)
    if why is not None:
        raise ValueError(f"one LSTM unit of hidden size {H} in "
                         f"{str(dtype)[6:]} fits no wavefront launch: its "
                         f"CTAs are more than the card holds at once ({why})")
    if streamed(len(depths), 0):
        return tuple(runs(streams, streamed))
    return tuple(g for s in streams for g in runs([s], streamed))


_groups: Dict[tuple, Tuple[Group, ...]] = {}


def wavefront_groups(depths: Tuple[int, ...], H: int, dtype: torch.dtype,
                     device: torch.device) -> Tuple[Group, ...]:
    """`depth_groups` on `device`: on the CPU one group of every layer (the
    plain recurrence takes any stack); on a card the partition its
    residency allows (`_card_grid_resident`), computed at the first call
    of a shape and cached, so that a CUDA-graph capture of a step, which
    may not ask the card anything a replay would skip, only reads it."""
    depths = tuple(depths)
    if device.type != "cuda":
        return (tuple((s, 0, d) for s, d in enumerate(depths)),)
    key = (depths, H, dtype, device)
    if key not in _groups:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the depth groups of {depths} layers of H={H} "
                               f"are not known yet: run the shape eagerly "
                               f"once before capturing it")
        _groups[key] = depth_groups(
            depths, H, dtype, _card_grid_resident(device, dtype),
            _card_grid_resident(device, dtype, stream=True))
    return _groups[key]


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


_feeds_of: Dict[int, tuple] = {}


def _feeds(lvec: torch.Tensor) -> Tuple[bool, ...]:
    """Which units a feed block reaches (lvec[u] > 0), read on the host
    once per lvec tensor (the model's are cached per layout, `blocks.
    _lvec_like`) and kept while that tensor lives, so that a CUDA-graph
    capture, which may not copy to the host, only reads it."""
    hit = _feeds_of.get(id(lvec))
    if hit is None or hit[0]() is not lvec:
        if lvec.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the streamed tiles' layout is not known for "
                               "this lvec yet: run the shape eagerly once "
                               "before capturing it")
        hit = weakref.ref(lvec), tuple(v > 0 for v in lvec.tolist())
        _feeds_of[id(lvec)] = hit
    return hit[1]


_tile_index: Dict[tuple, Tuple[torch.Tensor, Optional[torch.Tensor]]] = {}


def _stream_index(feeds: Tuple[bool, ...], H: int, N: int, kc: int, kw: int,
                  fwd: bool, device: torch.device
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Flat indices into W_eff (UH, 4UH) of the streamed tiles, int32, and
    the mask of the entries past H (depth or column; None where there are
    none), which the tiles hold as zeros. Tiles in order (unit, column
    block of N, stage,
    chunk of kc depths), each in the fragment order of the resident grid
    kernels' weight slice: forward, stage 0 unit u's recurrent block and
    stage 1 its feed block (units with feeds[u] only), A fragments
    [N / 4][kc / kw][32 lanes][4 registers] (x2 bf16 halves) of the 4N
    gate columns by the depth; reverse, stages 0-3 unit u's recurrent
    block's gates and 4-7 the gates of its feed block into unit u+1
    (where feeds[u+1] only), B fragments [N / 8][kc / kw][32][2] (x2) of
    the depth by the N state columns. Built once per shape."""
    key = (feeds, H, N, kc, kw, fwd, device)
    if key not in _tile_index:
        U = len(feeds)
        UH = U * H
        nc = -(-H // kc)
        half = kw // 8          # storage values a 32-bit register holds
        lane = torch.arange(32)
        g, t = lane // 4, lane % 4
        if fwd:
            r = torch.arange(4)
            shape = (N // 4, kc // kw, 32, 4, half)
            m = (torch.arange(N // 4).view(-1, 1, 1, 1, 1) * 16
                 + g.view(1, 1, -1, 1, 1) + (r % 2).view(1, 1, 1, -1, 1) * 8)
            d = (torch.arange(kc // kw).view(1, -1, 1, 1, 1) * kw
                 + (t * half).view(1, 1, -1, 1, 1)
                 + (r // 2).view(1, 1, 1, -1, 1) * (kw // 2)
                 + torch.arange(half).view(1, 1, 1, 1, -1))
        else:
            r = torch.arange(2)
            shape = (N // 8, kc // kw, 32, 2, half)
            m = (torch.arange(N // 8).view(-1, 1, 1, 1, 1) * 8
                 + g.view(1, 1, -1, 1, 1))
            d = (torch.arange(kc // kw).view(1, -1, 1, 1, 1) * kw
                 + (t * half).view(1, 1, -1, 1, 1)
                 + r.view(1, 1, 1, -1, 1) * (kw // 2)
                 + torch.arange(half).view(1, 1, 1, 1, -1))
        m, d = (x.expand(shape).reshape(-1) for x in (m, d))
        blocks = -(-H // N)      # column blocks a unit, the last maybe short
        t = torch.arange(blocks).view(-1, 1, 1) * N + (m % N if fwd else m
                                                       ).view(1, 1, -1)
        depth = torch.arange(nc).view(1, -1, 1) * kc + d.view(1, 1, -1)
        pad = (depth >= H) | (t >= H)                       # (blocks, nc, e)
        parts, masks = [], []
        for u in range(U):
            if fwd:      # stage s: rows of unit u - s, gate columns of u
                stages = [(u, 0)] + ([(u - 1, 0)] if feeds[u] else [])
                col = (m // N) * UH + u * H + t                 # (blocks, 1, e)
                idx = [(v * H + depth) * 4 * UH + col for v, _ in stages]
            else:        # stage s: rows of unit u, gate s % 4 of u + s // 4
                last = u + 1 == U or not feeds[u + 1]
                stages = [(u + s // 4, s % 4) for s in range(4 if last else 8)]
                row = u * H + t                                 # (blocks, 1, e)
                idx = [row * 4 * UH + q * UH + v * H + depth for v, q in stages]
            idx = torch.stack([i.expand(blocks, nc, -1) for i in idx], 1)
            mask = pad.unsqueeze(1).expand(-1, len(stages), -1, -1)
            parts.append(torch.where(mask, 0, idx).reshape(-1))
            masks.append(mask.reshape(-1))
        mask = torch.cat(masks)
        _tile_index[key] = (torch.cat(parts).to(torch.int32).to(device),
                            mask.to(device) if mask.any() else None)
    return _tile_index[key]


def _stream_tiles(W_eff: torch.Tensor, lvec: torch.Tensor, plan: LaunchPlan,
                  fwd: bool) -> torch.Tensor:
    """The streamed mode's weight tiles (`_stream_index`), gathered from
    W_eff on its device and stream every call: one index_select, and zeros
    written past H where a chunk is short."""
    U = lvec.numel()
    H = W_eff.shape[0] // U
    kw = 8 if W_eff.element_size() == 4 else 16
    kc = plan.fwd_chunk if fwd else plan.bwd_chunk
    idx, pad = _stream_index(_feeds(lvec), H, plan.cols, kc, kw, fwd,
                             W_eff.device)
    tiles = torch.index_select(W_eff.view(-1), 0, idx)
    if pad is not None:
        tiles.masked_fill_(pad, 0)
    return tiles


def _max_clusters(kind: str):
    """wavefront_{kind}_max_clusters(bf16, B, U, H, M, smem) -> int."""
    fn = build.load(f"wavefront_{kind}.cu")[f"wavefront_{kind}_max_clusters"]
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return fn


def _max_ctas(kind: str):
    """wavefront_grid_{kind}_max_ctas(bf16, CS, smem) -> int; `kind` fwd,
    bwd, fwd_stream or bwd_stream."""
    fn = build.load(f"wavefront_grid_{kind.split('_')[0]}.cu")[
        f"wavefront_grid_{kind}_max_ctas"]
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


def _kernel(source: str, entry: str, n_ptr: int, n_int: int):
    fn = getattr(build.load(source), entry)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
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
                        _card_grid_resident(seq.device, dtype),
                        _card_grid_resident(seq.device, dtype, stream=True))


def _launch(kind: str, entry: str, plan: LaunchPlan, ptrs, K: int, B: int,
            U: int, H: int, S: int, device: torch.device) -> str:
    """Launch `entry` of the cluster or the grid kernel of `kind` ("fwd" or
    "bwd") as `plan` says; raises on a CUDA error. Returns the entry point's
    name as counted: the grid kernels' carry `grid_` after `wavefront_`,
    their streamed mode's also `_stream` before the storage type."""
    smem = plan.fwd_smem if kind == "fwd" else plan.bwd_smem
    if plan.kind in ("grid", "stream"):
        entry = entry.replace("wavefront_", "wavefront_grid_", 1)
        source = f"wavefront_grid_{kind}.cu"
        # the units' step flags, zero at the start of every launch
        flags = torch.zeros(plan.flags, dtype=torch.int32, device=device)
        ptrs = list(ptrs) + [flags.data_ptr()]
        bufs = plan.fwd_bufs if kind == "fwd" else plan.bwd_bufs
        ints = (K, B, U, H, S, plan.cols, plan.cluster, plan.rows, bufs)
        if plan.kind == "stream":
            head, dt = entry.rsplit("_", 1)
            entry = f"{head}_stream_{dt}"
            ints += ((plan.fwd_chunk, plan.fwd_row_chunk, plan.fwd_resident)
                     if kind == "fwd" else
                     (plan.bwd_chunk, plan.bwd_row_chunk, plan.bwd_resident))
        ints += (smem,)
    else:
        source = f"wavefront_{kind}.cu"
        ints = (K, B, U, H, S, plan.rows, smem)
    with torch.cuda.device(device):
        err = _kernel(source, entry, len(ptrs), len(ints))(
            *ptrs, *ints, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: " + (
            f"CUDA error {err}" if err < 10000 else
            f"cuTensorMapEncodeTiled refused a tensor map (CUresult "
            f"{err - 10000})"))
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
    wf = (_stream_tiles(W_eff, lvec, plan, True) if plan.kind == "stream"
          else W_eff.view(-1)[_block_index(U, H, device)[0]])
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


@counted("launches", "residual_launches")
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


@counted("launches")
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
    wb = (_stream_tiles(W_eff, lvec, plan, False) if plan.kind == "stream"
          else W_eff.view(-1)[_block_index(U, H, device)[1]])
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
