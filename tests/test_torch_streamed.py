"""The grid kernels' streamed-weight mode: the plan and the depth groups
that take it (only where no resident plan fits, every earlier plan kept
field for field), its resident share and the shared-memory layout the
plan mirrors from the kernels' header, the tile packer against
`unit_blocks`, the streamed products' summation order emulated on the
CPU against the plain recurrence, one run at H=1024 against the JAX
package, and, on a card, the streamed entry points against their plain
versions.

JAX is imported inside the test that compares with it, so the CUDA cases
also run where JAX is not installed:
    python -m pytest tests/test_torch_streamed.py -m cuda
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from vae_teb_tpu_torch.kernels import (wavefront, wavefront_bwd,
                                       wavefront_bwd_plain, wavefront_fwd,
                                       wavefront_fwd_plain,
                                       wavefront_recurrence)
from vae_teb_tpu_torch.kernels.wavefront import (_L2_BUDGET, LaunchPlan,
                                                 _grid_layout, _launch_plan,
                                                 _step_bytes, _stream_layout,
                                                 _stream_tiles, depth_groups,
                                                 unit_blocks)
from vae_teb_tpu_torch.models.blocks import LSTMStream, run_lstm_streams

torch.set_num_threads(2)

LIMIT = 232448      # a CTA's shared memory on Hopper
# the H100's residency of grid CTAs in clusters of CS (15 clusters of 8,
# 30 of 4, 66 of 2)
H100 = {8: 120, 4: 120, 2: 132, 1: 132}


def _h100(N, CS, fwd, bwd):
    return H100[CS]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (depths, H, dtype, depth groups, the plan of each group at B=32 by default
# residency, and with the H100's) as the planner gave them before the
# streamed mode existed: LaunchPlan's fields but the streamed mode's chunks
# and resident shares
BEFORE = [
    ((4, 4), 8, torch.float32, 1, (2, 16, 3856, 4560, 'cluster', 0, 0, 0, 0, 0, 0), (2, 16, 3856, 4560, 'cluster', 0, 0, 0, 0, 0, 0)),
    ((4, 4), 8, torch.bfloat16, 1, (2, 16, 2576, 3312, 'cluster', 0, 0, 0, 0, 0, 0), (2, 16, 2576, 3312, 'cluster', 0, 0, 0, 0, 0, 0)),
    ((4, 4), 64, torch.float32, 1, (2, 16, 145424, 151056, 'cluster', 0, 0, 0, 0, 0, 0), (2, 16, 145424, 151056, 'cluster', 0, 0, 0, 0, 0, 0)),
    ((4, 4), 64, torch.bfloat16, 1, (2, 16, 77840, 83728, 'cluster', 0, 0, 0, 0, 0, 0), (2, 16, 77840, 83728, 'cluster', 0, 0, 0, 0, 0, 0)),
    ((4, 4), 104, torch.float32, 1, (32, 104, 85376, 158976, 'grid', 8, 104, 1, 2, 8, 256), (32, 104, 85376, 158976, 'grid', 8, 104, 1, 2, 8, 256)),
    ((4, 4), 104, torch.bfloat16, 1, (32, 104, 56704, 90368, 'grid', 8, 104, 1, 2, 8, 256), (32, 104, 56704, 90368, 'grid', 8, 104, 1, 2, 8, 256)),
    ((4, 4), 512, torch.float32, 4, (32, 16, 228224, 218880, 'grid', 8, 128, 8, 1, 1, 64), (32, 64, 228224, 218880, 'grid', 8, 128, 2, 1, 1, 64)),
    ((4, 4), 512, torch.bfloat16, 2, (32, 16, 228864, 226560, 'grid', 16, 128, 8, 2, 2, 128), (32, 64, 228864, 226560, 'grid', 16, 128, 2, 2, 2, 128)),
    ((3,), 256, torch.float32, 1, (32, 12, 163200, 220416, 'grid', 8, 96, 8, 2, 4, 96), (32, 12, 163200, 220416, 'grid', 8, 96, 8, 2, 4, 96)),
    ((3,), 256, torch.bfloat16, 1, (32, 12, 93568, 182528, 'grid', 8, 96, 8, 2, 8, 96), (32, 12, 93568, 182528, 'grid', 8, 96, 8, 2, 8, 96)),
    ((2,), 256, torch.float32, 1, (32, 8, 163200, 220416, 'grid', 8, 64, 8, 2, 4, 64), (32, 8, 163200, 220416, 'grid', 8, 64, 8, 2, 4, 64)),
    ((2,), 256, torch.bfloat16, 1, (32, 8, 93568, 182528, 'grid', 8, 64, 8, 2, 8, 64), (32, 8, 93568, 182528, 'grid', 8, 64, 8, 2, 8, 64)),
    ((8,), 128, torch.float32, 1, (32, 16, 97664, 189696, 'grid', 8, 128, 8, 2, 8, 256), (32, 64, 97664, 189696, 'grid', 8, 128, 2, 2, 8, 256)),
    ((8,), 128, torch.bfloat16, 1, (32, 16, 60800, 100608, 'grid', 8, 128, 8, 2, 8, 256), (32, 8, 81408, 131328, 'grid', 16, 64, 8, 2, 8, 256)),
    ((10,), 64, torch.float32, 1, (32, 10, 64896, 107776, 'grid', 8, 80, 8, 2, 8, 320), (32, 10, 64896, 107776, 'grid', 8, 80, 8, 2, 8, 320)),
    ((10,), 64, torch.bfloat16, 1, (32, 10, 44416, 59648, 'grid', 8, 80, 8, 2, 8, 320), (32, 10, 44416, 59648, 'grid', 8, 80, 8, 2, 8, 320)),
]


@pytest.mark.parametrize("depths,h,dtype,n_groups,default,h100", BEFORE)
def test_resident_plans_are_kept(depths, h, dtype, n_groups, default, h100):
    """Every shape that planned a cluster or a resident grid keeps exactly
    that plan and its depth groups: the main path's encoders (H = 8, 64),
    the padded H=100 (104), the depth-grouped H=512 encoders (4 groups in
    fp32, 2 in bf16), the decoders' LSTM(256, 3) and (256, 2), and the
    grid kernels' (8, 128) and (10, 64), by default residency and by the
    H100's."""
    for res, want in ((None, default), (_h100, h100)):
        groups = depth_groups(depths, h, dtype, res)
        assert len(groups) == n_groups
        for g in groups:
            plan = _launch_plan(32, sum(l1 - l0 for _, l0, l1 in g), h, dtype,
                                grid_resident=res)
            assert tuple(plan)[:11] == want
            assert plan.fwd_chunk == plan.bwd_chunk == 0
            assert plan.fwd_resident == plan.bwd_resident == 0


def _up128(x):
    return -(-x // 128) * 128


def _up1024(x):
    return -(-x // 1024) * 1024


def _stream_bytes(fwd, cols, item, cs, bufs, kc, rc, kr):
    """A streamed CTA's shared memory at 32 rows, from the layout the
    kernels' header documents: 1024 bytes of mbarriers; `bufs` slots of
    the rows (cs parts, each the 1024-byte aligned share of 32 rows by rc
    values); `bufs` weight tiles (4N x kc forward, kc x N reverse); kr
    resident tiles; the depth slices' sums; two steps' inputs; the
    forward's bias; the carried state."""
    tile = (4 * cols if fwd else cols) * kc * item
    off = 1024 + bufs * cs * _up1024(32 // cs * rc * item)
    off += (bufs + kr) * tile
    if fwd:
        off = _up128(_up128(off) + max(1, 32 // cols) * 32 * (4 * cols + 8)
                     * 4)
        off = _up128(off + 2 * 32 * 4 * cols * item)
        off = _up128(off + 16 * cols)
        return _up128(off + 2 * 32 * cols * 4)
    off = _up128(_up128(off) + 4 * 32 * cols * 4)
    off = _up128(off + 2 * 32 * 7 * cols * item)
    return _up128(off + 3 * 32 * cols * 4)


@pytest.mark.parametrize("h,dtype,cols,ctas", [
    (528, torch.float32, 8, 66), (1024, torch.float32, 8, 128),
    (1536, torch.float32, 16, 96), (1064, torch.bfloat16, 16, 67),
    (1536, torch.bfloat16, 16, 96), (2048, torch.bfloat16, 16, 128)])
def test_streamed_plan_where_the_shared_memory_bit(h, dtype, cols, ctas):
    """One unit whose 2H x 4N weight slice fits no CTA at any N (fp32 H
    over 520, bf16 over 1056) plans the streamed mode: the fewest columns
    N whose ceil(H / N) CTAs are resident (bf16 H=1064 = 8 x 133: 67 CTAs
    of 16 columns, the last owning 8), in clusters with at least 8 of the
    32 rows a CTA part; each way the deepest weight chunk of 2 KB, 1 KB,
    512, 256 or 128 bytes a row (the rows' tensor copies take 128-byte
    pieces) whose rings of 2 slots fit; rows chunks of whole weight chunks
    up to 2 KB a row; and a resident share of as many chunks as the
    rest of the 227 KB holds, up to a step's most (2 stages forward, 8
    reverse): the resident chunks, the rings and the tail fit 232,448
    bytes, one more chunk would not, and the shared memory is what the
    kernels' header lays out."""
    item = torch.empty((), dtype=dtype).element_size()
    plan = _launch_plan(32, 1, h, dtype, grid_resident=_h100)
    assert (plan.kind, plan.cols, plan.ctas) == ("stream", cols, ctas)
    assert plan.clusters * plan.cluster == ctas
    assert -(-h // cols) % plan.cluster == 0 and plan.flags == 32
    assert 32 // plan.cluster >= 8
    for fwd, smem, bufs, kc, rc, kr in (
            (True, plan.fwd_smem, plan.fwd_bufs, plan.fwd_chunk,
             plan.fwd_row_chunk, plan.fwd_resident),
            (False, plan.bwd_smem, plan.bwd_bufs, plan.bwd_chunk,
             plan.bwd_row_chunk, plan.bwd_resident)):
        assert kc * item in (2048, 1024, 512, 256, 128) and bufs == 2
        assert rc % kc == 0 and rc * item <= 2048
        # a chunk twice as deep (its rows chunk too) leaves no rings of 2
        assert kc * item == 2048 or _stream_bytes(
            fwd, cols, item, plan.cluster, 2, 2 * kc, 2 * kc, 0) > LIMIT
        most = (2 if fwd else 8) * -(-h // kc)
        assert smem == _stream_bytes(fwd, cols, item, plan.cluster, bufs, kc,
                                     rc, kr) <= LIMIT
        assert 0 <= kr <= most
        assert kr == most or _stream_bytes(fwd, cols, item, plan.cluster,
                                           bufs, kc, rc, kr + 1) > LIMIT
    # the default residency (whole clusters on 132 SMs) plans the same N
    assert _launch_plan(32, 1, h, dtype).cols == cols


# (fwd, N, storage bytes, rows, CS, slots of each ring, weight chunk, rows
# chunk, resident chunks) of streamed plans like the main path's groups',
# and (fwd, N, H, storage bytes, rows, buffers) of resident grid plans
STREAM_LAYOUTS = [
    (True, 8, 4, 32, 2, 2, 256, 512, 0), (False, 8, 4, 32, 2, 2, 512, 512, 2),
    (True, 16, 4, 32, 2, 2, 128, 256, 1),
    (False, 16, 4, 32, 2, 2, 256, 512, 1),
    (True, 32, 4, 32, 2, 2, 128, 128, 0),
    (False, 32, 4, 32, 2, 2, 256, 256, 0),
    (True, 32, 2, 32, 4, 2, 256, 256, 0),
    (False, 32, 2, 32, 4, 2, 512, 512, 1),
    (True, 64, 4, 32, 4, 2, 32, 128, 0), (False, 64, 4, 32, 4, 2, 64, 64, 0),
    (True, 16, 2, 32, 1, 2, 512, 512, 0),
    (False, 16, 2, 32, 1, 2, 1024, 1024, 0)]
# ... and other streamed layouts the kernels take: deeper rings, shallower
# chunks, fewer rows than a pass
OTHER_LAYOUTS = [
    (True, 8, 4, 32, 2, 4, 64, 256, 12), (False, 16, 4, 32, 2, 8, 64, 256, 22),
    (True, 16, 2, 5, 1, 2, 64, 128, 3), (False, 16, 2, 20, 4, 3, 64, 64, 0),
    (True, 8, 4, 8, 8, 5, 32, 64, 5)]
GRID_LAYOUTS = [(True, 8, 256, 4, 32, 2), (False, 8, 256, 4, 32, 4),
                (True, 16, 512, 2, 32, 2), (False, 8, 104, 2, 5, 8)]


def _header_layouts(stream_cases, grid_cases):
    """The totals `stream_layout` and `grid_layout` of the kernels' header
    give, compiled for the host with g++: the header's region from its
    constants to the layouts, with __host__ and __device__ defined away."""
    src = os.path.join(os.path.dirname(wavefront.__file__),
                       "wavefront_grid.cuh")
    text = open(src).read()
    body = text[text.index("constexpr int WARPS"):
                text.index("// The streamed tiles of unit u start")]
    lines = [f"s {int(f)} {n} {i} {r} {c} {b} {k} {rc} {q}"
             for f, n, i, r, c, b, k, rc, q in stream_cases]
    lines += [f"g {int(f)} {n} {h} {i} {r} {b}"
              for f, n, h, i, r, b in grid_cases]
    prog = ("#include <stddef.h>\n#include <stdio.h>\n#define __host__\n"
            "#define __device__\nstruct bf16 { unsigned short x; };\n"
            "namespace {\n" + body + "}\n" + r"""
template <typename T, bool F> size_t s(int n, int r, int c, int b, int k,
                                       int rc, int q) {
  return stream_layout<T, F>(n, r, c, b, k, rc, q).total;
}
template <typename T, bool F> size_t g(int n, int h, int r, int b) {
  return grid_layout<T, F>(h, n, r, b).total;
}
int main() {
  char kind;
  int f, n, h, i, r, c, b, k, rc, q;
  while (scanf(" %c", &kind) == 1) {
    size_t t;
    if (kind == 's') {
      scanf("%d %d %d %d %d %d %d %d %d", &f, &n, &i, &r, &c, &b, &k, &rc,
            &q);
      t = i == 4 ? (f ? s<float, true>(n, r, c, b, k, rc, q)
                      : s<float, false>(n, r, c, b, k, rc, q))
                 : (f ? s<bf16, true>(n, r, c, b, k, rc, q)
                      : s<bf16, false>(n, r, c, b, k, rc, q));
    } else {
      scanf("%d %d %d %d %d %d", &f, &n, &h, &i, &r, &b);
      t = i == 4 ? (f ? g<float, true>(n, h, r, b) : g<float, false>(n, h, r, b))
                 : (f ? g<bf16, true>(n, h, r, b) : g<bf16, false>(n, h, r, b));
    }
    printf("%zu\n", t);
  }
}
""")
    return prog, "\n".join(lines) + "\n"


def test_stream_layout_mirrors_the_header(tmp_path):
    """`_stream_layout` (and `_grid_layout`) give the bytes that the
    kernels' own `stream_layout` (`grid_layout`) in wavefront_grid.cuh
    lays out, which the kernels hold the launch's `smem` to: the header's
    layout code compiled for the host at the streamed plans' shapes
    (weight chunks of 32 and 64 depths, rows chunks of 1-8 of them, 1-8
    row parts, rings of 2-8 slots, resident shares from 0 to 13 chunks,
    fewer rows than a pass) and at
    resident grid plans'."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header's layout for the host")
    prog, cases = _header_layouts(STREAM_LAYOUTS + OTHER_LAYOUTS,
                                  GRID_LAYOUTS)
    (tmp_path / "layout.cc").write_text(prog)
    subprocess.run([gxx, "-std=c++17", "-O0", "-o", str(tmp_path / "layout"),
                    str(tmp_path / "layout.cc")], check=True)
    out = subprocess.run([str(tmp_path / "layout")], input=cases, text=True,
                         capture_output=True, check=True).stdout.split()
    want = [_stream_layout(f, n, i, r, c, b, k, rc, q)
            for f, n, i, r, c, b, k, rc, q in STREAM_LAYOUTS + OTHER_LAYOUTS]
    want += [_grid_layout(f, n, h, i, r, b) for f, n, h, i, r, b in GRID_LAYOUTS]
    assert [int(x) for x in out] == want
    assert all(w <= LIMIT for w in want[:len(STREAM_LAYOUTS)])


def test_streamed_plan_where_the_residency_bit():
    """A unit whose CTAs at N <= 32 outnumber what the card holds plans the
    streamed mode's wider CTAs: H=4352 on a card of 132 CTAs (N=32: 136)
    takes N=64, 68 CTAs (its fp32 forward in weight chunks of 32 depths:
    rings of deeper tiles would not fit beside the buffers of 64 columns);
    bf16 H=1024 on a card
    holding 100 CTAs, whose resident plan needs 128 of N=8 (N=16's slice
    is over 227 KB), takes 64 streamed CTAs of N=16. A card that holds too
    few even at N=64 raises, naming both modes' attempts."""
    held = lambda N, CS, f, b: 132 // CS * CS
    for dtype, chunks in ((torch.float32, (32, 64)),
                          (torch.bfloat16, (128, 256))):
        plan = _launch_plan(32, 1, 4352, dtype, grid_resident=held)
        assert (plan.kind, plan.cols, plan.ctas) == ("stream", 64, 68)
        assert (plan.fwd_chunk, plan.bwd_chunk) == chunks
    assert _launch_plan(32, 1, 1024, torch.bfloat16).kind == "grid"
    plan = _launch_plan(32, 1, 1024, torch.bfloat16,
                        grid_resident=lambda N, CS, f, b: 100)
    assert (plan.kind, plan.cols, plan.ctas) == ("stream", 16, 64)
    with pytest.raises(ValueError, match=r"N=8 in clusters of 8: 128 CTAs, "
                                         r"the card holds 12.*streamed N=64 "
                                         r"in clusters of 1: 16 CTAs, the "
                                         r"card holds 12"):
        _launch_plan(32, 1, 1024, torch.bfloat16,
                     grid_resident=lambda N, CS, f, b: 12)


@pytest.mark.parametrize("h,dtype,groups", [
    # one layer of both streams a group: 33.5 MB (fp32 1024) and 37.7 MB
    # (bf16 1536) of weights a step, within the budget; two layers of both
    # with their two feed blocks would read 3x that
    (1024, torch.float32, "layers"), (1536, torch.bfloat16, "layers"),
    # one layer of both streams at fp32 H=1536 reads 75.5 MB: one unit a
    # group, stream after stream
    (1536, torch.float32, "units")])
def test_depth_groups_streamed_within_the_l2_budget(h, dtype, groups):
    """Where no unit fits a resident plan, the groups are streamed and
    hold the most layers whose weights a step streams, (units + feed
    blocks) x H x 4H values but the chunks the CTAs keep resident, stay
    within `_L2_BUDGET`, by default residency and the H100's alike."""
    item = torch.empty((), dtype=dtype).element_size()
    want = (tuple(((0, l, l + 1), (1, l, l + 1)) for l in range(4))
            if groups == "layers" else
            tuple(((s, l, l + 1),) for s in range(2) for l in range(4)))
    for res in (None, _h100):
        got = depth_groups((4, 4), h, dtype, res)
        assert got == want
        for g in got:
            units = sum(l1 - l0 for _, l0, l1 in g)
            feeds = units - len(g)
            plan = _launch_plan(32, units, h, dtype, grid_resident=res)
            assert plan.kind == "stream"
            streamed = _step_bytes(plan, units, feeds, h, item)
            assert units == 1 or streamed <= _L2_BUDGET
            assert streamed <= (units + feeds) * h * 4 * h * item
    # a lone stream of four layers: two layers with their feed block hold
    # 50.3 MB of weights; their CTAs (64 a unit) keep kr of a forward
    # step's 1 or 2 stages of chunks resident (bkr of the reverse's 4 or 8)
    # and stream the rest: two layers a group where that fits the budget
    plan = _launch_plan(32, 2, 1024, torch.float32)
    kr, bkr = plan.fwd_resident, plan.bwd_resident
    nf, nb = 1024 // plan.fwd_chunk, 1024 // plan.bwd_chunk
    streamed = max(64 * (nf - kr + 2 * nf - kr) * 64 * plan.fwd_chunk * 4,
                   64 * (4 * nb - bkr + 8 * nb - bkr) * 16 * plan.bwd_chunk
                   * 4)
    assert _step_bytes(plan, 2, 1, 1024, 4) == streamed
    per = 2 if streamed <= _L2_BUDGET else 1
    assert depth_groups((4,), 1024, torch.float32) == tuple(
        ((0, l, l + per),) for l in range(0, 4, per))


# ---------------------------------------------------------------------------
# the tiles
# ---------------------------------------------------------------------------

def _packed_weights(depths, h, seed):
    """A block-bidiagonal W_eff as `_wavefront_pack` fills it (zeros
    elsewhere), distinct values, and its lvec."""
    U = sum(depths)
    lvec = torch.as_tensor(np.concatenate([np.arange(d) for d in depths]),
                           dtype=torch.int32)
    r = torch.Generator().manual_seed(seed)
    blk = torch.zeros(U, h, 4, U, h)
    for u in range(U):
        blk[u, :, :, u] = torch.randn((h, 4, h), generator=r)
        if lvec[u] > 0:
            blk[u - 1, :, :, u] = torch.randn((h, 4, h), generator=r)
    return blk.view(U * h, 4 * U * h), lvec


def _unpack(tiles, lvec, h, N, kc, kw, fwd):
    """Read the tiles back, element by element from the fragment layout's
    definition, into Wf (U, 2H, 4H) (forward) or Wb (U, H, 8H) (reverse)
    with zeros where no tile is; also the number of tiles."""
    U = len(lvec)
    half = kw // 8
    per_unit, nc = -(-h // N), -(-h // kc)
    out = np.zeros((U, 2 * h, 4 * h) if fwd else (U, h, 8 * h))
    vals = tiles.float().view(-1).tolist()
    size = (4 * N if fwd else N) * kc
    pos = 0
    for u in range(U):
        if fwd:
            n_st = 2 if lvec[u] > 0 else 1
        else:
            n_st = 8 if u + 1 < U and lvec[u + 1] > 0 else 4
        for jb in range(per_unit):
            for s in range(n_st):
                for c in range(nc):
                    for e in range(size):
                        hb = e % half
                        r = (e // half) % (4 if fwd else 2)
                        lane = (e // half // (4 if fwd else 2)) % 32
                        j = e // half // (4 if fwd else 2) // 32 % (kc // kw)
                        tile = e // half // (4 if fwd else 2) // 32 // (kc // kw)
                        if fwd:
                            m = 16 * tile + lane // 4 + (r % 2) * 8
                            d = kw * j + half * (lane % 4) + (r // 2) * (
                                kw // 2) + hb
                        else:
                            m = 8 * tile + lane // 4
                            d = kw * j + half * (lane % 4) + r * (kw // 2) + hb
                        depth, col = c * kc + d, jb * N + (m % N if fwd else m)
                        v = vals[pos + e]
                        if depth >= h or col >= h:
                            assert v == 0
                        elif fwd:
                            out[u, s * h + depth, (m // N) * h + col] = v
                        else:
                            out[u, col, s * h + depth] = v
                    pos += size
    assert pos == tiles.numel()
    return torch.as_tensor(out).to(tiles.dtype), pos // size


@pytest.mark.parametrize("depths,h,N,kt", [((2, 1), 24, 16, 2),
                                           ((3,), 40, 8, 4),
                                           ((1, 2), 16, 16, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiles_unpack_to_the_unit_blocks(depths, h, N, kt, dtype):
    """The streamed tiles, gathered as the wrapper gathers them for a plan
    built directly (N columns a CTA, chunks of kt k-tiles: a short last
    chunk at H=24 and 40, a short last column block at H=24 with N=16),
    unpack to `unit_blocks`' Wf and Wb bit for bit; a unit of layer 0
    has no forward feed tile and a unit that feeds none no reverse feed
    tiles (their blocks unpack as the zeros unit_blocks gives them), and
    every entry past H is a zero."""
    W, lvec = _packed_weights(depths, h, 7)
    W = W.to(dtype)
    kw = 8 if dtype == torch.float32 else 16
    plan = LaunchPlan(32, 1, 0, 0, "stream", cols=N, fwd_chunk=kt * kw,
                      bwd_chunk=kt * kw)
    wf, wb = unit_blocks(W, lvec)
    U = len(lvec)
    per_unit, nc = -(-h // N), -(-h // (kt * kw))
    fed = int((lvec > 0).sum())
    feeds_out = int((lvec[1:] > 0).sum())
    for fwd, want, stages in ((True, wf, U + fed),
                              (False, wb, 4 * U + 4 * feeds_out)):
        got, n = _unpack(_stream_tiles(W, lvec, plan, fwd), lvec.tolist(), h,
                         N, kt * kw, kw, fwd)
        assert n == stages * per_unit * nc
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the streamed products' summation order
# ---------------------------------------------------------------------------

def _tf32(x):
    """x rounded to tf32 as cvt.rna.tf32.f32 rounds (ties away from 0)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x cut to its top 19 bits, as the tensor cores read a tf32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _streamed_product(x, w, H, kw, kc, ks, sets, tf32, kr=0):
    """x (R, stages * H) @ w (stages * H, C) summed as a streamed CTA's
    warps sum it: each stage's depth in chunks of kc, each chunk in
    k-tiles of kw (zero past H); the chunks in the order a step takes
    them, its streamed chunks and then its last kr, resident ones (the
    order of the stages' chunks whatever kr is); k-tile i of a chunk to
    depth slice i % ks and accumulator set (i // ks) % sets, restarting at
    every chunk; per k-tile one tensor-core step, taken as the exact sum
    rounded to fp32 once and added to its accumulator; fp32 operands split
    into tf32 big + small, three accumulators (big*big, small*big,
    big*small) summed as acc0 + (acc1 + acc2); the sets added in order,
    then the slices."""
    R, D = x.shape
    S = D // H
    kts = -(-H // kw)
    pad = kts * kw - H
    xs = torch.nn.functional.pad(x.view(R, S, H), (0, pad)).view(R, S, kts, kw)
    ws = torch.nn.functional.pad(w.view(S, H, -1), (0, 0, 0, pad)).view(
        S, kts, kw, -1)
    tiles = lambda a, b: torch.einsum("rskd,skdc->skrc", a.double(),
                                      b.double()).float()
    if tf32:
        xh, wh = _tf32(xs), _tf32(ws)
        xl, wl = _tf32_trunc(xs - xh), _tf32_trunc(ws - wh)
        parts = [tiles(xh, wh), tiles(xl, wh), tiles(xh, wl)]
    else:
        parts = [tiles(xs, ws)]
    kpc = kc // kw
    nc = -(-H // kc)
    n = S * nc
    streamed = max(0, n - kr)
    order = list(range(streamed)) + list(range(streamed, n))
    acc = torch.zeros(ks, sets, len(parts), R, w.shape[1])
    for chunk in order:
        s, c = divmod(chunk, nc)
        for j in range(c * kpc, min(kts, (c + 1) * kpc)):
            i = j % kpc
            for a, part in enumerate(parts):
                acc[i % ks, (i // ks) % sets, a] += part[s, j]
    per_set = acc[:, :, 0] + (acc[:, :, 1] + acc[:, :, 2]) if tf32 \
        else acc[:, :, 0]
    v = per_set[:, 0]
    for q in range(1, sets):
        v = v + per_set[:, q]
    dot = v[0]
    for s in range(1, ks):
        dot = dot + v[s]
    return dot


def _streamed_products(W, lvec, B, N, kc, tf32, kr=0):
    """The forward's and reverse's step products as the streamed kernels
    form them for N columns a CTA, chunks of kc and kr resident chunks a
    CTA, on min(B, 32) rows a pass, as `product` hooks of the plain
    recurrences."""
    U = lvec.numel()
    H = W.shape[0] // U
    wf, wb = (x.float() for x in unit_blocks(W, lvec))
    kw = 8 if tf32 else 16
    rows = min(B, 32)
    nt_f, mt_b = -(-rows // 8), -(-rows // 16)
    sets_for = lambda nt: 1 if nt >= 3 else 4 // nt
    ks_f, sets_f = max(1, 32 // N), sets_for(nt_f)
    ks_b, sets_b = 8 // mt_b, sets_for(N // 8)

    def fwd(h, _):
        hu = h.view(B, U, H)
        below = torch.cat([torch.zeros_like(hu[:, :1]), hu[:, :-1]], 1)
        out = torch.empty(B, 4, U, H)
        for u in range(U):
            x = torch.cat([hu[:, u], below[:, u]], 1)
            out[:, :, u] = _streamed_product(x, wf[u], H, kw, kc, ks_f,
                                             sets_f, tf32, kr).view(B, 4, H)
        return out.view(B, 4 * U * H)

    def bwd(dg, _):
        d = dg.view(B, 4, U, H)
        above = torch.cat([d[:, :, 1:], torch.zeros_like(d[:, :, :1])], 2)
        out = torch.empty(B, U, H)
        for u in range(U):
            x = torch.cat([d[:, :, u].reshape(B, -1),
                           above[:, :, u].reshape(B, -1)], 1)
            out[:, u] = _streamed_product(x, wb[u].t(), H, kw, kc, ks_b,
                                          sets_b, tf32, kr)
        return out.view(B, U * H)
    return fwd, bwd


def _recurrence_inputs(seed, b, s, h, depths, dtype, device="cpu"):
    """Wavefront operands (W_eff, b, xs_wave, h0, c0, lvec) masked to the
    structure the model packs: recurrent and feed blocks, the bias of
    layers >= 1, xs at the layer-0 units' columns for the first s steps;
    weights scaled by 1 / sqrt(2h) so that the gates stay O(1)."""
    U = sum(depths)
    K = s + max(depths) - 1
    W, lvec = _packed_weights(depths, h, seed)
    W = W / np.sqrt(2 * h)
    r = torch.Generator().manual_seed(seed + 1)
    deep = (lvec > 0).float()[None, :, None]
    bias = (torch.randn((4, U, h), generator=r) * 0.1 * deep).reshape(-1)
    x_mask = torch.zeros(K, 1, 1, U, 1)
    x_mask[:s, :, :, lvec == 0] = 1
    xs = (torch.randn((K, b, 4, U, h), generator=r) * x_mask).reshape(K, b, -1)
    h0, c0 = (torch.randn((b, U * h), generator=r) * 0.2 for _ in range(2))
    args = (W, bias, xs, h0, c0)
    return tuple(a.to(device=device, dtype=dtype) for a in args) + (
        lvec.to(device),)


def _bwd_inputs(seed, args, s):
    """Residuals of the plain residual forward and random cotangents."""
    W, _, xs, _, c0, lvec = args
    K, b, G = xs.shape
    _, _, _, gates, c_seq = wavefront_fwd_plain(*args, s, with_residuals=True)
    r = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=r).to(xs)
    c_prev = torch.cat([c0[None], c_seq[:-1]])
    return (W, gates, c_seq, c_prev, rnd(K, b, G // 4), rnd(b, G // 4),
            rnd(b, G // 4), lvec)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depths,h,b,N,kc,kr", [((2,), 96, 3, 8, 256, 0),
                                                ((1, 2), 72, 20, 32, 32, 3),
                                                ((1, 2), 72, 20, 32, 64, 16)])
def test_streamed_products_hold_the_bars(dtype, depths, h, b, N, kc, kr):
    """The streamed kernels' tensor-core arithmetic in their k-chunked
    order (3xTF32 for fp32 storage, bf16 operands with fp32 sums for bf16;
    chunks of 256, 64 or 32 depths, short last chunks; a resident share
    of none, 3 chunks and all of them), run through the plain recurrences,
    against the plain recurrences at the card's bars: forward max-abs 1e-5
    (fp32) / 1.6e-2 (bf16; the stored gates per element to that times
    max(1, |g|)), reverse 1e-5 / 3e-2 of max|plain|. The resident share
    does not move the order: the same products without it are the same
    bits. The emulation itself gives x @ w exactly on values whose sums
    are exact."""
    fp32 = dtype == torch.float32
    if not fp32 and kc == 32:
        kc = 64          # bf16 chunks are at least 128 bytes deep
    s = 20
    args = _recurrence_inputs(31, b, s, h, depths, dtype)
    fwd_p, bwd_p = _streamed_products(args[0], args[5], b, N, kc, fp32, kr)
    fwd_0, bwd_0 = _streamed_products(args[0], args[5], b, N, kc, fp32)
    want = wavefront_fwd_plain(*args, s, with_residuals=True)
    got = wavefront_fwd_plain(*args, s, with_residuals=True, product=fwd_p)
    tol = 1e-5 if fp32 else 1.6e-2
    for i, (g, w) in enumerate(zip(got, want)):
        scale = w.float().abs().clamp_min(1.0) if i == 3 else 1.0
        assert ((g.float() - w.float()).abs() / scale).max().item() <= tol
    if kr:
        same = wavefront_fwd_plain(*args, s, with_residuals=True,
                                   product=fwd_0)
        assert all(torch.equal(g, w) for g, w in zip(got, same))
    bargs = _bwd_inputs(32, args, s)
    want = wavefront_bwd_plain(*bargs, s)
    got = wavefront_bwd_plain(*bargs, s, product=bwd_p)
    btol = 1e-5 if fp32 else 3e-2
    for g, w in zip(got, want):
        assert ((g.float() - w.float()).abs().max().item()
                <= btol * w.float().abs().max().item())
    if kr:
        same = wavefront_bwd_plain(*bargs, s, product=bwd_0)
        assert all(torch.equal(g, w) for g, w in zip(got, same))
    r = np.random.default_rng(33)
    x = torch.as_tensor(r.integers(-8, 8, (5, 2 * h)).astype(np.float32))
    w = torch.as_tensor(r.integers(-8, 8, (2 * h, 12)).astype(np.float32))
    assert torch.equal(_streamed_product(x, w, h, 8 if fp32 else 16, kc, 2,
                                         2, fp32, kr), x @ w)


# ---------------------------------------------------------------------------
# the new width against the JAX package
# ---------------------------------------------------------------------------

def test_h1024_matches_jax():
    """One stream of two H=1024 layers (B=2, S=4) through the port's
    run_lstm_streams (on the CPU the plain recurrence, one group) against
    the JAX package's run_lstm_streams(schedule="wavefront") on the same
    weights, converted to jnp arrays: ys and the final states within 1e-5
    of their max (fp32; the two sum the 2H-deep products in other
    orders)."""
    import jax.numpy as jnp
    from vae_teb_tpu.models import blocks as jb
    h, b, s, depth = 1024, 2, 4, 2
    r = np.random.default_rng(1024)
    f = lambda *shape, scale=1.0: (scale * r.standard_normal(shape)
                                   ).astype(np.float32)
    w = 0.3 * np.sqrt(8 / h)
    a = dict(xp=f(b, s, 4 * h), w_ih=[f(h, 4 * h, scale=w) for _ in range(2)],
             w_hh=[f(h, 4 * h, scale=w) for _ in range(2)],
             b=[f(4 * h, scale=0.1) for _ in range(2)],
             h0=[f(b, h, scale=0.2) for _ in range(2)],
             c0=[f(b, h, scale=0.2) for _ in range(2)])
    stream = lambda cls, wrap: cls(
        wrap(a["xp"]), [wrap(x) for x in a["w_ih"]],
        [wrap(x) for x in a["w_hh"]], [wrap(x) for x in a["b"]],
        (tuple(wrap(x) for x in a["h0"]), tuple(wrap(x) for x in a["c0"])))
    ((ys, (hf, cf)),) = run_lstm_streams([stream(LSTMStream, torch.as_tensor)])
    ((ys_j, (h_j, c_j)),) = jb.run_lstm_streams(
        [stream(jb.LSTMStream, jnp.asarray)], schedule="wavefront")
    for got, want in ((ys, ys_j), (hf, h_j), (cf, c_j)):
        want = np.asarray(want)
        assert got.shape == want.shape
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (depths, H, dtype): one unit, two units without feed (a group of one
# layer of both encoder streams), one stream of two layers (a feed block
# each way), bf16's (2, 1536); each at K=40 with an odd B and at K=303, B=32
STREAM_SHAPES = [((1,), 1024, torch.float32), ((1, 1), 1024, torch.float32),
                 ((2,), 1024, torch.float32), ((1, 1), 1536, torch.bfloat16)]
STREAM_BATCHES = [(5, 40), (32, 303)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "fwd_res", "bwd"])
@pytest.mark.parametrize("b,k", STREAM_BATCHES)
@pytest.mark.parametrize("depths,h,dtype", STREAM_SHAPES)
def test_streamed_kernels_match_plain(cuda_device, kind, b, k, depths, h,
                                      dtype):
    """The streamed entry points against their plain versions on the card,
    at the grid kernels' bars (serving and residual forward max-abs 1e-5
    fp32, 1.6e-2 bf16, the stored gates per element to that times max(1,
    |g|); reverse 1e-5 / 3e-2 of max|plain|), each call one launch of its
    streamed entry point."""
    from vae_teb_tpu_torch.kernels.wavefront import _check
    fp32 = dtype == torch.float32
    s = k - max(depths) + 1
    args = _recurrence_inputs(21, b, s, h, depths, dtype, cuda_device)
    assert _check("stream", args[:5], args[5], args[2]).kind == "stream"
    counts = wavefront_bwd.entry_launches if kind == "bwd" else \
        wavefront_fwd.entry_launches
    entry = f"wavefront_grid_{kind}_stream_{'f32' if fp32 else 'bf16'}"
    before = counts[entry]
    if kind == "bwd":
        bargs = _bwd_inputs(22, args, s)
        got, want = wavefront_bwd(*bargs, s), wavefront_bwd_plain(*bargs, s)
    else:
        res = kind == "fwd_res"
        got = wavefront_fwd(*args, s, with_residuals=res)
        want = wavefront_fwd_plain(*args, s, with_residuals=res)
    torch.cuda.synchronize()
    assert counts[entry] == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        if kind == "bwd":
            tol = 1e-5 if fp32 else 3e-2
            assert err.max().item() <= tol * w.float().abs().max().item()
        else:
            scale = w.float().abs().clamp_min(1.0) if i == 3 else 1.0
            assert (err / scale).max().item() <= (1e-5 if fp32 else 1.6e-2)


@pytest.mark.cuda
def test_streamed_gradients_flow_through_the_kernels(cuda_device):
    """Two H=1024 streams of 2 and 1 layers on the card through
    WavefrontFunction, in two depth groups (the three units with their
    feed block would read 67 MB of weights a step, over the L2 budget):
    one streamed residual forward and one streamed reverse launch a group,
    the gradient of every leaf within 1e-4 of its max against autograd of
    the plain loop on the card in the same groups (fp32)."""
    h, b, s = 1024, 4, 24
    r = np.random.default_rng(5)
    w = 0.3 * np.sqrt(8 / h)
    f = lambda *shape, scale=1.0: (scale * r.standard_normal(shape)
                                   ).astype(np.float32)
    arrays = [dict(xp=f(b, s, 4 * h), w_ih=[f(h, 4 * h, scale=w)
                                            for _ in range(d)],
                   w_hh=[f(h, 4 * h, scale=w) for _ in range(d)],
                   b=[f(4 * h, scale=0.1) for _ in range(d)],
                   h0=[f(b, h, scale=0.2) for _ in range(d)],
                   c0=[f(b, h, scale=0.2) for _ in range(d)])
              for d in (2, 1)]
    grads, entries = [], ("wavefront_grid_fwd_res_stream_f32",
                          "wavefront_grid_bwd_stream_f32")
    for recurrence in (wavefront_recurrence, wavefront_fwd_plain):
        leaves = [{k: ([torch.tensor(x, device=cuda_device,
                                     requires_grad=True) for x in v]
                       if isinstance(v, list) else
                       torch.tensor(v, device=cuda_device, requires_grad=True))
                   for k, v in a.items()} for a in arrays]
        streams = [LSTMStream(t["xp"], t["w_ih"], t["w_hh"], t["b"],
                              (tuple(t["h0"]), tuple(t["c0"])))
                   for t in leaves]
        before = (wavefront_fwd.entry_launches[entries[0]],
                  wavefront_bwd.entry_launches[entries[1]])
        outs = run_lstm_streams(streams, recurrence)
        gen = torch.Generator().manual_seed(6)
        loss = sum((x * torch.randn(x.shape, generator=gen).to(cuda_device)
                    ).sum() for y, (hh, cc) in outs for x in (y, hh, cc))
        loss.backward()
        torch.cuda.synchronize()
        launched = (wavefront_fwd.entry_launches[entries[0]] - before[0],
                    wavefront_bwd.entry_launches[entries[1]] - before[1])
        kernels = recurrence is wavefront_recurrence
        assert launched == ((2, 2) if kernels else (0, 0))
        grads.append([t.grad for t in torch.utils._pytree.tree_leaves(leaves)])
    assert len(wavefront.wavefront_groups((2, 1), h, torch.float32,
                                          cuda_device)) == 2
    for a, b_ in zip(*grads):
        # layer 0's input weight reaches no output: its projection is in xp
        assert (a is None) == (b_ is None)
        if a is not None:
            assert (a - b_).abs().max().item() <= 1e-4 * b_.abs().max().item()
