// LayerNorm over the last axis, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package normalizes with flax's
// nn.LayerNorm, which XLA fuses into its neighbours. The port's
// models.blocks.LayerNorm used nn.LayerNorm, whose CUDA kernels are built
// for wide rows: a thread block a row, a separate moments pass
// (RowwiseMomentsCUDAKernel) for widths that are not a multiple of its
// vector width, and a gamma/beta gradient (GammaBetaBackwardCUDAKernel)
// that reduces columns slowly when the rows number 38,400 and the columns
// 16-130. A SeqVaeTeb training step makes 115 calls, 111 of them over
// 38,400 rows of 16 to 130 features; at B=128 on an H100 they took 25.2
// ms a step, about 4% of the bytes bound.
//
// What bounds it on the card: bytes. The forward reads x and writes y
// (and a mean and a reciprocal deviation a row); the backward reads x and
// dy and writes dx. There is little to compute, so the design keeps every
// row in registers and moves each byte once:
//   - rows up to kMaxNarrow wide: a row is held by LANES lanes of a warp
//     (a power of two), VPT values a lane, at least 4 (one 16-byte word),
//     so a warp takes 32 / LANES rows; lanes and values follow W
//     (`narrow_shape`): W <= 4 one lane a row, W = 16 four lanes, W = 128
//     and above a warp a row with 4 to 32 values a lane. Where W is a
//     multiple of 4 and the pointers 16-byte aligned each lane moves
//     16-byte words; otherwise single words, neighbouring lanes on
//     neighbouring addresses either way. A row's sums are butterfly
//     shuffles among its lanes; no shared memory.
//   - wider rows (the raw heads' 4800, 128 rows): a block a row, the row
//     read again from L1/L2 for each pass.
//
// Arithmetic, in fp32: mean = sum(x) / W; var = sum((x - mean)^2) / W,
// biased and centered (flax's and nn.LayerNorm's; not E[x^2] - E[x]^2);
// rstd = 1 / sqrt(var + eps), each rounded correctly; y = (x - mean) *
// rstd * gamma + beta. Backward, with xh = (x - mean) * rstd and g = dy *
// gamma: dx = rstd * (g - mean(g) - xh * mean(g * xh)); dgamma = sum over
// rows of dy * xh, dbeta = sum of dy.
//
// The column sums take no atomics: each block of the row kernel keeps
// its lanes' column sums over its rows in registers and writes the
// block's sums, a row of `partial`, after adding its lanes in a fixed
// order; a second launch (layer_norm_bwd_cols) adds the blocks' rows in a
// fixed order. The grid follows only (M, W) and the card's SM count, so
// two runs give the same bits.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;            // a block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxNarrow = 1024;         // widest row held in registers
constexpr unsigned kFull = 0xffffffffu;

// Column of value j (0 <= j < VPT) held by lane `sub` of its row's LANES
// lanes: VEC, element j % 4 of 16-byte word sub + (j / 4) * LANES;
// otherwise element sub + j * LANES.
template <int LANES, bool VEC>
__device__ __forceinline__ int column(int sub, int j) {
  return VEC ? 4 * (sub + (j / 4) * LANES) + j % 4 : sub + j * LANES;
}

// a row's values at this lane's columns, 0 past W or where !valid
template <int LANES, int VPT, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         int sub, int W, bool valid,
                                         float (&v)[VPT]) {
#pragma unroll
  for (int j = 0; j < VPT; j += VEC ? 4 : 1) {
    const int c = column<LANES, VEC>(sub, j);
    if constexpr (VEC) {
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid && c < W) q = *reinterpret_cast<const float4*>(p + c);
      v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
    } else {
      v[j] = valid && c < W ? p[c] : 0.f;
    }
  }
}

template <int LANES, int VPT, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ p, int sub,
                                          int W, bool valid,
                                          const float (&v)[VPT]) {
  if (!valid) return;
#pragma unroll
  for (int j = 0; j < VPT; j += VEC ? 4 : 1) {
    const int c = column<LANES, VEC>(sub, j);
    if (c >= W) continue;
    if constexpr (VEC)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    else
      p[c] = v[j];
  }
}

// sum over the LANES lanes of a row (aligned groups of a warp), to each
template <int LANES>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// sum over the block, lanes by butterfly then the warps in turn, to each
// thread; `red` holds kWarps floats
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s += red[w];
  __syncthreads();   // red is written again by the next call
  return s;
}

template <int LANES, int VPT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_rows(const float* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* __restrict__ y,
                        float* __restrict__ mean, float* __restrict__ rstd,
                        long long M, int W, float eps) {
  constexpr int kRows = kThreads / LANES;   // rows a block
  const int sub = threadIdx.x % LANES;
  const long long row = blockIdx.x * (long long)kRows + threadIdx.x / LANES;
  const bool valid = row < M;
  const long long off = (valid ? row : 0) * W;
  float v[VPT];
  load_row<LANES, VPT, VEC>(x + off, sub, W, valid, v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) s += v[j];
  const float mu = row_sum<LANES>(s) / (float)W;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const float d = column<LANES, VEC>(sub, j) < W ? v[j] - mu : 0.f;
    q += d * d;
  }
  const float rs = 1.f / sqrtf(row_sum<LANES>(q) / (float)W + eps);
  float g[VPT], b[VPT];
  load_row<LANES, VPT, VEC>(gamma, sub, W, true, g);
  load_row<LANES, VPT, VEC>(beta, sub, W, true, b);
#pragma unroll
  for (int j = 0; j < VPT; ++j) v[j] = (v[j] - mu) * rs * g[j] + b[j];
  store_row<LANES, VPT, VEC>(y + off, sub, W, valid, v);
  if (mean != nullptr && valid && sub == 0) mean[row] = mu, rstd[row] = rs;
}

// the block's sums of `a` over its rows, column by column, into out[0, W):
// the lanes of a warp that hold the same columns by butterfly, then the
// warps in turn through `red`
template <int LANES, int VPT, bool VEC>
__device__ __forceinline__ void block_columns(float (&a)[VPT],
                                              float (*red)[LANES * VPT],
                                              int sub, int W,
                                              float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < VPT; ++j)
#pragma unroll
    for (int o = LANES; o < 32; o <<= 1)
      a[j] += __shfl_xor_sync(kFull, a[j], o);
  if (lane < LANES)
#pragma unroll
    for (int j = 0; j < VPT; ++j) red[warp][column<LANES, VEC>(sub, j)] = a[j];
  __syncthreads();
  for (int c = threadIdx.x; c < W; c += kThreads) {
    float s = red[0][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][c];
    out[c] = s;
  }
  __syncthreads();   // red is written again by the next call
}

// dx (unless null) of each row, and in partial[blockIdx.x] and
// partial[gridDim.x + blockIdx.x] the block's column sums of dy * xh and
// dy; the block takes rows in steps of gridDim.x * kRows
template <int LANES, int VPT, bool VEC>
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_rows(const float* __restrict__ x,
                        const float* __restrict__ dy,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ gamma,
                        float* __restrict__ dx, float* __restrict__ partial,
                        long long M, int W) {
  constexpr int kRows = kThreads / LANES;
  __shared__ float red[kWarps][LANES * VPT];
  const int sub = threadIdx.x % LANES;
  float g[VPT], dgamma[VPT], dbeta[VPT];
  load_row<LANES, VPT, VEC>(gamma, sub, W, true, g);
#pragma unroll
  for (int j = 0; j < VPT; ++j) dgamma[j] = dbeta[j] = 0.f;
  for (long long r0 = blockIdx.x * (long long)kRows; r0 < M;
       r0 += gridDim.x * (long long)kRows) {
    const long long row = r0 + threadIdx.x / LANES;
    const bool valid = row < M;
    const long long off = (valid ? row : 0) * W;
    float xh[VPT], d[VPT];
    load_row<LANES, VPT, VEC>(x + off, sub, W, valid, xh);
    load_row<LANES, VPT, VEC>(dy + off, sub, W, valid, d);
    const float mu = valid ? mean[row] : 0.f, rs = valid ? rstd[row] : 0.f;
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {   // d = 0 past W and in invalid rows
      xh[j] = (xh[j] - mu) * rs;
      const float gj = d[j] * g[j];
      sg += gj, sgx += gj * xh[j];
      dgamma[j] += d[j] * xh[j], dbeta[j] += d[j];
    }
    if (dx != nullptr) {
      const float mg = row_sum<LANES>(sg) / (float)W;
      const float mgx = row_sum<LANES>(sgx) / (float)W;
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        xh[j] = rs * (d[j] * g[j] - mg - xh[j] * mgx);
      store_row<LANES, VPT, VEC>(dx + off, sub, W, valid, xh);
    }
  }
  block_columns<LANES, VPT, VEC>(dgamma, red, sub, W,
                                 partial + (size_t)blockIdx.x * W);
  block_columns<LANES, VPT, VEC>(
      dbeta, red, sub, W, partial + (size_t)(gridDim.x + blockIdx.x) * W);
}

__global__ void __launch_bounds__(kThreads)
    layer_norm_fwd_wide(const float* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, float* __restrict__ y,
                        float* __restrict__ mean, float* __restrict__ rstd,
                        long long M, int W, float eps) {
  __shared__ float red[kWarps];
  for (long long row = blockIdx.x; row < M; row += gridDim.x) {
    const float* xr = x + row * W;
    float s = 0.f;
    for (int c = threadIdx.x; c < W; c += kThreads) s += xr[c];
    const float mu = block_sum(s, red) / (float)W;
    float q = 0.f;
    for (int c = threadIdx.x; c < W; c += kThreads) {
      const float d = xr[c] - mu;
      q += d * d;
    }
    const float rs = 1.f / sqrtf(block_sum(q, red) / (float)W + eps);
    float* yr = y + row * W;
    for (int c = threadIdx.x; c < W; c += kThreads)
      yr[c] = (xr[c] - mu) * rs * gamma[c] + beta[c];
    if (mean != nullptr && threadIdx.x == 0) mean[row] = mu, rstd[row] = rs;
  }
}

// as layer_norm_bwd_rows, a block a row; each thread keeps its columns'
// sums in the block's rows of `partial` (gridDim.x <= M: every block has
// a row)
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_wide(const float* __restrict__ x,
                        const float* __restrict__ dy,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ gamma,
                        float* __restrict__ dx, float* __restrict__ partial,
                        long long M, int W) {
  __shared__ float red[kWarps];
  float* pg = partial + (size_t)blockIdx.x * W;
  float* pb = partial + (size_t)(gridDim.x + blockIdx.x) * W;
  for (long long row = blockIdx.x; row < M; row += gridDim.x) {
    const bool first = row == blockIdx.x;
    const float* xr = x + row * W;
    const float* dr = dy + row * W;
    const float mu = mean[row], rs = rstd[row];
    float mg = 0.f, mgx = 0.f;
    if (dx != nullptr) {
      float sg = 0.f, sgx = 0.f;
      for (int c = threadIdx.x; c < W; c += kThreads) {
        const float gj = dr[c] * gamma[c];
        sg += gj, sgx += gj * ((xr[c] - mu) * rs);
      }
      mg = block_sum(sg, red) / (float)W;
      mgx = block_sum(sgx, red) / (float)W;
    }
    for (int c = threadIdx.x; c < W; c += kThreads) {
      const float xh = (xr[c] - mu) * rs, d = dr[c];
      if (dx != nullptr) dx[row * W + c] = rs * (d * gamma[c] - mg - xh * mgx);
      pg[c] = first ? d * xh : pg[c] + d * xh;
      pb[c] = first ? d : pb[c] + d;
    }
  }
}

// dgamma[c] and dbeta[c]: the blocks' rows of `partial` added in order;
// blockIdx.x a tile of 32 columns, blockIdx.y 0 (dgamma) or 1 (dbeta)
__global__ void __launch_bounds__(kThreads)
    layer_norm_bwd_cols(const float* __restrict__ partial, int blocks, int W,
                        float* __restrict__ dgamma,
                        float* __restrict__ dbeta) {
  __shared__ float red[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const float* p = partial + (size_t)blockIdx.y * blocks * W;
  float s = 0.f;
  if (c < W)
    for (int b = warp; b < blocks; b += kWarps) s += p[(size_t)b * W + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < W) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][lane];
    (blockIdx.y ? dbeta : dgamma)[c] = s;
  }
}

// (lanes a row, values a lane) of the instantiated narrow kernels
struct Shape {
  int lanes, vpt;
};
constexpr Shape kShapes[] = {{1, 4},  {2, 4},  {4, 4},   {8, 4},  {16, 4},
                             {32, 4}, {32, 8}, {32, 16}, {32, 32}};
constexpr int kNumShapes = sizeof(kShapes) / sizeof(kShapes[0]);

// the shape for W <= kMaxNarrow: lanes a power of two up to a warp, at
// least 4 values a lane, as few lanes as hold the row
Shape narrow_shape(int W) {
  int lanes = 1, vpt = 4;
  while (lanes < 32 && 4 * lanes < W) lanes *= 2;
  while (lanes * vpt < W) vpt *= 2;
  return {lanes, vpt};
}

// calls f.run<LANES, VPT, VEC>() for the instantiated shape s
template <int I = 0, typename F>
void dispatch(const F& f, Shape s, bool vec) {
  if constexpr (I < kNumShapes) {
    constexpr int L = kShapes[I].lanes, V = kShapes[I].vpt;
    if (s.lanes != L || s.vpt != V) return dispatch<I + 1>(f, s, vec);
    if (vec)
      f.template run<L, V, true>();
    else
      f.template run<L, V, false>();
  }
}

struct Fwd {
  const float *x, *gamma, *beta;
  float *y, *mean, *rstd;
  long long M;
  int W;
  float eps;
  cudaStream_t stream;
  template <int L, int V, bool VEC>
  void run() const {
    constexpr int rows = kThreads / L;
    const unsigned blocks = (unsigned)((M + rows - 1) / rows);
    layer_norm_fwd_rows<L, V, VEC><<<blocks, kThreads, 0, stream>>>(
        x, gamma, beta, y, mean, rstd, M, W, eps);
  }
};

struct Bwd {
  const float *x, *dy, *mean, *rstd, *gamma;
  float *dx, *partial;
  long long M;
  int W, blocks;
  cudaStream_t stream;
  template <int L, int V, bool VEC>
  void run() const {
    layer_norm_bwd_rows<L, V, VEC><<<blocks, kThreads, 0, stream>>>(
        x, dy, mean, rstd, gamma, dx, partial, M, W);
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The entry points take their arguments as one struct (natural alignment;
// kernels/layer_norm.py packs it with Python's `struct` module): a ctypes
// call converts each argument on the host, and the serving path makes 115
// calls a forward.

// x (M, W) -> y (M, W) and, unless mean is null, mean and rstd (M), all
// float32, contiguous; gamma and beta (W)
struct LayerNormFwdArgs {
  const void *x, *gamma, *beta;
  void *y, *mean, *rstd;
  long long M;
  int W;
  float eps;
  void* stream;
};

// from x, dy (M, W), mean, rstd (M) and gamma (W): dx (M, W) unless null,
// dgamma and dbeta (W), all float32, contiguous; partial holds 2 *
// min(M, max_blocks) * W floats of scratch
struct LayerNormBwdArgs {
  const void *x, *dy, *mean, *rstd, *gamma;
  void *dx, *partial, *dgamma, *dbeta;
  long long M;
  int W, max_blocks;
  void* stream;
};

// Returns the CUDA error (0 on success).
extern "C" int layer_norm_fwd_f32(const LayerNormFwdArgs* a) {
  const long long M = a->M;
  const int W = a->W;
  if (M < 0 || W < 1 || (a->mean == nullptr) != (a->rstd == nullptr) ||
      M > (long long)INT_MAX * 8)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const Fwd f{static_cast<const float*>(a->x),
              static_cast<const float*>(a->gamma),
              static_cast<const float*>(a->beta), static_cast<float*>(a->y),
              static_cast<float*>(a->mean), static_cast<float*>(a->rstd), M,
              W, a->eps, static_cast<cudaStream_t>(a->stream)};
  if (W <= kMaxNarrow) {
    const bool vec = W % 4 == 0 && aligned16(f.x) && aligned16(f.gamma) &&
                     aligned16(f.beta) && aligned16(f.y);
    dispatch(f, narrow_shape(W), vec);
  } else {
    const unsigned blocks = (unsigned)(M < INT_MAX ? M : INT_MAX);
    layer_norm_fwd_wide<<<blocks, kThreads, 0, f.stream>>>(
        f.x, f.gamma, f.beta, f.y, f.mean, f.rstd, M, W, f.eps);
  }
  return (int)cudaGetLastError();
}

// Two launches: the rows, then the column sums. Returns the CUDA error.
extern "C" int layer_norm_bwd_f32(const LayerNormBwdArgs* a) {
  const long long M = a->M;
  const int W = a->W, max_blocks = a->max_blocks;
  if (M < 1 || W < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const auto x = static_cast<const float*>(a->x);
  const auto dy = static_cast<const float*>(a->dy);
  const auto mean = static_cast<const float*>(a->mean);
  const auto rstd = static_cast<const float*>(a->rstd);
  const auto gamma = static_cast<const float*>(a->gamma);
  const auto dx = static_cast<float*>(a->dx);
  const auto partial = static_cast<float*>(a->partial);
  const auto stream = static_cast<cudaStream_t>(a->stream);
  int blocks;   // each block a row of partial
  if (W <= kMaxNarrow) {
    // as many blocks as take the same number of row groups each, at most
    // max_blocks
    const Shape shape = narrow_shape(W);
    const long long rows = kThreads / shape.lanes;
    const long long groups = (M + rows - 1) / rows;
    const long long steps = (groups + max_blocks - 1) / max_blocks;
    blocks = (int)((groups + steps - 1) / steps);
    const bool vec = W % 4 == 0 && aligned16(x) && aligned16(dy) &&
                     aligned16(gamma) && (dx == nullptr || aligned16(dx));
    dispatch(Bwd{x, dy, mean, rstd, gamma, dx, partial, M, W, blocks, stream},
             shape, vec);
  } else {
    blocks = (int)(M < max_blocks ? M : max_blocks);
    layer_norm_bwd_wide<<<blocks, kThreads, 0, stream>>>(
        x, dy, mean, rstd, gamma, dx, partial, M, W);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 tiles((W + 31) / 32, 2);
  layer_norm_bwd_cols<<<tiles, kThreads, 0, stream>>>(
      partial, blocks, W, static_cast<float*>(a->dgamma),
      static_cast<float*>(a->dbeta));
  return (int)cudaGetLastError();
}
