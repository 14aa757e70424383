// Fused residual-add + f32 LayerNorm + cast, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fleetx_tpu/ops/fused_norm.py:
// _fwd_kernel (launched by _fwd_call) and _bwd_kernel (launched by
// _bwd_call). They compute those functions, not their block structure:
//
//   forward, per row of `hidden` values:
//     s    = residual + x            (in the input dtype; s = x without)
//     mean = sum(f32(s)) / hidden;   var = sum((f32(s) - mean)^2) / hidden
//     out  = ((f32(s) - mean) * rsqrt(var + eps) * scale + bias) -> out dtype
//   backward, from the saved (s, mean, var), in _bwd_kernel's op order:
//     u = var + eps; rstd = rsqrt(u); xc = f32(s) - mean
//     dy = f32(dout) * scale; dxc_a = dy * rstd
//     drstd = sum(xc * dy); dxc_b = ((drstd * (-0.5 * (rstd / u))) / hidden)
//                                   * (2 * xc)
//     acc = (f32(ds_in) + dxc_b) + dxc_a     (dxc_b + dxc_a without ds_in)
//     dmean = sum(-dxc_b) + sum(-dxc_a)
//     dx = (acc + dmean / hidden) -> s dtype
// dscale/dbias reduce outside the kernel (ops/fused_norm.py:param_grads),
// as _param_grads does.
//
// What bounds it on the H100: device-memory bytes. At the GPT-345M
// training shape ([8192 rows, 1024] bf16) the forward with a residual
// moves x, residual, out and s once (4 x 16.8 MB) plus the stats; the
// arithmetic is a few flops per byte, far below the card's ridge point.
// At the generation path's one-token shape ([8 rows, 1024]) the bytes take
// ~0.02 us: there the launch and the first load's latency are the time.
//
// Forward, two routes; ops/fused_norm.py:plan_fwd picks one per shape and
// the entry takes its plan (there is no fallback between them):
//
// "rows" (hidden <= 4096: every shape the port's main paths give it). A
// persistent grid: min(row tiles, blocks an SM x SMs) blocks, block b
// walking tiles b, b + grid, ... A tile is `rows_per_tile` consecutive
// rows, contiguous in memory. The block's last warp is the producer: one
// lane issues the plain 1-D bulk copies (cp.async.bulk, no tensor map) of
// a tile of x, and of the residual, into a shared-memory ring of `stages`
// stages, each with a full and an empty mbarrier. The other `warps` warps
// consume: iteration j of the block goes to warp j % warps, stage
// j % stages (stages a multiple of warps, so a stage always returns to the
// warp that last read it and no wait can pass on a stale phase). A warp
// normalises each row of its tile alone: each lane reads its 8-value
// chunks (chunk c of a row at lanes c % 32) with 16-byte shared loads,
// rounds the residual add to the input dtype, and takes the mean and then
// the sum of squared deviations (the plain version's two passes, not
// Welford) by warp shuffles alone: no __syncthreads, no slot array. s and
// out go to global memory as 16-byte vectors; lane 0 writes mean and var.
// Each row is normalised by exactly one warp in a fixed order, so a
// repeated call is bitwise identical. Up to hidden 1024 the row's values
// (4 chunks a lane) and scale and bias (float4 loads, once per warp) stay
// in registers; wider, scale and bias are read once per block into shared
// memory and each pass reads the row again from the ring (consumers never
// write the ring, so the bulk copies overwrite only what the generic proxy
// has read).
//   Latency: 3.35 TB/s over 132 SMs is 25.4 bytes/ns an SM; at ~0.6-1 us
// of loaded HBM latency an SM needs ~15-25 KB of loads in flight. The plan
// aims a tile at 8 KB (two 2-KB bf16 rows of x and of the residual at
// hidden 1024) and a ring at 64 KB (8 stages: 4 consumer warps x 2), with
// 2 blocks an SM: while each of the SM's 8 consumer warps works on one
// tile its next is in flight, ~64 KB an SM, 2.5-4x the product.
//   The grid is cut to the tiles, a tile to one row a warp when rows are
// few, and a block's warps and stages to its tiles ([8, 1, 1024]: 8 blocks
// of one consumer warp, one stage and one row each). A caller that drops
// the statistics passes null mean and var, and the kernel writes none.
//
// "row_block" (hidden > 4096, up to 32768: a warp cannot hold the row;
// the port's first design, kept as it was). One block per row. The row is held in
// registers, E values a thread (E = 8 up to hidden 8192, 32 up to 32768),
// loaded and stored as 16-byte vectors of 8 values: chunk c of thread t
// covers values [(c * NT + t) * 8, +8) with NT = hidden / E active
// threads, so a warp's loads are contiguous. Block reductions (f32) go
// through warp shuffles and one shared-memory slot per warp.
//
// Backward: the row_block structure (one block per row, the row in
// registers, block reductions), unchanged.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::bulk_load_1d;
using hopper::fence_barrier_init;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;

// load/store 8 consecutive values of T as f32
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  __device__ static void load(const float* p, float* out) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ static void store(float* p, const float* v) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  // round f32 values to T and back (the input dtype's arithmetic)
  __device__ static float round(float v) { return v; }
};

template <>
struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Vec8<__half> {
  __device__ static void load(const __half* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__half* p, const float* v) {
    uint4 raw;
    __half2* h = reinterpret_cast<__half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  __device__ static float round(float v) {
    return __half2float(__float2half_rn(v));
  }
};

// Sum of v over the block; every thread gets the result. `slots` holds
// one float per warp; the caller's __syncthreads discipline is inside.
__device__ float block_sum(float v, float* slots) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // slots may still be read by a previous reduction
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < n_warps; ++w) total += slots[w];
  return total;
}

template <typename T, typename TO, int E, bool RESIDUAL>
__global__ void fused_norm_fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ r,
    const float* __restrict__ scale, const float* __restrict__ bias,
    TO* __restrict__ out, T* __restrict__ s_out, float* __restrict__ mean_out,
    float* __restrict__ var_out, int hidden, float eps) {
  constexpr int C = E / 8;  // 8-value chunks per thread
  __shared__ float slots[32];
  const int nt = hidden / E;
  const int t = threadIdx.x;
  const bool active = t < nt;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  float v[E];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int off = (c * nt + t) * 8;
    if (active) {
      Vec8<T>::load(x + base + off, v + c * 8);
      if (RESIDUAL) {
        float rv[8];
        Vec8<T>::load(r + base + off, rv);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[c * 8 + i] = Vec8<T>::round(rv[i] + v[c * 8 + i]);
        Vec8<T>::store(s_out + base + off, v + c * 8);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[c * 8 + i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[c * 8 + i];
  }
  const float mean = block_sum(sum, slots) / static_cast<float>(hidden);
  float sq = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float var = block_sum(sq, slots) / static_cast<float>(hidden);
  const float rstd = rsqrtf(var + eps);
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int off = (c * nt + t) * 8;
      float o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = (v[c * 8 + i] - mean) * rstd;
        o[i] = y * scale[off + i] + bias[off + i];
      }
      Vec8<TO>::store(out + base + off, o);
    }
  }
  if (t == 0) {
    mean_out[blockIdx.x] = mean;
    var_out[blockIdx.x] = var;
  }
}

template <typename T, int E, bool DSIN>
__global__ void fused_norm_bwd_kernel(
    const T* __restrict__ s, const float* __restrict__ scale,
    const float* __restrict__ mean_in, const float* __restrict__ var_in,
    const T* __restrict__ dout, const T* __restrict__ ds_in,
    T* __restrict__ dx, int hidden, float eps) {
  constexpr int C = E / 8;
  __shared__ float slots[32];
  const int nt = hidden / E;
  const int t = threadIdx.x;
  const bool active = t < nt;
  const size_t base = static_cast<size_t>(blockIdx.x) * hidden;
  const float mean = mean_in[blockIdx.x];
  const float u = var_in[blockIdx.x] + eps;
  const float rstd = rsqrtf(u);
  float xc[E];
  float dy[E];
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int off = (c * nt + t) * 8;
    if (active) {
      Vec8<T>::load(s + base + off, xc + c * 8);
      Vec8<T>::load(dout + base + off, dy + c * 8);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xc[c * 8 + i] -= mean;
        dy[c * 8 + i] *= scale[off + i];
        part += xc[c * 8 + i] * dy[c * 8 + i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        xc[c * 8 + i] = 0.f;
        dy[c * 8 + i] = 0.f;
      }
    }
  }
  const float drstd = block_sum(part, slots);
  const float e_res = -0.5f * (rstd / u);
  const float h = static_cast<float>(hidden);
  // dxc_b overwrites xc, dxc_a overwrites dy
  float neg_b = 0.f;
  float neg_a = 0.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float b = ((drstd * e_res) / h) * (2.f * xc[i]);
    const float a = dy[i] * rstd;
    xc[i] = b;
    dy[i] = a;
    neg_b += -b;
    neg_a += -a;
  }
  if (!active) {
    neg_b = 0.f;
    neg_a = 0.f;
  }
  const float sum_b = block_sum(neg_b, slots);
  const float sum_a = block_sum(neg_a, slots);
  const float dmean = sum_b + sum_a;
  if (active) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int off = (c * nt + t) * 8;
      float acc[8];
      if (DSIN) {
        Vec8<T>::load(ds_in + base + off, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc[i] = (acc[i] + xc[c * 8 + i]) + dy[c * 8 + i];
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = xc[c * 8 + i] + dy[c * 8 + i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = acc[i] + dmean / h;
      Vec8<T>::store(dx + base + off, acc);
    }
  }
}

// ------------------------------------------------------ route "rows"
constexpr int kRowsMaxHidden = 4096;
// scale, bias and a row's values in registers up to this hidden (4 chunks
// of 8 a lane); wider, scale and bias in shared memory
constexpr int kRowsRegHidden = 1024;
constexpr int kRowsMaxWarps = 8;
constexpr int kRowsMaxStages = 32;
// a block's dynamic shared memory on the H100 (227 KB)
constexpr size_t kSmemMax = 232448;
// an mbarrier's transaction count is below 2^20
constexpr size_t kMaxTileBytes = (1u << 20) - 16;
constexpr int kMaxDevices = 64;

// Dynamic shared memory of a "rows" launch, laid out in this order: the
// full and empty mbarriers (8 bytes each a stage, padded to 128 bytes),
// scale and bias as f32 above kRowsRegHidden, and the ring of `stages`
// tiles, each `rows_per_tile` rows of x and then as many of the residual.
__host__ __device__ inline size_t rows_bar_bytes(int stages) {
  return ((16 * static_cast<size_t>(stages) + 127) / 128) * 128;
}

size_t rows_smem_bytes(int hidden, int itemsize, bool residual,
                       int rows_per_tile, int stages) {
  const size_t affine =
      hidden > kRowsRegHidden ? 2 * static_cast<size_t>(hidden) * 4 : 0;
  const size_t tile = static_cast<size_t>(rows_per_tile) * hidden * itemsize *
                      (residual ? 2 : 1);
  return rows_bar_bytes(stages) + affine + stages * tile;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 8 f32 values from a float4 pair (global or shared memory)
__device__ __forceinline__ void load_f32x8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}

// s values of chunk c of a row in the ring: the rounded residual add, or x
template <typename T, bool RESIDUAL>
__device__ __forceinline__ void row_chunk(const T* sx, const T* sr, int c,
                                          float* v) {
  Vec8<T>::load(sx + c * 8, v);
  if (RESIDUAL) {
    float rv[8];
    Vec8<T>::load(sr + c * 8, rv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = Vec8<T>::round(rv[i] + v[i]);
  }
}

template <typename T, typename TO, bool RESIDUAL, bool REGS>
__global__ void __launch_bounds__((kRowsMaxWarps + 1) * 32)
    fused_norm_fwd_rows_kernel(const T* __restrict__ x,
                               const T* __restrict__ r,
                               const float* __restrict__ scale,
                               const float* __restrict__ bias,
                               TO* __restrict__ out, T* __restrict__ s_out,
                               float* __restrict__ mean_out,
                               float* __restrict__ var_out, int rows,
                               int hidden, int rows_per_tile, int stages,
                               float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warps = static_cast<int>(blockDim.x >> 5) - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  float* s_scale = reinterpret_cast<float*>(smem + rows_bar_bytes(stages));
  float* s_bias = s_scale + hidden;
  uint8_t* ring = reinterpret_cast<uint8_t*>(s_scale) +
                  (REGS ? 0 : 2 * static_cast<size_t>(hidden) * 4);
  const uint32_t row_bytes = hidden * sizeof(T);
  const size_t part = static_cast<size_t>(rows_per_tile) * row_bytes;
  const size_t tile_bytes = part * (RESIDUAL ? 2 : 1);
  const int n_tiles = (rows - 1) / rows_per_tile + 1;
  const int nch = hidden / 8;  // 8-value chunks a row
  const float h = static_cast<float>(hidden);

  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    fence_barrier_init();
  }
  if constexpr (!REGS) {
    for (int i = threadIdx.x * 4; i < hidden; i += blockDim.x * 4) {
      *reinterpret_cast<float4*>(s_scale + i) =
          *reinterpret_cast<const float4*>(scale + i);
      *reinterpret_cast<float4*>(s_bias + i) =
          *reinterpret_cast<const float4*>(bias + i);
    }
  }
  __syncthreads();

  if (warp == warps) {  // the producer: one lane issues every copy
    if (lane == 0) {
      for (int j = 0;; ++j) {
        const long long t = blockIdx.x + static_cast<long long>(j) * gridDim.x;
        if (t >= n_tiles) break;
        const int st = j % stages;
        // a fresh barrier passes parity 1 at once: the first lap of the
        // ring waits for nothing
        mbar_wait(&empty[st], ((j / stages) & 1) ^ 1);
        const int row0 = static_cast<int>(t) * rows_per_tile;
        const uint32_t bytes = min(rows_per_tile, rows - row0) * row_bytes;
        mbar_expect_tx(&full[st], RESIDUAL ? 2 * bytes : bytes);
        uint8_t* dst = ring + st * tile_bytes;
        const size_t off = static_cast<size_t>(row0) * hidden;
        bulk_load_1d(dst, x + off, bytes, &full[st]);
        if (RESIDUAL) bulk_load_1d(dst + part, r + off, bytes, &full[st]);
      }
    }
    return;
  }

  // the consumers; sc / bi: this lane's scale and bias (REGS)
  constexpr int kRegChunks = kRowsRegHidden / 256;  // chunks a lane
  float sc[REGS ? 8 * kRegChunks : 1];
  float bi[REGS ? 8 * kRegChunks : 1];
  if constexpr (REGS) {
#pragma unroll
    for (int i = 0; i < kRegChunks; ++i) {
      const int c = lane + 32 * i;
      if (c < nch) {
        load_f32x8(scale + c * 8, sc + 8 * i);
        load_f32x8(bias + c * 8, bi + 8 * i);
      }
    }
  }
  for (int j = warp;; j += warps) {
    const long long t = blockIdx.x + static_cast<long long>(j) * gridDim.x;
    if (t >= n_tiles) break;
    const int st = j % stages;
    mbar_wait(&full[st], (j / stages) & 1);
    const T* tx = reinterpret_cast<const T*>(ring + st * tile_bytes);
    const T* tr = reinterpret_cast<const T*>(ring + st * tile_bytes + part);
    const int row0 = static_cast<int>(t) * rows_per_tile;
    const int n = min(rows_per_tile, rows - row0);
    for (int k = 0; k < n; ++k) {
      const T* sx = tx + static_cast<size_t>(k) * hidden;
      const T* sr = tr + static_cast<size_t>(k) * hidden;
      const size_t base = static_cast<size_t>(row0 + k) * hidden;
      float mean, var;
      if constexpr (REGS) {
        float v[8 * kRegChunks];
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kRegChunks; ++i) {
          const int c = lane + 32 * i;
          if (c < nch) {
            row_chunk<T, RESIDUAL>(sx, sr, c, v + 8 * i);
            if (RESIDUAL) Vec8<T>::store(s_out + base + c * 8, v + 8 * i);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[8 * i + e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += v[8 * i + e];
        }
        mean = warp_sum(sum) / h;
        float sq = 0.f;
#pragma unroll
        for (int i = 0; i < kRegChunks; ++i) {
          if (lane + 32 * i < nch) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float d = v[8 * i + e] - mean;
              sq += d * d;
            }
          }
        }
        var = warp_sum(sq) / h;
        const float rstd = rsqrtf(var + eps);
#pragma unroll
        for (int i = 0; i < kRegChunks; ++i) {
          const int c = lane + 32 * i;
          if (c < nch) {
            float o[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float y = (v[8 * i + e] - mean) * rstd;
              o[e] = y * sc[8 * i + e] + bi[8 * i + e];
            }
            Vec8<TO>::store(out + base + c * 8, o);
          }
        }
      } else {
        float sum = 0.f;
        for (int c = lane; c < nch; c += 32) {
          float v[8];
          row_chunk<T, RESIDUAL>(sx, sr, c, v);
          if (RESIDUAL) Vec8<T>::store(s_out + base + c * 8, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += v[e];
        }
        mean = warp_sum(sum) / h;
        float sq = 0.f;
        for (int c = lane; c < nch; c += 32) {
          float v[8];
          row_chunk<T, RESIDUAL>(sx, sr, c, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[e] - mean;
            sq += d * d;
          }
        }
        var = warp_sum(sq) / h;
        const float rstd = rsqrtf(var + eps);
        for (int c = lane; c < nch; c += 32) {
          float v[8], w[8], b[8], o[8];
          row_chunk<T, RESIDUAL>(sx, sr, c, v);
          load_f32x8(s_scale + c * 8, w);
          load_f32x8(s_bias + c * 8, b);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float y = (v[e] - mean) * rstd;
            o[e] = y * w[e] + b[e];
          }
          Vec8<TO>::store(out + base + c * 8, o);
        }
      }
      if (lane == 0 && mean_out != nullptr) {
        mean_out[row0 + k] = mean;
        var_out[row0 + k] = var;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
}

int block_threads(int hidden, int e) {
  const int nt = hidden / e;
  return ((nt + 31) / 32) * 32;
}

template <typename T, typename TO, int E>
cudaError_t launch_fwd(const void* x, const void* r, const float* scale,
                       const float* bias, void* out, void* s, float* mean,
                       float* var, int rows, int hidden, float eps,
                       cudaStream_t stream) {
  const int threads = block_threads(hidden, E);
  if (r != nullptr) {
    fused_norm_fwd_kernel<T, TO, E, true><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), scale, bias,
        static_cast<TO*>(out), static_cast<T*>(s), mean, var, hidden, eps);
  } else {
    fused_norm_fwd_kernel<T, TO, E, false><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, scale, bias,
        static_cast<TO*>(out), nullptr, mean, var, hidden, eps);
  }
  return cudaGetLastError();
}

template <typename T, int E>
cudaError_t launch_bwd(const void* s, const float* scale, const float* mean,
                       const float* var, const void* dout, const void* ds_in,
                       void* dx, int rows, int hidden, float eps,
                       cudaStream_t stream) {
  const int threads = block_threads(hidden, E);
  if (ds_in != nullptr) {
    fused_norm_bwd_kernel<T, E, true><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(s), scale, mean, var,
        static_cast<const T*>(dout), static_cast<const T*>(ds_in),
        static_cast<T*>(dx), hidden, eps);
  } else {
    fused_norm_bwd_kernel<T, E, false><<<rows, threads, 0, stream>>>(
        static_cast<const T*>(s), scale, mean, var,
        static_cast<const T*>(dout), nullptr, static_cast<T*>(dx), hidden,
        eps);
  }
  return cudaGetLastError();
}

bool shape_ok(int rows, int hidden) {
  return rows >= 1 && rows <= 2147483647 && hidden >= 128 &&
         hidden % 128 == 0 && hidden <= 32768;
}

template <typename T, typename TO>
cudaError_t fwd_by_width(const void* x, const void* r, const float* scale,
                         const float* bias, void* out, void* s, float* mean,
                         float* var, int rows, int hidden, float eps,
                         cudaStream_t stream) {
  if (hidden <= 8192)
    return launch_fwd<T, TO, 8>(x, r, scale, bias, out, s, mean, var, rows,
                                hidden, eps, stream);
  return launch_fwd<T, TO, 32>(x, r, scale, bias, out, s, mean, var, rows,
                               hidden, eps, stream);
}

template <typename T>
cudaError_t bwd_by_width(const void* s, const float* scale,
                         const float* mean, const float* var,
                         const void* dout, const void* ds_in, void* dx,
                         int rows, int hidden, float eps,
                         cudaStream_t stream) {
  if (hidden <= 8192)
    return launch_bwd<T, 8>(s, scale, mean, var, dout, ds_in, dx, rows,
                            hidden, eps, stream);
  return launch_bwd<T, 32>(s, scale, mean, var, dout, ds_in, dx, rows,
                           hidden, eps, stream);
}

// the forward's operands (r and s null together without a residual)
struct FwdArgs {
  const void* x;
  const void* r;
  const float* scale;
  const float* bias;
  void* out;
  void* s;
  float* mean;
  float* var;
  int rows;
  int hidden;
  float eps;
};

// a "rows" launch (ops/fused_norm.py:plan_fwd)
struct RowsPlan {
  int warps;  // consumer warps a block; one producer warp besides
  int rows_per_tile;
  int stages;
  int grid;
};

template <typename T, typename TO, bool RESIDUAL, bool REGS>
cudaError_t launch_rows_inst(const FwdArgs& a, const RowsPlan& p,
                             size_t smem, cudaStream_t stream) {
  const auto kernel = fused_norm_fwd_rows_kernel<T, TO, RESIDUAL, REGS>;
  if (smem > 48 * 1024) {
    // above 48 KB a kernel needs its limit raised: once per instantiation
    // and device, not on every launch
    static bool raised[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!raised[dev]) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kSmemMax));
      if (err != cudaSuccess) return err;
      raised[dev] = true;
    }
  }
  kernel<<<p.grid, (p.warps + 1) * 32, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.r), a.scale, a.bias,
      static_cast<TO*>(a.out), static_cast<T*>(a.s), a.mean, a.var, a.rows,
      a.hidden, p.rows_per_tile, p.stages, a.eps);
  return cudaGetLastError();
}

template <typename T, typename TO>
cudaError_t launch_rows(const FwdArgs& a, const RowsPlan& p,
                        cudaStream_t stream) {
  const bool residual = a.r != nullptr;
  if (a.hidden > kRowsMaxHidden || p.warps < 1 || p.warps > kRowsMaxWarps ||
      p.stages < 1 || p.stages > kRowsMaxStages || p.stages % p.warps != 0 ||
      p.rows_per_tile < 1 || p.grid < 1 ||
      p.grid > (a.rows - 1) / p.rows_per_tile + 1)
    return cudaErrorInvalidValue;
  const size_t tile = static_cast<size_t>(p.rows_per_tile) * a.hidden *
                      sizeof(T) * (residual ? 2 : 1);
  const size_t smem = rows_smem_bytes(a.hidden, sizeof(T), residual,
                                      p.rows_per_tile, p.stages);
  if (tile > kMaxTileBytes || smem > kSmemMax) return cudaErrorInvalidValue;
  const bool regs = a.hidden <= kRowsRegHidden;
  if (residual)
    return regs ? launch_rows_inst<T, TO, true, true>(a, p, smem, stream)
                : launch_rows_inst<T, TO, true, false>(a, p, smem, stream);
  return regs ? launch_rows_inst<T, TO, false, true>(a, p, smem, stream)
              : launch_rows_inst<T, TO, false, false>(a, p, smem, stream);
}

// route 0: "row_block"; 1: "rows" with plan p
template <typename T, typename TO>
cudaError_t fwd_route(const FwdArgs& a, int route, const RowsPlan& p,
                      cudaStream_t stream) {
  if (route == 1) return launch_rows<T, TO>(a, p, stream);
  if (route != 0 || a.mean == nullptr) return cudaErrorInvalidValue;
  return fwd_by_width<T, TO>(a.x, a.r, a.scale, a.bias, a.out, a.s, a.mean,
                             a.var, a.rows, a.hidden, a.eps, stream);
}

}  // namespace

// C interface, loaded with ctypes. dtype codes: 0 = float32, 1 = bfloat16,
// 2 = float16. Returns 0 on success, else a cudaError_t (a refused launch,
// or a shape, dtype or plan outside what the kernels take).
//
// The forward: dtypes holds the input dtype in bits 0-3 and the output
// dtype (the input's, or float32) in bits 4-7; r and s are null together
// when there is no residual. plan bits 0-3 name the route (0 "row_block",
// 1 "rows"); for "rows", bits 4-7 the consumer warps, 8-15 the stages and
// 16-30 the rows a tile, and grid the blocks (ops/fused_norm.py:plan_fwd).
// On "rows" mean and var may be null together: the caller drops the
// statistics (an eager call that records no gradient), and the kernel
// writes none.
extern "C" int fleetx_fused_norm_fwd(const void* x, const void* r,
                                     const float* scale, const float* bias,
                                     void* out, void* s, float* mean,
                                     float* var, int rows, int hidden,
                                     int dtypes, int plan, int grid,
                                     float eps, void* stream) {
  if (!shape_ok(rows, hidden) || (r == nullptr) != (s == nullptr) ||
      (mean == nullptr) != (var == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{x, r, scale, bias, out, s, mean, var, rows, hidden, eps};
  const RowsPlan p{(plan >> 4) & 15, (plan >> 16) & 32767, (plan >> 8) & 255,
                   grid};
  const int route = plan & 15;
  const int dtype = dtypes & 15;
  const int out_dtype = (dtypes >> 4) & 15;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && out_dtype == 0) {
    err = fwd_route<float, float>(a, route, p, st);
  } else if (dtype == 1 && out_dtype == 1) {
    err = fwd_route<__nv_bfloat16, __nv_bfloat16>(a, route, p, st);
  } else if (dtype == 1 && out_dtype == 0) {
    err = fwd_route<__nv_bfloat16, float>(a, route, p, st);
  } else if (dtype == 2 && out_dtype == 2) {
    err = fwd_route<__half, __half>(a, route, p, st);
  } else if (dtype == 2 && out_dtype == 0) {
    err = fwd_route<__half, float>(a, route, p, st);
  }
  return static_cast<int>(err);
}

// The dynamic shared memory a "rows" launch asks for (what plan_fwd
// computes, held equal on the card); -1 for a dtype code it does not take.
extern "C" long long fleetx_fused_norm_fwd_smem_bytes(int hidden, int dtype,
                                                      int residual,
                                                      int rows_per_tile,
                                                      int stages) {
  if (dtype < 0 || dtype > 2) return -1;
  return static_cast<long long>(rows_smem_bytes(
      hidden, dtype == 0 ? 4 : 2, residual != 0, rows_per_tile, stages));
}

// dtypes: s dtype in bits 0-3, dout dtype in bits 4-7 (they must agree).
extern "C" int fleetx_fused_norm_bwd(const void* s, const float* scale,
                                     const float* mean, const float* var,
                                     const void* dout, const void* ds_in,
                                     void* dx, int rows, int hidden,
                                     int dtypes, float eps, void* stream) {
  const int dtype = dtypes & 15;
  if (!shape_ok(rows, hidden) || ((dtypes >> 4) & 15) != dtype)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = bwd_by_width<float>(s, scale, mean, var, dout, ds_in, dx, rows,
                              hidden, eps, st);
  } else if (dtype == 1) {
    err = bwd_by_width<__nv_bfloat16>(s, scale, mean, var, dout, ds_in, dx,
                                      rows, hidden, eps, st);
  } else if (dtype == 2) {
    err = bwd_by_width<__half>(s, scale, mean, var, dout, ds_in, dx, rows,
                               hidden, eps, st);
  }
  return static_cast<int>(err);
}
