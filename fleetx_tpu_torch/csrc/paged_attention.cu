// One-token paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fleetx_tpu/ops/paged_attention.py
// _decode_kernel (launched by _paged_call). It computes _paged_call's
// function, not its block structure: for every request b and head h,
// the f32 online softmax over the key positions 0..lens[b] that the
// request's block table maps onto the page pool, returning the
// UNnormalised (acc [B,nh,hd], m [B,nh], l [B,nh]) triple. The division
// (_normalize) stays in PyTorch, as it is plain jnp in the reference.
//
// Semantics (as the TPU kernel, paged_attention.py:170-180):
//   * a table entry < 0 is a skipped page (null, unallocated tail, or not
//     this pool's); ids >= num_pages are skipped too, so a bad id can
//     never read outside the pool;
//   * lens[b] < 0 marks an inactive row: nothing is read, and the row
//     comes out m = -1e30, l = 0, acc = 0 (exact zeros after _normalize);
//   * positions > lens[b] are never folded in; q and k are cast to f32
//     before the dot, scores scale by 1/sqrt(hd), running m starts at
//     -1e30.
//
// What bounds it on the H100: device-memory bytes. Each active row must
// read its K and V rows once, sum_b (lens_b + 1) * nh * hd * 2 * itemsize
// bytes per layer (a page-granular walk would read
// ceil((lens_b + 1) / ps) * ps rows); the arithmetic is 4 * hd flops per
// key, far below the card's ridge point.
//
// Design: one block of 8 warps per (head, request), 10 KB of static
// shared memory. A "worker" is a group of G lanes (G a power of two, the
// fewest lanes whose 16-byte vector loads span head_dim) that owns key
// positions worker, worker + n_workers, ... and keeps its own running
// (m, l, acc) in registers. Every key row is read exactly once, straight
// from the pool through the block table: there is no dense gather of
// the request's pages. At the end the workers' partial softmax states
// are merged in shared memory with the flash-decoding rescale. Left for
// later work: several blocks per head with a split-K merge for long
// contexts, cp.async/TMA double buffering of the next rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
// floats of a head row one lane holds: 1 bf16 vector of 8, or 2 f32
// vectors of 4 (head_dim 256 over 32 lanes)
constexpr int kLaneFloats = 8;
// worker partial accumulators: n_workers * head_dim <= 8 * 32 * 8
constexpr int kSmemAcc = kThreads * kLaneFloats;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
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
};

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pool_k,
    const T* __restrict__ pool_v, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int nh, int hd,
    int num_pages, int ps, int pages_per_req, int group, float scale) {
  constexpr int V = Vec<T>::N;
  constexpr int kChunks = kLaneFloats / V;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane & (group - 1);           // lane within its worker
  const int per_warp = 32 / group;
  const int worker = warp * per_warp + lane / group;
  const int n_workers = kWarps * per_warp;
  const int span = group * V;                 // head dims per group step
  const unsigned gmask =
      group == 32 ? 0xffffffffu
                  : (((1u << group) - 1u) << ((lane / group) * group));

  float qv[kLaneFloats];
  float acc[kLaneFloats];
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) {
    qv[i] = 0.f;
    acc[i] = 0.f;
  }
  const T* q_row = q + (static_cast<size_t>(b) * nh + h) * hd;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = c * span + g * V;
    if (d < hd) Vec<T>::load(q_row + d, qv + c * V);
  }

  float m = kNegInf;
  float l = 0.f;
  const int q_pos = lens[b];
  if (q_pos >= 0) {
    const int last = min(q_pos, pages_per_req * ps - 1);
    const int* table = tables + static_cast<size_t>(b) * pages_per_req;
    // every lane of a worker shares pos, so the worker's lanes take the
    // same branches and the group-masked shuffles below are well formed
    for (int pos = worker; pos <= last; pos += n_workers) {
      const int page = table[pos / ps];
      if (page < 0 || page >= num_pages) continue;
      const size_t row =
          ((static_cast<size_t>(page) * ps + pos % ps) * nh + h) * hd;
      float kv[kLaneFloats];
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = c * span + g * V;
        if (d < hd) {
          Vec<T>::load(pool_k + row + d, kv + c * V);
#pragma unroll
          for (int i = 0; i < V; ++i) s += qv[c * V + i] * kv[c * V + i];
        }
      }
      for (int off = group >> 1; off > 0; off >>= 1)
        s += __shfl_xor_sync(gmask, s, off);
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + p;
      m = m_new;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int d = c * span + g * V;
        if (d < hd) {
          Vec<T>::load(pool_v + row + d, kv + c * V);
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[c * V + i] = acc[c * V + i] * alpha + p * kv[c * V + i];
        }
      }
    }
  }

  // merge the workers' partial (m, l, acc) states
  __shared__ float sm_m[kThreads];
  __shared__ float sm_l[kThreads];
  __shared__ float sm_acc[kSmemAcc];
  if (g == 0) {
    sm_m[worker] = m;
    sm_l[worker] = l;
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int d = c * span + g * V;
    if (d < hd) {
#pragma unroll
      for (int i = 0; i < V; ++i) sm_acc[worker * hd + d + i] = acc[c * V + i];
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < hd) {
    float m_all = kNegInf;
    for (int w = 0; w < n_workers; ++w) m_all = fmaxf(m_all, sm_m[w]);
    float a = 0.f;
    float l_all = 0.f;
    for (int w = 0; w < n_workers; ++w) {
      const float r = expf(sm_m[w] - m_all);
      a += sm_acc[w * hd + d] * r;
      l_all += sm_l[w] * r;
    }
    const size_t bh = static_cast<size_t>(b) * nh + h;
    acc_out[bh * hd + d] = a;
    if (d == 0) {
      m_out[bh] = m_all;
      l_out[bh] = l_all;
    }
  }
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Returns 0 on success, else a cudaError_t (the launch was refused or a
// shape is outside what the kernel takes).
extern "C" int fleetx_paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, const int* tables,
    const int* lens, float* acc, float* m, float* l, int batch, int nh,
    int hd, int num_pages, int ps, int pages_per_req, int dtype, float scale,
    void* stream) {
  if (batch < 1 || batch > 65535 || nh < 1 || hd < 8 || hd > 256 ||
      hd % 8 != 0 || ps < 1 || pages_per_req < 1 || num_pages < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec = dtype == 1 ? 8 : 4;
  int group = 1;
  while (group < 32 && group * vec < hd) group <<= 1;
  const dim3 grid(nh, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool_k),
        static_cast<const float*>(pool_v), tables, lens, acc, m, l, nh, hd,
        num_pages, ps, pages_per_req, group, scale);
  } else {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(pool_k),
        static_cast<const __nv_bfloat16*>(pool_v), tables, lens, acc, m, l,
        nh, hd, num_pages, ps, pages_per_req, group, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
