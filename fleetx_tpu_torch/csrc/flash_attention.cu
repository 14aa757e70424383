// Causal flash attention for Hopper (sm_90a): the forward, the fused
// single-pass backward and the split backward (dq; dk/dv).
//
// Replaces four Pallas TPU kernels of fleetx_tpu/ops/flash_attention.py:
//   * _fwd_kernel (launched by _fwd): FlashAttention-2 forward over
//     [b*heads, seq, head_dim]. Scores q.k * scale in f32, -1e30 above the
//     diagonal, f32 online softmax whose normaliser l uses the UNdropped p;
//     dropout scales only p @ v. Emits out (input dtype) and
//     lse = m + log(l) (f32).
//   * _bwd_fused_kernel (launched by _bwd_fused): recomputes
//     p = exp(s - lse), dp = do . v, masks dv and dp with the same dropout
//     mask (_bwd_fused_kernel:484-493), ds = p * (dp - delta) * scale, and
//     emits dq (f32), dk and dv (input dtype). delta = sum(out * do) is
//     computed outside the kernel, as _bwd does.
//   * _bwd_dq_kernel (launched by _bwd_dq) and _bwd_dkv_kernel (launched by
//     _bwd_dkv): the split FlashAttention-2 backward, taken where the fused
//     kernel does not apply (fused_bwd off, head_dim 256) and always by the
//     ring path, which feeds them the GLOBAL logsumexp. dq comes back in
//     the operand dtype, dk/dv in the k/v dtype; sq != sk is allowed when
//     not causal.
//
// Dropout: the TPU draws its mask from the hardware PRNG per block; here
// one counter-based hash per ELEMENT, keyed by (seed, b*head, row, col):
//   bits = mix32(mix32(mix32(seed ^ mix32(bh ^ K0)) ^ row) ^ (col * K1))
// where bh is the GLOBAL batch-head index (DropKey: a rank that holds a
// block of the batch rows and of the heads passes its offsets, so a
// sharded run draws one rank's masks)
// kept when bits >= rate * 2^32 (the threshold _dropout_mask uses). The
// same words come out whatever the tiling, so forward and backward agree,
// and ops/flash_attention.py:dropout_bits computes them bit for bit.
//
// Routes. bf16 / fp16 operands at head_dim 64 and 128 run all four
// kernels on the tensor cores (flash_fwd_kernel_tc, flash_bwd_kernel_tc,
// flash_bwd_dq_kernel_tc, flash_bwd_dkv_kernel_tc, below: wgmma on 16-bit
// tiles that TMA brings into shared memory, f32 accumulation; P and dS are
// rounded to the operand type before their products, as every GPU
// FlashAttention does). f32 at every head_dim and 16-bit types at head_dim
// 256 run the SIMT kernels, which keep every product in f32 and so compute
// what the TPU kernels' f32 casts compute, up to summation order. The C
// entry points take the route from the caller and refuse one that
// disagrees with tc_route().
//
// What bounds it on the H100: operations. At the GPT-345M training shape
// (128 heads, seq 1024, head_dim 64) the causal forward does ~17 GFLOP on
// ~67 MB and the backward ~43 GFLOP on ~135 MB: far above the ridge
// point. The SIMT kernels run on the f32 cores, whose peak is 67 TFLOP/s,
// not the tensor cores' 989.
//
// Design of the SIMT kernels.
//   Forward: one block of 256 threads per (q tile of BQ rows, head); the
//   heaviest causal tiles launch first. The block walks the k tiles (64
//   rows) up to the diagonal: Q^T, K^T (d-major) and V (row-major) in
//   shared memory as f32, a 16 x 16 thread grid where each thread owns
//   BQ/16 rows x 4 columns of the score tile and BQ/16 rows x head_dim/16
//   columns of the output (float4 shared-memory reads), row max / sum by
//   shuffles across the 16 threads of a row, P (dropped) staged in shared
//   memory column-major for P @ V.
//   Backward: one block per head, deterministic, no atomics. It sweeps
//   the k tiles; for each it keeps dk/dv accumulators in registers and
//   visits every q tile at or below the diagonal: S and dP from Q^T/K^T
//   and dO^T/V^T, P and dS elementwise, then dV += P^T dO, dK += dS^T Q,
//   and dQ += dS K read-modify-written in the head's own f32 dq rows in
//   device memory (the first k tile writes them). Each thread always owns
//   the same dq elements, so no other thread or block ever touches them.
//   128 blocks at the 345M shape: one wave on 132 SMs. (f32 only: 16-bit
//   operands take flash_bwd_kernel_tc, the same sweep on the tensor cores.)
//   Split backward: the TPU kernels carry their dq (resp. dk/dv)
//   accumulator across a sequential grid dimension; here that dimension is
//   a loop inside one block. dq: one block per (q tile, head) walking the k
//   tiles up to the diagonal; dk/dv: one block per (k tile, head) walking
//   the q tiles from the diagonal down. Each recomputes S and dP for its
//   tiles (the price of the split: 3 and 4 products where the fused kernel
//   does 5 for both) and keeps its accumulators in registers, written once:
//   deterministic, no atomics. At the GPT-1.3B seq-8192 shape
//   ([32, 8192, 128] causal) that is 4096 blocks each, many waves; bound by
//   operations (~0.83 ms and ~1.11 ms at the bf16 tensor rate). The SIMT
//   versions keep f32 and head_dim 256.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;  // k rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

// The dropout hash's key: the seed, and the map from a launch's b*head
// index to the global one (a rank's block of the batch and of the heads):
//   global = (batch_offset + bh / local_heads) * total_heads
//            + head_offset + bh % local_heads
// (local_heads = total_heads = 1 and offsets 0 leave bh as it is).
struct DropKey {
  uint32_t seed;
  int local_heads;
  int total_heads;
  int batch_offset;
  int head_offset;
};

__device__ __forceinline__ uint32_t head_key(DropKey key, uint32_t bh) {
  const int b = static_cast<int>(bh);
  const uint32_t g = static_cast<uint32_t>(
      (key.batch_offset + b / key.local_heads) * key.total_heads +
      key.head_offset + b % key.local_heads);
  return mix32(key.seed ^ mix32(g ^ 0x85ebca6bu));
}

__device__ __forceinline__ uint32_t drop_bits(uint32_t row_key, int col) {
  return mix32(row_key ^ (static_cast<uint32_t>(col) * 0x9e3779b9u));
}

// 8 consecutive values of T as f32, and 4 values f32 -> T
template <typename T>
struct IO;

template <>
struct IO<float> {
  __device__ static void load8(const float* p, float* o) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
  __device__ static void store4(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct IO<__nv_bfloat16> {
  __device__ static void load8(const __nv_bfloat16* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* p, const float* v) {
    uint2 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <>
struct IO<__half> {
  __device__ static void load8(const __half* p, float* o) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store4(__half* p, const float* v) {
    uint2 raw;
    __half2* h = reinterpret_cast<__half2*>(&raw);
    h[0] = __floats2half2_rn(v[0], v[1]);
    h[1] = __floats2half2_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// N consecutive f32 from shared memory (N = 1, 2 or 4; 4/8/16-byte
// aligned)
template <int N>
__device__ __forceinline__ void lds(const float* p, float* o);

template <>
__device__ __forceinline__ void lds<4>(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

template <>
__device__ __forceinline__ void lds<2>(const float* p, float* o) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  o[0] = v.x; o[1] = v.y;
}

template <>
__device__ __forceinline__ void lds<1>(const float* p, float* o) {
  o[0] = *p;
}

// g[R][D] (row-major, type T) -> s[d * ld + r] (d-major f32). Consecutive
// threads take consecutive rows, so the transposed stores hit distinct
// banks.
template <typename T, int D>
__device__ void load_t(const T* __restrict__ g, int R, float* s, int ld) {
  const int chunks = R * (D / 8);
  for (int ch = threadIdx.x; ch < chunks; ch += kThreads) {
    const int r = ch % R;
    const int d0 = (ch / R) * 8;
    float v[8];
    IO<T>::load8(g + static_cast<size_t>(r) * D + d0, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[(d0 + i) * ld + r] = v[i];
  }
}

// g[R][D] (row-major, type T) -> s[r * ld + d] (row-major f32)
template <typename T, int D>
__device__ void load_r(const T* __restrict__ g, int R, float* s, int ld) {
  const int chunks = R * (D / 8);
  for (int ch = threadIdx.x; ch < chunks; ch += kThreads) {
    const int r = ch / (D / 8);
    const int d0 = (ch % (D / 8)) * 8;
    float v[8];
    IO<T>::load8(g + static_cast<size_t>(r) * D + d0, v);
    float* dst = s + r * ld + d0;
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// ------------------------------------------------------------ forward
template <int D, int BQ>
struct FwdSmem {
  static constexpr int LQ = BQ + 4;   // Qt / Pt row stride
  static constexpr int LK = kBK + 4;  // Kt row stride
  static constexpr int LV = D + 4;    // V row stride
  static constexpr int kFloats = D * LQ + D * LK + kBK * LV + kBK * LQ;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int sq, int sk, int causal,
    float scale, DropKey seed, uint32_t thresh, int dropout,
    float keep_prob) {
  constexpr int TM = BQ / 16;   // q rows per thread
  constexpr int DC = D / 64;    // 64-wide output column groups
  using S = FwdSmem<D, BQ>;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                 // [D][LQ]
  float* Kt = Qt + D * S::LQ;       // [D][LK]
  float* Vr = Kt + D * S::LK;       // [BK][LV]
  float* Pt = Vr + kBK * S::LV;     // [BK][LQ]

  const int bh = blockIdx.y;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qi * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t head = static_cast<size_t>(bh);
  const T* kg = k + head * sk * D;
  const T* vg = v + head * sk * D;
  const uint32_t kh = head_key(seed, bh);

  load_t<T, D>(q + (head * sq + q0) * D, BQ, Qt, S::LQ);

  float acc[TM][DC * 4];
  float m_i[TM];
  float l_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? (q0 + BQ - 1) / kBK + 1 : sk / kBK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_t<T, D>(kg + static_cast<size_t>(k0) * D, kBK, Kt, S::LK);
    load_r<T, D>(vg + static_cast<size_t>(k0) * D, kBK, Vr, S::LV);
    __syncthreads();

    float s[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[TM];
      float b[4];
      lds<TM>(Qt + d * S::LQ + ty * TM, a);
      lds<4>(Kt + d * S::LK + tx * 4, b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = q0 + ty * TM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * scale;
        if (causal && k0 + tx * 4 + j > row) x = kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float p[4];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rs += p[j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC * 4; ++c) acc[i][c] *= alpha;
      if (dropout) {
        const uint32_t rk = mix32(kh ^ static_cast<uint32_t>(row));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = drop_bits(rk, k0 + tx * 4 + j) >= thresh ? p[j] / keep_prob
                                                           : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) Pt[(tx * 4 + j) * S::LQ + ty * TM + i] = p[j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float a[TM];
      lds<TM>(Pt + c * S::LQ + ty * TM, a);
#pragma unroll
      for (int g = 0; g < DC; ++g) {
        float b[4];
        lds<4>(Vr + c * S::LV + g * 64 + tx * 4, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][g * 4 + j] += a[i] * b[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    const float l_safe = l_i[i] == 0.f ? 1.f : l_i[i];
    T* orow = out + (head * sq + row) * D;
#pragma unroll
    for (int g = 0; g < DC; ++g) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = acc[i][g * 4 + j] / l_safe;
      IO<T>::store4(orow + g * 64 + tx * 4, o);
    }
    if (tx == 0) lse[head * sq + row] = m_i[i] + logf(l_safe);
  }
}

// ----------------------------------------------------------- backward
template <int D, int BQ>
struct BwdSmem {
  static constexpr int LQ = BQ + 4;   // Qt / dOt / dSt row stride
  static constexpr int LK = kBK + 4;  // Kt / Vt / Pr / dSr row stride
  static constexpr int LD = D + 4;    // Qr / dOr / Kr row stride
  static constexpr int kFloats = 2 * D * LQ + 2 * BQ * LD  // Q, dO
                                 + 2 * D * LK + kBK * LD   // Kt, Vt, Kr
                                 + 2 * BQ * LK + kBK * LQ  // Pr, dSr, dSt
                                 + 2 * BQ;                 // lse, delta
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int causal,
    float scale, DropKey seed, uint32_t thresh, int dropout, float inv) {
  constexpr int TM = BQ / 16;  // q rows per thread (S, dP, dQ)
  constexpr int DC = D / 64;   // 64-wide column groups (dK, dV, dQ)
  using S = BwdSmem<D, BQ>;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // [D][LQ]
  float* dOt = Qt + D * S::LQ;        // [D][LQ]
  float* Qr = dOt + D * S::LQ;        // [BQ][LD]
  float* dOr = Qr + BQ * S::LD;       // [BQ][LD]
  float* Kt = dOr + BQ * S::LD;       // [D][LK]
  float* Vt = Kt + D * S::LK;         // [D][LK]
  float* Kr = Vt + D * S::LK;         // [BK][LD]
  float* Pr = Kr + kBK * S::LD;       // [BQ][LK]
  float* dSr = Pr + BQ * S::LK;       // [BQ][LK]
  float* dSt = dSr + BQ * S::LK;      // [BK][LQ]
  float* lse_s = dSt + kBK * S::LQ;   // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int bh = blockIdx.x;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t head = static_cast<size_t>(bh);
  const T* qg = q + head * sq * D;
  const T* kg = k + head * sk * D;
  const T* vg = v + head * sk * D;
  const T* dog = dout + head * sq * D;
  float* dqg = dq + head * sq * D;
  const uint32_t kh = head_key(seed, bh);
  const int nq = sq / BQ;

  for (int kj = 0; kj < sk / kBK; ++kj) {
    const int k0 = kj * kBK;
    __syncthreads();  // the previous k tile's readers are done
    load_t<T, D>(kg + static_cast<size_t>(k0) * D, kBK, Kt, S::LK);
    load_t<T, D>(vg + static_cast<size_t>(k0) * D, kBK, Vt, S::LK);
    load_r<T, D>(kg + static_cast<size_t>(k0) * D, kBK, Kr, S::LD);

    float dk_acc[4][DC * 4];
    float dv_acc[4][DC * 4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC * 4; ++c) {
        dk_acc[i][c] = 0.f;
        dv_acc[i][c] = 0.f;
      }

    // causal: q tiles whose last row reaches k0 (k0 is a multiple of BQ)
    for (int qi = causal ? k0 / BQ : 0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      __syncthreads();  // the previous q tile's readers are done
      load_t<T, D>(qg + static_cast<size_t>(q0) * D, BQ, Qt, S::LQ);
      load_t<T, D>(dog + static_cast<size_t>(q0) * D, BQ, dOt, S::LQ);
      load_r<T, D>(qg + static_cast<size_t>(q0) * D, BQ, Qr, S::LD);
      load_r<T, D>(dog + static_cast<size_t>(q0) * D, BQ, dOr, S::LD);
      if (threadIdx.x < BQ) {
        lse_s[threadIdx.x] = lse[head * sq + q0 + threadIdx.x];
        delta_s[threadIdx.x] = delta[head * sq + q0 + threadIdx.x];
      }
      __syncthreads();

      // S = Q K^T and dP = dO V^T, TM x 4 per thread
      float s[TM][4];
      float dp[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = 0.f;
          dp[i][j] = 0.f;
        }
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float a[TM];
        float g[TM];
        float b[4];
        float w[4];
        lds<TM>(Qt + d * S::LQ + ty * TM, a);
        lds<TM>(dOt + d * S::LQ + ty * TM, g);
        lds<4>(Kt + d * S::LK + tx * 4, b);
        lds<4>(Vt + d * S::LK + tx * 4, w);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += a[i] * b[j];
            dp[i][j] += g[i] * w[j];
          }
      }

      // P (dropped copy for dV) and dS, staged in shared memory
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const int row = q0 + r;
        const float L = lse_s[r];
        const float Dl = delta_s[r];
        const uint32_t rk = mix32(kh ^ static_cast<uint32_t>(row));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx * 4 + j;
          const int col = k0 + c;
          float x = s[i][j] * scale;
          if (causal && col > row) x = kNegInf;
          const float p = expf(x - L);
          float dpv = dp[i][j];
          float pd = p;
          if (dropout) {
            const bool keep = drop_bits(rk, col) >= thresh;
            pd = keep ? p * inv : 0.f;
            dpv = keep ? dpv * inv : 0.f;
          }
          const float ds = p * (dpv - Dl) * scale;
          Pr[r * S::LK + c] = pd;
          dSr[r * S::LK + c] = ds;
          dSt[c * S::LQ + r] = ds;
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: rows ty*4+i of the k tile
#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pa[4];
        float sa[4];
        lds<4>(Pr + r * S::LK + ty * 4, pa);
        lds<4>(dSr + r * S::LK + ty * 4, sa);
#pragma unroll
        for (int g = 0; g < DC; ++g) {
          float go[4];
          float qv[4];
          lds<4>(dOr + r * S::LD + g * 64 + tx * 4, go);
          lds<4>(Qr + r * S::LD + g * 64 + tx * 4, qv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dv_acc[i][g * 4 + j] += pa[i] * go[j];
              dk_acc[i][g * 4 + j] += sa[i] * qv[j];
            }
        }
      }

      // dQ tile = dS K, then read-modify-write this thread's dq elements
      float dq_acc[TM][DC * 4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < DC * 4; ++c) dq_acc[i][c] = 0.f;
#pragma unroll 4
      for (int c = 0; c < kBK; ++c) {
        float a[TM];
        lds<TM>(dSt + c * S::LQ + ty * TM, a);
#pragma unroll
        for (int g = 0; g < DC; ++g) {
          float b[4];
          lds<4>(Kr + c * S::LD + g * 64 + tx * 4, b);
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dq_acc[i][g * 4 + j] += a[i] * b[j];
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float* drow = dqg + static_cast<size_t>(q0 + ty * TM + i) * D;
#pragma unroll
        for (int g = 0; g < DC; ++g) {
          float4* p4 = reinterpret_cast<float4*>(drow + g * 64 + tx * 4);
          float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kj > 0) cur = *p4;  // the first k tile writes the rows
          cur.x += dq_acc[i][g * 4 + 0];
          cur.y += dq_acc[i][g * 4 + 1];
          cur.z += dq_acc[i][g * 4 + 2];
          cur.w += dq_acc[i][g * 4 + 3];
          *p4 = cur;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t row = head * sk + k0 + ty * 4 + i;
#pragma unroll
      for (int g = 0; g < DC; ++g) {
        IO<T>::store4(dk + row * D + g * 64 + tx * 4, &dk_acc[i][g * 4]);
        IO<T>::store4(dv + row * D + g * 64 + tx * 4, &dv_acc[i][g * 4]);
      }
    }
  }
}

// ------------------------------------------------- split backward: dq
// One block per (q tile of BQ rows, head), heaviest causal tiles first.
// Q and dO stay in shared memory (d-major) for the whole block; the block
// walks the k tiles (BK rows) from 0 to the diagonal (all of them when not
// causal). Per k tile: S = Q K^T and dP = dO V^T (TM x TN per thread),
// P = exp(S*scale - lse) from the GIVEN lse (any logsumexp: the ring feeds
// the global one), dP masked by the dropout hash and divided by the keep
// probability (_bwd_dq_kernel:301-305), dS = P (dP - delta) scale staged
// column-major, then dQ += dS K into registers. dQ is written once, in the
// operand dtype; no atomics.
template <int D, int BQ, int BK>
struct DqSmem {
  static constexpr int LQ = BQ + 4;  // Qt / dOt / dSt row stride
  static constexpr int LK = BK + 4;  // Kt / Vt row stride
  static constexpr int LD = D + 4;   // Kr row stride
  static constexpr int kFloats = 2 * D * LQ + 2 * D * LK + BK * LD + BK * LQ
                                 + 2 * BQ;  // lse, delta
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
    int causal, float scale, DropKey seed, uint32_t thresh, int dropout,
    float keep_prob) {
  constexpr int TM = BQ / 16;  // q rows per thread (S, dP, dQ)
  constexpr int TN = BK / 16;  // k columns per thread (S, dP)
  constexpr int DC = D / 64;   // 64-wide dQ column groups
  using S = DqSmem<D, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                  // [D][LQ]
  float* dOt = Qt + D * S::LQ;       // [D][LQ]
  float* Kt = dOt + D * S::LQ;       // [D][LK]
  float* Vt = Kt + D * S::LK;        // [D][LK]
  float* Kr = Vt + D * S::LK;        // [BK][LD]
  float* dSt = Kr + BK * S::LD;      // [BK][LQ]
  float* lse_s = dSt + BK * S::LQ;   // [BQ]
  float* delta_s = lse_s + BQ;       // [BQ]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t head = static_cast<size_t>(bh);
  const T* kg = k + head * sk * D;
  const T* vg = v + head * sk * D;
  const uint32_t kh = head_key(seed, bh);

  load_t<T, D>(q + (head * sq + q0) * D, BQ, Qt, S::LQ);
  load_t<T, D>(dout + (head * sq + q0) * D, BQ, dOt, S::LQ);
  if (threadIdx.x < BQ) {
    lse_s[threadIdx.x] = lse[head * sq + q0 + threadIdx.x];
    delta_s[threadIdx.x] = delta[head * sq + q0 + threadIdx.x];
  }

  float dq_acc[TM][DC * 4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) dq_acc[i][c] = 0.f;

  const int nk = causal ? (q0 + BQ - 1) / BK + 1 : sk / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();  // the previous tile's readers of Kt/Vt/Kr/dSt are done
    load_t<T, D>(kg + static_cast<size_t>(k0) * D, BK, Kt, S::LK);
    load_t<T, D>(vg + static_cast<size_t>(k0) * D, BK, Vt, S::LK);
    load_r<T, D>(kg + static_cast<size_t>(k0) * D, BK, Kr, S::LD);
    __syncthreads();

    float s[TM][TN];
    float dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM];
      float g[TM];
      float b[TN];
      float w[TN];
      lds<TM>(Qt + d * S::LQ + ty * TM, a);
      lds<TM>(dOt + d * S::LQ + ty * TM, g);
      lds<TN>(Kt + d * S::LK + tx * TN, b);
      lds<TN>(Vt + d * S::LK + tx * TN, w);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += g[i] * w[j];
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      const int row = q0 + r;
      const float L = lse_s[r];
      const float Dl = delta_s[r];
      const uint32_t rk = mix32(kh ^ static_cast<uint32_t>(row));
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx * TN + j;
        const int col = k0 + c;
        float x = s[i][j] * scale;
        if (causal && col > row) x = kNegInf;
        const float p = expf(x - L);
        float dpv = dp[i][j];
        if (dropout)
          dpv = drop_bits(rk, col) >= thresh ? dpv / keep_prob : 0.f;
        dSt[c * S::LQ + r] = p * (dpv - Dl) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[TM];
      lds<TM>(dSt + c * S::LQ + ty * TM, a);
#pragma unroll
      for (int g = 0; g < DC; ++g) {
        float b[4];
        lds<4>(Kr + c * S::LD + g * 64 + tx * 4, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dq_acc[i][g * 4 + j] += a[i] * b[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    T* drow = dq + (head * sq + q0 + ty * TM + i) * D;
#pragma unroll
    for (int g = 0; g < DC; ++g)
      IO<T>::store4(drow + g * 64 + tx * 4, &dq_acc[i][g * 4]);
  }
}

// ---------------------------------------------- split backward: dk / dv
// One block per (k tile of BK rows, head), heaviest causal tiles (the
// first ones) first. K and V stay in shared memory (d-major); the block
// walks the q tiles from the first whose last row reaches k0 (k0 / BQ
// under causal, 0 otherwise) to the end. Per q tile: S and dP as in the dq
// kernel, the dropped P / (1 - rate) for dV and dP masked and multiplied
// by 1 / (1 - rate) (_bwd_dkv_kernel:347-360), dS = P (dP - delta) scale;
// P and dS staged row-major, then dV += P^T dO and dK += dS^T Q into
// registers (TN k rows x head_dim/16 columns per thread). dK and dV are
// written once, in the k/v dtype; no atomics.
template <int D, int BQ, int BK>
struct DkvSmem {
  static constexpr int LQ = BQ + 4;  // Qt / dOt row stride
  static constexpr int LK = BK + 4;  // Kt / Vt / Pr / dSr row stride
  static constexpr int LD = D + 4;   // Qr / dOr row stride
  static constexpr int kFloats = 2 * D * LK + 2 * D * LQ + 2 * BQ * LD
                                 + 2 * BQ * LK + 2 * BQ;  // lse, delta
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int causal, float scale, DropKey seed, uint32_t thresh,
    int dropout, float inv) {
  constexpr int TM = BQ / 16;  // q rows per thread (S, dP)
  constexpr int TN = BK / 16;  // k columns per thread (S, dP); k rows (dK, dV)
  constexpr int DC = D / 64;   // 64-wide dK/dV column groups
  using S = DkvSmem<D, BQ, BK>;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                   // [D][LK]
  float* Vt = Kt + D * S::LK;         // [D][LK]
  float* Qt = Vt + D * S::LK;         // [D][LQ]
  float* dOt = Qt + D * S::LQ;        // [D][LQ]
  float* Qr = dOt + D * S::LQ;        // [BQ][LD]
  float* dOr = Qr + BQ * S::LD;       // [BQ][LD]
  float* Pr = dOr + BQ * S::LD;       // [BQ][LK]
  float* dSr = Pr + BQ * S::LK;       // [BQ][LK]
  float* lse_s = dSr + BQ * S::LK;    // [BQ]
  float* delta_s = lse_s + BQ;        // [BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t head = static_cast<size_t>(bh);
  const T* qg = q + head * sq * D;
  const T* dog = dout + head * sq * D;
  const uint32_t kh = head_key(seed, bh);

  load_t<T, D>(k + (head * sk + k0) * D, BK, Kt, S::LK);
  load_t<T, D>(v + (head * sk + k0) * D, BK, Vt, S::LK);

  float dk_acc[TN][DC * 4];
  float dv_acc[TN][DC * 4];
#pragma unroll
  for (int i = 0; i < TN; ++i)
#pragma unroll
    for (int c = 0; c < DC * 4; ++c) {
      dk_acc[i][c] = 0.f;
      dv_acc[i][c] = 0.f;
    }

  // causal: the first q tile whose last row q0 + BQ - 1 reaches k0
  for (int qi = causal ? k0 / BQ : 0; qi < sq / BQ; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();  // the previous q tile's readers are done
    load_t<T, D>(qg + static_cast<size_t>(q0) * D, BQ, Qt, S::LQ);
    load_t<T, D>(dog + static_cast<size_t>(q0) * D, BQ, dOt, S::LQ);
    load_r<T, D>(qg + static_cast<size_t>(q0) * D, BQ, Qr, S::LD);
    load_r<T, D>(dog + static_cast<size_t>(q0) * D, BQ, dOr, S::LD);
    if (threadIdx.x < BQ) {
      lse_s[threadIdx.x] = lse[head * sq + q0 + threadIdx.x];
      delta_s[threadIdx.x] = delta[head * sq + q0 + threadIdx.x];
    }
    __syncthreads();

    float s[TM][TN];
    float dp[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[TM];
      float g[TM];
      float b[TN];
      float w[TN];
      lds<TM>(Qt + d * S::LQ + ty * TM, a);
      lds<TM>(dOt + d * S::LQ + ty * TM, g);
      lds<TN>(Kt + d * S::LK + tx * TN, b);
      lds<TN>(Vt + d * S::LK + tx * TN, w);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] += a[i] * b[j];
          dp[i][j] += g[i] * w[j];
        }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty * TM + i;
      const int row = q0 + r;
      const float L = lse_s[r];
      const float Dl = delta_s[r];
      const uint32_t rk = mix32(kh ^ static_cast<uint32_t>(row));
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx * TN + j;
        const int col = k0 + c;
        float x = s[i][j] * scale;
        if (causal && col > row) x = kNegInf;
        const float p = expf(x - L);
        float dpv = dp[i][j];
        float pd = p;
        if (dropout) {
          const bool keep = drop_bits(rk, col) >= thresh;
          pd = keep ? p * inv : 0.f;
          dpv = keep ? dpv * inv : 0.f;
        }
        Pr[r * S::LK + c] = pd;
        dSr[r * S::LK + c] = p * (dpv - Dl) * scale;
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: k rows ty*TN+i of the tile
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pa[TN];
      float sa[TN];
      lds<TN>(Pr + r * S::LK + ty * TN, pa);
      lds<TN>(dSr + r * S::LK + ty * TN, sa);
#pragma unroll
      for (int g = 0; g < DC; ++g) {
        float go[4];
        float qv[4];
        lds<4>(dOr + r * S::LD + g * 64 + tx * 4, go);
        lds<4>(Qr + r * S::LD + g * 64 + tx * 4, qv);
#pragma unroll
        for (int i = 0; i < TN; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[i][g * 4 + j] += pa[i] * go[j];
            dk_acc[i][g * 4 + j] += sa[i] * qv[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TN; ++i) {
    const size_t row = head * sk + k0 + ty * TN + i;
#pragma unroll
    for (int g = 0; g < DC; ++g) {
      IO<T>::store4(dk + row * D + g * 64 + tx * 4, &dk_acc[i][g * 4]);
      IO<T>::store4(dv + row * D + g * 64 + tx * 4, &dv_acc[i][g * 4]);
    }
  }
}

// ------------------------------------------- tensor-core forward (wgmma)
// Replaces _fwd_kernel for bf16 / fp16 operands at head_dim 64 and 128.
// Bound at [32, 8192, 128] causal: operations (5.5e11 FLOP at 989 TFLOP/s
// bf16 = 0.56 ms against 0.07 GB of traffic, 0.02 ms).
//
// One CTA of 384 threads per (q tile of 128 rows, head), heaviest causal
// tiles first. Warpgroup 2 is the producer: one lane loads Q once and streams
// [128, d] K and V tiles by TMA into a ring of kTcStages stages, 128-byte
// swizzled for wgmma, with a full barrier per tile (K and V apart, so
// S = Q K^T starts before V lands) and an empty barrier per stage that the
// eight consumer warps release. Warpgroups 0 and 1 are the consumers, 64 q
// rows each. Per k tile: S = Q K^T as wgmma m64n128k16 (A = Q, B = K, both
// K-major in shared memory) into f32 registers; the online softmax of
// _fwd_kernel:201-215 in f32 (the normaliser l sums the UNdropped,
// unrounded p; each row's 128 columns lie on the 4 threads of a quad, so
// its max takes two shuffles, and l is summed per thread and reduced once
// at the end); the causal mask only on the diagonal tile; the dropout hash
// at each accumulator element's own (row, col); the dropped P rounded to
// the operand type in registers, where the accumulator fragment of S is
// the A fragment of O += P V (wgmma m64n{d}k16, B = V MN-major), so P
// never goes through shared memory. The producer keeps 24 registers and
// the consumers take 240 (setmaxnreg). O / l goes out in the operand type
// and lse = m + log(l) in f32, the contract the dq and fused kernels read.
// Two consumer warpgroups and a producer warpgroup. Under the launch bound
// of 384 threads every thread starts with 168 registers; the producer then
// gives its share to the consumers (4 x 32 x 24 + 8 x 32 x 240 = 64,512 of
// the SM's 65,536), which hold O and S (forward) or dK, dV, S^T and dP^T
// (dk/dv) in f32 registers without spilling.
constexpr int kTcThreads = 384;
constexpr int kTcProducerRegs = 24;
constexpr int kTcConsumerRegs = 240;
constexpr int kTcStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct TcFwdSmem {
  static constexpr int kTile = (D / 64) * 128 * 128;  // [128, D] 16-bit
  static constexpr size_t kBytes = 1024 + kTile * (1 + 2 * kTcStages);
};

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_fwd_kernel_tc(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
    float* __restrict__ lse, int sq, int sk, int causal, float scale,
    DropKey seed, uint32_t thresh, int dropout, float keep_prob) {
  using namespace hopper;
  constexpr int kTile = TcFwdSmem<D>::kTile;
  constexpr int kRegion = 128 * 128;  // one 64-column region of a tile
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_k[kTcStages];
  __shared__ __align__(8) uint64_t bar_v[kTcStages];
  __shared__ __align__(8) uint64_t bar_empty[kTcStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + kTile;                 // stage s at sK + s * kTile
  uint8_t* sV = sK + kTcStages * kTile;

  const int bh = blockIdx.y;
  const int qi = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qi * 128;
  const int nk = causal ? qi + 1 : sk / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer warpgroup: one lane issues the TMA
    setmaxnreg_dec<kTcProducerRegs>();
    if (warp == 8 && lane == 0) {
      const int qrow = bh * sq + q0;
      mbar_expect_tx(&bar_q, kTile);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_2d(sQ + c * kRegion, &tm_q, &bar_q, c * 64, qrow);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kTcStages;
        mbar_wait(&bar_empty[s], ((j / kTcStages) & 1) ^ 1);
        const int krow = bh * sk + j * 128;
        mbar_expect_tx(&bar_k[s], kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_2d(sK + s * kTile + c * kRegion, &tm_k, &bar_k[s], c * 64,
                      krow);
        mbar_expect_tx(&bar_v[s], kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_2d(sV + s * kTile + c * kRegion, &tm_v, &bar_v[s], c * 64,
                      krow);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63
  setmaxnreg_inc<kTcConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int t4 = lane % 4;
  const int row0 = q0 + wg * 64 + w * 16 + lane / 4;  // and row0 + 8
  const float sl2 = scale * kLog2e;  // scores in the log2 domain
  const float inv_keep = 1.f / keep_prob;
  uint32_t rkey[2] = {0u, 0u};
  if (dropout) {
    const uint32_t kh = head_key(seed, bh);
    rkey[0] = mix32(kh ^ static_cast<uint32_t>(row0));
    rkey[1] = mix32(kh ^ static_cast<uint32_t>(row0 + 8));
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 domain
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  const uint64_t desc_q = sw128_desc(sQ + wg * 64 * 128, 0, 1024);
  mbar_wait(&bar_q, 0);
  for (int j = 0; j < nk; ++j) {
    const int s = j % kTcStages;
    const uint32_t phase = (j / kTcStages) & 1;
    const int k0 = j * 128;
    float sc[64];
    mbar_wait(&bar_k[s], phase);
    const uint64_t desc_k = sw128_desc(sK + s * kTile, 0, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kRegion + (kk % 4) * 32;
      wgmma_ss<128, T>(sc, desc_add(desc_q, off), desc_add(desc_k, off),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<64>(sc);

    const bool diag = causal && j == nk - 1;
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      float mx = m[i];
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * jb + 2 * i + e] * sl2;
          if (diag && k0 + 8 * jb + 2 * t4 + e > row) x = kNegInf;
          sc[4 * jb + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[i] = exp2f(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int jb = 0; jb < 16; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(sc[4 * jb + 2 * i + e] - mx);
          rs += p;
          if (dropout)
            p = drop_bits(rkey[i], k0 + 8 * jb + 2 * t4 + e) >= thresh
                    ? p * inv_keep
                    : 0.f;
          sc[4 * jb + 2 * i + e] = p;
        }
      l[i] = l[i] * alpha[i] + rs;
    }
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * jb + 2 * i] *= alpha[i];
        o[4 * jb + 2 * i + 1] *= alpha[i];
      }
    uint32_t pa[8][4];  // the dropped P as A fragments, one per k16 slice
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack2<T>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    mbar_wait(&bar_v[s], phase);
    const uint64_t desc_v = sw128_desc(sV + s * kTile, kRegion, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs<D, T>(o, pa[kk], desc_add(desc_v, kk * 16 * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(o);
    fence_regs<32>(&pa[0][0]);
    if (lane == 0) mbar_arrive(&bar_empty[s]);  // K and V of stage s read
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float l_safe = li == 0.f ? 1.f : li;
    const int row = row0 + 8 * i;
    T* orow = out + (static_cast<size_t>(bh) * sq + row) * D;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(orow + 8 * jb + 2 * t4) =
          pack2<T>(o[4 * jb + 2 * i] / l_safe, o[4 * jb + 2 * i + 1] / l_safe);
    if (t4 == 0)
      lse[static_cast<size_t>(bh) * sq + row] = m[i] * kLn2 + logf(l_safe);
  }
}

// --------------------------------------- tensor-core dk / dv (wgmma)
// Replaces _bwd_dkv_kernel for bf16 / fp16 operands at head_dim 64 and
// 128. Bound at [32, 8192, 128] causal: operations (4 products, 1.1e12
// FLOP at 989 TFLOP/s = 1.11 ms).
//
// One CTA of 384 threads per (k tile of 128 rows, head), heaviest causal
// tiles (the first) first; sq != sk is allowed when not causal. K and V
// stay in shared memory (loaded once by TMA). Warp 8, in the producer
// warpgroup, streams [64, d] Q and dO tiles by TMA through kTcStages
// stages, its 32 lanes copying the tiles' lse and delta slices beside them (plain loads,
// released to the consumers by the full barrier's arrive). The q tiles run
// from the first whose last row reaches the k tile (k0 / 64 under causal)
// to the end. Warpgroups 0 and 1 own 64 k rows each and compute the
// transposed scores, so the k row is the row index throughout:
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, A = K / V and
//   B = Q / dO, all K-major in shared memory);
//   P^T = exp(S^T scale - lse[col]) from the GIVEN lse (any logsumexp: the
//   ring feeds the global one), the dropped P^T * inv for dV, and
//   dS^T = P^T (dP^T mask inv - delta[col]) scale (_bwd_dkv_kernel:
//   344-362), in f32; the causal mask only on the two q tiles that cross
//   the diagonal; the dropout hash at (row = q, col = k), its per-q half
//   mix32(kh ^ q) once per column a thread holds;
//   dV += P^T_dropped dO and dK += dS^T Q (wgmma m64n{d}k16, A from
//   registers: the S^T / dP^T accumulators rounded to the operand type in
//   place; B = dO / Q MN-major, the same shared-memory tiles read the
//   other way).
// The loop is software-pipelined: the products of q tile i and the dV / dK
// update of tile i - 1 are issued together, and the elementwise work on
// tile i runs while that update is still on the tensor cores (one wgmma
// wait per q tile; on the H100 this ran faster than waiting after each
// product).
// dK and dV are written once, in the k/v type: deterministic, no atomics.
template <int D>
struct TcDkvSmem {
  static constexpr int kKV = (D / 64) * 128 * 128;  // [128, D] K or V
  static constexpr int kQ = (D / 64) * 64 * 128;    // [64, D] Q or dO
  static constexpr size_t kBytes = 1024 + 2 * kKV + 2 * kTcStages * kQ;
};

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dkv_kernel_tc(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int causal, float scale, DropKey seed, uint32_t thresh,
    int dropout, float inv) {
  using namespace hopper;
  constexpr int kKV = TcDkvSmem<D>::kKV;
  constexpr int kQ = TcDkvSmem<D>::kQ;
  constexpr int kKRegion = 128 * 128;  // 64-column region of a K/V tile
  constexpr int kQRegion = 64 * 128;   // 64-column region of a Q/dO tile
  __shared__ __align__(8) uint64_t bar_kv;
  __shared__ __align__(8) uint64_t bar_full[kTcStages];
  __shared__ __align__(8) uint64_t bar_empty[kTcStages];
  __shared__ float s_lse[kTcStages][64];
  __shared__ float s_delta[kTcStages][64];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + kKV;
  uint8_t* sQ = sV + kKV;                 // stage s at sQ + s * kQ
  uint8_t* sdO = sQ + kTcStages * kQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 128;
  const int qt0 = causal ? k0 / 64 : 0;  // first q tile reaching k0
  const int nq = sq / 64 - qt0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar_full[s], 32);  // the producer warp's lanes
      mbar_init(&bar_empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer warpgroup: warp 8 streams the tiles
    setmaxnreg_dec<kTcProducerRegs>();
    if (warp > 8) return;
    if (lane == 0) {
      const int krow = bh * sk + k0;
      mbar_expect_tx(&bar_kv, 2 * kKV);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_2d(sK + c * kKRegion, &tm_k, &bar_kv, c * 64, krow);
        tma_load_2d(sV + c * kKRegion, &tm_v, &bar_kv, c * 64, krow);
      }
    }
    for (int it = 0; it < nq; ++it) {
      const int s = it % kTcStages;
      mbar_wait(&bar_empty[s], ((it / kTcStages) & 1) ^ 1);
      const size_t qrow = static_cast<size_t>(bh) * sq + (qt0 + it) * 64;
      s_lse[s][lane] = lse[qrow + lane];
      s_lse[s][lane + 32] = lse[qrow + lane + 32];
      s_delta[s][lane] = delta[qrow + lane];
      s_delta[s][lane + 32] = delta[qrow + lane + 32];
      if (lane == 0) {
        mbar_expect_tx(&bar_full[s], 2 * kQ);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_2d(sQ + s * kQ + c * kQRegion, &tm_q, &bar_full[s], c * 64,
                      static_cast<int>(qrow));
          tma_load_2d(sdO + s * kQ + c * kQRegion, &tm_do, &bar_full[s],
                      c * 64, static_cast<int>(qrow));
        }
      } else {
        mbar_arrive(&bar_full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns k rows k0 + 64 wg .. + 63
  setmaxnreg_inc<kTcConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int t4 = lane % 4;
  const int krow0 = k0 + wg * 64 + w * 16 + lane / 4;  // and krow0 + 8
  const uint32_t kh = head_key(seed, bh);
  const float sl2 = scale * kLog2e;
  float dka[D / 2];
  float dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const uint64_t desc_k = sw128_desc(sK + wg * 64 * 128, 0, 1024);
  const uint64_t desc_v = sw128_desc(sV + wg * 64 * 128, 0, 1024);
  float st[32];       // S^T of one q tile, then the dropped P^T (f32)
  float dpt[32];      // dP^T, then dS^T (f32)
  uint32_t pa[4][4];  // dropped P^T, A fragments per k16 slice of q
  uint32_t sa[4][4];  // dS^T
  // Software pipeline, one wgmma wait per q tile. Step it issues
  // S^T_it, dP^T_it and dV, dK += (P^T, dS^T)_{it-1} (Q, dO)_{it-1} as two
  // commit groups; the elementwise work on tile it runs as soon as its
  // products land, while tile it - 1's are still on the tensor cores.
  mbar_wait(&bar_kv, 0);
  for (int it = 0; it <= nq; ++it) {
    const bool has_s = it < nq;  // S^T_it and dP^T_it
    const bool has_g = it > 0;   // dV, dK from tile it - 1
    const int s = it % kTcStages;
    const int sp = (it + kTcStages - 1) % kTcStages;  // stage of tile it-1
    if (has_s) mbar_wait(&bar_full[s], (it / kTcStages) & 1);
    wgmma_fence();
    if (has_s) {
      const uint64_t desc_q = sw128_desc(sQ + s * kQ, 0, 1024);
      const uint64_t desc_do = sw128_desc(sdO + s * kQ, 0, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, T>(st,
                        desc_add(desc_k, (kk / 4) * kKRegion + (kk % 4) * 32),
                        desc_add(desc_q, (kk / 4) * kQRegion + (kk % 4) * 32),
                        kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, T>(dpt,
                        desc_add(desc_v, (kk / 4) * kKRegion + (kk % 4) * 32),
                        desc_add(desc_do, (kk / 4) * kQRegion + (kk % 4) * 32),
                        kk > 0);
    }
    wgmma_commit();
    if (has_g) {
      const uint64_t desc_dot = sw128_desc(sdO + sp * kQ, kQRegion, 1024);
      const uint64_t desc_qt = sw128_desc(sQ + sp * kQ, kQRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, T>(dva, pa[kk], desc_add(desc_dot, kk * 16 * 128), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, T>(dka, sa[kk], desc_add(desc_qt, kk * 16 * 128), 1);
    }
    wgmma_commit();
    if (has_s) {
      wgmma_wait<1>();  // S^T_it and dP^T_it have landed
      fence_regs<32>(st);
      fence_regs<32>(dpt);
      const int q0 = (qt0 + it) * 64;
      const bool diag = causal && q0 < k0 + 128;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jb + 2 * t4 + e;  // q column in the tile
          const int q = q0 + c;
          const float L2 = s_lse[s][c] * kLog2e;
          const float Dl = s_delta[s][c];
          const uint32_t qkey =
              dropout ? mix32(kh ^ static_cast<uint32_t>(q)) : 0u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * jb + 2 * i + e;
            const int krow = krow0 + 8 * i;
            float x = st[idx] * sl2 - L2;
            if (diag && krow > q) x = kNegInf;
            const float p = exp2f(x);
            float dpv = dpt[idx];
            float pd = p;
            if (dropout) {
              const bool keep = drop_bits(qkey, krow) >= thresh;
              pd = keep ? p * inv : 0.f;
              dpv = keep ? dpv * inv : 0.f;
            }
            st[idx] = pd;
            dpt[idx] = p * (dpv - Dl) * scale;
          }
        }
    }
    wgmma_wait<0>();  // dV, dK of tile it - 1 have landed
    fence_regs<D / 2>(dva);
    fence_regs<D / 2>(dka);
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&sa[0][0]);
    if (has_g && lane == 0)
      mbar_arrive(&bar_empty[sp]);  // Q, dO, lse, delta of tile it-1 read
    if (has_s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack2<T>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          sa[kk][r] =
              pack2<T>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = static_cast<size_t>(bh) * sk + krow0 + 8 * i;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const int col = 8 * jb + 2 * t4;
      *reinterpret_cast<uint32_t*>(dk + row * D + col) =
          pack2<T>(dka[4 * jb + 2 * i], dka[4 * jb + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv + row * D + col) =
          pack2<T>(dva[4 * jb + 2 * i], dva[4 * jb + 2 * i + 1]);
    }
  }
}

// ------------------------------------------------- tensor-core dq (wgmma)
// Replaces _bwd_dq_kernel (fleetx_tpu/ops/flash_attention.py:268, launched
// by _bwd_dq at :378) for bf16 / fp16 operands at head_dim 64 and 128.
// Bound at the seq-8192 path's shape ([32, 8192, 128] causal): operations
// (3 products, 8.25e11 FLOP at 989 TFLOP/s bf16 = 0.834 ms, against
// 0.08 GB of traffic, 0.02 ms).
//
// One CTA of 384 threads per (q tile of 128 rows, head); the grid runs the
// heaviest causal tiles of every head first (blockIdx.y counts down the q
// tiles, blockIdx.x is the head). Warp 8's lane 0 loads Q and dO once by
// TMA, then streams [64, d] K and V tiles through a ring of kDqStages
// stages (one full barrier per stage for both, one empty barrier per
// stage that the eight consumer warps release): from k tile 0 to the
// diagonal under causal, over all of sk otherwise (sq != sk is allowed
// when not causal). Warpgroups 0 and 1 own 64 q rows each; their lse and
// delta rows stay in registers. Per k tile:
//   S = Q K^T and dP = dO V^T (wgmma m64n64k16, A = Q / dO and B = K / V,
//   all K-major in shared memory, as the forward reads Q and K);
//   P = exp2(S scale log2e - lse log2e) from the GIVEN lse (any
//   logsumexp: the ring feeds the global one), the causal mask only on the
//   two k tiles that reach the block's rows, the dropout hash at each
//   accumulator element's own (row = q, col = k), kept dP DIVIDED by the
//   keep probability (_bwd_dq_kernel:301-305; dk/dv multiplies by its
//   reciprocal), dS = P (dP - delta) scale in f32;
//   dS rounded to the operand type in registers, where the accumulator
//   fragment is the A fragment of dQ += dS K (wgmma m64n{d}k16, B = the
//   same K tile read MN-major with the transpose bit).
// The loop is software-pipelined as the dk/dv kernel's: step j issues S_j,
// dP_j and dQ += dS_{j-1} K_{j-1} together, and the elementwise work on
// tile j runs while the dQ product is on the tensor cores (one wgmma wait
// per tile). Three stages let the producer load tile j + 1 while tile
// j - 1 is still read. dQ accumulates in f32 registers (d / 2 a thread)
// and is written once, in the operand type: deterministic, no atomics.
constexpr int kDqBK = 64;     // k rows per streamed tile
constexpr int kDqStages = 3;  // depth of the K / V ring

template <int D>
struct TcDqSmem {
  static constexpr int kQ = (D / 64) * 128 * 128;     // [128, D] Q or dO
  static constexpr int kKV = (D / 64) * kDqBK * 128;  // [64, D] K or V
  static constexpr size_t kBytes = 1024 + 2 * kQ + 2 * kDqStages * kKV;
};

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dq_kernel_tc(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk,
    int causal, float scale, DropKey seed, uint32_t thresh, int dropout,
    float keep_prob) {
  using namespace hopper;
  using Smem = TcDqSmem<D>;
  constexpr int kQRegion = 128 * 128;    // 64-column region of a Q/dO tile
  constexpr int kKRegion = kDqBK * 128;  // 64-column region of a K/V tile
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_full[kDqStages];
  __shared__ __align__(8) uint64_t bar_empty[kDqStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sdO = sQ + Smem::kQ;
  uint8_t* sK = sdO + Smem::kQ;            // stage s at sK + s * kKV
  uint8_t* sV = sK + kDqStages * Smem::kKV;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // heaviest first
  const int nk = causal ? (q0 + 128) / kDqBK : sk / kDqBK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer warpgroup: one lane issues the TMA
    setmaxnreg_dec<kTcProducerRegs>();
    if (warp == 8 && lane == 0) {
      const int qrow = bh * sq + q0;
      mbar_expect_tx(&bar_q, 2 * Smem::kQ);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_2d(sQ + c * kQRegion, &tm_q, &bar_q, c * 64, qrow);
        tma_load_2d(sdO + c * kQRegion, &tm_do, &bar_q, c * 64, qrow);
      }
      for (int j = 0; j < nk; ++j) {
        const int s = j % kDqStages;
        mbar_wait(&bar_empty[s], ((j / kDqStages) & 1) ^ 1);
        const int krow = bh * sk + j * kDqBK;
        mbar_expect_tx(&bar_full[s], 2 * Smem::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_2d(sK + s * Smem::kKV + c * kKRegion, &tm_k, &bar_full[s],
                      c * 64, krow);
          tma_load_2d(sV + s * Smem::kKV + c * kKRegion, &tm_v, &bar_full[s],
                      c * 64, krow);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63
  setmaxnreg_inc<kTcConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int t4 = lane % 4;
  const int row0 = q0 + wg * 64 + w * 16 + lane / 4;  // and row0 + 8
  const float sl2 = scale * kLog2e;
  const uint32_t kh = head_key(seed, bh);
  float L2[2];  // lse of the two rows, log2 domain
  float Dl[2];  // delta of the two rows
  uint32_t rkey[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t r = static_cast<size_t>(bh) * sq + row0 + 8 * i;
    L2[i] = lse[r] * kLog2e;
    Dl[i] = delta[r];
    rkey[i] = mix32(kh ^ static_cast<uint32_t>(row0 + 8 * i));
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  float sc[32];        // S of one k tile (f32)
  float dps[32];       // dP, then dS (f32)
  uint32_t sa[4][4];   // dS rounded, A fragments per k16 slice of the tile
  const uint64_t desc_q = sw128_desc(sQ + wg * 64 * 128, 0, 1024);
  const uint64_t desc_do = sw128_desc(sdO + wg * 64 * 128, 0, 1024);
  mbar_wait(&bar_q, 0);
  for (int j = 0; j <= nk; ++j) {
    const bool has_s = j < nk;  // S_j and dP_j
    const bool has_g = j > 0;   // dQ += dS_{j-1} K_{j-1}
    const int s = j % kDqStages;
    const int sp = (j + kDqStages - 1) % kDqStages;  // stage of tile j-1
    if (has_s) mbar_wait(&bar_full[s], (j / kDqStages) & 1);
    wgmma_fence();
    if (has_s) {
      const uint64_t desc_k = sw128_desc(sK + s * Smem::kKV, 0, 1024);
      const uint64_t desc_v = sw128_desc(sV + s * Smem::kKV, 0, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, T>(sc,
                        desc_add(desc_q, (kk / 4) * kQRegion + (kk % 4) * 32),
                        desc_add(desc_k, (kk / 4) * kKRegion + (kk % 4) * 32),
                        kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, T>(dps,
                        desc_add(desc_do, (kk / 4) * kQRegion + (kk % 4) * 32),
                        desc_add(desc_v, (kk / 4) * kKRegion + (kk % 4) * 32),
                        kk > 0);
    }
    wgmma_commit();
    if (has_g) {
      const uint64_t desc_kt = sw128_desc(sK + sp * Smem::kKV, kKRegion, 1024);
#pragma unroll
      for (int kk = 0; kk < kDqBK / 16; ++kk)
        wgmma_rs<D, T>(dqa, sa[kk], desc_add(desc_kt, kk * 16 * 128), 1);
    }
    wgmma_commit();
    if (has_s) {
      wgmma_wait<1>();  // S_j and dP_j have landed
      fence_regs<32>(sc);
      fence_regs<32>(dps);
      const int k0 = j * kDqBK;
      const bool diag = causal && k0 + kDqBK > q0;
#pragma unroll
      for (int jb = 0; jb < kDqBK / 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * jb + 2 * t4 + e;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * jb + 2 * i + e;
            float x = sc[idx] * sl2 - L2[i];
            if (diag && col > row0 + 8 * i) x = kNegInf;
            const float p = exp2f(x);
            float dpv = dps[idx];
            if (dropout)
              dpv = drop_bits(rkey[i], col) >= thresh ? dpv / keep_prob : 0.f;
            dps[idx] = p * (dpv - Dl[i]) * scale;
          }
        }
    }
    wgmma_wait<0>();  // dQ += dS_{j-1} K_{j-1} has landed
    fence_regs<D / 2>(dqa);
    fence_regs<16>(&sa[0][0]);
    if (has_g && lane == 0)
      mbar_arrive(&bar_empty[sp]);  // K and V of tile j-1 read
    if (has_s) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sa[kk][r] = pack2<T>(dps[8 * kk + 2 * r], dps[8 * kk + 2 * r + 1]);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T* orow = dq + (static_cast<size_t>(bh) * sq + row0 + 8 * i) * D;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<uint32_t*>(orow + 8 * jb + 2 * t4) =
          pack2<T>(dqa[4 * jb + 2 * i], dqa[4 * jb + 2 * i + 1]);
  }
}

// ------------------------------------ tensor-core fused backward (wgmma)
// Replaces _bwd_fused_kernel (fleetx_tpu/ops/flash_attention.py:431,
// launched by _bwd_fused at :519) for bf16 / fp16 operands at head_dim 64
// and 128. Bound at the GPT-345M training shape ([128, 1024, 64] causal):
// operations (5 products, 4.29e10 FLOP at 989 TFLOP/s bf16 = 0.0435 ms,
// against 0.07 GB of traffic, 0.02 ms).
//
// Deterministic, as _bwd_fused_kernel and the SIMT kernel are: one CTA of
// 384 threads per head owns the head's whole sweep. It walks the k tiles
// of 128 rows IN ORDER; warpgroups 0 and 1 own 64 k rows each, as in
// flash_bwd_dkv_kernel_tc. Warp 8 loads K and V once per k tile by TMA
// (a full and an empty barrier), and streams [64, d] Q and dO tiles with
// their lse and delta slices through a ring of kTcStages stages, flat over
// the sweep: for each k tile the q tiles from the first that reaches it
// (k0 / 64 under causal, 0 otherwise) to the end. Per (k tile, q tile) the
// dk/dv kernel's four products, then a fifth:
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, all K-major);
//   P^T = exp2(S^T scale log2e - lse log2e), the dropped P^T * inv for dV,
//   dS^T = P^T (dP^T mask inv - delta) scale (_bwd_fused_kernel:484-493:
//   both multiply by inv), in f32; the causal mask only on the two q tiles
//   that cross the diagonal;
//   dV += P^T dO and dK += dS^T Q (wgmma m64n{d}k16, A from registers: the
//   accumulators rounded to the operand type in place; B = dO / Q
//   MN-major);
//   dQ_tile = dS K: dS must reach the tensor cores with q as the row index,
//   so both warpgroups store their rounded dS^T rows into one
//   [128 k, 64 q] 128-byte-swizzled tile (double-buffered; a named barrier
//   over the 256 consumer threads hands it over), which wgmma reads as A
//   MN-major; B = the resident K tile, MN-major. The warpgroups split dQ's
//   d columns (wgmma m64n{d/2}k16 over the 128 k rows): warpgroup wg owns
//   columns wg d/2 .. + d/2 - 1 of the q tile's 64 rows;
//   each thread adds its dQ partial to the head's f32 dq rows in device
//   memory (read while the products run, added, written back; the first
//   k tile writes them).
// The steps run one after another: a software-pipelined loop (tile i's
// updates issued with tile i + 1's products, as in the dk/dv kernel) gave
// bit-identical results and ran slower on the H100 at d 64 and no faster
// at d 128, so the serial loop stays.
// Why it is deterministic: a thread's dQ elements are the same (row,
// column) pairs at every k tile, so each thread reads, adds to and writes
// back the same elements in program order; no other thread or CTA touches
// them, there are no atomics, and the sums run in one fixed order. The
// head's f32 dq window (1024 x 64 x 4 B = 256 KB at the 345M shape, 32 MB
// over 128 heads) stays in the 50 MB L2 cache: the counterpart of the JAX
// kernel's VMEM-resident dq window. dK and dV are written once per k tile,
// in the k/v type. Registers at d 64: dK 32 + dV 32 + S^T 32 + dP^T 32 +
// dQ 16 + fragments 32 per consumer thread.
template <int D>
struct TcBwdSmem {
  static constexpr int kKV = (D / 64) * 128 * 128;  // [128, D] K or V
  static constexpr int kQ = (D / 64) * 64 * 128;    // [64, D] Q or dO
  static constexpr int kDs = 128 * 128;             // [128 k, 64 q] dS^T
  static constexpr size_t kBytes =
      1024 + 2 * kKV + 2 * kTcStages * kQ + 2 * kDs;
};

template <typename T, int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_kernel_tc(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int causal,
    float scale, DropKey seed, uint32_t thresh, int dropout, float inv) {
  using namespace hopper;
  using Smem = TcBwdSmem<D>;
  constexpr int kKRegion = 128 * 128;  // 64-column region of a K/V tile
  constexpr int kQRegion = 64 * 128;   // 64-column region of a Q/dO tile
  constexpr int kN = D / 2;            // dQ columns per warpgroup
  __shared__ __align__(8) uint64_t bar_kv_full;
  __shared__ __align__(8) uint64_t bar_kv_empty;
  __shared__ __align__(8) uint64_t bar_full[kTcStages];
  __shared__ __align__(8) uint64_t bar_empty[kTcStages];
  __shared__ float s_lse[kTcStages][64];
  __shared__ float s_delta[kTcStages][64];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + Smem::kKV;
  uint8_t* sQ = sV + Smem::kKV;              // stage s at sQ + s * kQ
  uint8_t* sdO = sQ + kTcStages * Smem::kQ;
  uint8_t* sdS = sdO + kTcStages * Smem::kQ;  // buffer b at sdS + b * kDs

  const int bh = blockIdx.x;
  const int nkt = sk / 128;
  const int nqt = sq / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(&bar_kv_full, 1);
    mbar_init(&bar_kv_empty, 8);   // lane 0 of each consumer warp
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar_full[s], 32);  // the producer warp's lanes
      mbar_init(&bar_empty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // ---- producer warpgroup: warp 8 streams the tiles
    setmaxnreg_dec<kTcProducerRegs>();
    if (warp > 8) return;
    int g = 0;  // q-tile step, flat over the sweep
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * 128;
      if (lane == 0) {
        mbar_wait(&bar_kv_empty, (kt & 1) ^ 1);  // k tile kt-1 done
        mbar_expect_tx(&bar_kv_full, 2 * Smem::kKV);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_2d(sK + c * kKRegion, &tm_k, &bar_kv_full, c * 64,
                      bh * sk + k0);
          tma_load_2d(sV + c * kKRegion, &tm_v, &bar_kv_full, c * 64,
                      bh * sk + k0);
        }
      }
      for (int qt = causal ? k0 / 64 : 0; qt < nqt; ++qt, ++g) {
        const int s = g % kTcStages;
        mbar_wait(&bar_empty[s], ((g / kTcStages) & 1) ^ 1);
        const size_t qrow = static_cast<size_t>(bh) * sq + qt * 64;
        s_lse[s][lane] = lse[qrow + lane];
        s_lse[s][lane + 32] = lse[qrow + lane + 32];
        s_delta[s][lane] = delta[qrow + lane];
        s_delta[s][lane + 32] = delta[qrow + lane + 32];
        if (lane == 0) {
          mbar_expect_tx(&bar_full[s], 2 * Smem::kQ);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_2d(sQ + s * Smem::kQ + c * kQRegion, &tm_q, &bar_full[s],
                        c * 64, static_cast<int>(qrow));
            tma_load_2d(sdO + s * Smem::kQ + c * kQRegion, &tm_do,
                        &bar_full[s], c * 64, static_cast<int>(qrow));
          }
        } else {
          mbar_arrive(&bar_full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns k rows k0 + 64 wg .. + 63 of each k
  // tile, and dQ columns wg kN .. + kN - 1 of each q tile
  setmaxnreg_inc<kTcConsumerRegs>();
  const int wg = warp / 4;
  const int w = warp % 4;
  const int t4 = lane % 4;
  const int r0 = wg * 64 + w * 16 + lane / 4;  // k row in the tile (and +8)
  const uint32_t kh = head_key(seed, bh);
  const float sl2 = scale * kLog2e;
  const uint64_t desc_k = sw128_desc(sK + wg * 64 * 128, 0, 1024);
  const uint64_t desc_v = sw128_desc(sV + wg * 64 * 128, 0, 1024);
  // B of dQ_tile = dS K: K MN-major, this warpgroup's kN columns (a
  // region of its own at d 128, a 64-byte offset inside the one region at
  // d 64: the swizzle acts on address bits, so the offset reads columns
  // 32-63 as they were stored)
  const uint64_t desc_kb =
      sw128_desc(sK + wg * (D == 128 ? kKRegion : kN * 2), kKRegion, 1024);
  float dka[D / 2];
  float dva[D / 2];
  float st[32];       // S^T of one q tile, then the dropped P^T (f32)
  float dpt[32];      // dP^T, then dS^T (f32)
  float dqa[kN / 2];  // this warpgroup's dQ columns of the q tile
  uint32_t pa[4][4];  // dropped P^T, A fragments per k16 slice of q
  uint32_t sa[4][4];  // dS^T
  int g = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * 128;
    const int krow0 = k0 + r0;  // and krow0 + 8
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dka[i] = 0.f;
      dva[i] = 0.f;
    }
    mbar_wait(&bar_kv_full, kt & 1);
    for (int qt = causal ? k0 / 64 : 0; qt < nqt; ++qt, ++g) {
      const int s = g % kTcStages;
      const int q0 = qt * 64;
      uint8_t* ds_tile = sdS + (g & 1) * Smem::kDs;
      mbar_wait(&bar_full[s], (g / kTcStages) & 1);
      const uint64_t desc_q = sw128_desc(sQ + s * Smem::kQ, 0, 1024);
      const uint64_t desc_do = sw128_desc(sdO + s * Smem::kQ, 0, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, T>(st,
                        desc_add(desc_k, (kk / 4) * kKRegion + (kk % 4) * 32),
                        desc_add(desc_q, (kk / 4) * kQRegion + (kk % 4) * 32),
                        kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64, T>(dpt,
                        desc_add(desc_v, (kk / 4) * kKRegion + (kk % 4) * 32),
                        desc_add(desc_do, (kk / 4) * kQRegion + (kk % 4) * 32),
                        kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32>(st);
      fence_regs<32>(dpt);

      const bool diag = causal && q0 < k0 + 128;
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * jb + 2 * t4 + e;  // q column in the tile
          const int q = q0 + c;
          const float L2 = s_lse[s][c] * kLog2e;
          const float Dl = s_delta[s][c];
          const uint32_t qkey =
              dropout ? mix32(kh ^ static_cast<uint32_t>(q)) : 0u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * jb + 2 * i + e;
            const int krow = krow0 + 8 * i;
            float x = st[idx] * sl2 - L2;
            if (diag && krow > q) x = kNegInf;
            const float p = exp2f(x);
            float dpv = dpt[idx];
            float pd = p;
            if (dropout) {
              const bool keep = drop_bits(qkey, krow) >= thresh;
              pd = keep ? p * inv : 0.f;
              dpv = keep ? dpv * inv : 0.f;
            }
            st[idx] = pd;
            dpt[idx] = p * (dpv - Dl) * scale;
          }
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[kk][r] = pack2<T>(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
          sa[kk][r] = pack2<T>(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
        }
      // the rounded dS^T rows into the shared tile: register 2h + i of
      // slice kk holds k row r0 + 8i, q columns 16kk + 8h + 2 t4 + {0, 1},
      // i.e. 16-byte chunk 2kk + h of the row, at chunk (2kk + h) ^ (row %
      // 8) under the 128-byte swizzle (a warp's 32 stores hit 32 banks)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = r0 + 8 * i;
            *reinterpret_cast<uint32_t*>(
                ds_tile + row * 128 + (((2 * kk + h) ^ (row & 7)) << 4) +
                t4 * 4) = sa[kk][2 * h + i];
          }
      fence_proxy_async();
      named_barrier(1, 256);  // both halves of dS^T are in the tile

      const uint64_t desc_dot = sw128_desc(sdO + s * Smem::kQ, kQRegion, 1024);
      const uint64_t desc_qt = sw128_desc(sQ + s * Smem::kQ, kQRegion, 1024);
      const uint64_t desc_ds = sw128_desc(ds_tile, Smem::kDs, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, T>(dva, pa[kk], desc_add(desc_dot, kk * 16 * 128), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D, T>(dka, sa[kk], desc_add(desc_qt, kk * 16 * 128), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_tt<kN, T>(dqa, desc_add(desc_ds, kk * 16 * 128),
                           desc_add(desc_kb, kk * 16 * 128), kk > 0);
      wgmma_commit();
      // this thread's dq elements: rows q0 + 16w + l/4 + 8i, columns
      // wg kN + 8jb + 2 t4 + {0, 1}; read while the products run
      float* dq_rows = dq + (static_cast<size_t>(bh) * sq + q0 + w * 16 +
                             lane / 4) * D + wg * kN + 2 * t4;
      float2 cur[kN / 8][2];
#pragma unroll
      for (int jb = 0; jb < kN / 8; ++jb)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          cur[jb][i] = kt > 0 ? *reinterpret_cast<const float2*>(
                                    dq_rows + 8 * i * D + 8 * jb)
                              : make_float2(0.f, 0.f);
      wgmma_wait<0>();
      fence_regs<D / 2>(dva);
      fence_regs<D / 2>(dka);
      fence_regs<kN / 2>(dqa);
      fence_regs<16>(&pa[0][0]);
      fence_regs<16>(&sa[0][0]);
      if (lane == 0) mbar_arrive(&bar_empty[s]);  // Q, dO, lse, delta read
#pragma unroll
      for (int jb = 0; jb < kN / 8; ++jb)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(dq_rows + 8 * i * D + 8 * jb) =
              make_float2(cur[jb][i].x + dqa[4 * jb + 2 * i],
                          cur[jb][i].y + dqa[4 * jb + 2 * i + 1]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const size_t row = static_cast<size_t>(bh) * sk + krow0 + 8 * i;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int col = 8 * jb + 2 * t4;
        *reinterpret_cast<uint32_t*>(dk + row * D + col) =
            pack2<T>(dka[4 * jb + 2 * i], dka[4 * jb + 2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + row * D + col) =
            pack2<T>(dva[4 * jb + 2 * i], dva[4 * jb + 2 * i + 1]);
      }
    }
    if (lane == 0) mbar_arrive(&bar_kv_empty);  // K and V of this tile read
  }
}

template <typename T, int D, int BQ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int sq, int sk,
                       int causal, float scale, DropKey seed,
                       uint32_t thresh, int dropout, float keep_prob,
                       cudaStream_t stream) {
  if (sq % BQ) return cudaErrorInvalidValue;
  const size_t bytes = FwdSmem<D, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / BQ, bh);
  flash_fwd_kernel<T, D, BQ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, sq, sk, causal,
      scale, seed, thresh, dropout, keep_prob);
  return cudaGetLastError();
}

template <typename T, int D, int BQ>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, float* dq, void* dk, void* dv,
                       int bh, int sq, int sk, int causal, float scale,
                       DropKey seed, uint32_t thresh, int dropout, float inv,
                       cudaStream_t stream) {
  if (sq % BQ) return cudaErrorInvalidValue;
  const size_t bytes = BwdSmem<D, BQ>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<T, D, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  flash_bwd_kernel<T, D, BQ><<<bh, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, causal, scale, seed,
      thresh, dropout, inv);
  return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int causal,
                      float scale, DropKey seed, uint32_t thresh,
                      int dropout, float keep_prob, cudaStream_t stream) {
  if (sq % BQ || sk % BK) return cudaErrorInvalidValue;
  const size_t bytes = DqSmem<D, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / BQ, bh);
  flash_bwd_dq_kernel<T, D, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, causal, scale, seed, thresh, dropout,
      keep_prob);
  return cudaGetLastError();
}

template <typename T, int D, int BQ, int BK>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int sq,
                       int sk, int causal, float scale, DropKey seed,
                       uint32_t thresh, int dropout, float inv,
                       cudaStream_t stream) {
  if (sq % BQ || sk % BK) return cudaErrorInvalidValue;
  const size_t bytes = DkvSmem<D, BQ, BK>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(sk / BK, bh);
  flash_bwd_dkv_kernel<T, D, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, causal, scale, seed,
      thresh, dropout, inv);
  return cudaGetLastError();
}

// Tiles (BQ, BK) per head_dim. Shared memory per block: dq 104,960 /
// 190,976 / 185,600 bytes and dk/dv 139,776 / 157,952 / 223,488 bytes for
// head_dim 64 / 128 / 256, under the 232,448 a block may use.
// SIMT dq: f32 at every head_dim, 16-bit types at head_dim 256 only
// (16-bit at 64 and 128 take the tensor-core kernel).
template <typename T>
cudaError_t dq_by_dim(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int d, int causal,
                      float scale, DropKey seed, uint32_t thresh,
                      int dropout, float keep_prob, cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (d == 64)
      return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, bh, sq,
                                      sk, causal, scale, seed, thresh,
                                      dropout, keep_prob, st);
    if (d == 128)
      return launch_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, bh, sq,
                                       sk, causal, scale, seed, thresh,
                                       dropout, keep_prob, st);
  }
  if (d == 256)
    return launch_dq<T, 256, 32, 32>(q, k, v, dout, lse, delta, dq, bh, sq,
                                     sk, causal, scale, seed, thresh,
                                     dropout, keep_prob, st);
  return cudaErrorInvalidValue;
}

// SIMT dk/dv: f32 at every head_dim, 16-bit types at head_dim 256 only
// (16-bit at 64 and 128 take the tensor-core kernel).
template <typename T>
cudaError_t dkv_by_dim(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int sq,
                       int sk, int d, int causal, float scale, DropKey seed,
                       uint32_t thresh, int dropout, float inv,
                       cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (d == 64)
      return launch_dkv<T, 64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       sq, sk, causal, scale, seed, thresh,
                                       dropout, inv, st);
    if (d == 128)
      return launch_dkv<T, 128, 32, 64>(q, k, v, dout, lse, delta, dk, dv,
                                        bh, sq, sk, causal, scale, seed,
                                        thresh, dropout, inv, st);
  }
  if (d == 256)
    return launch_dkv<T, 256, 32, 32>(q, k, v, dout, lse, delta, dk, dv, bh,
                                      sq, sk, causal, scale, seed, thresh,
                                      dropout, inv, st);
  return cudaErrorInvalidValue;
}

// SIMT forward: f32 at every head_dim, 16-bit types at head_dim 256 only.
template <typename T>
cudaError_t fwd_by_dim(const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int sq, int sk, int d,
                       int causal, float scale, DropKey seed,
                       uint32_t thresh, int dropout, float keep_prob,
                       cudaStream_t st) {
  if constexpr (std::is_same<T, float>::value) {
    if (d == 64)
      return launch_fwd<T, 64, 64>(q, k, v, out, lse, bh, sq, sk, causal,
                                   scale, seed, thresh, dropout, keep_prob,
                                   st);
    if (d == 128)
      return launch_fwd<T, 128, 64>(q, k, v, out, lse, bh, sq, sk, causal,
                                    scale, seed, thresh, dropout, keep_prob,
                                    st);
  }
  if (d == 256)
    return launch_fwd<T, 256, 32>(q, k, v, out, lse, bh, sq, sk, causal,
                                  scale, seed, thresh, dropout, keep_prob,
                                  st);
  return cudaErrorInvalidValue;
}

// Tensor-core launchers. A tensor map that cannot be encoded returns
// cudaErrorNotSupported.
template <typename T, int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* out, float* lse, int dtype, int bh, int sq,
                          int sk, int causal, float scale, DropKey seed,
                          uint32_t thresh, int dropout, float keep_prob,
                          cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!hopper::make_tile_map(&mq, q, dtype, static_cast<uint64_t>(bh) * sq,
                             D, 128) ||
      !hopper::make_tile_map(&mk, k, dtype, static_cast<uint64_t>(bh) * sk,
                             D, 128) ||
      !hopper::make_tile_map(&mv, v, dtype, static_cast<uint64_t>(bh) * sk,
                             D, 128))
    return cudaErrorNotSupported;
  const size_t bytes = TcFwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(sq / 128, bh);
  flash_fwd_kernel_tc<T, D><<<grid, kTcThreads, bytes, stream>>>(
      mq, mk, mv, static_cast<T*>(out), lse, sq, sk, causal, scale, seed,
      thresh, dropout, keep_prob);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv, int dtype,
                          int bh, int sq, int sk, int causal, float scale,
                          DropKey seed, uint32_t thresh, int dropout,
                          float inv, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  const uint64_t rq = static_cast<uint64_t>(bh) * sq;
  const uint64_t rk = static_cast<uint64_t>(bh) * sk;
  if (!hopper::make_tile_map(&mq, q, dtype, rq, D, 64) ||
      !hopper::make_tile_map(&mk, k, dtype, rk, D, 128) ||
      !hopper::make_tile_map(&mv, v, dtype, rk, D, 128) ||
      !hopper::make_tile_map(&mdo, dout, dtype, rq, D, 64))
    return cudaErrorNotSupported;
  const size_t bytes = TcDkvSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(sk / 128, bh);
  flash_bwd_dkv_kernel_tc<T, D><<<grid, kTcThreads, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, causal, scale, seed, thresh, dropout, inv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, void* dq, int dtype, int bh,
                         int sq, int sk, int causal, float scale,
                         DropKey seed, uint32_t thresh, int dropout,
                         float keep_prob, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  const uint64_t rq = static_cast<uint64_t>(bh) * sq;
  const uint64_t rk = static_cast<uint64_t>(bh) * sk;
  if (!hopper::make_tile_map(&mq, q, dtype, rq, D, 128) ||
      !hopper::make_tile_map(&mk, k, dtype, rk, D, kDqBK) ||
      !hopper::make_tile_map(&mv, v, dtype, rk, D, kDqBK) ||
      !hopper::make_tile_map(&mdo, dout, dtype, rq, D, 128))
    return cudaErrorNotSupported;
  const size_t bytes = TcDqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel_tc<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, sq / 128);
  flash_bwd_dq_kernel_tc<T, D><<<grid, kTcThreads, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), sq, sk, causal,
      scale, seed, thresh, dropout, keep_prob);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, float* dq, void* dk, void* dv,
                          int dtype, int bh, int sq, int sk, int causal,
                          float scale, DropKey seed, uint32_t thresh,
                          int dropout, float inv, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  const uint64_t rq = static_cast<uint64_t>(bh) * sq;
  const uint64_t rk = static_cast<uint64_t>(bh) * sk;
  if (!hopper::make_tile_map(&mq, q, dtype, rq, D, 64) ||
      !hopper::make_tile_map(&mk, k, dtype, rk, D, 128) ||
      !hopper::make_tile_map(&mv, v, dtype, rk, D, 128) ||
      !hopper::make_tile_map(&mdo, dout, dtype, rq, D, 64))
    return cudaErrorNotSupported;
  const size_t bytes = TcBwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel_tc<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  flash_bwd_kernel_tc<T, D><<<bh, kTcThreads, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, dq, static_cast<T*>(dk),
      static_cast<T*>(dv), sq, sk, causal, scale, seed, thresh, dropout, inv);
  return cudaGetLastError();
}

// The route, one predicate for all four kernels: bf16 / fp16 operands at
// head_dim 64 and 128 take the tensor-core kernels, everything else the
// SIMT ones. The Python wrappers
// decide it too (ops/flash_attention.py:tc_route) and pass it in; an entry
// point refuses a route that disagrees with this one.
bool tc_route(int dtype, int d) {
  return (dtype == 1 || dtype == 2) && (d == 64 || d == 128);
}

cudaError_t fwd_tc(const void* q, const void* k, const void* v, void* out,
                   float* lse, int dtype, int bh, int sq, int sk, int d,
                   int causal, float scale, DropKey seed, uint32_t thresh,
                   int dropout, float keep_prob, cudaStream_t st) {
  if (dtype == 1 && d == 64)
    return launch_fwd_tc<__nv_bfloat16, 64>(q, k, v, out, lse, dtype, bh, sq,
                                            sk, causal, scale, seed, thresh,
                                            dropout, keep_prob, st);
  if (dtype == 1 && d == 128)
    return launch_fwd_tc<__nv_bfloat16, 128>(q, k, v, out, lse, dtype, bh,
                                             sq, sk, causal, scale, seed,
                                             thresh, dropout, keep_prob, st);
  if (dtype == 2 && d == 64)
    return launch_fwd_tc<__half, 64>(q, k, v, out, lse, dtype, bh, sq, sk,
                                     causal, scale, seed, thresh, dropout,
                                     keep_prob, st);
  if (dtype == 2 && d == 128)
    return launch_fwd_tc<__half, 128>(q, k, v, out, lse, dtype, bh, sq, sk,
                                      causal, scale, seed, thresh, dropout,
                                      keep_prob, st);
  return cudaErrorInvalidValue;
}

cudaError_t dkv_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int dtype, int bh, int sq, int sk,
                   int d, int causal, float scale, DropKey seed,
                   uint32_t thresh, int dropout, float inv, cudaStream_t st) {
  if (dtype == 1 && d == 64)
    return launch_dkv_tc<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk,
                                            dv, dtype, bh, sq, sk, causal,
                                            scale, seed, thresh, dropout, inv,
                                            st);
  if (dtype == 1 && d == 128)
    return launch_dkv_tc<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk,
                                             dv, dtype, bh, sq, sk, causal,
                                             scale, seed, thresh, dropout,
                                             inv, st);
  if (dtype == 2 && d == 64)
    return launch_dkv_tc<__half, 64>(q, k, v, dout, lse, delta, dk, dv, dtype,
                                     bh, sq, sk, causal, scale, seed, thresh,
                                     dropout, inv, st);
  if (dtype == 2 && d == 128)
    return launch_dkv_tc<__half, 128>(q, k, v, dout, lse, delta, dk, dv,
                                      dtype, bh, sq, sk, causal, scale, seed,
                                      thresh, dropout, inv, st);
  return cudaErrorInvalidValue;
}

cudaError_t dq_tc(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, int dtype, int bh, int sq, int sk, int d,
                  int causal, float scale, DropKey seed, uint32_t thresh,
                  int dropout, float keep_prob, cudaStream_t st) {
  if (dtype == 1 && d == 64)
    return launch_dq_tc<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq,
                                           dtype, bh, sq, sk, causal, scale,
                                           seed, thresh, dropout, keep_prob,
                                           st);
  if (dtype == 1 && d == 128)
    return launch_dq_tc<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq,
                                            dtype, bh, sq, sk, causal, scale,
                                            seed, thresh, dropout, keep_prob,
                                            st);
  if (dtype == 2 && d == 64)
    return launch_dq_tc<__half, 64>(q, k, v, dout, lse, delta, dq, dtype, bh,
                                    sq, sk, causal, scale, seed, thresh,
                                    dropout, keep_prob, st);
  if (dtype == 2 && d == 128)
    return launch_dq_tc<__half, 128>(q, k, v, dout, lse, delta, dq, dtype,
                                     bh, sq, sk, causal, scale, seed, thresh,
                                     dropout, keep_prob, st);
  return cudaErrorInvalidValue;
}

cudaError_t bwd_tc(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   float* dq, void* dk, void* dv, int dtype, int bh, int sq,
                   int sk, int d, int causal, float scale, DropKey seed,
                   uint32_t thresh, int dropout, float inv, cudaStream_t st) {
  if (dtype == 1 && d == 64)
    return launch_bwd_tc<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq,
                                            dk, dv, dtype, bh, sq, sk, causal,
                                            scale, seed, thresh, dropout, inv,
                                            st);
  if (dtype == 1 && d == 128)
    return launch_bwd_tc<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq,
                                             dk, dv, dtype, bh, sq, sk,
                                             causal, scale, seed, thresh,
                                             dropout, inv, st);
  if (dtype == 2 && d == 64)
    return launch_bwd_tc<__half, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     dtype, bh, sq, sk, causal, scale, seed,
                                     thresh, dropout, inv, st);
  if (dtype == 2 && d == 128)
    return launch_bwd_tc<__half, 128>(q, k, v, dout, lse, delta, dq, dk, dv,
                                      dtype, bh, sq, sk, causal, scale, seed,
                                      thresh, dropout, inv, st);
  return cudaErrorInvalidValue;
}

// SIMT fused backward: f32 at head_dim 64 and 128 (16-bit types there take
// the tensor-core kernel; the fused kernel takes no head_dim above 128).
cudaError_t bwd_f32(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    float* dq, void* dk, void* dv, int bh, int sq, int sk,
                    int d, int causal, float scale, DropKey seed,
                    uint32_t thresh, int dropout, float inv,
                    cudaStream_t st) {
  if (d == 64)
    return launch_bwd<float, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv,
                                     bh, sq, sk, causal, scale, seed, thresh,
                                     dropout, inv, st);
  if (d == 128)
    return launch_bwd<float, 128, 32>(q, k, v, dout, lse, delta, dq, dk, dv,
                                      bh, sq, sk, causal, scale, seed,
                                      thresh, dropout, inv, st);
  return cudaErrorInvalidValue;
}

bool geometry_ok(int bh, int sq, int sk, int causal) {
  return bh >= 1 && bh <= 65535 && sq >= 128 && sq % 128 == 0 && sk >= 128 &&
         sk % 128 == 0 && (!causal || sq == sk);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16; tc: 1 for the tensor-core route, which must equal
// tc_route(dtype, d) (every entry point takes it). q/k/v/out/dout are
// [bh, seq, d] contiguous; lse/delta [bh, sq] f32; the fused kernel's dq
// [bh, sq, d] f32. dropout != 0 keeps an element when its
// hash word is >= thresh; local_heads, total_heads, batch_offset and
// head_offset map a launch's b*head index to the global one (DropKey). Returns 0 on success, else a cudaError_t (a
// refused launch, or a geometry outside what the kernels take).
extern "C" int fleetx_flash_fwd(const void* q, const void* k, const void* v,
                                void* out, float* lse, int bh, int sq, int sk,
                                int d, int causal, int dtype, float scale,
                                uint32_t seed_word, int local_heads, int total_heads,
    int batch_offset, int head_offset, uint32_t thresh, int dropout,
                                float keep_prob, int tc, void* stream) {
  if (!geometry_ok(bh, sq, sk, causal) || (tc != 0) != tc_route(dtype, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (local_heads < 1 || total_heads < local_heads || batch_offset < 0 ||
      head_offset < 0 || head_offset + local_heads > total_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const DropKey seed{seed_word, local_heads, total_heads, batch_offset,
                     head_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tc) {
    err = fwd_tc(q, k, v, out, lse, dtype, bh, sq, sk, d, causal, scale, seed,
                 thresh, dropout, keep_prob, st);
  } else if (dtype == 0) {
    err = fwd_by_dim<float>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                            seed, thresh, dropout, keep_prob, st);
  } else if (dtype == 1) {
    err = fwd_by_dim<__nv_bfloat16>(q, k, v, out, lse, bh, sq, sk, d, causal,
                                    scale, seed, thresh, dropout, keep_prob,
                                    st);
  } else if (dtype == 2) {
    err = fwd_by_dim<__half>(q, k, v, out, lse, bh, sq, sk, d, causal, scale,
                             seed, thresh, dropout, keep_prob, st);
  }
  return static_cast<int>(err);
}

extern "C" int fleetx_flash_bwd_fused(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      float* dq, void* dk, void* dv, int bh,
                                      int sq, int sk, int d, int causal,
                                      int dtype, float scale, uint32_t seed_word, int local_heads, int total_heads,
    int batch_offset, int head_offset,
                                      uint32_t thresh, int dropout, float inv,
                                      int tc, void* stream) {
  if (!geometry_ok(bh, sq, sk, causal) || (tc != 0) != tc_route(dtype, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (local_heads < 1 || total_heads < local_heads || batch_offset < 0 ||
      head_offset < 0 || head_offset + local_heads > total_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const DropKey seed{seed_word, local_heads, total_heads, batch_offset,
                     head_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tc) {
    err = bwd_tc(q, k, v, dout, lse, delta, dq, dk, dv, dtype, bh, sq, sk, d,
                 causal, scale, seed, thresh, dropout, inv, st);
  } else if (dtype == 0) {
    err = bwd_f32(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq, sk, d,
                  causal, scale, seed, thresh, dropout, inv, st);
  }
  return static_cast<int>(err);
}

// Split backward. dq [bh, sq, d] in the operand dtype; dk/dv [bh, sk, d] in
// the operand dtype. lse may be any logsumexp of the rows (the ring feeds
// the global one). keep_prob = 1 - rate (dq divides by it, as
// _bwd_dq_kernel does); inv = 1 / (1 - rate) (dk/dv multiply by it, as
// _bwd_dkv_kernel does).
extern "C" int fleetx_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int bh, int sq, int sk, int d,
                                   int causal, int dtype, float scale,
                                   uint32_t seed_word, int local_heads, int total_heads,
    int batch_offset, int head_offset, uint32_t thresh,
                                   int dropout, float keep_prob, int tc,
                                   void* stream) {
  if (!geometry_ok(bh, sq, sk, causal) || (tc != 0) != tc_route(dtype, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (local_heads < 1 || total_heads < local_heads || batch_offset < 0 ||
      head_offset < 0 || head_offset + local_heads > total_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const DropKey seed{seed_word, local_heads, total_heads, batch_offset,
                     head_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tc) {
    err = dq_tc(q, k, v, dout, lse, delta, dq, dtype, bh, sq, sk, d, causal,
                scale, seed, thresh, dropout, keep_prob, st);
  } else if (dtype == 0) {
    err = dq_by_dim<float>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                           causal, scale, seed, thresh, dropout, keep_prob,
                           st);
  } else if (dtype == 1) {
    err = dq_by_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, sq, sk,
                                   d, causal, scale, seed, thresh, dropout,
                                   keep_prob, st);
  } else if (dtype == 2) {
    err = dq_by_dim<__half>(q, k, v, dout, lse, delta, dq, bh, sq, sk, d,
                            causal, scale, seed, thresh, dropout, keep_prob,
                            st);
  }
  return static_cast<int>(err);
}

extern "C" int fleetx_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dk, void* dv, int bh, int sq,
                                    int sk, int d, int causal, int dtype,
                                    float scale, uint32_t seed_word, int local_heads, int total_heads,
    int batch_offset, int head_offset,
                                    uint32_t thresh, int dropout, float inv,
                                    int tc, void* stream) {
  if (!geometry_ok(bh, sq, sk, causal) || (tc != 0) != tc_route(dtype, d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (local_heads < 1 || total_heads < local_heads || batch_offset < 0 ||
      head_offset < 0 || head_offset + local_heads > total_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const DropKey seed{seed_word, local_heads, total_heads, batch_offset,
                     head_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (tc) {
    err = dkv_tc(q, k, v, dout, lse, delta, dk, dv, dtype, bh, sq, sk, d,
                 causal, scale, seed, thresh, dropout, inv, st);
  } else if (dtype == 0) {
    err = dkv_by_dim<float>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d,
                            causal, scale, seed, thresh, dropout, inv, st);
  } else if (dtype == 1) {
    err = dkv_by_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh,
                                    sq, sk, d, causal, scale, seed, thresh,
                                    dropout, inv, st);
  } else if (dtype == 2) {
    err = dkv_by_dim<__half>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, causal, scale, seed, thresh, dropout, inv,
                             st);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of a tensor-core kernel's launch at head_dim d (64
// or 128; else 0): kernel 0 = forward, 1 = fused backward, 2 = dq, 3 =
// dk/dv. ptxas -v reports only the static part.
extern "C" int fleetx_flash_tc_smem_bytes(int kernel, int d) {
  if (d != 64 && d != 128) return 0;
  const bool wide = d == 128;
  switch (kernel) {
    case 0:
      return static_cast<int>(wide ? TcFwdSmem<128>::kBytes
                                   : TcFwdSmem<64>::kBytes);
    case 1:
      return static_cast<int>(wide ? TcBwdSmem<128>::kBytes
                                   : TcBwdSmem<64>::kBytes);
    case 2:
      return static_cast<int>(wide ? TcDqSmem<128>::kBytes
                                   : TcDqSmem<64>::kBytes);
    case 3:
      return static_cast<int>(wide ? TcDkvSmem<128>::kBytes
                                   : TcDkvSmem<64>::kBytes);
    default:
      return 0;
  }
}
