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
// kept when bits >= rate * 2^32 (the threshold _dropout_mask uses). The
// same words come out whatever the tiling, so forward and backward agree,
// and ops/flash_attention.py:dropout_bits computes them bit for bit.
//
// What bounds it on the H100: operations. At the GPT-345M training shape
// (128 heads, seq 1024, head_dim 64) the causal forward does ~17 GFLOP on
// ~67 MB and the backward ~43 GFLOP on ~135 MB: far above the ridge
// point. This first version keeps every product in f32 (bf16 x bf16 is
// exact in f32, so it computes what the TPU kernel's f32 casts compute, up
// to summation order) on the SIMT cores, whose peak is 67 TFLOP/s, not
// the tensor cores' 989; wgmma/TMA are later work.
//
// Design.
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
//   128 blocks at the 345M shape: one wave on 132 SMs.
//   Split backward: the TPU kernels carry their dq (resp. dk/dv)
//   accumulator across a sequential grid dimension; here that dimension is
//   a loop inside one block. dq: one block per (q tile, head) walking the k
//   tiles up to the diagonal; dk/dv: one block per (k tile, head) walking
//   the q tiles from the diagonal down. Each recomputes S and dP for its
//   tiles (the price of the split: 3 and 4 products where the fused kernel
//   does 5 for both) and keeps its accumulators in registers, written once:
//   deterministic, no atomics. At the GPT-1.3B seq-8192 shape
//   ([32, 8192, 128] causal) that is 4096 blocks each, many waves; bound by
//   operations (~0.83 ms and ~1.11 ms at the bf16 tensor rate), run here on
//   the SIMT cores in f32 like the kernels above.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t head_key(uint32_t seed, uint32_t bh) {
  return mix32(seed ^ mix32(bh ^ 0x85ebca6bu));
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
    float scale, uint32_t seed, uint32_t thresh, int dropout,
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
    float scale, uint32_t seed, uint32_t thresh, int dropout, float inv) {
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
    int causal, float scale, uint32_t seed, uint32_t thresh, int dropout,
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
    int sq, int sk, int causal, float scale, uint32_t seed, uint32_t thresh,
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

template <typename T, int D, int BQ>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int sq, int sk,
                       int causal, float scale, uint32_t seed,
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
                       uint32_t seed, uint32_t thresh, int dropout, float inv,
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
                      float scale, uint32_t seed, uint32_t thresh,
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
                       int sk, int causal, float scale, uint32_t seed,
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
template <typename T>
cudaError_t dq_by_dim(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int bh, int sq, int sk, int d, int causal,
                      float scale, uint32_t seed, uint32_t thresh,
                      int dropout, float keep_prob, cudaStream_t st) {
  switch (d) {
    case 64:
      return launch_dq<T, 64, 64, 64>(q, k, v, dout, lse, delta, dq, bh, sq,
                                      sk, causal, scale, seed, thresh,
                                      dropout, keep_prob, st);
    case 128:
      return launch_dq<T, 128, 64, 64>(q, k, v, dout, lse, delta, dq, bh, sq,
                                       sk, causal, scale, seed, thresh,
                                       dropout, keep_prob, st);
    case 256:
      return launch_dq<T, 256, 32, 32>(q, k, v, dout, lse, delta, dq, bh, sq,
                                       sk, causal, scale, seed, thresh,
                                       dropout, keep_prob, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dkv_by_dim(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, void* dk, void* dv, int bh, int sq,
                       int sk, int d, int causal, float scale, uint32_t seed,
                       uint32_t thresh, int dropout, float inv,
                       cudaStream_t st) {
  switch (d) {
    case 64:
      return launch_dkv<T, 64, 64, 64>(q, k, v, dout, lse, delta, dk, dv, bh,
                                       sq, sk, causal, scale, seed, thresh,
                                       dropout, inv, st);
    case 128:
      return launch_dkv<T, 128, 32, 64>(q, k, v, dout, lse, delta, dk, dv,
                                        bh, sq, sk, causal, scale, seed,
                                        thresh, dropout, inv, st);
    case 256:
      return launch_dkv<T, 256, 32, 32>(q, k, v, dout, lse, delta, dk, dv,
                                        bh, sq, sk, causal, scale, seed,
                                        thresh, dropout, inv, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t fwd_by_dim(const void* q, const void* k, const void* v,
                       void* out, float* lse, int bh, int sq, int sk, int d,
                       int causal, float scale, uint32_t seed,
                       uint32_t thresh, int dropout, float keep_prob,
                       cudaStream_t st) {
  switch (d) {
    case 64:
      return launch_fwd<T, 64, 64>(q, k, v, out, lse, bh, sq, sk, causal,
                                   scale, seed, thresh, dropout, keep_prob,
                                   st);
    case 128:
      return launch_fwd<T, 128, 64>(q, k, v, out, lse, bh, sq, sk, causal,
                                    scale, seed, thresh, dropout, keep_prob,
                                    st);
    case 256:
      return launch_fwd<T, 256, 32>(q, k, v, out, lse, bh, sq, sk, causal,
                                    scale, seed, thresh, dropout, keep_prob,
                                    st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_by_dim(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, float* dq, void* dk, void* dv,
                       int bh, int sq, int sk, int d, int causal, float scale,
                       uint32_t seed, uint32_t thresh, int dropout, float inv,
                       cudaStream_t st) {
  switch (d) {
    case 64:
      return launch_bwd<T, 64, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh,
                                   sq, sk, causal, scale, seed, thresh,
                                   dropout, inv, st);
    case 128:
      return launch_bwd<T, 128, 32>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    bh, sq, sk, causal, scale, seed, thresh,
                                    dropout, inv, st);
    default:
      return cudaErrorInvalidValue;
  }
}

bool geometry_ok(int bh, int sq, int sk, int causal) {
  return bh >= 1 && bh <= 65535 && sq >= 128 && sq % 128 == 0 && sk >= 128 &&
         sk % 128 == 0 && (!causal || sq == sk);
}

}  // namespace

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16,
// 2 = float16. q/k/v/out/dout are [bh, seq, d] contiguous; lse/delta
// [bh, sq] f32; dq [bh, sq, d] f32. dropout != 0 keeps an element when its
// hash word is >= thresh. Returns 0 on success, else a cudaError_t (a
// refused launch, or a geometry outside what the kernels take).
extern "C" int fleetx_flash_fwd(const void* q, const void* k, const void* v,
                                void* out, float* lse, int bh, int sq, int sk,
                                int d, int causal, int dtype, float scale,
                                uint32_t seed, uint32_t thresh, int dropout,
                                float keep_prob, void* stream) {
  if (!geometry_ok(bh, sq, sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
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
                                      int dtype, float scale, uint32_t seed,
                                      uint32_t thresh, int dropout, float inv,
                                      void* stream) {
  if (!geometry_ok(bh, sq, sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = bwd_by_dim<float>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq,
                            sk, d, causal, scale, seed, thresh, dropout, inv,
                            st);
  } else if (dtype == 1) {
    err = bwd_by_dim<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv,
                                    bh, sq, sk, d, causal, scale, seed,
                                    thresh, dropout, inv, st);
  } else if (dtype == 2) {
    err = bwd_by_dim<__half>(q, k, v, dout, lse, delta, dq, dk, dv, bh, sq,
                             sk, d, causal, scale, seed, thresh, dropout,
                             inv, st);
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
                                   uint32_t seed, uint32_t thresh,
                                   int dropout, float keep_prob,
                                   void* stream) {
  if (!geometry_ok(bh, sq, sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
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
                                    float scale, uint32_t seed,
                                    uint32_t thresh, int dropout, float inv,
                                    void* stream) {
  if (!geometry_ok(bh, sq, sk, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
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
