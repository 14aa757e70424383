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
//
// Design: one block per row. The row is held in registers, E values a
// thread (E = 8 up to hidden 8192, 32 up to 32768), loaded and stored as
// 16-byte vectors of 8 values: chunk c of thread t covers values
// [(c * NT + t) * 8, +8) with NT = hidden / E active threads, so a warp's
// loads are contiguous. Block reductions (f32) go through warp shuffles
// and one shared-memory slot per warp. The row is read once and written
// once; no shared-memory staging. Left for later work: several rows per
// block for narrow rows, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// C interface, loaded with ctypes. dtype codes: 0 = float32, 1 = bfloat16,
// 2 = float16. The forward takes out_dtype equal to dtype, or float32.
// r and s are null together when there is no residual. Returns 0 on
// success, else a cudaError_t (a refused launch or a shape/dtype outside
// what the kernel takes).
extern "C" int fleetx_fused_norm_fwd(const void* x, const void* r,
                                     const float* scale, const float* bias,
                                     void* out, void* s, float* mean,
                                     float* var, int rows, int hidden,
                                     int dtype, int out_dtype, float eps,
                                     void* stream) {
  if (!shape_ok(rows, hidden) || (r == nullptr) != (s == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && out_dtype == 0) {
    err = fwd_by_width<float, float>(x, r, scale, bias, out, s, mean, var,
                                     rows, hidden, eps, st);
  } else if (dtype == 1 && out_dtype == 1) {
    err = fwd_by_width<__nv_bfloat16, __nv_bfloat16>(
        x, r, scale, bias, out, s, mean, var, rows, hidden, eps, st);
  } else if (dtype == 1 && out_dtype == 0) {
    err = fwd_by_width<__nv_bfloat16, float>(x, r, scale, bias, out, s, mean,
                                             var, rows, hidden, eps, st);
  } else if (dtype == 2 && out_dtype == 2) {
    err = fwd_by_width<__half, __half>(x, r, scale, bias, out, s, mean, var,
                                       rows, hidden, eps, st);
  } else if (dtype == 2 && out_dtype == 0) {
    err = fwd_by_width<__half, float>(x, r, scale, bias, out, s, mean, var,
                                      rows, hidden, eps, st);
  }
  return static_cast<int>(err);
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
