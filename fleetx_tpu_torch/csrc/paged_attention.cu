// One-token paged decode attention for Hopper (sm_90a): a split page walk
// with bulk asynchronous page copies, one launch, deterministic.
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
//     never read outside the pool. A skipped page is never copied;
//   * lens[b] < 0 marks an inactive row: nothing is read, and the row
//     comes out m = -1e30, l = 0, acc = 0 (exact zeros after _normalize);
//   * positions > lens[b] are never folded in; q and k are cast to f32
//     before the dot, scores scale by 1/sqrt(hd), running m starts at
//     -1e30.
//
// What bounds it on the H100: device-memory bytes. Each active row must
// read its K and V rows once, sum_b (lens_b + 1) * nh * hd * 2 * itemsize
// bytes per layer; the arithmetic is 4 * hd flops per key, far below the
// card's ridge point, so there are no tensor cores here. The TPU kernel
// streams whole [ps, hb, hd] page tiles by DMA over a sequential (request,
// head block, page) grid; a block that walked one request's pages alone
// would make the longest request set the time, with little in flight.
//
// Design. The host planner (ops/paged_attention.py plan_split) picks a
// head block hb, rows per tile rb, pages per chunk ppc and a ring depth S
// from the static geometry (345M in bf16: hb 4, rb 16, ppc 8, S 2; 256
// threads and ~76 KB of shared memory a block, two blocks an SM).
//   1. Split. A block owns one work item -- ppc consecutive table entries
//      of one request -- and hb heads (the last head block may be
//      narrower: hb need not divide nh). The 1-D grid holds every possible
//      item; each block finds its own from a warp scan over lens, so the
//      items that exist are the first blocks and all start in the first
//      wave, and an inactive row has one item, which writes its empty
//      triple.
//   2. TMA into shared-memory rings. A tile is the K (or V) rows [rb
//      positions, hb heads, hd] of one page, one box of a 3-D tensor map
//      over the pool ([pages * ps, nh, hd]; heads past nh and rows past the
//      pool read as zeros). The block's two consumer groups of four warps
//      take alternate tiles of the chunk; thread 0 of each keeps S pages
//      (a K box and a V box each) in flight in the group's own ring, each
//      slot completing on its mbarrier (hopper.cuh, a wait that traps
//      instead of hanging). Skipped pages, and tiles that start past
//      lens[b], are never copied.
//   3. Fold in f32 from shared memory. A worker is the fewest lanes whose
//      16-byte vectors span a head row (8 for bf16 at hd 64); it owns one
//      head and every W-th row of its group's tiles, keeps its own running
//      (m, l, acc) in registers, and folds four rows at a time: their K and
//      V loads are all issued before the arithmetic, the scores use f32
//      FMAs on q and k cast to f32, and xor shuffles inside the worker sum
//      them. One group barrier a page frees its slot; the groups never
//      wait for each other until the end, where the workers of each head
//      merge in (group, worker) order.
//   4. Merge in the same launch, deterministically. A request whose
//      positions fit one chunk writes its triple directly. Otherwise each
//      chunk writes its partial (acc, m, l) into an f32 workspace, and the
//      last block of the (request, head block) to arrive -- it learns so
//      from an acquire-release atomicAdd on an arrival counter, and resets
//      the counter to 0 for the next call -- stages the partials into its
//      idle rings (every load in flight) and folds them in chunk order
//      with the flash-decoding rescale. Only the counter is atomic, so a
//      repeated call is bitwise identical.
// The workspace and counters belong to the caller (allocated once per
// device, stream and geometry); two launches on one workspace must not
// overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// Two consumer groups of four warps fold alternate pages of a chunk.
constexpr int kGroups = 2;
constexpr int kGroupThreads = 128;
constexpr int kThreads = kGroups * kGroupThreads;
constexpr float kNegInf = -1e30f;
// floats of a head row one lane holds: 1 bf16 vector of 8, or 2 f32
// vectors of 4 (head_dim 256 over 32 lanes)
constexpr int kLaneFloats = 8;
// rows a worker folds in at once (independent dot products in flight)
constexpr int kRowBatch = 4;
// head-block elements one thread merges: hb * hd <= (kThreads / group) *
// (kLaneFloats * group), so at most kLaneFloats
constexpr int kMergeElems = kLaneFloats;
constexpr int kMaxSlots = 8;
constexpr int kMaxChunkPages = kThreads;
constexpr int kMaxSmem = 232448;  // 227 KB a block may use on sm_90

struct Plan {
  int nh, hd, num_pages, ps, ppr;
  int hb, rb, ppc, slots, n_chunks, n_hblk;
  int batch;
  int n_parts;           // batch * n_hblk * n_chunks
  int group;             // lanes of a worker
  uint32_t tile_stride;  // bytes of one K or V tile (128-byte multiple)
  float scale;
};

// Lanes of a worker: the fewest (a power of two, at most 32) whose
// 16-byte vectors span a head row.
inline int group_lanes(int hd, int itemsize) {
  const int chunks = hd * itemsize / 16;
  int g = 1;
  while (g < 32 && g < chunks) g <<= 1;
  return g;
}

inline uint32_t tile_stride_bytes(int hb, int rb, int hd, int itemsize) {
  const uint32_t t = static_cast<uint32_t>(rb) * hb * hd * itemsize;
  return (t + 127u) & ~127u;
}

// Shared-memory layout (after up to 128 bytes of alignment): each group's
// `slots` ring slots of a K tile and a V tile, the workers' (m, l) and acc
// slices in f32, one mbarrier a slot, the block's work item, the chunk's
// table entries, a flag.
constexpr uint32_t kWorkerBytes = 4u * (2 * kThreads + kThreads * kLaneFloats);

inline uint32_t smem_bytes(int hb, int rb, int hd, int itemsize, int slots,
                           int ppc) {
  return 128u + kGroups * slots * 2 * tile_stride_bytes(hb, rb, hd, itemsize) +
         kWorkerBytes + 8u * kGroups * slots + 16u + 4u * ppc + 16u;
}

__device__ __forceinline__ uint8_t* align128(uint8_t* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + (((a + 127u) & ~127u) - a);
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

template <typename T>
struct Vec;

// 16 bytes of T as floats: `unpack` from a register copy, `load` from
// memory.
template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements in 16 bytes
  __device__ static void unpack(const uint4& r, float* out) {
    out[0] = __uint_as_float(r.x);
    out[1] = __uint_as_float(r.y);
    out[2] = __uint_as_float(r.z);
    out[3] = __uint_as_float(r.w);
  }
  __device__ static void load(const void* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  // a bf16 is the high half of the f32 with the same bits
  __device__ static void unpack(const uint4& r, float* out) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void load(const void* p, float* out) {
    unpack(*reinterpret_cast<const uint4*>(p), out);
  }
};

// One tile's worth of a chunk: rows [row, row + nrows) of a page, every
// one of them a position <= last.
struct Unit {
  int page, row, nrows;
};

// The chunk's walk: page slot `slot` of the chunk, next row `row`, units
// found so far.
struct Cursor {
  int slot = 0;
  int row = 0;
  int seen = 0;
};

// Advance `cur` to the next unit to fold in; false when the chunk is done.
// Every thread that calls it with the same cursor gets the same answer.
__device__ __forceinline__ bool next_unit(Cursor& cur, Unit& u,
                                          const int* pages, int n_slots,
                                          int page0, const Plan& p,
                                          int last) {
  while (cur.slot < n_slots) {
    const int base = (page0 + cur.slot) * p.ps;
    if (base > last) {
      cur.slot = n_slots;
      return false;
    }
    const int page = pages[cur.slot];
    const int rows = min(p.ps, last - base + 1);
    if (page < 0 || page >= p.num_pages || cur.row >= rows) {
      ++cur.slot;
      cur.row = 0;
      continue;
    }
    u.page = page;
    u.row = cur.row;
    u.nrows = min(p.rb, rows - cur.row);
    cur.row += p.rb;
    if (cur.row >= rows) {
      ++cur.slot;
      cur.row = 0;
    }
    return true;
  }
  return false;
}

// The next unit of group `gi`: the chunk's units alternate between the
// groups (unit k goes to group k % kGroups).
__device__ __forceinline__ bool next_own_unit(Cursor& cur, Unit& u,
                                              const int* pages, int n_slots,
                                              int page0, const Plan& p,
                                              int last, int gi) {
  while (next_unit(cur, u, pages, n_slots, page0, p, last))
    if (cur.seen++ % kGroups == gi) return true;
  return false;
}

// Blocks an SM must hold: the register cap (128) that lets two blocks
// share an SM.
constexpr int kMinBlocks = 2;

// The work item of block `item` (head blocks fastest, then the chunks of
// request 0 in order, then request 1's, ...): every request has
// max(n_active, 1) items, an inactive row's one writing its empty triple.
// Warp 0 scans lens; returns (b, c, lens[b]), b = -1 past the last item.
__device__ __forceinline__ int3 find_item(const int* __restrict__ lens,
                                          int item, const Plan& p,
                                          int lane) {
  const int span = p.ppc * p.ps;
  int carry = 0;
  for (int b0 = 0; b0 < p.batch; b0 += 32) {
    const int bb = b0 + lane;
    int n = 0;
    const int qp = bb < p.batch ? lens[bb] : -1;
    if (bb < p.batch)
      n = qp < 0 ? 1 : min(min(qp, p.ppr * p.ps - 1) / span + 1, p.n_chunks);
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    incl += carry;
    const int excl = incl - n;
    const unsigned hit = __ballot_sync(0xffffffffu, item >= excl && item < incl);
    if (hit != 0u) {
      const int src = __ffs(hit) - 1;
      return make_int3(b0 + src, item - __shfl_sync(0xffffffffu, excl, src),
                       __shfl_sync(0xffffffffu, qp, src));
    }
    carry = __shfl_sync(0xffffffffu, incl, 31);
  }
  return make_int3(-1, 0, -1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
paged_split_kernel(
    const T* __restrict__ q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ tables,
    const int* __restrict__ lens, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ ws, int* __restrict__ counters, const Plan p) {
  constexpr int V = Vec<T>::N;
  constexpr int kChunks = kLaneFloats / V;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  uint8_t* smem = align128(smem_raw);  // a TMA destination: 128-byte aligned
  uint8_t* ring = smem;
  const int ring_bytes = kGroups * p.slots * 2 * p.tile_stride;
  float* w_m = reinterpret_cast<float*>(smem + ring_bytes);
  float* w_l = w_m + kThreads;
  float* w_acc = w_l + kThreads;  // [workers, hd]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + ring_bytes + kWorkerBytes);
  int* item = reinterpret_cast<int*>(bars + kGroups * p.slots);  // b, c, lens
  int* pages = item + 4;
  int* flag = pages + p.ppc;

  // the descriptors load while warp 0 looks for the block's work item
  if (tid == 32) {
    hopper::prefetch_tensor_map(&tm_k);
    hopper::prefetch_tensor_map(&tm_v);
  }
  // the grid holds every possible item; the items that exist come first,
  // so the blocks that walk pages all start in the first wave
  const int hblk = blockIdx.x % p.n_hblk;
  if (tid < 32) {
    const int3 it = find_item(lens, blockIdx.x / p.n_hblk, p, lane);
    if (lane == 0) {
      item[0] = it.x;
      item[1] = it.y;
      item[2] = it.z;
    }
  }
  __syncthreads();
  const int b = item[0];
  const int c = item[1];
  const int q_pos = item[2];
  if (b < 0) return;  // past the last item
  const int hd = p.hd;
  const int h0 = hblk * p.hb;
  const int nhb = min(p.hb, p.nh - h0);  // heads of this block
  const size_t bh0 = static_cast<size_t>(b) * p.nh + h0;
  const int page0 = c * p.ppc;
  const int n_slots = min(p.ppc, p.ppr - page0);
  const int last = min(q_pos, p.ppr * p.ps - 1);
  const int n_active =
      q_pos < 0 ? 0 : min(last / (p.ppc * p.ps) + 1, p.n_chunks);

  if (n_active == 0) {  // inactive row: the empty triple
    for (int i = tid; i < nhb * hd; i += kThreads) acc_out[bh0 * hd + i] = 0.f;
    for (int j = tid; j < nhb; j += kThreads) {
      m_out[bh0 + j] = kNegInf;
      l_out[bh0 + j] = 0.f;
    }
    return;
  }

  if (tid < n_slots)
    pages[tid] = tables[static_cast<size_t>(b) * p.ppr + page0 + tid];
  if (tid == 0) {
    for (int s = 0; s < kGroups * p.slots; ++s) hopper::mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // ------------------------------------------------------------ producer
  // Thread 0 of each group copies the group's unit n into its slot n % S:
  // one TMA box of the unit's K rows and one of its V rows ([rb rows, hb
  // heads, hd] each, whatever the head block), both completing on the
  // slot's mbarrier.
  const int gi = tid / kGroupThreads;  // this thread's group
  const int gtid = tid - gi * kGroupThreads;
  uint8_t* gring = ring + gi * p.slots * 2 * p.tile_stride;
  uint64_t* gbars = bars + gi * p.slots;
  const uint32_t tile_bytes = static_cast<uint32_t>(p.rb) * p.hb * hd * sizeof(T);
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  Cursor pcur;
  auto produce = [&](int n) {
    Unit u;
    if (!next_own_unit(pcur, u, pages, n_slots, page0, p, last, gi)) return;
    const int slot = n % p.slots;
    uint8_t* dst = gring + 2 * slot * p.tile_stride;
    const int row = u.page * p.ps + u.row;
    hopper::mbar_expect_tx(&gbars[slot], 2 * tile_bytes);
    hopper::tma_load_3d(dst, map_k, &gbars[slot], 0, h0, row);
    hopper::tma_load_3d(dst + p.tile_stride, map_v, &gbars[slot], 0, h0, row);
  };
  if (gtid == 0)
    for (int n = 0; n < p.slots; ++n) produce(n);

  // ----------------------------------------------------------- consumers
  // A worker is `group` lanes owning one head j and the rows sub, sub + W,
  // ... of every tile its group folds; lane g holds head dims c * group *
  // V + g * V + [0, V) for c < kChunks. It keeps its own running (m, l,
  // acc).
  const int group = p.group;
  const int g = lane & (group - 1);
  const int worker = tid / group;
  const int group_workers = kGroupThreads / group;
  const int per_head = group_workers / p.hb;  // W
  const int j = (worker - gi * group_workers) / per_head;
  const int sub = worker - gi * group_workers - j * per_head;
  const bool working = j < nhb;
  const int span = group * V;
  // head-dim chunks a worker spans (uniform), this lane's element offset
  // in each (clamped into the head row; its q is 0 past head_dim), and the
  // tile head it reads (an idle worker reads head 0 and folds nothing)
  const int n_chunks = (hd + span - 1) / span;
  const int jt = working ? j : 0;
  int dl[kChunks];
  float qv[kLaneFloats];
  float acc[kLaneFloats];
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) {
    qv[i] = 0.f;
    acc[i] = 0.f;
  }
  const T* q_row = q + (bh0 + jt) * hd;
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int d = cc * span + g * V;
    dl[cc] = min(d, hd - V);
    if (working && d < hd) Vec<T>::load(q_row + d, qv + cc * V);
  }
  float m = kNegInf;
  float l = 0.f;
  const int row_elems = p.hb * hd;  // a tile row holds hb heads

  Cursor ccur;
  Unit u;
  int n = 0;
  while (next_own_unit(ccur, u, pages, n_slots, page0, p, last, gi)) {
    const int slot = n % p.slots;
    hopper::mbar_wait(&gbars[slot], (n / p.slots) & 1);
    const T* kt = reinterpret_cast<const T*>(gring + 2 * slot * p.tile_stride);
    const T* vt = reinterpret_cast<const T*>(gring + (2 * slot + 1) *
                                             p.tile_stride);
    // rows base + sub + i * W for i < kRowBatch. Every worker runs the
    // same iterations and issues the same loads (row and head indices
    // clamped into the tile; a lane past head_dim holds q = 0, a row past
    // the tile gets p = 0), so a batch's K and V loads are all in flight
    // before its arithmetic, the warp stays converged, and the xor
    // shuffles (offsets below `group`) stay inside the worker.
    for (int base = 0; base < u.nrows; base += per_head * kRowBatch) {
      uint4 kr[kRowBatch][kChunks];
      uint4 vr[kRowBatch][kChunks];
      bool valid[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const int r = base + sub + i * per_head;
        valid[i] = working && r < u.nrows;
        const int off = min(r, u.nrows - 1) * row_elems + jt * hd;
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
          if (cc < n_chunks) {
            kr[i][cc] = *reinterpret_cast<const uint4*>(kt + off + dl[cc]);
            vr[i][cc] = *reinterpret_cast<const uint4*>(vt + off + dl[cc]);
          }
        }
      }
      float s[kRowBatch];
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        s[i] = 0.f;
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
          if (cc < n_chunks) {
            float kv[V];
            Vec<T>::unpack(kr[i][cc], kv);
#pragma unroll
            for (int e = 0; e < V; ++e) s[i] += qv[cc * V + e] * kv[e];
          }
        }
      }
      for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kRowBatch; ++i)
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      }
      float m_new = m;
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        s[i] *= p.scale;
        if (valid[i]) m_new = fmaxf(m_new, s[i]);
      }
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < kLaneFloats; ++e) acc[e] *= alpha;
#pragma unroll
      for (int i = 0; i < kRowBatch; ++i) {
        const float pr = valid[i] ? expf(s[i] - m_new) : 0.f;
        l += pr;
#pragma unroll
        for (int cc = 0; cc < kChunks; ++cc) {
          if (cc < n_chunks) {
            float vv[V];
            Vec<T>::unpack(vr[i][cc], vv);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[cc * V + e] += pr * vv[e];
          }
        }
      }
      m = m_new;
    }
    hopper::named_barrier(1 + gi, kGroupThreads);  // slot n is free
    if (gtid == 0) produce(n + p.slots);
    ++n;
  }

  // ---------------------------------------- the chunk's triple per head
  // merge the W workers of each head in worker order: per head the
  // largest m, each worker's weight exp(m_w - m) in place of its m, and l;
  // then every element of acc
  if (g == 0) {
    w_m[worker] = m;
    w_l[worker] = l;
  }
#pragma unroll
  for (int cc = 0; cc < kChunks; ++cc) {
    const int d = cc * span + g * V;
    if (d < hd) {
#pragma unroll
      for (int e = 0; e < V; ++e) w_acc[worker * hd + d + e] = acc[cc * V + e];
    }
  }
  __syncthreads();
  const size_t part0 = static_cast<size_t>(b * p.n_hblk + hblk) * p.n_chunks;
  float* ws_acc = ws;
  float* ws_ml = ws + static_cast<size_t>(p.n_parts) * p.hb * hd;
  // the chunk's triple goes out directly when the request fits one chunk,
  // else into the workspace
  float* c_acc = n_active == 1 ? acc_out + bh0 * hd
                               : ws_acc + (part0 + c) * p.hb * hd;
  float* c_m = n_active == 1 ? m_out + bh0 : ws_ml + (part0 + c) * 2 * p.hb;
  float* c_l = n_active == 1 ? l_out + bh0 : c_m + p.hb;
  // head jj's workers: per_head of them in each group, in group order
  for (int jj = tid; jj < nhb; jj += kThreads) {
    float mx = kNegInf;
    for (int gg = 0; gg < kGroups; ++gg)
      for (int w = 0; w < per_head; ++w)
        mx = fmaxf(mx, w_m[gg * group_workers + jj * per_head + w]);
    float ll = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) {
      for (int w = 0; w < per_head; ++w) {
        const int wi = gg * group_workers + jj * per_head + w;
        w_m[wi] = expf(w_m[wi] - mx);
        ll += w_l[wi] * w_m[wi];
      }
    }
    c_m[jj] = mx;
    c_l[jj] = ll;
  }
  __syncthreads();
  for (int i = tid; i < nhb * hd; i += kThreads) {
    const int jj = i / hd;
    const int d = i - jj * hd;
    float a = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) {
      for (int w = 0; w < per_head; ++w) {
        const int wi = gg * group_workers + jj * per_head + w;
        a += w_acc[wi * hd + d] * w_m[wi];
      }
    }
    c_acc[i] = a;
  }
  if (n_active == 1) return;

  // ------------------------------------ the last chunk merges them all
  // The arrival is one acquire-release atomic after the barrier: it
  // publishes this block's partial (the barrier orders every thread's
  // stores before it) and, in the last block, makes every other block's
  // partial visible to the reads after the next barrier.
  __syncthreads();
  if (tid == 0) {
    int* counter = counters + b * p.n_hblk + hblk;
    const int arrived = atomic_add_acq_rel(counter, 1);
    const int is_last = arrived == n_active - 1;
    if (is_last) *counter = 0;  // ready for the next call
    *flag = is_last;
  }
  __syncthreads();
  if (!*flag) return;
  // chunks 0 .. n_active - 1 in order, whichever block arrived last, in
  // passes of as many partials as the idle ring holds. A pass stages its
  // partials into shared memory with every load in flight; then per head
  // the running max moves to the pass's, the old sums rescale, and l and
  // each acc element fold the pass's chunks in order.
  float* st_acc = reinterpret_cast<float*>(ring);
  const int ring_floats = ring_bytes / 4;
  const int group_chunks = ring_floats / (p.hb * hd + 2 * p.hb);
  float* run_m = w_m;  // per head: the running max
  float* run_l = w_l;  // per head: the running sum
  float* rescale = w_acc;  // per head: this pass's rescale of the old sums
  const float* ml0 = ws_ml + part0 * 2 * p.hb;
  const float* acc0 = ws_acc + part0 * p.hb * hd;
  for (int j2 = tid; j2 < nhb; j2 += kThreads) {
    run_m[j2] = kNegInf;
    run_l[j2] = 0.f;
  }
  float a[kMergeElems];
#pragma unroll
  for (int k = 0; k < kMergeElems; ++k) a[k] = 0.f;
  for (int c0 = 0; c0 < n_active; c0 += group_chunks) {
    const int nc = min(group_chunks, n_active - c0);
    float* st_ml = st_acc + nc * p.hb * hd;  // [nc][m (hb), l (hb)]
    __syncthreads();  // the previous pass is done with the stage
    const float4* src = reinterpret_cast<const float4*>(acc0 + c0 * p.hb * hd);
    float4* dst = reinterpret_cast<float4*>(st_acc);
#pragma unroll 4
    for (int v = tid; v < nc * p.hb * hd / 4; v += kThreads)
      dst[v] = __ldcg(src + v);
    for (int v = tid; v < nc * 2 * p.hb; v += kThreads)
      st_ml[v] = __ldcg(ml0 + c0 * 2 * p.hb + v);
    __syncthreads();
    float* new_m = rescale + p.hb;  // per head: the pass's running max
    for (int j2 = tid; j2 < nhb; j2 += kThreads) {
      float mx = run_m[j2];
      for (int cc = 0; cc < nc; ++cc) mx = fmaxf(mx, st_ml[cc * 2 * p.hb + j2]);
      new_m[j2] = mx;
      rescale[j2] = expf(run_m[j2] - mx);
    }
    __syncthreads();
    // each chunk's weight replaces its m, one (chunk, head) a thread
    for (int v = tid; v < nc * nhb; v += kThreads) {
      float* m_c = st_ml + (v / nhb) * 2 * p.hb + v % nhb;
      *m_c = expf(*m_c - new_m[v % nhb]);
    }
    __syncthreads();
    for (int j2 = tid; j2 < nhb; j2 += kThreads) {
      float ll = run_l[j2] * rescale[j2];
      for (int cc = 0; cc < nc; ++cc)
        ll += st_ml[cc * 2 * p.hb + p.hb + j2] * st_ml[cc * 2 * p.hb + j2];
      run_m[j2] = new_m[j2];
      run_l[j2] = ll;
    }
#pragma unroll
    for (int k = 0; k < kMergeElems; ++k) {
      const int i = tid + k * kThreads;
      if (i < nhb * hd) {
        const int jj = i / hd;
        float x = a[k] * rescale[jj];
        for (int cc = 0; cc < nc; ++cc)
          x += st_acc[cc * p.hb * hd + i] * st_ml[cc * 2 * p.hb + jj];
        a[k] = x;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMergeElems; ++k) {
    const int i = tid + k * kThreads;
    if (i < nhb * hd) acc_out[bh0 * hd + i] = a[k];
  }
  for (int j2 = tid; j2 < nhb; j2 += kThreads) {
    m_out[bh0 + j2] = run_m[j2];
    l_out[bh0 + j2] = run_l[j2];
  }
}

// Once per type: up to 227 KB of dynamic shared memory, and the SM's
// carveout all shared memory, so that several blocks fit an SM. The result
// is kept: a failure refuses every later launch too.
template <typename T>
cudaError_t configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_split_kernel<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  return err;
}

template <typename T>
cudaError_t launch(const void* q, const CUtensorMap& tm_k,
                   const CUtensorMap& tm_v, const int* tables,
                   const int* lens, float* acc, float* m, float* l,
                   float* ws, int* counters, const Plan& plan, uint32_t smem,
                   cudaStream_t stream) {
  const cudaError_t err = configure<T>();
  if (err != cudaSuccess) return err;
  const dim3 grid(plan.n_parts);
  paged_split_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), tm_k, tm_v, tables, lens, acc, m, l, ws,
      counters, plan);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for a plan (ops/paged_attention.py
// plan_split computes the same number; chip_smoke.py holds them equal).
extern "C" int fleetx_paged_smem_bytes(int head_block, int rows_per_tile,
                                       int hd, int itemsize, int slots,
                                       int pages_per_chunk) {
  return static_cast<int>(smem_bytes(head_block, rows_per_tile, hd, itemsize,
                                     slots, pages_per_chunk));
}

// C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// `workspace` holds batch * ceil(nh / head_block) * ceil(pages_per_req /
// pages_per_chunk) partials of head_block * (hd + 2) floats; `counters`
// batch * ceil(nh / head_block) ints, zero before the first call (the
// kernel leaves them zero). `slots`: pages (K and V tiles) in flight in
// each consumer group. Returns 0 on success, else a cudaError_t (the launch was refused
// or a shape or plan is outside what the kernel takes).
extern "C" int fleetx_paged_attention_decode(
    const void* q, const void* pool_k, const void* pool_v, const int* tables,
    const int* lens, float* acc, float* m, float* l, float* workspace,
    int* counters, int batch, int nh, int hd, int num_pages, int ps,
    int pages_per_req, int head_block, int rows_per_tile,
    int pages_per_chunk, int slots, int dtype, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || nh < 1 || hd < 8 || hd > 256 ||
      hd % 8 != 0 || ps < 1 || pages_per_req < 1 || num_pages < 1 ||
      (dtype != 0 && dtype != 1) || head_block < 1 || head_block > nh ||
      rows_per_tile < 1 || rows_per_tile > ps || pages_per_chunk < 1 ||
      pages_per_chunk > kMaxChunkPages || slots < 1 || slots > kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int itemsize = dtype == 1 ? 2 : 4;
  const int group = group_lanes(hd, itemsize);
  const uint32_t smem = smem_bytes(head_block, rows_per_tile, hd, itemsize,
                                   slots, pages_per_chunk);
  const int n_hblk = (nh + head_block - 1) / head_block;
  const int n_chunks = (pages_per_req + pages_per_chunk - 1) / pages_per_chunk;
  // every head of a block needs a worker in each group; a TMA box
  // dimension is at most 256; a pool row index and the grid fit an int
  if (head_block > kGroupThreads / group || rows_per_tile > 256 ||
      smem > static_cast<uint32_t>(kMaxSmem) ||
      static_cast<int64_t>(num_pages) * ps > 2147483647LL ||
      static_cast<int64_t>(batch) * n_hblk * n_chunks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_k, tm_v;
  const uint64_t rows = static_cast<uint64_t>(num_pages) * ps;
  if (!hopper::make_rows_map(&tm_k, pool_k, dtype, rows, nh, hd,
                             rows_per_tile, head_block) ||
      !hopper::make_rows_map(&tm_v, pool_v, dtype, rows, nh, hd,
                             rows_per_tile, head_block))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  plan.nh = nh;
  plan.hd = hd;
  plan.num_pages = num_pages;
  plan.ps = ps;
  plan.ppr = pages_per_req;
  plan.hb = head_block;
  plan.rb = rows_per_tile;
  plan.ppc = pages_per_chunk;
  plan.slots = slots;
  plan.n_chunks = n_chunks;
  plan.n_hblk = n_hblk;
  plan.batch = batch;
  plan.n_parts = batch * n_hblk * plan.n_chunks;
  plan.group = group;
  plan.tile_stride = tile_stride_bytes(head_block, rows_per_tile, hd, itemsize);
  plan.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0
          ? launch<float>(q, tm_k, tm_v, tables, lens, acc, m, l, workspace,
                          counters, plan, smem, s)
          : launch<__nv_bfloat16>(q, tm_k, tm_v, tables, lens, acc, m, l,
                                  workspace, counters, plan, smem, s);
  return static_cast<int>(err);
}
