// Absorbed MLA (multi-head latent attention) for Hopper (sm_90a): the
// port's latent decode kernel.
//
// Replaces the jnp einsums of the reference's `mla_decode_attention`
// (src/repro/models/attention.py, DeepSeek-V3's absorbed decode); the
// reference has no Pallas kernel for it. Same function: H query heads
// attend to ONE latent stream. Query i of request b is q_lat [H, R]
// (q_nope with wk_b absorbed, float32) beside q_rope [H, RR]; key t is
// ckv[b, t] [R] beside k_rope[b, t] [RR], and the value is ckv[b, t]
// itself. Scores s = (q_lat . ckv + q_rope . k_rope) * scale, softmax and
// o_lat = P ckv all in float32, as the reference keeps them (its q_lat is
// float32 and it upcasts the cache). Key t is valid for query i iff
// 0 <= p_t <= q_pos[b, i] and, with window > 0, p_t > q_pos[b, i] - window,
// where p_t = k_pos[b, t] when k_pos is given (a windowed ring cache's
// slot_pos), else t. An invalid key inside the visited range scores the
// -1e30 sentinel, as the reference's jnp.where does; a query with no valid
// key visits all L keys and so returns the mean of ckv, as the reference.
//
// Two routes, one function. The tensor-core route takes the bf16 cache at
// deepseek-v3's widths (R = 512, RR = 64), the serving path's; the float32
// cache and the smoke widths (R = 32, RR = 16) take the FMA route, kept so
// that the card = CPU checks hold in float32 (mla_attention_route says
// which).
//
// What bounds it. Per query and key the H heads do 2 * H * (R + RR + R)
// operations on (R + RR) cache elements: 2 * 128 * 1088 = 278,528 per
// 1,152 bf16 bytes of a 576-wide latent row, 242 per byte. In float32 FMAs
// (67 TFLOP/s, 20 per byte of 3.35 TB/s) that bounds the one-query decode
// at batch 4 over 1104 rows by operations: 1.23 GFLOP, 0.018 ms, against
// 7.3 MB, 0.0022 ms. The bf16 tensor cores (989 TFLOP/s, 295 per byte)
// bring the operations under the bytes' line, but the reference keeps
// q_lat and P in float32, and one bf16 rounding of either misses the
// kernel's bar (1e-4 of the largest output) by 20-100x, TF32 by 2-12x
// (tests/test_torch_mla_split.py). So each is split into a bf16 high part
// and a bf16 remainder, x = hi + lo to 2^-16, and each product runs twice:
// S = q_hi K^T + q_lo K^T and O = P_hi V + P_lo V (the cache is bf16, so
// K and V enter exactly; sums are float32). The function's bound stays
// max(bytes, its own operations at the bf16 rate): 0.0022 ms one-query, by
// bytes. The split's doubled products, 2.5 GFLOP, 0.0025 ms, are the
// design's own floor above it.
//
// Tensor-core route (one kernel, plus the merge below when a row tile's
// keys are split over CTAs). Grid (splits, row tiles, B): a CTA owns 64
// rows (query i, head h) of one request, row i * H + h (one-query decode
// at H = 128 is 2 row tiles a request, the S = 5 verify 10; each row masks
// by its own query's q_pos), and the keys [s * split, (s + 1) * split) of
// the range those rows can see. 384 threads, three warpgroups:
//  - one thread of warpgroup 2 issues TMA loads of key tiles of 32 rows
//    into a ring of 2 stages under mbarriers: 3-d tensor maps over ckv
//    [B, L, 512] and k_rope [B, L, 64], nine 64-column boxes with the
//    128-byte swizzle per tile (36 KB), rows past L zero-filled;
//  - warpgroups 0 and 1 first write q_hi and q_lo of the 64 rows (float32
//    q_lat | q_rope from global memory, split in registers) into shared
//    memory in the swizzled layout the TMA would give;
//  - warpgroup 0 computes S (72 m64n32k16 wgmmas, both operands in shared
//    memory, K-major; q_hi K^T and q_lo K^T in two interleaved
//    accumulators, added in float32), runs the online softmax on the
//    accumulators (quad shuffles; base 2 on the special-function unit;
//    -inf past the split, the -1e30 sentinel for an invalid key inside
//    it), splits P and hands P_hi / P_lo (its A fragments) and the rescale
//    factors to warpgroup 1 through 9 KB of shared memory under two named
//    barriers;
//  - the O accumulator, 64 x 512 float32, is 256 registers a thread for
//    one warpgroup, so warpgroups 0 and 1 own 256 of the output columns
//    each (128 registers) and issue O += P_hi V + P_lo V for them
//    (m64n256k16, A from registers, V = the tile's ckv boxes read
//    MN-major). Warpgroup 0 issues S of tile i behind its P V of tile
//    i - 1. With O, S and P warpgroup 0 needs ~190 registers a thread:
//    warpgroup 2 gives its registers to the other two (setmaxnreg 24 /
//    240), else ptxas serialises the wgmmas.
// Shared memory: q_hi + q_lo 144 KB, 2 stages of 32 keys 72 KB, the P
// exchange 9 KB: 226 KB of the 227 KB a CTA may have (64-key stages do not
// fit beside both halves of q), so one CTA a SM. The wrapper picks the
// split count from the grid (tc_split in kernels/mla_attention.py): row
// tiles x splits about the SMs, at least one key tile a split; with one
// split the CTA writes O / l itself and no partial exists.
//
// FMA route (float32 cache, smoke widths), split-KV as the paged kernel.
// Two kernels, launched back to back by the one C entry:
//  1. Grid (splits, head tiles, B * Sq). A CTA of 256 threads takes one
//     query (b, i), a tile of HT = 16 heads and the keys
//     [s * split, (s + 1) * split) that the query can see. Its q rows
//     (16 x 576 float32, 36 KB) sit in shared memory; latent rows arrive
//     by 16-byte cp.async in tiles of BK = 32 keys, two tiles in flight,
//     in the cache's dtype (each row padded by 16 bytes, so the score loop's
//     two rows a half-warp reads fall in distinct banks). Per tile:
//       - scores: each thread owns 4 heads x 4 keys over one eighth of the
//         576 columns (float4 pieces interleaved, so 8 lanes read 128
//         consecutive bytes), 16 FMAs per 8 shared loads, reduced over the
//         8 lanes of a column group with shuffles;
//       - online softmax: a warp per 2 heads, a lane per key (running max,
//         sum and the rescale factor of each head in shared memory);
//       - P ckv: each thread owns 4 heads x 8 of the 512 latent columns
//         (32 float32 accumulators in registers) and reads the tile's ckv
//         rows as float4, broadcasting P.
//     The CTA writes its split's partial (m, l, acc[16, R]) to float32
//     scratch; a split the query cannot see writes m = -inf, l = 0.
//  2. Grid (B * Sq * H). One CTA per output row merges the partials:
//     o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s, M = max_s m_s,
//     skipping the empty splits.
// `split` is the wrapper's constant (128 keys: at batch 4, one query and
// 128 heads over 1104 rows that is 9 x 8 x 4 = 288 CTAs, two per SM).
// Sq >= 1 serves decode (Sq = 1) and the per-row-start verify
// (Sq = gamma + 1, each query its own q_pos); a verify's queries each read
// the split's rows once, and share them through L2.
//
// Instantiated for (R, RR) = (32, 16) (the smoke config) in both cache
// dtypes and (512, 64) (deepseek-v3-671b) with a float32 cache on the FMA
// route, and (512, 64) with a bf16 cache on the tensor-core route; anything
// else is refused (cudaErrorInvalidValue).

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HT = 16;  // heads per CTA
constexpr int BK = 32;  // keys per shared-memory tile

template <typename T, int R, int RR>
struct Layout {
  static constexpr int DK = R + RR;                    // key width
  static constexpr int VEC = 16 / (int)sizeof(T);      // elements per piece
  static constexpr int PIECES_CKV = R / VEC;           // 16-byte pieces
  static constexpr int PIECES = DK / VEC;
  static constexpr int ROW = DK + VEC;                 // padded row (elements)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = repro::align128(sizeof(float) * HT * DK);
  static constexpr size_t s_off =
      k_off + repro::align128(sizeof(T) * 2 * BK * ROW);
  static constexpr size_t st_off = s_off + sizeof(float) * HT * BK;
  static constexpr size_t bytes = st_off + sizeof(float) * 3 * HT;
  static_assert(R % VEC == 0 && RR % VEC == 0, "rows are 16-byte pieces");
  static_assert(R % 4 == 0 && RR % 4 == 0, "float4 columns");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
// a 16-byte cp.async that writes zeros (reads nothing)
__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, c.x, c.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int R, int RR>
__global__ void __launch_bounds__(THREADS)
    mla_split_kernel(const float* __restrict__ q_lat,
                     const float* __restrict__ q_rope,
                     const T* __restrict__ ckv, const T* __restrict__ k_rope,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos, int window,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int Sq, int H, int L,
                     int split, float scale) {
  using Lay = Layout<T, R, RR>;
  constexpr int DK = Lay::DK, ROW = Lay::ROW, VEC = Lay::VEC;
  constexpr int C4 = R / 4;                  // float4 columns of a latent row
  constexpr int NJ = (C4 + 63) / 64;         // of them per thread in P ckv
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + Lay::q_off);
  T* Ks = reinterpret_cast<T*>(smem + Lay::k_off);
  float* S = reinterpret_cast<float*>(smem + Lay::s_off);
  float* m_s = reinterpret_cast<float*>(smem + Lay::st_off);
  float* l_s = m_s + HT;
  float* corr_s = l_s + HT;

  const int s = blockIdx.x, h0 = blockIdx.y * HT, bi = blockIdx.z;
  const int b = bi / Sq, n_split = gridDim.x, tid = threadIdx.x;
  const int qp = q_pos[bi];
  // the keys this query visits: [lo, hi), or all L when none is valid
  int lo = 0, hi = L;
  if (k_pos == nullptr) {
    hi = qp < 0 ? 0 : min(L, qp + 1);
    lo = window > 0 ? max(0, qp - window + 1) : 0;
  }
  if (lo >= hi) lo = 0, hi = L;
  const int start = max(lo, s * split), end = min(hi, (s + 1) * split);
  const size_t row0 = (size_t)bi * H + h0;  // output row of head h0

  if (start >= end) {  // nothing to see in this split
    if (tid < HT && h0 + tid < H) {
      part_ml[((row0 + tid) * n_split + s) * 2] = -INFINITY;
      part_ml[((row0 + tid) * n_split + s) * 2 + 1] = 0.0f;
    }
    return;
  }

  const T* ckv_b = ckv + (size_t)b * L * R;
  const T* kr_b = k_rope + (size_t)b * L * RR;
  const int n_tiles = (end - start + BK - 1) / BK;
  auto issue = [&](int tile) {
    const int t0 = start + tile * BK;
    T* dst = Ks + (tile & 1) * BK * ROW;
    for (int idx = tid; idx < BK * Lay::PIECES; idx += THREADS) {
      const int r = idx / Lay::PIECES, pc = idx % Lay::PIECES, t = t0 + r;
      T* d = dst + r * ROW + pc * VEC;
      if (t < end)
        cp_async16(d, pc < Lay::PIECES_CKV
                          ? ckv_b + (size_t)t * R + pc * VEC
                          : kr_b + (size_t)t * RR + (pc - Lay::PIECES_CKV) * VEC);
      else
        cp_async16_zero(d, ckv_b);  // rows past the split stay finite
    }
    cp_async_commit();
  };
  issue(0);

  // q rows of the tile's heads (zeros past H), while the first tile flies
  for (int idx = tid; idx < HT * (DK / 4); idx += THREADS) {
    const int hh = idx / (DK / 4), c = idx % (DK / 4), h = h0 + hh;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (h < H)
      v = c < C4 ? *reinterpret_cast<const float4*>(
                       q_lat + ((size_t)bi * H + h) * R + 4 * c)
                 : *reinterpret_cast<const float4*>(
                       q_rope + ((size_t)bi * H + h) * RR + 4 * (c - C4));
    *reinterpret_cast<float4*>(Qs + hh * DK + 4 * c) = v;
  }
  if (tid < HT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }

  // P ckv ownership: heads 4 hg .. 4 hg + 3, float4 columns rg + 64 j
  const int hg = tid >> 6, rg = tid & 63;
  float acc[4][NJ][4];
#pragma unroll
  for (int hh = 0; hh < 4; ++hh)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[hh][j][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait_1();  // tile it has landed (it + 1 may still fly)
    } else {
      cp_async_wait_0();
    }
    __syncthreads();
    const T* Kt = Ks + (it & 1) * BK * ROW;
    const int t0 = start + it * BK, nk = min(BK, end - t0);

    {  // scores: heads 4 hq.., keys 4 kq.., float4 columns ds, ds + 8, ...
      const int ds = tid & 7, kq = (tid >> 3) & 7, hq = tid >> 6;
      float sacc[4][4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) sacc[hh][kk] = 0.0f;
#pragma unroll 2
      for (int c = ds; c < DK / 4; c += 8) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
          qv[hh] = *reinterpret_cast<const float4*>(Qs + (4 * hq + hh) * DK +
                                                    4 * c);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          kv[kk] = load4<T>(Kt + (4 * kq + kk) * ROW + 4 * c);
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            sacc[hh][kk] = dot4(qv[hh], kv[kk], sacc[hh][kk]);
      }
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float v = sacc[hh][kk];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          sacc[hh][kk] = v;
        }
      if (ds == 0)
#pragma unroll
        for (int hh = 0; hh < 4; ++hh)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            S[(4 * hq + hh) * BK + 4 * kq + kk] = sacc[hh][kk] * scale;
    }
    __syncthreads();

    {  // online softmax: warp w owns heads 2w, 2w + 1; lane = key
      const int warp = tid >> 5, lane = tid & 31, t = t0 + lane;
      const bool in = lane < nk;
      bool valid = false;
      if (in) {
        const int p_t = k_pos != nullptr ? k_pos[(size_t)b * L + t] : t;
        valid = p_t >= 0 && p_t <= qp && (window <= 0 || p_t > qp - window);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = 2 * warp + rr;
        // lane 0 is always in: m_new is finite
        const float sv = in ? (valid ? S[row * BK + lane] : repro::kNegBig)
                            : -INFINITY;
        const float m_old = m_s[row];
        const float m_new = fmaxf(m_old, repro::warp_max(sv));
        const float p = in ? expf(sv - m_new) : 0.0f;
        const float sum = repro::warp_sum(p);
        S[row * BK + lane] = p;
        __syncwarp();
        if (lane == 0) {
          const float corr = m_old == -INFINITY ? 0.0f : expf(m_old - m_new);
          corr_s[row] = corr;
          l_s[row] = l_s[row] * corr + sum;
          m_s[row] = m_new;
        }
      }
    }
    __syncthreads();

    {  // acc = acc * corr + P ckv over the tile's keys
      float corr[4];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) corr[hh] = corr_s[4 * hg + hh];
#pragma unroll
      for (int hh = 0; hh < 4; ++hh)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[hh][j][e] *= corr[hh];
      for (int t = 0; t < nk; ++t) {
        float p[4];
#pragma unroll
        for (int hh = 0; hh < 4; ++hh) p[hh] = S[(4 * hg + hh) * BK + t];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = rg + 64 * j;
          if (c < C4) {
            const float4 kv = load4<T>(Kt + t * ROW + 4 * c);
#pragma unroll
            for (int hh = 0; hh < 4; ++hh) {
              acc[hh][j][0] = fmaf(p[hh], kv.x, acc[hh][j][0]);
              acc[hh][j][1] = fmaf(p[hh], kv.y, acc[hh][j][1]);
              acc[hh][j][2] = fmaf(p[hh], kv.z, acc[hh][j][2]);
              acc[hh][j][3] = fmaf(p[hh], kv.w, acc[hh][j][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the tile's buffer and S are free again
  }

#pragma unroll
  for (int hh = 0; hh < 4; ++hh) {
    if (h0 + 4 * hg + hh >= H) continue;
    float* dst = part_acc + ((row0 + 4 * hg + hh) * n_split + s) * R;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = rg + 64 * j;
      if (c < C4)
        *reinterpret_cast<float4*>(dst + 4 * c) = make_float4(
            acc[hh][j][0], acc[hh][j][1], acc[hh][j][2], acc[hh][j][3]);
    }
  }
  if (tid < HT && h0 + tid < H) {
    part_ml[((row0 + tid) * n_split + s) * 2] = m_s[tid];
    part_ml[((row0 + tid) * n_split + s) * 2 + 1] = l_s[tid];
  }
}

constexpr int MERGE_THREADS = 128;

// One CTA per output row (b, i, h): merge the splits' partials.
__global__ void __launch_bounds__(MERGE_THREADS)
    mla_merge_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     float* __restrict__ out, int n_split, int R) {
  extern __shared__ float w_s[];  // one weight per split
  __shared__ float den_s;
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * n_split * 2;
  float M = -INFINITY;
  for (int s = 0; s < n_split; ++s) M = fmaxf(M, ml[2 * s]);
  for (int s = threadIdx.x; s < n_split; s += MERGE_THREADS)
    w_s[s] = ml[2 * s] == -INFINITY ? 0.0f : expf(ml[2 * s] - M);
  __syncthreads();
  if (threadIdx.x == 0) {
    float den = 0.0f;
    for (int s = 0; s < n_split; ++s)
      if (ml[2 * s] != -INFINITY) den += w_s[s] * ml[2 * s + 1];
    den_s = fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const float* acc = part_acc + row * n_split * R;
  for (int c = threadIdx.x; c < R / 4; c += MERGE_THREADS) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_split; ++s) {
      if (ml[2 * s] == -INFINITY) continue;  // its acc was never written
      const float4 a = *reinterpret_cast<const float4*>(acc + (size_t)s * R +
                                                        4 * c);
      const float w = w_s[s];
      o.x = fmaf(w, a.x, o.x);
      o.y = fmaf(w, a.y, o.y);
      o.z = fmaf(w, a.z, o.z);
      o.w = fmaf(w, a.w, o.w);
    }
    const float inv = 1.0f / den_s;
    *reinterpret_cast<float4*>(out + row * R + 4 * c) =
        make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

template <typename T, int R, int RR>
cudaError_t launch(const float* q_lat, const float* q_rope, const void* ckv,
                   const void* k_rope, const int* q_pos, const int* k_pos,
                   int window, float* out, float* part_acc, float* part_ml,
                   int B, int Sq, int H, int L, int split, float scale,
                   cudaStream_t stream) {
  const size_t smem = Layout<T, R, RR>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mla_split_kernel<T, R, RR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_split = (L + split - 1) / split;
  const dim3 grid(n_split, (H + HT - 1) / HT, B * Sq);
  mla_split_kernel<T, R, RR><<<grid, THREADS, smem, stream>>>(
      q_lat, q_rope, static_cast<const T*>(ckv), static_cast<const T*>(k_rope),
      q_pos, k_pos, window, part_acc, part_ml, Sq, H, L, split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_merge_kernel<<<B * Sq * H, MERGE_THREADS, n_split * sizeof(float),
                     stream>>>(part_acc, part_ml, out, n_split, R);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 cache at deepseek-v3's widths: TMA + split-bf16 wgmma
// ---------------------------------------------------------------------------

namespace tc {

using namespace repro::sm90;

constexpr int R = 512, RR = 64, DK = R + RR;  // latent, rope and key width
constexpr int BM = 64;                        // rows (query, head) per CTA
constexpr int BN = 32;                        // keys per stage
constexpr int STAGES = 2;
constexpr int NB = DK / 64;                   // 64-column boxes of a key row
constexpr int KSTEPS = DK / 16;               // k-steps of q . k
constexpr int WG = 128;                       // threads of a warpgroup
constexpr int CONSUMERS = 2 * WG;             // warps 0-7
constexpr int THREADS = CONSUMERS + WG;       // + the producer warpgroup
// registers a thread after setmaxnreg: the producer gives its share to
// the consumers (O, both S accumulators and P take ~190 in warpgroup 0);
// 128 x 24 + 256 x 240 <= 65,536
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int OC = R / 2;                     // output columns a warpgroup
constexpr int XW = 18;  // exchange words a thread: P hi/lo fragments + corr
// named barriers (0 is __syncthreads)
constexpr int kQReady = 1, kPFull = 2, kPEmpty = 3;

// Byte offsets from the 1024-byte aligned base. Boxes are [rows][64]
// bf16 with the 128-byte swizzle: 8 KB for the 64 q rows, 4 KB for 32 keys.
struct Smem {
  static constexpr uint32_t q_box = BM * 128;
  static constexpr uint32_t k_box = BN * 128;
  static constexpr uint32_t q_hi = 0;
  static constexpr uint32_t q_lo = q_hi + NB * q_box;
  static constexpr uint32_t stage = NB * k_box;
  static constexpr uint32_t kv = q_lo + NB * q_box;
  static constexpr uint32_t x = kv + STAGES * stage;
  static constexpr uint32_t bars = x + XW * WG * 4;
  // full[STAGES], empty[STAGES]; + 1 KB to align the base
  static constexpr size_t bytes = bars + 8 * 2 * STAGES + 1024;
  static_assert(bytes <= 232448, "over the 227 KB a CTA may opt into");
};

__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return wgmma_desc(addr, lbo, 1024, kSwizzle128B);
}

// O[64 x 256] += P_hi V + P_lo V over a stage's BN keys: this warpgroup's
// half of the ckv columns (v_off into the stage), read MN-major.
__device__ __forceinline__ void issue_pv(float (&o)[OC / 2],
                                         const uint32_t (&ph)[2][4],
                                         const uint32_t (&pl)[2][4],
                                         uint32_t v) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = desc(v + kk * 16 * 128, Smem::k_box);
    wgmma_rs_m64n256k16_tb(o, ph[kk], dv);
    wgmma_rs_m64n256k16_tb(o, pl[kk], dv);
  }
  wgmma_commit();
}

// O's rows r0 (c0) and r1 (c1) times the online softmax's rescale factors.
__device__ __forceinline__ void rescale(float (&o)[OC / 2], float c0,
                                        float c1) {
#pragma unroll
  for (int j = 0; j < OC / 8; ++j) {
    o[4 * j] *= c0;
    o[4 * j + 1] *= c0;
    o[4 * j + 2] *= c1;
    o[4 * j + 3] *= c1;
  }
}

// f = hi + lo to 2^-16: hi = bf16(f), lo = bf16(f - hi), as bf16 pairs.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__global__ void __launch_bounds__(THREADS, 1)
    mla_tc_kernel(const __grid_constant__ CUtensorMap tm_ckv,
                  const __grid_constant__ CUtensorMap tm_kr,
                  const float* __restrict__ q_lat,
                  const float* __restrict__ q_rope,
                  const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                  int window, float* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int Sq, int H, int L, int split, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int s = blockIdx.x, b = blockIdx.z, n_split = gridDim.x;
  const int rows = Sq * H;           // rows (i, h) of request b
  const int g0 = blockIdx.y * BM;    // the tile's first row
  const int nrows = min(BM, rows - g0);
  const size_t row0 = (size_t)b * rows + g0;

  // the keys the tile's rows visit: [lo, hi), or all L when one sees none
  int lo = 0, hi = L;
  if (k_pos == nullptr) {
    lo = L;
    hi = 0;
    for (int i = g0 / H; i <= (g0 + nrows - 1) / H; ++i) {
      const int qp = q_pos[b * Sq + i];
      const int h_i = qp < 0 ? 0 : min(L, qp + 1);
      const int l_i = window > 0 ? max(0, qp - window + 1) : 0;
      if (l_i >= h_i) {
        lo = 0;
        hi = L;
        break;
      }
      lo = min(lo, l_i);
      hi = max(hi, h_i);
    }
  }
  const int start = max(lo, s * split), end = min(hi, (s + 1) * split);
  if (start >= end) {  // nothing to see in this split (never with one)
    for (int r = threadIdx.x; r < nrows; r += THREADS) {
      part_ml[((row0 + r) * n_split + s) * 2] = -INFINITY;
      part_ml[((row0 + r) * n_split + s) * 2 + 1] = 0.0f;
    }
    return;
  }
  const int n_tiles = (end - start + BN - 1) / BN;

  const uint32_t bars = base + Smem::bars;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (STAGES + st); };
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp >= CONSUMERS / 32) {
    // ------------------------------------------- producer warpgroup ----
    // Stage i % STAGES holds key tile i: 8 ckv boxes and the k_rope box,
    // rows past L zero-filled; free once both warpgroups' P V is done.
    // One thread issues the loads.
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS) {
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES, t0 = start + i * BN;
        const uint32_t dst = base + Smem::kv + st * Smem::stage;
        mbar_wait(empty(st), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(st), Smem::stage);
        for (int c = 0; c < R / 64; ++c)
          tma_load_3d(dst + c * Smem::k_box, &tm_ckv, full(st), 64 * c, t0, b);
        tma_load_3d(dst + (R / 64) * Smem::k_box, &tm_kr, full(st), 0, t0, b);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  // ------------------------------------------------ both warpgroups ----
  // q_hi and q_lo of the tile's rows (zeros past the request's rows),
  // written in the swizzled K-major layout the TMA would give, while the
  // first key tiles fly. Chunk c of row r (8 columns, 16 bytes) sits at
  // box c / 8, row r, 16-byte slot (c % 8) ^ (r % 8).
  {
    constexpr int CHUNKS = DK / 8, PER = BM * CHUNKS / CONSUMERS, U = 9;
    static_assert(PER % U == 0, "whole load batches");
    for (int k0 = 0; k0 < PER; k0 += U) {
      float4 v[U][2];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = threadIdx.x + (k0 + u) * CONSUMERS;
        const int r = idx / CHUNKS, c = idx % CHUNKS;
        v[u][0] = v[u][1] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < nrows) {
          const float* src =
              c < R / 8 ? q_lat + (row0 + r) * R + 8 * c
                        : q_rope + (row0 + r) * RR + 8 * (c - R / 8);
          v[u][0] = *reinterpret_cast<const float4*>(src);
          v[u][1] = *reinterpret_cast<const float4*>(src + 4);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = threadIdx.x + (k0 + u) * CONSUMERS;
        const int r = idx / CHUNKS, c = idx % CHUNKS;
        uint4 h, l;
        split2(v[u][0].x, v[u][0].y, h.x, l.x);
        split2(v[u][0].z, v[u][0].w, h.y, l.y);
        split2(v[u][1].x, v[u][1].y, h.z, l.z);
        split2(v[u][1].z, v[u][1].w, h.w, l.w);
        const uint32_t off =
            (c / 8) * Smem::q_box + r * 128 + (((c % 8) ^ (r % 8)) << 4);
        *reinterpret_cast<uint4*>(gbase + Smem::q_hi + off) = h;
        *reinterpret_cast<uint4*>(gbase + Smem::q_lo + off) = l;
      }
    }
    fence_proxy_async();
    named_sync(kQReady, CONSUMERS);
  }

  const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
  const int r0 = 16 * (t / 32) + lane / 4, r1 = r0 + 8, col0 = 2 * (lane % 4);
  uint32_t* xw = reinterpret_cast<uint32_t*>(gbase + Smem::x);  // [XW][WG]
  const uint32_t kv0 = base + Smem::kv;
  const uint32_t v_off = wg * (OC / 64) * Smem::k_box;  // this half's ckv
  float o[OC / 2];
#pragma unroll
  for (int k = 0; k < OC / 2; ++k) o[k] = 0.0f;
  uint32_t ph[2][4], pl[2][4];
  float l0 = 0.0f, l1 = 0.0f;
  float m0 = repro::kNegBig, m1 = repro::kNegBig;

  if (wg == 0) {
    // -------------------------------------- warpgroup 0: scores too ----
    // S = q_hi K^T + q_lo K^T (72 m64n32k16 from shared memory, the two
    // products in two accumulators, interleaved, then added), the
    // online softmax on the accumulators, P split into bf16 hi + lo and
    // handed to warpgroup 1 with the rescale factors, then O[:, :256] +=
    // P_hi V + P_lo V. S of tile i is issued behind P V of tile i - 1.
    const int qp0 = q_pos[b * Sq + min(g0 + r0, rows - 1) / H];
    const int qp1 = q_pos[b * Sq + min(g0 + r1, rows - 1) / H];
    const int* kp = k_pos == nullptr ? nullptr : k_pos + (size_t)b * L;
    const uint64_t dq = desc(base, 16);
    float sc[BN / 2], sc_lo[BN / 2];  // q_hi K^T and q_lo K^T
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES, t0 = start + i * BN;
      const uint32_t kt = kv0 + st * Smem::stage;
      mbar_wait(full(st), (i / STAGES) & 1);
      // a descriptor's address field is addr >> 4: offsets add to it
      const uint64_t dk = desc(kt, 16);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KSTEPS; ++k) {
        const uint32_t qo = (k / 4) * Smem::q_box + (k % 4) * 32;
        const uint32_t ko = (k / 4) * Smem::k_box + (k % 4) * 32;
        wgmma_ss_m64n32k16(sc, dq + ((Smem::q_hi + qo) >> 4),
                           dk + (ko >> 4), k > 0);
        wgmma_ss_m64n32k16(sc_lo, dq + ((Smem::q_lo + qo) >> 4),
                           dk + (ko >> 4), k > 0);
      }
      wgmma_commit();
      if (i > 0) {
        wgmma_wait<1>();  // P V of tile i - 1 is done: its stage is free
        fence_regs(o);
        mbar_arrive(empty((i - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(sc_lo);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sc[j] += sc_lo[j];

      // masks: -inf past the split (not keys), -1e30 for an invalid key
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t0 + 8 * j + col0 + e;
          float s0 = sc[4 * j + e] * scale_log2;
          float s1 = sc[4 * j + 2 + e] * scale_log2;
          if (key >= end) {
            s0 = s1 = -INFINITY;
          } else {
            const int p_t = kp != nullptr ? kp[key] : key;
            if (!(p_t >= 0 && p_t <= qp0 &&
                  (window <= 0 || p_t > qp0 - window)))
              s0 = repro::kNegBig;
            if (!(p_t >= 0 && p_t <= qp1 &&
                  (window <= 0 || p_t > qp1 - window)))
              s1 = repro::kNegBig;
          }
          sc[4 * j + e] = s0;
          sc[4 * j + 2 + e] = s1;
          mx0 = fmaxf(mx0, s0);
          mx1 = fmaxf(mx1, s1);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        sc[4 * j] = fast_exp2(sc[4 * j] - mn0);
        sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] - mn1);
        sum0 += sc[4 * j] + sc[4 * j + 1];
        sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        split2(sc[4 * j], sc[4 * j + 1], ph[j / 2][(j % 2) * 2],
               pl[j / 2][(j % 2) * 2]);
        split2(sc[4 * j + 2], sc[4 * j + 3], ph[j / 2][(j % 2) * 2 + 1],
               pl[j / 2][(j % 2) * 2 + 1]);
      }
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      rescale(o, c0, c1);

      named_sync(kPEmpty, CONSUMERS);  // warpgroup 1 has read tile i - 1's
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        xw[k * WG + t] = ph[k / 4][k % 4];
        xw[(8 + k) * WG + t] = pl[k / 4][k % 4];
      }
      xw[16 * WG + t] = __float_as_uint(c0);
      xw[17 * WG + t] = __float_as_uint(c1);
      named_arrive(kPFull, CONSUMERS);
      issue_pv(o, ph, pl, kt + v_off);
    }
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty((n_tiles - 1) % STAGES));
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (n_split == 1) {  // warpgroup 1 normalises with the same sums
      named_sync(kPEmpty, CONSUMERS);
      xw[t] = __float_as_uint(l0);
      xw[WG + t] = __float_as_uint(l1);
      named_arrive(kPFull, CONSUMERS);
    } else if (lane % 4 == 0) {
      // the split's partial softmax: m in natural-log units of the scores
      const float ln2 = 0.6931471805599453f;
      if (r0 < nrows) {
        float* ml = part_ml + ((row0 + r0) * n_split + s) * 2;
        ml[0] = m0 * ln2;
        ml[1] = l0;
      }
      if (r1 < nrows) {
        float* ml = part_ml + ((row0 + r1) * n_split + s) * 2;
        ml[0] = m1 * ln2;
        ml[1] = l1;
      }
    }
  } else {
    // ------------------------------------ warpgroup 1: O[:, 256:] ----
    named_arrive(kPEmpty, CONSUMERS);  // the exchange starts free
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      named_sync(kPFull, CONSUMERS);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        ph[k / 4][k % 4] = xw[k * WG + t];
        pl[k / 4][k % 4] = xw[(8 + k) * WG + t];
      }
      const float c0 = __uint_as_float(xw[16 * WG + t]);
      const float c1 = __uint_as_float(xw[17 * WG + t]);
      if (i + 1 < n_tiles || n_split == 1) named_arrive(kPEmpty, CONSUMERS);
      rescale(o, c0, c1);  // P V of tile i - 1 was waited for below
      mbar_wait(full(st), (i / STAGES) & 1);
      issue_pv(o, ph, pl, kv0 + st * Smem::stage + v_off);
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(empty(st));
    }
    if (n_split == 1) {
      named_sync(kPFull, CONSUMERS);
      l0 = __uint_as_float(xw[t]);
      l1 = __uint_as_float(xw[WG + t]);
    }
  }

  // epilogue: O / l (one split) or the split's partial accumulator
  const int c_base = wg * OC + col0;
  if (n_split == 1) {
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < OC / 8; ++j) {
      const int c = c_base + 8 * j;
      if (r0 < nrows)
        *reinterpret_cast<float2*>(out + (row0 + r0) * R + c) =
            make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (r1 < nrows)
        *reinterpret_cast<float2*>(out + (row0 + r1) * R + c) =
            make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  } else {
    float* a0 = part_acc + ((row0 + r0) * n_split + s) * R;
    float* a1 = part_acc + ((row0 + r1) * n_split + s) * R;
#pragma unroll
    for (int j = 0; j < OC / 8; ++j) {
      const int c = c_base + 8 * j;
      if (r0 < nrows)
        *reinterpret_cast<float2*>(a0 + c) = make_float2(o[4 * j], o[4 * j + 1]);
      if (r1 < nrows)
        *reinterpret_cast<float2*>(a1 + c) =
            make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  }
}

// A 3-d map of a [B, L, cols] bf16 tensor: boxes of 64 columns x BN rows
// of one request with the 128-byte swizzle, zero fill past L.
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int cols) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * 2 * L};
  const cuuint32_t box[3] = {64, BN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const float* q_lat, const float* q_rope, const void* ckv,
                   const void* k_rope, const int* q_pos, const int* k_pos,
                   int window, float* out, float* part_acc, float* part_ml,
                   int B, int Sq, int H, int L, int split, float scale,
                   cudaStream_t stream) {
  CUtensorMap tm_ckv, tm_kr;
  if (!make_map(&tm_ckv, ckv, B, L, R) || !make_map(&tm_kr, k_rope, B, L, RR))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mla_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem::bytes);
  if (err != cudaSuccess) return err;
  const int n_split = (L + split - 1) / split;
  const dim3 grid(n_split, (Sq * H + BM - 1) / BM, B);
  mla_tc_kernel<<<grid, THREADS, Smem::bytes, stream>>>(
      tm_ckv, tm_kr, q_lat, q_rope, q_pos, k_pos, window, out, part_acc,
      part_ml, Sq, H, L, split, 1.4426950408889634f * scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  mla_merge_kernel<<<B * Sq * H, MERGE_THREADS, n_split * sizeof(float),
                     stream>>>(part_acc, part_ml, out, n_split, R);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q_lat [B,Sq,H,R] and q_rope [B,Sq,H,RR] float32; ckv [B,L,R] and k_rope
// [B,L,RR] of one dtype (0 float32, 1 bfloat16); q_pos [B,Sq] int32; k_pos
// [B,L] int32 or null; all contiguous and 16-byte aligned. o_lat
// [B,Sq,H,R] float32. `split` keys per CTA; scratch: part_acc [B*Sq*H,
// n_split, R] and part_ml [B*Sq*H, n_split, 2] float32, n_split =
// ceil(L / split) (the tensor-core route takes none when n_split is 1).
// Returns the CUDA error of the launches (0 on success).
extern "C" int mla_attention_fwd(const void* q_lat, const void* q_rope,
                                 const void* ckv, const void* k_rope,
                                 const void* q_pos, const void* k_pos,
                                 int window, void* o_lat, void* part_acc,
                                 void* part_ml, int B, int Sq, int H, int L,
                                 int R, int RR, int split, float scale,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || H < 1 || L < 1 || split < 1 || window < 0 ||
      (L + split - 1) / split > 12 * 1024)
    return (int)cudaErrorInvalidValue;
  const float* ql = static_cast<const float*>(q_lat);
  const float* qr = static_cast<const float*>(q_rope);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  float* o = static_cast<float*>(o_lat);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
#define REPRO_MLA(TT, RRANK, RROPE)                                          \
  if (R == RRANK && RR == RROPE)                                             \
    return (int)launch<TT, RRANK, RROPE>(ql, qr, ckv, k_rope, qp, kp, window, \
                                         o, pa, pm, B, Sq, H, L, split,      \
                                         scale, s);
  if (dtype == repro::kFloat32) {
    REPRO_MLA(float, 32, 16)
    REPRO_MLA(float, 512, 64)
  }
  if (dtype == repro::kBFloat16) {
    REPRO_MLA(__nv_bfloat16, 32, 16)
    if (R == tc::R && RR == tc::RR)
      return (int)tc::launch(ql, qr, ckv, k_rope, qp, kp, window, o, pa, pm,
                             B, Sq, H, L, split, scale, s);
  }
#undef REPRO_MLA
  return (int)cudaErrorInvalidValue;
}

// Which route the instantiation for (dtype, R) takes: 1 the tensor-core
// kernel (TMA + split-bf16 wgmma), 0 the float32 FMA kernel, -1 none.
extern "C" int mla_attention_route(int dtype, int R) {
  if (R != 32 && R != 512) return -1;
  return dtype == repro::kBFloat16 && R == tc::R ? 1 : 0;
}

// Dynamic shared memory of one split-kernel CTA for (dtype, R), in bytes
// (reported by chip_smoke.py's build phase), or -1 for a latent rank the
// kernel does not take.
extern "C" int mla_attention_smem_bytes(int dtype, int R) {
  if (dtype == repro::kFloat32)
    return R == 32 ? (int)Layout<float, 32, 16>::bytes
           : R == 512 ? (int)Layout<float, 512, 64>::bytes
                      : -1;
  return R == 32 ? (int)Layout<__nv_bfloat16, 32, 16>::bytes
         : R == 512 ? (int)tc::Smem::bytes
                    : -1;
}
