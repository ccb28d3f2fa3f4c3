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
// What bounds it. Per query and key the H heads do 2 * H * (R + RR + R)
// float32 operations on (R + RR) cache elements: 2 * 128 * 1088 = 278,528
// operations per 1,152 bf16 bytes of deepseek-v3's 576-wide latent row, 242
// per byte, far above the float32 FMA rate's 20 per byte (67 TFLOP/s over
// 3.35 TB/s). So the kernel is bounded by float32 operations: the one-query
// decode at batch 4 over 1104 rows is 1.23 GFLOP, 0.018 ms at 67 TFLOP/s,
// against 7.3 MB, 0.0022 ms. The float32 queries rule out the bf16 tensor
// cores without rounding q_lat, which the reference does not do; a
// tensor-core design is later work (ROADMAP).
//
// Design (split-KV, as the paged kernel). Two kernels, launched back to
// back by the one C entry:
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
// Instantiated for (R, RR) = (32, 16) (the smoke config) and (512, 64)
// (deepseek-v3-671b), for a float32 or bfloat16 cache; anything else is
// refused (cudaErrorInvalidValue).

#include <stdint.h>

#include "common.cuh"

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

}  // namespace

// q_lat [B,Sq,H,R] and q_rope [B,Sq,H,RR] float32; ckv [B,L,R] and k_rope
// [B,L,RR] of one dtype (0 float32, 1 bfloat16); q_pos [B,Sq] int32; k_pos
// [B,L] int32 or null; all contiguous and 16-byte aligned. o_lat
// [B,Sq,H,R] float32. Scratch: part_acc [B*Sq*H, n_split, R] and part_ml
// [B*Sq*H, n_split, 2] float32, n_split = ceil(L / split). Returns the CUDA
// error of the launches (0 on success).
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
    REPRO_MLA(__nv_bfloat16, 512, 64)
  }
#undef REPRO_MLA
  return (int)cudaErrorInvalidValue;
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
         : R == 512 ? (int)Layout<__nv_bfloat16, 512, 64>::bytes
                    : -1;
}
