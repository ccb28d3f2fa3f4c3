// GQA flash attention for Hopper (sm_90a): the port's prefill kernel.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py. Same function: online softmax
// (running max m, sum l and output accumulator in float32), scale 1/sqrt(D)
// unless the caller gives one (MLA's prefill pads q/k with zero columns and
// keeps the scale of the unpadded width), masks k < kv_len, causal k <= q + q_offset, window k > q + q_offset - window.
// q, k, v and o are [B, N, S, D] views whose last dimension is contiguous;
// the other strides are arguments (multiples of 16 bytes).
//
// What bounds it. Causal prefill does 4 * Sq * Sk * D / 2 operations per
// head on Sq * D + 2 * Sk * D elements: at the main shape (Sq = Sk = 1056,
// D = 128) it is bounded by operations, so the bfloat16 products must run
// on the tensor cores, whose full rate on Hopper only `wgmma` reaches.
//
// Design (bfloat16). The TPU grid walks kv blocks in order and carries
// (m, l, acc) in VMEM across grid steps; Hopper's CTAs run in no order, so
// one CTA owns one (batch, q head, 64-row q tile) and loops over the 64-key
// tiles that tile can see (causal and window bounds). It is warp
// specialised, 160 threads:
//  - one producer warp (warp 4) issues TMA loads: Q once, then K and V
//    tiles into a 2-stage ring. Each stage has a full barrier per operand
//    and an empty barrier per operand (K is free once S is computed, V once
//    P V is). TMA writes each 64-column box with the 128-byte swizzle and
//    zero-fills rows past the end of the view. At D = 32 a row is 64 bytes:
//    one 32-column box with the 64-byte swizzle (the wgmma descriptors take
//    its layout type and 512-byte row groups), S = Q K^T takes two k-steps
//    and P V is an m64n32k16. At D = 192 (nemotron-4-340b) a row is three
//    128-byte boxes, S = Q K^T takes 12 k-steps and P V is an m64n192k16
//    whose O accumulator is 96 registers a thread; the Q tile and the two
//    K/V stages take 121 KB, so one CTA fits an SM and its launch bound
//    gives it up to 255 registers;
//  - one consumer warpgroup (warps 0-3) owns the 64 q rows, 16 per warp.
//    S = Q K^T is a `wgmma` with both operands in shared memory (K-major).
//    The online softmax runs on the accumulator registers: each thread
//    holds two rows, a row's max is reduced over the 4 threads of its quad,
//    and the per-thread partial sum is reduced once, at the end; exp2 runs
//    on the special-function unit (ex2.approx). P is rounded to bf16 in
//    registers and is the register A operand of O += P V, with V read from
//    shared memory as a transposed (MN-major) B operand. O stays in
//    registers until the epilogue writes O / l.
//  - the consumer is software-pipelined: S of tile i and P V of tile i-1 are
//    issued back to back, and the softmax of tile i runs while the tensor
//    cores still work on P V of tile i-1; O is rescaled after it.
// Masks are evaluated only on the tiles that cross a mask edge. Grid
// (H, q tiles, B) with the q tiles in reverse order, so the heaviest causal
// tiles start first and the 6 q heads of a kv head run side by side and
// share its K/V in L2. Two CTAs fit an SM (81 KB of shared memory each at
// D = 128), so one CTA's softmax also overlaps the other's products.
//
// What still holds it back (PERF.md): one consumer warpgroup per CTA, so
// the tensor cores idle while a CTA rescales O and packs P unless the
// other CTA on the SM has products ready; and at short prompts the causal
// tiles spread unevenly over the SMs (204 tiles of 1 to 17 key tiles on
// 132 SMs at the main shape).
//
// float32 inputs take a plain FMA path (synchronous tile loads into
// shared memory), kept so that the float32 result can be checked tightly
// (211 KB of shared memory at D = 192, inside the 227 KB opt-in).
//
// Rows with no valid key: the reference kernels visit every key and return
// the mean of V for such a row. When a q tile holds such a row this kernel
// visits all Sk keys too, masked, with the same -1e30 sentinel, and so
// agrees; keys past Sk are not keys at all (probability 0).
//
// With a non-null `lse` [B, H, Sq] (float32) the epilogue also writes each
// row's log-sum-exp of its scaled scores, m + log(l), which the backward
// (flash_attention_bwd.cu) reads; O's arithmetic is the same either way.
//
// Tensor maps are encoded on the host per call with cuTensorMapEncodeTiled,
// looked up at run time through the CUDA runtime (no -lcuda), and passed
// as __grid_constant__ kernel parameters.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Element strides of a [B, N, S, D] view (the D stride is 1).
struct Strides {
  long long b, n, s;
};

// The keys [lo, hi) that the q rows at absolute positions
// q_first..q_last can see. If one of those rows sees no key at all, the
// reference averages V over all Sk keys for it, so then every key is
// visited (all masked): all_masked is set and [lo, hi) = [0, Sk).
struct KeyRange {
  int lo, hi;
  bool all_masked;
};

__device__ __forceinline__ KeyRange visible_keys(int Sk, int kv_len,
                                                 int q_first, int q_last,
                                                 int causal, int window) {
  const int kmax = min(kv_len, Sk);
  int lo = 0, hi = kmax;
  bool empty_row = kmax <= 0;
  if (causal) {
    hi = min(kmax, q_last + 1);
    if (window > 0) lo = max(0, q_first - window + 1);
    empty_row = empty_row || q_first < 0 ||
                (window > 0 && q_last - window + 1 >= kmax);
  }
  if (empty_row || hi <= lo) return {0, Sk, true};
  return {lo, hi, false};
}

// ---------------------------------------------------------------------------
// float32: FMA path
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // threads 2r, 2r+1 own q row r in the softmax
constexpr int LDS = BK + 4;   // score row stride

template <int D>
struct Layout {
  static constexpr int LDK = D + 1;  // +1: conflict-free score reads
  static constexpr int LDO = D + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = repro::align128(q_off + 4 * BQ * D);
  static constexpr size_t v_off = repro::align128(k_off + 4 * BK * LDK);
  static constexpr size_t s_off = repro::align128(v_off + 4 * BK * D);
  static constexpr size_t o_off = repro::align128(s_off + 4 * BQ * LDS);
  static constexpr size_t c_off = repro::align128(o_off + 4 * BQ * LDO);
  static constexpr size_t l_off = c_off + 4 * BQ;
  static constexpr size_t bytes = l_off + 4 * BQ;
};

// Copy 64 rows of D floats (global row stride `stride`) into shared rows of
// stride LD, 16 bytes per load; rows at or past `valid` are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int valid, long long stride) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid)
      val = *reinterpret_cast<const float4*>(src + r * stride + c);
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int KVH, int Sq, int Sk, int kv_len, int q_offset,
                     int causal, int window, float scale, Strides qs,
                     Strides ks, Strides vs, Strides os) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  float* O = reinterpret_cast<float*>(smem + L::o_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::c_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int nq = min(BQ, Sq - q0);
  const float* qp = q + b * qs.b + h * qs.n + q0 * qs.s;
  const float* kp = k + b * ks.b + kvh * ks.n;
  const float* vp = v + b * vs.b + kvh * vs.n;

  load_tile<D, D>(Qs, qp, nq, qs.s);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) O[i] = 0.0f;

  const KeyRange keys = visible_keys(Sk, kv_len, q0 + q_offset,
                                     q0 + nq - 1 + q_offset, causal, window);

  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int qpos = q0 + r + q_offset;
  float m = repro::kNegBig, l = 0.0f;
  for (int k0 = (keys.lo / BK) * BK; k0 < keys.hi; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();  // previous tile fully consumed
    load_tile<D, L::LDK>(Ks, kp + k0 * ks.s, nk, ks.s);
    load_tile<D, D>(Vs, vp + k0 * vs.s, nk, vs.s);
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {  // S = Q K^T
      const int rr = i / BK, c = i % BK;
      const float* qr = Qs + rr * D;
      const float* kr = Ks + c * L::LDK;
      float acc = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      S[rr * LDS + c] = acc;
    }
    __syncthreads();
    // online softmax: threads 2r and 2r+1 hold 32 keys each of row r
    float sv[BK / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int c = half * (BK / 2) + i, kpos = k0 + c;
      float s = -INFINITY;  // past Sk: not a key at all
      if (kpos < Sk) {
        bool ok = kpos < kv_len;
        if (causal) {
          ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
        }
        s = ok ? S[r * LDS + c] * scale : repro::kNegBig;
      }
      sv[i] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const float p = expf(sv[i] - m_new);
      sum += p;
      S[r * LDS + half * (BK / 2) + i] = p;  // each thread its own keys
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m - m_new);
    l = l * corr + sum;
    m = m_new;
    if (half == 0) corr_s[r] = corr;
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * D; i += THREADS) {  // O = O*corr + P V
      const int rr = i / D, d = i % D;
      const float* pr = S + rr * LDS;
      float acc = O[rr * L::LDO + d] * corr_s[rr];
#pragma unroll 16
      for (int c = 0; c < BK; ++c) acc = fmaf(pr[c], Vs[c * D + d], acc);
      O[rr * L::LDO + d] = acc;
    }
  }
  if (half == 0) l_s[r] = l;
  if (lse != nullptr && half == 0 && r < nq)
    lse[((long long)b * H + h) * Sq + q0 + r] = m + logf(l);
  __syncthreads();
  float* op = o + b * os.b + h * os.n + q0 * os.s;
  for (int i = threadIdx.x; i < nq * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    op[rr * os.s + d] = O[rr * L::LDO + d] / fmaxf(l_s[rr], 1e-30f);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int H, int KVH, int Sq, int Sk, int kv_len,
                   int q_offset, int causal, int window, float scale,
                   const Strides* st, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, H, KVH, Sq, Sk, kv_len, q_offset, causal, window,
      scale > 0.0f ? scale : 1.0f / sqrtf((float)D), st[0], st[1], st[2],
      st[3]);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised TMA + wgmma path
// ---------------------------------------------------------------------------

namespace bf16 {

using namespace repro::sm90;

constexpr int BM = 64;               // q rows per CTA (one consumer warpgroup)
constexpr int BN = 64;               // keys per tile
constexpr int STAGES = 2;            // K/V ring depth
constexpr int CONSUMERS = 128;       // warps 0-3
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp

// The swizzled TMA box of a head dim. D >= 64: boxes of 64 columns (128-byte
// rows) with the 128-byte swizzle, D / 64 of them per tile row. D = 32: one
// box of 32 columns (64-byte rows) with the 64-byte swizzle. Either way a box
// holds 64 rows, its 8-row groups are ROWB * 8 bytes apart, and a 16-element
// k-step is 32 bytes along a row, ROWB / 32 k-steps per box.
template <int D>
struct Box {
  static constexpr int COLS = D >= 64 ? 64 : 32;
  static constexpr uint32_t ROWB = COLS * 2;     // bytes per box row
  static constexpr uint32_t BYTES = 64 * ROWB;   // one [64 rows][COLS] box
  static constexpr int NC = D / COLS;            // boxes per tile row
  static constexpr int KPB = ROWB / 32;          // k-steps per box
  static constexpr uint64_t LAYOUT = D >= 64 ? kSwizzle128B : kSwizzle64B;
  static_assert(D == 32 || D % 64 == 0, "head dim 32 or a multiple of 64");
};

template <int D>
struct Smem {
  static constexpr int NC = Box<D>::NC;
  static constexpr uint32_t tile = NC * Box<D>::BYTES;
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t k_off = q_off + tile;
  static constexpr uint32_t v_off = k_off + STAGES * tile;
  static constexpr uint32_t bar_off = v_off + STAGES * tile;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr uint32_t n_bars = 1 + 4 * STAGES;
  // + 1 KB: the swizzled boxes need a 1024-byte aligned base (512 bytes
  // for the 64-byte swizzle)
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
};

// wgmma shared-memory matrix descriptor of head dim D's box: 128-byte
// swizzle for D >= 64, 64-byte swizzle for D = 32. Byte offsets: lbo
// between swizzle atoms along the leading dimension (used by the MN-major
// V operand when D spans several boxes), sbo between 8-row groups (8 box
// rows: 1024 or 512).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return wgmma_desc(addr, lbo, sbo, Box<D>::LAYOUT);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_m64n32k16_tb(o, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  wgmma_rs_m64n64k16_tb(o, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  wgmma_rs_m64n128k16_tb(o, a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_pv<192>(float (&o)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  wgmma_rs_m64n192k16_tb(o, a, desc_b);
}

struct Problem {
  int H, KVH, Sq, Sk, kv_len, q_offset, causal, window, n_qt;
  float scale_log2;  // log2(e) * the softmax scale (1/sqrt(D) by default)
};

// The key tiles [lo, hi) (in units of BN keys) a q tile visits.
__device__ __forceinline__ KeyRange tile_range(const Problem& p, int q0,
                                               int nq) {
  const KeyRange k = visible_keys(p.Sk, p.kv_len, q0 + p.q_offset,
                                  q0 + nq - 1 + p.q_offset, p.causal,
                                  p.window);
  return {k.lo / BN, (k.hi + BN - 1) / BN, k.all_masked};
}

// One consumer thread's state. Accumulator fragment (m64nN, f32): thread
// (warp w, lane) holds rows r0 = 16w + lane/4 and r1 = r0 + 8; element
// 4j+e (e in 0,1) is (r0, 8j + 2*(lane%4) + e) and 4j+2+e is (r1, same
// column). A row's max and sum are reduced over the 4 threads of its quad;
// l0/l1 are this thread's partial sums, quad-reduced once at the end.
struct RowState {
  float m0, m1, l0, l1;
};

// Scores of one key tile -> probabilities (in place, float), with the
// running max and sum updated; returns the rescale factors of O's rows.
// Masks are evaluated only when the tile crosses a mask edge.
__device__ __forceinline__ float2 online_softmax(float (&sc)[BN / 2],
                                                 RowState& st,
                                                 const Problem& p, int k0,
                                                 bool edge, int qpos0,
                                                 int col0) {
  const int qpos1 = qpos0 + 8;
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s0 = sc[4 * j + e] * p.scale_log2;
      float s1 = sc[4 * j + 2 + e] * p.scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * j + col0 + e;
        if (kpos >= p.Sk) {  // not a key at all
          s0 = s1 = -INFINITY;
        } else {
          bool ok0 = kpos < p.kv_len, ok1 = ok0;
          if (p.causal) {
            ok0 = ok0 && kpos <= qpos0;
            ok1 = ok1 && kpos <= qpos1;
            if (p.window > 0) {
              ok0 = ok0 && kpos > qpos0 - p.window;
              ok1 = ok1 && kpos > qpos1 - p.window;
            }
          }
          if (!ok0) s0 = repro::kNegBig;
          if (!ok1) s1 = repro::kNegBig;
        }
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
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  const float2 corr =
      make_float2(fast_exp2(st.m0 - mn0), fast_exp2(st.m1 - mn1));
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = fast_exp2(sc[4 * j] - mn0);
    sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] - mn0);
    sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] - mn1);
    sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] - mn1);
    sum0 += sc[4 * j] + sc[4 * j + 1];
    sum1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  st.l0 = st.l0 * corr.x + sum0;
  st.l1 = st.l1 * corr.y + sum1;
  return corr;
}

// P (float, accumulator layout) -> bf16 A fragments of the P V product.
// k-step kk's registers are {r0, k lo}, {r1, k lo}, {r0, k hi}, {r1, k hi}:
// exactly the accumulator's n8 blocks 2kk and 2kk+1.
__device__ __forceinline__ void pack_p(const float (&sc)[BN / 2],
                                       uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// S = Q K^T over D (both operands K-major in shared memory).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t q_s,
                                         uint32_t k_s) {
  using X = Box<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / X::KPB) * X::BYTES + (kk % X::KPB) * 32;
    wgmma_ss_m64n64k16(sc, smem_desc<D>(q_s + off, 16, 8 * X::ROWB),
                       smem_desc<D>(k_s + off, 16, 8 * X::ROWB), kk > 0);
  }
  wgmma_commit();
}

// O += P V over the tile's keys (V MN-major in shared memory).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BN / 16][4],
                                         uint32_t v_s) {
  using X = Box<D>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_pv<D>(o, pa[kk], smem_desc<D>(v_s + kk * 16 * X::ROWB, X::BYTES,
                                        8 * X::ROWB));
  wgmma_commit();
}

// Two CTAs a SM up to D = 128; at D = 192 one CTA's 121 KB of shared
// memory leaves no room for a second, so its threads may take up to 255
// registers (the 96-register O accumulator).
template <int D>
__global__ void __launch_bounds__(THREADS, D == 192 ? 1 : 2)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     Strides os, Problem p) {
  using L = Smem<D>;
  using X = Box<D>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base (the 128-byte swizzle repeats every 8 rows)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q_off, bars = base + L::bar_off;
  auto k_tile = [&](int s) { return base + L::k_off + s * L::tile; };
  auto v_tile = [&](int s) { return base + L::v_off + s * L::tile; };
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (p.n_qt - 1 - (int)blockIdx.y) * BM;  // heaviest first
  const int kvh = h / (p.H / p.KVH);
  const int nq = min(BM, p.Sq - q0);
  const KeyRange t = tile_range(p, q0, nq);
  const int n = t.hi - t.lo;  // key tiles to visit, >= 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS);
      mbar_init(v_empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ------------------------------------------------ producer warp ----
    // Stage i % STAGES holds tile i; its K is free once S of tile i is
    // done, its V once P V of tile i is done.
    if (lane == 0) {
      mbar_expect_tx(q_full, L::tile);
      for (int c = 0; c < L::NC; ++c)
        tma_load(q_s + c * X::BYTES, &tm_q, q_full, c * X::COLS, q0, h, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const uint32_t free_ph = ((i / STAGES) & 1) ^ 1;
        const int k0 = (t.lo + i) * BN;
        mbar_wait(k_empty(s), free_ph);
        mbar_expect_tx(k_full(s), L::tile);
        for (int c = 0; c < L::NC; ++c)
          tma_load(k_tile(s) + c * X::BYTES, &tm_k, k_full(s), c * X::COLS, k0,
                   kvh, b);
        mbar_wait(v_empty(s), free_ph);
        mbar_expect_tx(v_full(s), L::tile);
        for (int c = 0; c < L::NC; ++c)
          tma_load(v_tile(s) + c * X::BYTES, &tm_v, v_full(s), c * X::COLS, k0,
                   kvh, b);
      }
    }
  } else {
    // ------------------------------------------- consumer warpgroup ----
    // Software pipeline (one warpgroup): S of tile i and P V of tile i-1
    // are issued back to back; the softmax of tile i runs while the
    // tensor cores still do P V of tile i-1, and O is rescaled after it.
    const int row0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
    const int qpos0 = q0 + row0 + p.q_offset;
    const int kmax = min(p.kv_len, p.Sk);
    const int q_first = q0 + p.q_offset, q_last = q0 + nq - 1 + p.q_offset;
    auto edge = [&](int k0) {
      return t.all_masked || k0 + BN > kmax ||
             (p.causal && (k0 + BN - 1 > q_first ||
                           (p.window > 0 && k0 <= q_last - p.window)));
    };

    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.0f;
    RowState st{repro::kNegBig, repro::kNegBig, 0.0f, 0.0f};
    float sc[BN / 2];
    uint32_t pa[BN / 16][4];

    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk<D>(sc, q_s, k_tile(0));
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty(0));
    online_softmax(sc, st, p, t.lo * BN, edge(t.lo * BN), qpos0, col0);
    pack_p(sc, pa);  // O is 0: no rescale

    for (int i = 1; i < n; ++i) {
      const int s = i % STAGES, sp = (i - 1) % STAGES;
      const int k0 = (t.lo + i) * BN;
      mbar_wait(k_full(s), (i / STAGES) & 1);
      mbar_wait(v_full(sp), ((i - 1) / STAGES) & 1);
      fence_regs(o_acc);
      wgmma_fence();
      issue_qk<D>(sc, q_s, k_tile(s));
      issue_pv<D>(o_acc, pa, v_tile(sp));
      wgmma_wait<1>();  // S of tile i is done; P V of tile i-1 may run on
      fence_regs(sc);
      mbar_arrive(k_empty(s));
      const float2 corr = online_softmax(sc, st, p, k0, edge(k0), qpos0,
                                         col0);
      wgmma_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(v_empty(sp));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= corr.x;
        o_acc[4 * j + 1] *= corr.x;
        o_acc[4 * j + 2] *= corr.y;
        o_acc[4 * j + 3] *= corr.y;
      }
      pack_p(sc, pa);
    }
    const int sl = (n - 1) % STAGES;
    mbar_wait(v_full(sl), ((n - 1) / STAGES) & 1);
    fence_regs(o_acc);
    wgmma_fence();
    issue_pv<D>(o_acc, pa, v_tile(sl));
    wgmma_wait<0>();
    fence_regs(o_acc);

    // epilogue: O / l, rows past Sq masked
    float l0 = st.l0, l1 = st.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* op = o + b * os.b + h * os.n;
    const int r0 = q0 + row0, r1 = r0 + 8;
    if (lse != nullptr && (lane & 3) == 0) {  // m, l are in log2 units
      float* lp = lse + ((long long)b * p.H + h) * p.Sq;
      if (r0 < p.Sq) lp[r0] = (st.m0 + log2f(l0)) * 0.6931471805599453f;
      if (r1 < p.Sq) lp[r1] = (st.m1 + log2f(l1)) * 0.6931471805599453f;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      if (r0 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + r0 * os.s + c) =
            __floats2bfloat162_rn(o_acc[4 * j] * inv0, o_acc[4 * j + 1] * inv0);
      if (r1 < p.Sq)
        *reinterpret_cast<__nv_bfloat162*>(op + r1 * os.s + c) =
            __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1,
                                  o_acc[4 * j + 3] * inv1);
    }
  }
}

// A 4-d map of a [B, N, S, D] bf16 view: boxes of 64 columns x 64 rows of
// one (b, n) with the 128-byte swizzle (D = 32: 32 columns, 64-byte
// swizzle), zero fill past the ends.
bool make_map(CUtensorMap* map, const void* ptr, int B, int N, int S, int D,
              const Strides& st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.n * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {D >= 64 ? 64u : 32u, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KVH, int Sq, int Sk, int kv_len,
                   int q_offset, int causal, int window, float scale,
                   const Strides* st, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, H, Sq, D, st[0]) ||
      !make_map(&tm_k, k, B, KVH, Sk, D, st[1]) ||
      !make_map(&tm_v, v, B, KVH, Sk, D, st[2]))
    return cudaErrorInvalidValue;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + BM - 1) / BM;
  const Problem p{H,      KVH,    Sq,   Sk,
                  kv_len, q_offset, causal, window,
                  n_qt,
                  scale > 0.0f ? 1.4426950408889634f * scale
                               : 1.4426950408889634f / sqrtf((float)D)};
  flash_fwd_kernel<D><<<dim3(H, n_qt, B), THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, st[3], p);
  return cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// q [B,H,Sq,D], k/v [B,KVH,Sk,D], o [B,H,Sq,D]: views of one dtype
// (0 float32, 1 bfloat16), D in {32, 64, 128, 192}, last dimension
// contiguous. `scale` > 0 is the softmax scale; 0 keeps 1/sqrt(D), computed
// as before the argument existed, so those results keep their bits.
// `strides` holds the element strides (b, head, seq) of q, k, v and o, in
// that order (12 values), each a multiple of 16 bytes. kv_len and q_offset
// are already resolved as the Pallas wrapper resolves them. `lse`, when not
// null, receives each row's log-sum-exp [B,H,Sq] (float32, contiguous).
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int H, int KVH, int Sq,
                                   int Sk, int D, int kv_len, int q_offset,
                                   int causal, int window, float scale,
                                   int dtype, const long long* strides,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (dtype == repro::kFloat32) {
    const float *qf = static_cast<const float*>(q),
                *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
#define REPRO_F32(DD)                                                       \
  if (D == DD)                                                              \
    return f32::launch<DD>(qf, kf, vf, of, lse, B, H, KVH, Sq, Sk, kv_len,       \
                           q_offset, causal, window, scale, st, s);
    REPRO_F32(32)
    REPRO_F32(64)
    REPRO_F32(128)
    REPRO_F32(192)
#undef REPRO_F32
  }
  if (dtype == repro::kBFloat16) {
#define REPRO_BF16(DD)                                                      \
  if (D == DD)                                                              \
    return bf16::launch<DD>(q, k, v, o, lse, B, H, KVH, Sq, Sk, kv_len, q_offset, \
                            causal, window, scale, st, s);
    REPRO_BF16(32)
    REPRO_BF16(64)
    REPRO_BF16(128)
    REPRO_BF16(192)
#undef REPRO_BF16
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the kernel for (dtype, D), in bytes
// (reported by chip_smoke.py's build phase; ptxas prints only static), or
// -1 for a head dim the kernel does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == repro::kFloat32)
    return D == 32    ? (int)f32::Layout<32>::bytes
           : D == 64  ? (int)f32::Layout<64>::bytes
           : D == 128 ? (int)f32::Layout<128>::bytes
           : D == 192 ? (int)f32::Layout<192>::bytes
                      : -1;
  return D == 32    ? (int)bf16::Smem<32>::bytes
         : D == 64  ? (int)bf16::Smem<64>::bytes
         : D == 128 ? (int)bf16::Smem<128>::bytes
         : D == 192 ? (int)bf16::Smem<192>::bytes
                    : -1;
}
