// GQA flash attention for Hopper (sm_90a): the port's prefill kernel.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py. Same function: online softmax
// (running max m, sum l and output accumulator in float32), scale 1/sqrt(D)
// unless the caller gives one (MLA's prefill pads q/k with zero columns and
// keeps the scale of the unpadded width), masks k < kv_len, causal k <= q +
// q_offset, window k > q + q_offset - window. q and k are [B, N, S, D], v
// and o [B, N, S, DV] views whose last dimension is contiguous (DV = D, or
// MLA's v 128 wide beside its 192-wide q and k); the other strides are
// arguments (multiples of 16 bytes).
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
//    and P V is an m64n32k16;
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
// Design at D = 192 (bfloat16; nemotron-4-340b's heads, deepseek-v3's MLA
// prefill with DV 192 or 128), `flash_fwd_wide_kernel`. A row is three
// 128-byte boxes, S = Q K^T takes 12 k-steps and P V is an m64n192k16
// (m64n128k16 at DV 128) whose O accumulator is 96 (64) registers a
// thread. A Q tile and a K/V stage take 72 KB, so no second CTA fits an SM
// and the one-warpgroup design above left the tensor cores idle through
// every softmax and O rescale. So a persistent CTA an SM, 384 threads,
// walks work items of 128 q rows of one (batch, q head):
//  - consumer warpgroups 0 and 1 each own one 64-row tile of the item and
//    run the software pipeline above on it, with its arithmetic, visiting
//    exactly the key tiles that tile would visit on its own (so the bits
//    are those of a 64-row CTA); both read every K/V tile of the ring,
//    which halves the ring's loads per q row. Q's A fragments are loaded
//    into registers once an item (48 a thread), so S reads only K from
//    shared memory. The softmax applies its masks in one branch ahead of
//    the max (online_softmax_hoisted: the same values);
//  - they issue their products in ping-pong, a turn each on named barriers
//    (bar.sync on its own, bar.arrive on the other's right after the
//    issue): one warpgroup's softmax, rescale and P pack run while the
//    tensor cores work through the other's products. Both take a turn per
//    tile of an item's union (plus one), with nothing to issue on a tile
//    outside their own range (the diagonal's extra tile), so the barriers
//    stay matched;
//  - warpgroup 2 gives its registers away (setmaxnreg 24; the consumers
//    take 240) and one of its threads issues TMA loads: an item's two Q
//    tiles (as soon as the consumers hold the last ones in registers), then
//    the union's K and V tiles into a 3-stage ring that runs on across
//    items, K one tile ahead of V (Q 48 KB + 3 x 48 KB = 197,744 bytes at
//    DV 192, 173,168 at DV 128). The next item's loads overlap this one's
//    last products and epilogue.
// The items are ordered on the host from the shape: all heads in one
// chunk, heaviest pair of every head first, where all K and V fit 16 MB of
// L2 (nemotron's 8 kv heads); else one kv head's q heads at a time (MLA's
// 128 heads of K and V, 84 MB at DV 128: a head's pairs run side by side
// and read its K and V from HBM once). CTA c takes items c, 2G - 1 - c,
// 2G + c, ... of the order (G CTAs: a snake), so heavy and light items
// spread evenly.
//
// float32 inputs take a plain FMA path (synchronous tile loads into
// shared memory), kept so that the float32 result can be checked tightly
// (211 KB of shared memory at D = 192, inside the 227 KB opt-in; DV may
// be 128 there too).
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

template <int D, int DV>
struct Layout {
  static constexpr int LDK = D + 1;  // +1: conflict-free score reads
  static constexpr int LDO = DV + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = repro::align128(q_off + 4 * BQ * D);
  static constexpr size_t v_off = repro::align128(k_off + 4 * BK * LDK);
  static constexpr size_t s_off = repro::align128(v_off + 4 * BK * DV);
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

// D: q and k's head dim; DV: v and o's
template <int D, int DV>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int KVH, int Sq, int Sk, int kv_len, int q_offset,
                     int causal, int window, float scale, Strides qs,
                     Strides ks, Strides vs, Strides os) {
  using L = Layout<D, DV>;
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
    load_tile<DV, DV>(Vs, vp + k0 * vs.s, nk, vs.s);
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
    for (int i = threadIdx.x; i < BQ * DV; i += THREADS) {  // O = O*corr + P V
      const int rr = i / DV, d = i % DV;
      const float* pr = S + rr * LDS;
      float acc = O[rr * L::LDO + d] * corr_s[rr];
#pragma unroll 16
      for (int c = 0; c < BK; ++c) acc = fmaf(pr[c], Vs[c * DV + d], acc);
      O[rr * L::LDO + d] = acc;
    }
  }
  if (half == 0) l_s[r] = l;
  if (lse != nullptr && half == 0 && r < nq)
    lse[((long long)b * H + h) * Sq + q0 + r] = m + logf(l);
  __syncthreads();
  float* op = o + b * os.b + h * os.n + q0 * os.s;
  for (int i = threadIdx.x; i < nq * DV; i += THREADS) {
    const int rr = i / DV, d = i % DV;
    op[rr * os.s + d] = O[rr * L::LDO + d] / fmaxf(l_s[rr], 1e-30f);
  }
}

template <int D, int DV>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int H, int KVH, int Sq, int Sk, int kv_len,
                   int q_offset, int causal, int window, float scale,
                   const Strides* st, cudaStream_t stream) {
  const size_t smem = Layout<D, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D, DV><<<grid, THREADS, smem, stream>>>(
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

// online_softmax's function with the mask applied in one branch ahead of
// the max: the same scaled and masked scores, max, exponents and sums in
// the same order, so the same bits. (ptxas compiles online_softmax's test
// of `edge` inside the unrolled loop into a branch and a convergence
// barrier per element pair, taken on every tile, masked or not. The
// kernels at D <= 128 keep online_softmax as it was.)
__device__ __forceinline__ float2 online_softmax_hoisted(float (&sc)[BN / 2],
                                                         RowState& st,
                                                         const Problem& p,
                                                         int k0, bool edge,
                                                         int qpos0,
                                                         int col0) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] *= p.scale_log2;
  if (edge) {
    const int qpos1 = qpos0 + 8;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * j + col0 + e;
        bool ok0 = kpos < p.kv_len, ok1 = ok0;
        if (p.causal) {
          ok0 = ok0 && kpos <= qpos0;
          ok1 = ok1 && kpos <= qpos1;
          if (p.window > 0) {
            ok0 = ok0 && kpos > qpos0 - p.window;
            ok1 = ok1 && kpos > qpos1 - p.window;
          }
        }
        const bool key = kpos < p.Sk;  // past Sk: not a key at all
        sc[4 * j + e] = !key ? -INFINITY : ok0 ? sc[4 * j + e]
                                                : repro::kNegBig;
        sc[4 * j + 2 + e] = !key ? -INFINITY : ok1 ? sc[4 * j + 2 + e]
                                                    : repro::kNegBig;
      }
    }
  }
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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

// The m64k16 A fragments of a 64-row bf16 tile that TMA wrote in
// 128-byte-swizzled 64-column boxes (16-byte chunk j of row r at chunk
// j ^ (r % 8)), for every k-step of D: registers kk are {r0, k lo},
// {r1, k lo}, {r0, k hi}, {r1, k hi} of k-step kk.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4],
                                             uint32_t tile, int warp,
                                             int lane) {
  using X = Box<D>;
  static_assert(X::COLS == 64, "128-byte swizzled boxes");
  const int r0 = warp * 16 + lane / 4;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + (i & 1) * 8;
      const int c = kk * 16 + (i >> 1) * 8 + 2 * (lane % 4);
      a[kk][i] = ld_shared_u32(
          tile + (c / 64) * X::BYTES + r * 128 +
          ((((c % 64) / 8) ^ (r % 8)) * 16) + (c % 8) * 2);
    }
}

// S = Q K^T over D with Q's A fragments in registers (K K-major in shared
// memory): only K is read from shared memory.
template <int D>
__device__ __forceinline__ void issue_qk_rs(float (&sc)[BN / 2],
                                            const uint32_t (&qa)[D / 16][4],
                                            uint32_t k_s) {
  using X = Box<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / X::KPB) * X::BYTES + (kk % X::KPB) * 32;
    wgmma_rs_m64n64k16(sc, qa[kk], smem_desc<D>(k_s + off, 16, 8 * X::ROWB),
                       kk > 0);
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

// Two CTAs a SM (D = 32, 64, 128; D = 192 takes flash_fwd_wide_kernel).
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
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

// ---------------------------------------------------------------------------
// bfloat16 at D = 192: two consumer warpgroups in ping-pong
// ---------------------------------------------------------------------------

constexpr int WG = 128;                // threads of a warpgroup
constexpr int WIDE_THREADS = 3 * WG;   // warpgroups 0, 1 compute, 2 loads
constexpr int WIDE_STAGES = 3;         // K/V ring depth
// registers a thread after setmaxnreg, one CTA an SM:
// 128 x 24 + 256 x 240 = 64,512 of 65,536
constexpr int WIDE_PRODUCER_REGS = 24, WIDE_CONSUMER_REGS = 240;
// named barrier TURN_BAR + w: consumer warpgroup w's turn to issue its
// products (0 is __syncthreads)
constexpr int TURN_BAR = 1;
// the K and V of all heads that one chunk of the item order may hold in L2
// (a third of the H100's 50 MB, as the backward's dQ grid)
constexpr long long WIDE_L2_BYTES = 16ll << 20;

// Q's two 64-row tiles (one a consumer warpgroup), then the K and V ring.
// DQK: q and k's head dim; DV: v and o's.
template <int DQK, int DV>
struct WideSmem {
  static constexpr uint32_t qk = Box<DQK>::NC * Box<DQK>::BYTES;  // Q or K
  static constexpr uint32_t vt = Box<DV>::NC * Box<DV>::BYTES;    // V
  static constexpr uint32_t q_off = 0;                         // + w * qk
  static constexpr uint32_t k_off = 2 * qk;                    // + s * qk
  static constexpr uint32_t v_off = k_off + WIDE_STAGES * qk;  // + s * vt
  static constexpr uint32_t bar_off = v_off + WIDE_STAGES * vt;
  // q_full, q_empty, k_full[STAGES], v_full[STAGES], k_empty[STAGES],
  // v_empty[STAGES]
  static constexpr uint32_t n_bars = 2 + 4 * WIDE_STAGES;
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
  static_assert(bytes <= 227 * 1024, "over the 227 KB opt-in");
};

struct WideProblem {
  Problem p;
  int B;
  int q_chunk;  // heads a chunk of the item order (launch_wide)
};

// A work item: 128 q rows (two 64-row tiles) of one (batch, q head), the
// key tiles each tile visits and their union.
struct WideItem {
  int b, h, kvh, q0, nq0, nq1, u_lo, u_hi;
  KeyRange t0, t1;
};

// Item w of the order: (b, q head, pair of q tiles) in chunks of q_chunk
// heads, within a chunk the heaviest pair of every head first, heads
// fastest.
__device__ __forceinline__ WideItem wide_item(const WideProblem& w2,
                                              int n_qp, int w) {
  const Problem& p = w2.p;
  WideItem it;
  it.b = w / (p.H * n_qp);
  const int r = w % (p.H * n_qp);
  const int h_lo = r / (w2.q_chunk * n_qp) * w2.q_chunk;
  const int nh = min(w2.q_chunk, p.H - h_lo), r2 = r - h_lo * n_qp;
  it.h = h_lo + r2 % nh;
  it.q0 = (n_qp - 1 - r2 / nh) * 2 * BM;
  it.kvh = it.h / (p.H / p.KVH);
  it.nq0 = min(BM, p.Sq - it.q0);
  it.nq1 = min(BM, p.Sq - it.q0 - BM);
  it.t0 = tile_range(p, it.q0, it.nq0);
  it.t1 = it.nq1 > 0 ? tile_range(p, it.q0 + BM, it.nq1) : it.t0;
  it.u_lo = min(it.t0.lo, it.t1.lo);
  it.u_hi = max(it.t0.hi, it.t1.hi);
  return it;
}

// The item of round r of a persistent CTA: the rounds walk the order in
// strides of the grid, every other round backwards (a snake), so each CTA
// takes heavy and light items alike.
__device__ __forceinline__ int wide_item_index(int r) {
  const int g = (int)gridDim.x, c = (int)blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - c : c);
}

// Persistent: one CTA an SM walks items (wide_item_index) until the order
// is done. Consumer warpgroup w owns q tile w of an item and visits exactly
// the key tiles that the kernel above visits for that tile, with its
// arithmetic, in the same order: the bits depend neither on the pairing nor
// on the schedule. The producer loads each item's two Q tiles (once both
// warpgroups have read the previous ones into registers: S takes Q as its
// register operand) and the union of the two key ranges into the ring, whose
// position runs on across items, so the next item's loads overlap this
// one's last products and epilogue. A tile outside a warpgroup's own range
// is released by it unread (after its load completed, so that an arrival
// never counts toward an earlier phase of its stage).
//
// Ping-pong: the warpgroups take turns to issue their products, one turn
// per tile of an item's union and one more (a warpgroup's turn t issues S
// of its tile t and P V of tile t-1, or nothing outside its range); a turn
// starts with bar.sync on its own named barrier and ends with bar.arrive on
// the other's, right after the issue, so one warpgroup's softmax, O
// rescale and P pack run while the tensor cores work through the other's
// products. Both take as many turns an item, so the barriers stay matched
// from the first item to the last.
template <int DQK, int DV>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, Strides os,
                          WideProblem w2) {
  using L = WideSmem<DQK, DV>;
  using X = Box<DQK>;
  using XV = Box<DV>;
  constexpr int STAGES = WIDE_STAGES;
  const Problem& p = w2.p;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base (the 128-byte swizzle repeats every 8 rows)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::bar_off;
  auto k_tile = [&](int s) { return base + L::k_off + s * L::qk; };
  auto v_tile = [&](int s) { return base + L::v_off + s * L::vt; };
  const uint32_t q_full = bars, q_empty = bars + 8u;
  auto k_full = [&](int s) { return bars + 8u * (2 + s); };
  auto v_full = [&](int s) { return bars + 8u * (2 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (2 + 3 * STAGES + s); };

  const int n_qp = (p.Sq + 2 * BM - 1) / (2 * BM);
  const int n_items = w2.B * p.H * n_qp;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * WG);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2 * WG);
      mbar_init(v_empty(s), 2 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------- producer warpgroup ----
    // Ring position g + i holds union tile i of the item; its K is free
    // once both warpgroups computed S of it (or passed it), its V once both
    // did P V. K of tile i goes ahead of V of tile i-1: a turn takes S of
    // one tile and P V of the one before, and V frees a turn later than K.
    setmaxnreg_dec<WIDE_PRODUCER_REGS>();
    if (threadIdx.x % WG == 0) {
      int g = 0;
      for (int r = 0;; ++r) {
        const int w = wide_item_index(r);
        if (w >= n_items) break;
        const WideItem it = wide_item(w2, n_qp, w);
        mbar_wait(q_empty, (r & 1) ^ 1);
        mbar_expect_tx(q_full, 2 * L::qk);
        for (int t = 0; t < 2; ++t)
          for (int c = 0; c < X::NC; ++c)
            tma_load(base + L::q_off + t * L::qk + c * X::BYTES, &tm_q,
                     q_full, c * X::COLS, it.q0 + t * BM, it.h, it.b);
        const int n_u = it.u_hi - it.u_lo;
        for (int i = 0; i <= n_u; ++i) {
          if (i < n_u) {
            const int s = (g + i) % STAGES;
            mbar_wait(k_empty(s), (((g + i) / STAGES) & 1) ^ 1);
            mbar_expect_tx(k_full(s), L::qk);
            for (int c = 0; c < X::NC; ++c)
              tma_load(k_tile(s) + c * X::BYTES, &tm_k, k_full(s),
                       c * X::COLS, (it.u_lo + i) * BN, it.kvh, it.b);
          }
          if (i > 0) {
            const int j = g + i - 1, s = j % STAGES;
            mbar_wait(v_empty(s), ((j / STAGES) & 1) ^ 1);
            mbar_expect_tx(v_full(s), L::vt);
            for (int c = 0; c < XV::NC; ++c)
              tma_load(v_tile(s) + c * XV::BYTES, &tm_v, v_full(s),
                       c * XV::COLS, (it.u_lo + i - 1) * BN, it.kvh, it.b);
          }
        }
        g += n_u;
      }
    }
    return;
  }

  // ----------------------------------------------- consumer warpgroups ----
  setmaxnreg_inc<WIDE_CONSUMER_REGS>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t q_s = base + L::q_off + wg * L::qk;
  const int row0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const int kmax = min(p.kv_len, p.Sk);
  auto turn_begin = [&] { named_sync(TURN_BAR + wg, 2 * WG); };
  auto turn_end = [&] { named_arrive(TURN_BAR + 1 - wg, 2 * WG); };

  if (wg == 1) turn_end();  // warpgroup 0 takes the first turn
  int g = 0;  // ring position of the item's first union tile
  for (int r = 0;; ++r) {
    const int w = wide_item_index(r);
    if (w >= n_items) break;
    const WideItem it = wide_item(w2, n_qp, w);
    const KeyRange t = wg == 0 ? it.t0 : it.t1;
    const int qw = it.q0 + wg * BM, nq = wg == 0 ? it.nq0 : it.nq1;
    const int u_lo = it.u_lo, u_hi = it.u_hi;
    const int lo = nq > 0 ? t.lo : u_hi, n = nq > 0 ? t.hi - t.lo : 0;
    const int qpos0 = qw + row0 + p.q_offset;
    const int q_first = qw + p.q_offset, q_last = qw + nq - 1 + p.q_offset;
    auto edge = [&](int k0) {
      return t.all_masked || k0 + BN > kmax ||
             (p.causal && (k0 + BN - 1 > q_first ||
                           (p.window > 0 && k0 <= q_last - p.window)));
    };
    auto stage = [&](int u) { return (g + u - u_lo) % STAGES; };
    auto phase = [&](int u) {
      return (uint32_t)(((g + u - u_lo) / STAGES) & 1);
    };
    // union tile u, outside this warpgroup's range: released unread
    auto pass = [&](int u) {
      mbar_wait(k_full(stage(u)), phase(u));
      mbar_arrive(k_empty(stage(u)));
      mbar_wait(v_full(stage(u)), phase(u));
      mbar_arrive(v_empty(stage(u)));
    };

    float o_acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.0f;
    RowState st{repro::kNegBig, repro::kNegBig, 0.0f, 0.0f};
    float sc[BN / 2];
    uint32_t pa[BN / 16][4], qa[DQK / 16][4];
    mbar_wait(q_full, r & 1);
    if (n > 0) load_a_frags<DQK>(qa, q_s, warp, lane);
    mbar_arrive(q_empty);  // Q is in registers: the next item may load

    int u = u_lo;
    for (; u < lo; ++u) {
      pass(u);
      turn_begin();
      turn_end();
    }
    if (n > 0) {
      // the one-warpgroup kernel's software pipeline, a turn per issue
      mbar_wait(k_full(stage(lo)), phase(lo));
      turn_begin();
      wgmma_fence();
      issue_qk_rs<DQK>(sc, qa, k_tile(stage(lo)));
      turn_end();
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty(stage(lo)));
      online_softmax_hoisted(sc, st, p, lo * BN, edge(lo * BN), qpos0, col0);
      pack_p(sc, pa);  // O is 0: no rescale

      for (u = lo + 1; u < lo + n; ++u) {
        const int s = stage(u), sp = stage(u - 1);
        const int k0 = u * BN;
        mbar_wait(k_full(s), phase(u));
        mbar_wait(v_full(sp), phase(u - 1));
        fence_regs(o_acc);
        turn_begin();
        wgmma_fence();
        issue_qk_rs<DQK>(sc, qa, k_tile(s));
        issue_pv<DV>(o_acc, pa, v_tile(sp));
        turn_end();
        wgmma_wait<1>();  // S of tile u is done; P V of tile u-1 may run on
        fence_regs(sc);
        mbar_arrive(k_empty(s));
        const float2 corr = online_softmax_hoisted(sc, st, p, k0, edge(k0),
                                                   qpos0, col0);
        wgmma_wait<0>();
        fence_regs(o_acc);
        mbar_arrive(v_empty(sp));
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o_acc[4 * j] *= corr.x;
          o_acc[4 * j + 1] *= corr.x;
          o_acc[4 * j + 2] *= corr.y;
          o_acc[4 * j + 3] *= corr.y;
        }
        pack_p(sc, pa);
      }
      const int sl = stage(u - 1);
      mbar_wait(v_full(sl), phase(u - 1));
      fence_regs(o_acc);
      turn_begin();  // turn u = lo + n: the last P V
      wgmma_fence();
      issue_pv<DV>(o_acc, pa, v_tile(sl));
      turn_end();
      wgmma_wait<0>();
      fence_regs(o_acc);
      mbar_arrive(v_empty(sl));
      if (u < u_hi) pass(u);
      ++u;
    }
    for (; u <= u_hi; ++u) {
      if (u < u_hi) pass(u);
      turn_begin();
      turn_end();
    }

    if (nq > 0) {
      // epilogue: O / l, rows past Sq masked
      float l0 = st.l0, l1 = st.l1;
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.0f / fmaxf(l0, 1e-30f),
                  inv1 = 1.0f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* op = o + it.b * os.b + it.h * os.n;
      const int r0 = qw + row0, r1 = r0 + 8;
      if (lse != nullptr && (lane & 3) == 0) {  // m, l are in log2 units
        float* lp = lse + ((long long)it.b * p.H + it.h) * p.Sq;
        if (r0 < p.Sq) lp[r0] = (st.m0 + log2f(l0)) * 0.6931471805599453f;
        if (r1 < p.Sq) lp[r1] = (st.m1 + log2f(l1)) * 0.6931471805599453f;
      }
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int c = 8 * j + col0;
        if (r0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + r0 * os.s + c) =
              __floats2bfloat162_rn(o_acc[4 * j] * inv0,
                                    o_acc[4 * j + 1] * inv0);
        if (r1 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(op + r1 * os.s + c) =
              __floats2bfloat162_rn(o_acc[4 * j + 2] * inv1,
                                    o_acc[4 * j + 3] * inv1);
      }
    }
    g += u_hi - u_lo;
  }
  if (wg == 0) turn_begin();  // warpgroup 1's last turn_end
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

// D = 192: the two-warpgroup kernel, one persistent CTA an SM. Its item
// order keeps K and V in L2: all heads in one chunk where every kv head's
// K and V fit WIDE_L2_BYTES together (nemotron's 8 kv heads, 6.5 MB at
// 1056 tokens: the heaviest pairs of all heads first), else one kv head's
// q heads at a time (MLA's 128 heads, 84 MB at 1024 tokens with v 128
// wide, twice L2: a head's pairs run side by side and read its K and V
// from HBM once).
template <int DQK, int DV>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int H, int KVH, int Sq, int Sk,
                        int kv_len, int q_offset, int causal, int window,
                        float scale, const Strides* st, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, H, Sq, DQK, st[0]) ||
      !make_map(&tm_k, k, B, KVH, Sk, DQK, st[1]) ||
      !make_map(&tm_v, v, B, KVH, Sk, DV, st[2]))
    return cudaErrorInvalidValue;
  const size_t smem = WideSmem<DQK, DV>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_qt = (Sq + BM - 1) / BM, n_qp = (Sq + 2 * BM - 1) / (2 * BM);
  const long long n_items = (long long)B * H * n_qp;
  const bool fits = (long long)KVH * Sk * (DQK + DV) * 2 <= WIDE_L2_BYTES;
  const WideProblem w2{
      {H, KVH, Sq, Sk, kv_len, q_offset, causal, window, n_qt,
       scale > 0.0f ? 1.4426950408889634f * scale
                    : 1.4426950408889634f / sqrtf((float)DQK)},
      B, fits ? H : H / KVH};
  flash_fwd_wide_kernel<DQK, DV>
      <<<(unsigned)(n_items < sms ? n_items : sms), WIDE_THREADS, smem,
         stream>>>(tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse,
                   st[3], w2);
  return cudaGetLastError();
}

}  // namespace bf16

}  // namespace

// q [B,H,Sq,D], k [B,KVH,Sk,D], v [B,KVH,Sk,DV], o [B,H,Sq,DV]: views of
// one dtype (0 float32, 1 bfloat16), (D, DV) one of (32, 32), (64, 64),
// (128, 128), (192, 192) and (192, 128) (MLA's v, 128 wide beside its
// 192-wide q and k), last dimension contiguous. `scale` > 0 is the softmax
// scale; 0 keeps 1/sqrt(D), computed as before the argument existed, so
// those results keep their bits. `strides` holds the element strides (b,
// head, seq) of q, k, v and o, in that order (12 values), each a multiple
// of 16 bytes. kv_len and q_offset are already resolved as the Pallas
// wrapper resolves them. `lse`, when not null, receives each row's
// log-sum-exp [B,H,Sq] (float32, contiguous). Returns the CUDA error of the
// launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, int B, int H, int KVH, int Sq,
                                   int Sk, int D, int DV, int kv_len,
                                   int q_offset, int causal, int window,
                                   float scale, int dtype,
                                   const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  if (dtype == repro::kFloat32) {
    const float *qf = static_cast<const float*>(q),
                *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v);
    float* of = static_cast<float*>(o);
#define REPRO_F32(DD, VV)                                                   \
  if (D == DD && DV == VV)                                                  \
    return f32::launch<DD, VV>(qf, kf, vf, of, lse, B, H, KVH, Sq, Sk,      \
                               kv_len, q_offset, causal, window, scale, st, \
                               s);
    REPRO_F32(32, 32)
    REPRO_F32(64, 64)
    REPRO_F32(128, 128)
    REPRO_F32(192, 192)
    REPRO_F32(192, 128)
#undef REPRO_F32
  }
  if (dtype == repro::kBFloat16) {
#define REPRO_BF16(DD)                                                      \
  if (D == DD && DV == DD)                                                  \
    return bf16::launch<DD>(q, k, v, o, lse, B, H, KVH, Sq, Sk, kv_len, q_offset, \
                            causal, window, scale, st, s);
    REPRO_BF16(32)
    REPRO_BF16(64)
    REPRO_BF16(128)
#undef REPRO_BF16
#define REPRO_WIDE(DD, VV)                                                  \
  if (D == DD && DV == VV)                                                  \
    return bf16::launch_wide<DD, VV>(q, k, v, o, lse, B, H, KVH, Sq, Sk,    \
                                     kv_len, q_offset, causal, window,      \
                                     scale, st, s);
    REPRO_WIDE(192, 192)
    REPRO_WIDE(192, 128)
#undef REPRO_WIDE
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one CTA of the kernel for (dtype, D, DV), in
// bytes (reported by chip_smoke.py's build phase; ptxas prints only
// static), or -1 for head dims the kernel does not take.
extern "C" int flash_attention_smem_bytes(int dtype, int D, int DV) {
  const bool f = dtype == repro::kFloat32;
  if (D == 32 && DV == 32)
    return f ? (int)f32::Layout<32, 32>::bytes : (int)bf16::Smem<32>::bytes;
  if (D == 64 && DV == 64)
    return f ? (int)f32::Layout<64, 64>::bytes : (int)bf16::Smem<64>::bytes;
  if (D == 128 && DV == 128)
    return f ? (int)f32::Layout<128, 128>::bytes
             : (int)bf16::Smem<128>::bytes;
  if (D == 192 && DV == 192)
    return f ? (int)f32::Layout<192, 192>::bytes
             : (int)bf16::WideSmem<192, 192>::bytes;
  if (D == 192 && DV == 128)
    return f ? (int)f32::Layout<192, 128>::bytes
             : (int)bf16::WideSmem<192, 128>::bytes;
  return -1;
}
