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
// Tensor maps are encoded on the host per call with cuTensorMapEncodeTiled,
// looked up at run time through the CUDA runtime (no -lcuda), and passed
// as __grid_constant__ kernel parameters.

#include <cuda.h>  // CUtensorMap and its enums (header only)

#include <stdint.h>

#include "common.cuh"

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
                     int H, int KVH, int Sq, int Sk, int kv_len, int q_offset,
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
  __syncthreads();
  float* op = o + b * os.b + h * os.n + q0 * os.s;
  for (int i = threadIdx.x; i < nq * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    op[rr * os.s + d] = O[rr * L::LDO + d] / fmaxf(l_s[rr], 1e-30f);
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int H, int KVH, int Sq, int Sk, int kv_len,
                   int q_offset, int causal, int window, float scale,
                   const Strides* st, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, H, KVH, Sq, Sk, kv_len, q_offset, causal, window,
      scale > 0.0f ? scale : 1.0f / sqrtf((float)D), st[0], st[1], st[2],
      st[3]);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised TMA + wgmma path
// ---------------------------------------------------------------------------

namespace bf16 {

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
  static constexpr uint64_t LAYOUT = D >= 64 ? 1 : 2;  // wgmma: 128B / 64B
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase with the given parity has completed. A
// wait that has not returned after ~2^34 cycles (seconds) traps, so a
// pipeline fault ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1LL << 34)) {
      __trap();
    }
  }
}

// TMA: one box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor of head dim D's box: 128-byte
// swizzle (layout type 1) for D >= 64, 64-byte swizzle (type 2) for D = 32.
// Byte offsets: lbo between swizzle atoms along the leading dimension (used
// by the MN-major V operand when D spans several boxes), sbo between 8-row
// groups (8 box rows: 1024 or 512).
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (Box<D>::LAYOUT << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// 2^x on the special-function unit (inputs here are <= 0; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads of accumulator registers above the
// wgmma wait (or writes below the issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B in shared memory
// (K-major, 128-byte swizzle), f32 accumulators in registers.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers (bf16 pairs), B in
// shared memory MN-major (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers (bf16 pairs), B in
// shared memory MN-major (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 192] += A[64 x 16] * B[16 x 192], A in registers (bf16 pairs), B
// in shared memory MN-major (transposed, 128-byte swizzle): head dim 192's
// P V, three 64-column boxes of V, a 96-register accumulator per thread.
__device__ __forceinline__ void wgmma_rs_m64n192k16_tb(float (&d)[96],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
      "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
      "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 32] += A[64 x 16] * B[16 x 32], A in registers (bf16 pairs), B in
// shared memory MN-major (transposed, 64-byte swizzle).
__device__ __forceinline__ void wgmma_rs_m64n32k16_tb(float (&d)[16],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
                     __nv_bfloat16* __restrict__ o, Strides os, Problem p) {
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &sym, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
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
                   int B, int H, int KVH, int Sq, int Sk, int kv_len,
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
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), st[3], p);
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
// are already resolved as the Pallas wrapper resolves them. Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KVH, int Sq,
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
    return f32::launch<DD>(qf, kf, vf, of, B, H, KVH, Sq, Sk, kv_len,       \
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
    return bf16::launch<DD>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len, q_offset, \
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
