// Split-KV ("flash-decoding") paged decode attention for Hopper (sm_90a):
// the port's decode kernel.
//
// Replaces the Pallas TPU kernel `paged_attention` / `_paged_kernel` of
// src/repro/kernels/paged_attention.py. Same function: one query token per
// request against a paged KV pool [P, page, KVH, D], read through
// block_table [B, pages_per_seq]; positions >= seq_lens[b] are masked; online
// softmax in float32; the G = H / KVH query heads of a kv head share every
// K/V row read.
//
// What bounds it. Decode attention moves 2 * seq_len * KVH * D elements of
// K/V per request for 4 * H * seq_len * D operations: it is bounded by
// bytes, so what matters is how many bytes are in flight across the card.
// On the TPU the pages are a sequential grid axis carrying (m, l, acc) in
// VMEM; one CTA per (request, kv head) walking the pages in order would put
// 8 CTAs on 132 SMs at batch 4. So the token axis is split.
//
// Design. Two kernels, launched back to back by the one C entry:
//  1. Grid (splits, KVH, B). A CTA takes the `split` tokens
//     [s * split, (s + 1) * split) of one (request, kv head). It reads its
//     own block_table row and gathers those tokens' K and V rows with
//     16-byte cp.async in chunks of 32 tokens, up to two in flight, into
//     shared memory in the input dtype (bf16 stays bf16). seq_lens[b], the
//     first chunk's table entries and q are requested together, so the CTA
//     waits for one memory latency before its copies start, not three. The
//     16-byte pieces of a row are XOR-swizzled by the token's low 3 bits so
//     the score loop, one token per lane, reads without bank conflicts.
//     Warp w scores query heads w, w + 4, ... (lane = token), keeps their
//     running max and sum, and writes the probabilities; then each thread
//     accumulates P V for a pair of columns over its heads. The kernel is
//     instantiated for G <= 4, 8 and 16, so the per-head loops of G = 6 run
//     8 predicated iterations, not 16. G up to 64 (granite-34b's MQA has
//     48 query heads on its one kv head) takes a 64-row instantiation:
//     the CTA still reads each K/V row once for all its heads. The CTA
//     writes the partial (m, l, acc[G, D]) of its split to float32
//     scratch. D = 192 (nemotron-4-340b) is 24 bf16 or 48 float32 pieces
//     a row, the swizzle permuting each run of 8; its P V has 96 column
//     pairs for 128 threads, so threads 96-127 sit that product out.
//  2. Grid (B * H), 4 * D threads. One CTA per output row merges the
//     partials: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s,
//     M = max_s m_s. The weights are computed once, in parallel; four
//     thread groups each sum a quarter of the splits. It is launched as a
//     programmatic dependent launch: it is scheduled while the split kernel
//     runs and waits (griddepcontrol.wait) for its end, so its launch
//     latency is hidden.
// `split` is a host constant, never read from seq_lens on the host: 32
// tokens (one chunk) at every batch. At the main shape (B = 4, KVH = 2,
// 1104 cache slots) that is 35 splits per (request, kv head), 280 CTAs, of
// which ~208 hold tokens: every SM gets work, and the partials (3 KB per
// split) stay small beside the 16 KB of K/V a split reads. The kernel is
// short and latency-bound, so more, smaller CTAs win: chip_smoke.py times
// 32, 64 and 128 tokens per split at batches 4 to 32, and 32 is fastest
// at 4 and 8 and within a few percent of 64 at 16 and 32 (PERF.md). A
// longer split runs its chunks through two cp.async buffers, one chunk in
// flight while the other is scored.
//
// Edges. A request with seq_len > 0 reads its first min(seq_len, table)
// tokens; a split wholly past them writes m = -inf, l = 0 and no acc, and
// the merge skips it. seq_len == 0 reads every slot of the table with every
// score at the -1e30 sentinel, as the reference does: all partials then
// share m = -1e30 and the merge returns the mean of V over the table. Any
// page size and any (permuted) table are taken.
//
// Masked mode (the position mask of the reference's `simple_sdpa`, for
// windowed ring caches and compacted slots). Optional k_pos [P, page] int32
// gives each physical slot's position (-1 = empty), q_pos [B] int32 the
// query's, window > 0 a sliding window. Token t of request b is a key iff
// t < seq_lens[b], and where k_pos is given 0 <= k_pos[t] <= q_pos[b], and
// where window > 0 p_t > q_pos[b] - window, with p_t = k_pos[t] if given,
// else t. A masked token inside seq_len scores the -1e30 sentinel (as
// simple_sdpa), one past it stays -inf; a row with no key therefore gets
// the mean of V over its first seq_len tokens. The k_pos entry of each
// token rides the chunk's cp.async gather through the same block-table
// entry, 4 bytes beside the 1 KB of bf16 K and V a token carries across
// qwen2-vl-2b's two kv heads (2 x 2 x 128 x 2 bytes): under 1% more bytes
// read. The masked kernel is its own instantiation (MASKED = true), so
// the unmasked one compiles as before; the merge kernel is shared.
//
// Multi-query mode (the per-row-start extend of the reference's
// `append_attention`: the batched speculative verify and the draft's
// 2-token lead). q is [B, S, H, D] with S >= 1 query tokens per request,
// q_pos [B, S] int32 their positions; token t of request b is a key of
// query i iff t < seq_lens[b] and t <= q_pos[b, i] (simple_sdpa's causal
// rule with k_pos = arange). A CTA of the split kernel still gathers its
// chunk of K/V once, and scores up to MAXROWS = 64 of the S * G query rows
// of its kv head against it (row r = i * G + g, query i, head g of the
// group): at qwen2-vl's G = 6 and a 5-token verify that is 30 rows, all of
// them. Past 64 rows (a verify of gamma >= 10 at G = 6) the rows go to
// row tiles of 64, a grid axis folded into y (row tile * KVH + kv head):
// each row-tile CTA gathers its own chunk, and the merge still runs per
// output row. With S * G <= 64 there is one row tile, and the kernels
// compute what they did before it existed. In float32 (and
// for S = 1) the FMA kernel takes them, its rows instantiated up to 32 and
// 64 (ROWS = the GMAX template argument) beside 4, 8 and 16, with q, P and
// the running max/sum sized by ROWS; bf16 with S >= 2 runs on tensor cores
// (below). The causal test is per row (each query its own q_pos), so a
// masked token scores the -1e30 sentinel, as in the masked mode. The
// merge runs per output
// row (b, i, h) of [B * S * H]. Rows past the cache (the engine's
// inactive slots, routed to start = L - 1 so q_pos >= L - 1) see every
// read token. At S = 1 with q_pos = seq_len - 1 the rows, scores and
// merge are the unmasked kernel's, bit for bit. The one-query
// instantiations are untouched (MODE is a template argument).
//
// Tensor cores for the bf16 verify. Scoring 30 rows per CTA with FMAs
// makes the split kernel issue- and latency-bound (each lane does 8 dot
// products of 128 and 16 rows of P V per chunk). For bf16 and S >= 2 the
// split kernel is `paged_mma_kernel` instead: each warp holds the A
// fragments of one 16-row tile of q (loaded once from device memory) and
// computes S = q K^T for the chunk's 32 tokens with mma.sync m16n8k16
// (K's B fragments by ldmatrix from the same swizzled chunk), the online
// softmax on the accumulator fragments (a row lives in the 4 lanes of a
// quad), and P V with P re-packed to bf16 A fragments and V's B fragments
// by ldmatrix.trans. The CTA's 4 warps split the 1, 2 or 4 row tiles
// (MT) x the output columns; warps sharing a row tile compute the same S.
// Rows past R are zero q rows, never written. Chunk rows past the split's
// tokens are zero-filled by the cp.async gather so 0 * V stays finite.
// P V rounds P to bf16, as the flash kernel does (within the bf16
// tolerance of the plain version). S = 1 and float32 keep the FMA kernel.
// With S >= 2 the wrapper gives each CTA 64 tokens (two chunks, the second
// in flight while the first is scored): half the CTAs and partials of 32,
// and faster at the verify's batch 8 (chip_smoke.py's paged_verify sweep;
// PERF.md).

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;     // tokens per cp.async stage (one per lane)
constexpr int MAXG = 16;      // rows of the smallest shared-memory layout
constexpr int MAXROWS = 64;   // query rows per CTA: G, or S * G a tile

// Modes of the split kernel (a template argument: each its own code).
enum Mode : int { kPlain = 0, kMasked = 1, kMulti = 2 };

// ROWS: query rows a CTA holds (MAXG for instantiations of <= 16 rows).
template <typename T, int D, int ROWS = MAXG>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte piece
  static constexpr int PIECES = D / VEC;      // pieces per row, >= 4
  static constexpr size_t stage = sizeof(T) * CHUNK * D;  // one K or V chunk
  static constexpr size_t q_off = 0;                      // f32 [ROWS][D]
  static constexpr size_t k_off = repro::align128(4 * ROWS * D);
  static constexpr size_t v_off = k_off + 2 * stage;
  static constexpr size_t p_off = v_off + 2 * stage;      // f32 [ROWS][CHUNK]
  static constexpr size_t c_off = p_off + 4 * ROWS * CHUNK;  // f32 [ROWS]
  static constexpr size_t kp_off = c_off + 4 * ROWS;  // int [2][CHUNK] k_pos
  static constexpr size_t bytes = kp_off + 4 * 2 * CHUNK;
  static_assert(PIECES >= 4, "the swizzle permutes 4 or 8 pieces");
  static_assert(CHUNK * PIECES % THREADS == 0, "whole pieces per thread");
};

// Shared-memory element offset of (token t, column d) in a chunk. A row of
// 8 or more 16-byte pieces permutes them by the token's low 3 bits; a row of
// 4 (bf16 at D = 32: two tokens per 128 bytes) by bits 1-2, so 8 lanes
// reading one piece of 8 consecutive tokens still hit 8 distinct 16-byte
// bank groups.
template <typename T, int D>
__device__ __forceinline__ int swz(int t, int d) {
  constexpr int VEC = Layout<T, D>::VEC;
  if constexpr (Layout<T, D>::PIECES >= 8)
    return t * D + (((d / VEC) ^ (t & 7)) * VEC) + d % VEC;
  else
    return t * D + (((d / VEC) ^ ((t >> 1) & 3)) * VEC) + d % VEC;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// GMAX (4, 8, 16 or 64; also 32 in float32 multi-query mode) bounds the rows
// of a CTA, R = G = H / KVH (S * G in multi-query mode), so the per-row
// loops run no more predicated-off iterations than needed (G = 6 takes
// GMAX = 8). kMasked takes k_pos (may be null), q_pos [B] and window (the
// header's masked mode); kMulti takes S query tokens per request and
// q_pos [B, S] (its multi-query mode).
template <typename T, int D, int GMAX, int MODE>
__global__ void __launch_bounds__(THREADS)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ k_pos,
                       const int* __restrict__ q_pos, int window,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int S, int H, int KVH,
                       int page, int pps, int split, float scale) {
  constexpr bool MASKED = MODE == kMasked;
  constexpr bool MULTI = MODE == kMulti;
  static_assert(GMAX <= MAXROWS, "a CTA holds at most MAXROWS rows");
  static_assert(GMAX <= THREADS, "one thread per row writes empty splits");
  using L = Layout<T, D, (GMAX > MAXG ? GMAX : MAXG)>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* P = reinterpret_cast<float*>(smem + L::p_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::c_off);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kp_off);

  // the merge kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // blockIdx.y = row tile * KVH + kv head (one row tile but in the
  // multi-query mode with S * G > MAXROWS)
  const int s = blockIdx.x, b = blockIdx.z;
  const int kvh = MULTI ? (int)(blockIdx.y % KVH) : (int)blockIdx.y;
  const int n_splits = gridDim.x, G = H / KVH;
  const int row0 = MULTI ? (int)(blockIdx.y / KVH) * MAXROWS : 0;
  // query rows of this CTA: rows row0 .. row0 + R - 1 of the kv head's S * G
  const int R = MULTI ? min(MAXROWS, S * G - row0) : G;
  // output row of CTA row r: (b, h) of [B, H], or (b, i, h) of [B, S, H]
  auto out_row = [&](int r) -> size_t {
    return MULTI ? ((size_t)b * S + (row0 + r) / G) * H + (size_t)kvh * G +
                       (row0 + r) % G
                 : (size_t)b * H + (size_t)kvh * G + r;
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tok = pps * page;
  const int j_begin = s * split;
  const int* bt = block_table + (size_t)b * pps;
  // A chunk's 16-byte pieces, PER per thread. What does not depend on
  // seq_len is requested together with it, so the three reads overlap:
  // seq_len, the first chunk's block-table entries and q.
  constexpr int PER = CHUNK * L::PIECES / THREADS;
  auto table_entries = [&](int j0, int (&pg)[PER]) {
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int j = j0 + (threadIdx.x + r * THREADS) / L::PIECES;
      pg[r] = j < n_tok ? bt[j / page] : 0;
    }
  };
  const int seq = seq_lens[b];
  const int qp = MASKED ? q_pos[b] : 0;
  int pg[PER];
  table_entries(j_begin, pg);
  if constexpr (MULTI) {
    for (int i = threadIdx.x; i < R * D; i += THREADS)
      qs[i] = repro::to_float<T>(q[out_row(i / D) * D + i % D]) * scale;
  } else {
    const T* qr = q + ((size_t)b * H + (size_t)kvh * G) * D;
    for (int i = threadIdx.x; i < G * D; i += THREADS)
      qs[i] = repro::to_float<T>(qr[i]) * scale;
  }

  const int n_read = seq > 0 ? min(seq, n_tok) : n_tok;
  const int j_end = min(j_begin + split, n_read);
  // partial of CTA row r of this split: row out_row(r) of
  // [B * H (* S), n_splits]
  auto prow = [&](int r) -> size_t { return out_row(r) * n_splits + s; };

  if (j_begin >= j_end) {  // the split holds none of the request's tokens
    if (threadIdx.x < R) {
      part_ml[2 * prow(threadIdx.x)] = -INFINITY;
      part_ml[2 * prow(threadIdx.x) + 1] = 0.0f;
    }
    return;
  }

  const int n_chunks = (j_end - j_begin + CHUNK - 1) / CHUNK;
  auto load_chunk = [&](int c, const int (&pages)[PER]) {
    const int j0 = j_begin + c * CHUNK, nc = min(CHUNK, j_end - j0);
    T* kd = Ks + (c & 1) * CHUNK * D;
    T* vd = Vs + (c & 1) * CHUNK * D;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = threadIdx.x + r * THREADS;
      const int t = i / L::PIECES, d = (i % L::PIECES) * L::VEC, j = j0 + t;
      if (t < nc) {
        const size_t src =
            (((size_t)pages[r] * page + j % page) * KVH + kvh) * D + d;
        cp_async16(kd + swz<T, D>(t, d), kp + src);
        cp_async16(vd + swz<T, D>(t, d), vp + src);
        // the thread of a token's first piece also fetches its position
        if (MASKED && k_pos != nullptr && d == 0)
          cp_async4(kpos_s + (c & 1) * CHUNK + t,
                    k_pos + (size_t)pages[r] * page + j % page);
      }
    }
    cp_async_commit();  // one group per chunk (empty past the last)
  };
  auto fetch_chunk = [&](int c) {  // table entries, then the copies
    int pgc[PER];
    table_entries(j_begin + c * CHUNK, pgc);
    load_chunk(c, pgc);
  };
  load_chunk(0, pg);
  if (n_chunks > 1) {
    fetch_chunk(1);
  } else {
    cp_async_commit();
  }

  // score/softmax role: warp w owns rows w + WARPS * gi; lane = token
  constexpr int GPW = GMAX / WARPS;
  float m_r[GPW], l_r[GPW];
  [[maybe_unused]] int qp_r[MULTI ? GPW : 1];  // each row's query position
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi) {
    m_r[gi] = -INFINITY;
    l_r[gi] = 0.0f;
    if constexpr (MULTI) {
      const int g = warp + WARPS * gi;
      qp_r[gi] = g < R ? q_pos[(size_t)b * S + (row0 + g) / G] : 0;
    }
  }
  // P V role: thread owns columns d2, d2 + 1 of heads set + NS * gi. At
  // D = 192 the 96 column pairs leave NS = 1 set: threads 96-127 idle here
  // (pv is false; true for every thread at D = 32, 64 and 128)
  constexpr int NS = THREADS / (D / 2);
  constexpr int GPS = (GMAX + NS - 1) / NS;  // NS = 8 > GMAX = 4 at D = 32
  const int d2 = 2 * (threadIdx.x % (D / 2)), set = threadIdx.x / (D / 2);
  const bool pv = set < NS;
  float acc[GPS][2];
#pragma unroll
  for (int gi = 0; gi < GPS; ++gi) acc[gi][0] = acc[gi][1] = 0.0f;

  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = j_begin + c * CHUNK, nc = min(CHUNK, j_end - j0);
    const T* Kc = Ks + (c & 1) * CHUNK * D;
    const T* Vc = Vs + (c & 1) * CHUNK * D;
    cp_async_wait_1();  // chunk c has landed (c + 1 may still fly)
    __syncthreads();

    // is token `lane` a key of the query (masked mode; true otherwise)?
    bool is_key = true;
    if (MASKED && lane < nc) {
      const int p =
          k_pos != nullptr ? kpos_s[(c & 1) * CHUNK + lane] : j0 + lane;
      is_key = (k_pos == nullptr || (p >= 0 && p <= qp)) &&
               (window <= 0 || p > qp - window);
    }
    // scores of token `lane` for this warp's heads
    float dot[GPW];
#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) dot[gi] = 0.0f;
    if (lane < nc) {
#pragma unroll 4
      for (int piece = 0; piece < L::PIECES; ++piece) {
        const int d = piece * L::VEC;
        float kf[L::VEC];
        const int4 raw = *reinterpret_cast<const int4*>(Kc + swz<T, D>(lane, d));
        const T* ke = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < L::VEC; ++e) kf[e] = repro::to_float<T>(ke[e]);
#pragma unroll
        for (int gi = 0; gi < GPW; ++gi) {
          const int g = warp + WARPS * gi;
          if (g < R) {
            const float* qg = qs + g * D + d;
#pragma unroll
            for (int e = 0; e < L::VEC; ++e) dot[gi] = fmaf(qg[e], kf[e], dot[gi]);
          }
        }
      }
    }
#pragma unroll
    for (int gi = 0; gi < GPW; ++gi) {
      const int g = warp + WARPS * gi;
      if (g < R) {
        // multi-query: token j0 + lane is a key of this row's query iff
        // it is not past the query's position
        const bool key = MULTI ? j0 + lane <= qp_r[gi] : is_key;
        // past the split's tokens: not a key; seq_len 0 or a masked
        // token: the sentinel
        const float sc = lane >= nc      ? -INFINITY
                         : seq > 0 && key ? dot[gi]
                                          : repro::kNegBig;
        const float m_new = fmaxf(m_r[gi], repro::warp_max(sc));
        const float pr = expf(sc - m_new);
        const float corr = expf(m_r[gi] - m_new);  // 0 on the first chunk
        l_r[gi] = l_r[gi] * corr + repro::warp_sum(pr);
        m_r[gi] = m_new;
        P[g * CHUNK + lane] = pr;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int gi = 0; gi < GPS; ++gi) {
      const int g = set + NS * gi;
      if (pv && g < R) {
        const float cr = corr_s[g];
        acc[gi][0] *= cr;
        acc[gi][1] *= cr;
      }
    }
#pragma unroll 4
    for (int t = 0; t < nc; ++t) {
      const float2 vv = load2<T>(Vc + swz<T, D>(t, d2));
#pragma unroll
      for (int gi = 0; gi < GPS; ++gi) {
        const int g = set + NS * gi;
        if (pv && g < R) {
          const float pr = P[g * CHUNK + t];
          acc[gi][0] = fmaf(pr, vv.x, acc[gi][0]);
          acc[gi][1] = fmaf(pr, vv.y, acc[gi][1]);
        }
      }
    }
    __syncthreads();  // chunk c's buffers and P are free
    if (c + 2 < n_chunks) {
      fetch_chunk(c + 2);
    } else {
      cp_async_commit();
    }
  }

#pragma unroll
  for (int gi = 0; gi < GPW; ++gi) {
    const int g = warp + WARPS * gi;
    if (g < R && lane == 0) {
      part_ml[2 * prow(g)] = m_r[gi];
      part_ml[2 * prow(g) + 1] = l_r[gi];
    }
  }
#pragma unroll
  for (int gi = 0; gi < GPS; ++gi) {
    const int g = set + NS * gi;
    if (pv && g < R)
      *reinterpret_cast<float2*>(part_acc + prow(g) * D + d2) =
          make_float2(acc[gi][0], acc[gi][1]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a 16-byte cp.async that writes zeros (reads nothing)
__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The multi-query split kernel on tensor cores (bf16, S >= 2; the header
// says why). Grid and partials as paged_split_kernel's kMulti mode. MT:
// 16-row tiles of q per CTA (1, 2 or 4); warp w takes tile w % MT and
// the D * MT / 4 output columns of column group w / MT.
template <int D, int MT>
__global__ void __launch_bounds__(THREADS)
    paged_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ kp,
                     const __nv_bfloat16* __restrict__ vp,
                     const int* __restrict__ block_table,
                     const int* __restrict__ seq_lens,
                     const int* __restrict__ q_pos,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int S, int H, int KVH,
                     int page, int pps, int split, float scale) {
  using T = __nv_bfloat16;
  using L = Layout<T, D>;
  constexpr int KSTEPS = D / 16;          // k-steps of q K^T
  constexpr int WPM = WARPS / MT;         // warps per row tile
  constexpr int NTO = D / WPM / 8;        // output n-tiles per warp
  static_assert(NTO % 2 == 0, "V fragments load two n-tiles at a time");
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + 2 * CHUNK * D;

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // blockIdx.y = row tile * KVH + kv head; the tile holds rows
  // row0 .. row0 + R - 1 of the kv head's S * G
  const int s = blockIdx.x, kvh = blockIdx.y % KVH, b = blockIdx.z;
  const int n_splits = gridDim.x, G = H / KVH;
  const int row0 = (int)(blockIdx.y / KVH) * MAXROWS;
  const int R = min(MAXROWS, S * G - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment row / column pair
  const int mt = warp % MT, col0 = (warp / MT) * (D / WPM);
  auto out_row = [&](int r) -> size_t {
    return ((size_t)b * S + (row0 + r) / G) * H + (size_t)kvh * G +
           (row0 + r) % G;
  };
  auto prow = [&](int r) -> size_t { return out_row(r) * n_splits + s; };
  const int n_tok = pps * page;
  const int j_begin = s * split;
  const int* bt = block_table + (size_t)b * pps;
  constexpr int PER = CHUNK * L::PIECES / THREADS;
  auto table_entries = [&](int j0, int (&pg)[PER]) {
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int j = j0 + (threadIdx.x + r * THREADS) / L::PIECES;
      pg[r] = j < n_tok ? bt[j / page] : 0;
    }
  };
  const int seq = seq_lens[b];
  int pg[PER];
  table_entries(j_begin, pg);
  // this thread's two rows of its tile, their query positions and the A
  // fragments of q (rows past R are zero)
  const int r0 = mt * 16 + g, r1 = r0 + 8;
  const int qp0 = r0 < R ? q_pos[(size_t)b * S + (row0 + r0) / G] : 0;
  const int qp1 = r1 < R ? q_pos[(size_t)b * S + (row0 + r1) / G] : 0;
  uint32_t qa[KSTEPS][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q + out_row(r0) * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(q + out_row(r1) * D);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int c = kk * 8 + t;          // column pair 2t of k-step kk
      qa[kk][0] = r0 < R ? q0[c] : 0u;
      qa[kk][1] = r1 < R ? q1[c] : 0u;
      qa[kk][2] = r0 < R ? q0[c + 4] : 0u;
      qa[kk][3] = r1 < R ? q1[c + 4] : 0u;
    }
  }

  const int n_read = seq > 0 ? min(seq, n_tok) : n_tok;
  const int j_end = min(j_begin + split, n_read);
  if (j_begin >= j_end) {  // the split holds none of the request's tokens
    if (threadIdx.x < R) {
      part_ml[2 * prow(threadIdx.x)] = -INFINITY;
      part_ml[2 * prow(threadIdx.x) + 1] = 0.0f;
    }
    return;
  }

  const int n_chunks = (j_end - j_begin + CHUNK - 1) / CHUNK;
  auto load_chunk = [&](int c, const int (&pages)[PER]) {
    const int j0 = j_begin + c * CHUNK, nc = min(CHUNK, j_end - j0);
    T* kd = Ks + (c & 1) * CHUNK * D;
    T* vd = Vs + (c & 1) * CHUNK * D;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = threadIdx.x + r * THREADS;
      const int tk = i / L::PIECES, d = (i % L::PIECES) * L::VEC, j = j0 + tk;
      if (tk < nc) {
        const size_t src =
            (((size_t)pages[r] * page + j % page) * KVH + kvh) * D + d;
        cp_async16(kd + swz<T, D>(tk, d), kp + src);
        cp_async16(vd + swz<T, D>(tk, d), vp + src);
      } else {  // rows past the split: zeros, so P V stays finite
        cp_async16_zero(kd + swz<T, D>(tk, d), kp);
        cp_async16_zero(vd + swz<T, D>(tk, d), vp);
      }
    }
    cp_async_commit();
  };
  auto fetch_chunk = [&](int c) {
    int pgc[PER];
    table_entries(j_begin + c * CHUNK, pgc);
    load_chunk(c, pgc);
  };
  load_chunk(0, pg);
  if (n_chunks > 1) {
    fetch_chunk(1);
  } else {
    cp_async_commit();
  }

  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f};
  float acc[NTO][4];
#pragma unroll
  for (int n = 0; n < NTO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const int mi = lane / 8, li = lane % 8;  // ldmatrix: matrix, row

  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = j_begin + c * CHUNK, nc = min(CHUNK, j_end - j0);
    const T* Kc = Ks + (c & 1) * CHUNK * D;
    const T* Vc = Vs + (c & 1) * CHUNK * D;
    cp_async_wait_1();
    __syncthreads();

    // scores of the tile's 16 rows x the chunk's 32 tokens (4 n-tiles)
    float sc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, Kc + swz<T, D>(8 * (2 * jp + mi / 2) + li,
                                   16 * kk + 8 * (mi % 2)));
        mma_bf16(sc[2 * jp], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[2 * jp + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // masks (past the split: -inf; not a key: the sentinel), row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tt = 8 * j + 2 * t + (e & 1), row = e / 2;
        const bool key = seq > 0 && j0 + tt <= (row ? qp1 : qp0);
        const float v = tt >= nc ? -INFINITY
                        : key    ? sc[j][e] * scale
                                 : repro::kNegBig;
        sc[j][e] = v;
        mx[row] = fmaxf(mx[row], v);
      }
    }
    float corr[2];
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 1));
      mx[row] = fmaxf(mx[row], __shfl_xor_sync(0xffffffffu, mx[row], 2));
      const float m_new = fmaxf(m_r[row], mx[row]);
      corr[row] = expf(m_r[row] - m_new);  // 0 on the first chunk
      m_r[row] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = expf(sc[j][e] - m_r[e / 2]);
        sc[j][e] = pr;
        sum[e / 2] += pr;
      }
    }
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 1);
      sum[row] += __shfl_xor_sync(0xffffffffu, sum[row], 2);
      l_r[row] = l_r[row] * corr[row] + sum[row];
    }
#pragma unroll
    for (int n = 0; n < NTO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // acc += P V: P's accumulator fragments are its A fragments
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NTO / 2; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vc + swz<T, D>(16 * kk + 8 * (mi % 2) + li,
                                         col0 + 8 * (2 * np + mi / 2)));
        mma_bf16(acc[2 * np], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * np + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // chunk c's buffers are free
    if (c + 2 < n_chunks) {
      fetch_chunk(c + 2);
    } else {
      cp_async_commit();
    }
  }

#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const int r = row ? r1 : r0;
    if (r >= R) continue;
    if (col0 == 0 && t == 0) {
      part_ml[2 * prow(r)] = m_r[row];
      part_ml[2 * prow(r) + 1] = l_r[row];
    }
#pragma unroll
    for (int n = 0; n < NTO; ++n)
      *reinterpret_cast<float2*>(part_acc + prow(r) * D + col0 + 8 * n +
                                 2 * t) =
          make_float2(acc[n][2 * row], acc[n][2 * row + 1]);
  }
}

// Merge the split partials of one output row: (request, query head), or
// (request, query token, query head) in multi-query mode. The weights
// e^(m_s - M) are computed once, in parallel, into shared memory; then SG
// groups of D threads each sum every SG-th split of their column (short
// chains of independent loads) and group 0 adds the SG sums.
constexpr int SG = 4;

template <typename T, int D>
__global__ void __launch_bounds__(D * SG)
    paged_combine_kernel(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml, T* __restrict__ o,
                         int n_splits) {
  constexpr int NT = D * SG, NW = NT / 32;
  extern __shared__ float w_s[];  // [n_splits]
  __shared__ float red[NW];
  __shared__ float sums[SG][D];
  // launched early (programmatic dependent launch): wait until the split
  // kernel has finished and its partials are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t row = blockIdx.x;  // b * H + h, or (b * S + i) * H + h
  const float* ml = part_ml + row * n_splits * 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float mx = -INFINITY;
  for (int s = threadIdx.x; s < n_splits; s += NT) mx = fmaxf(mx, ml[2 * s]);
  mx = repro::warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();  // red is reused below

  float l = 0.0f;
  for (int s = threadIdx.x; s < n_splits; s += NT) {
    const float m = ml[2 * s];
    const float w = m == -INFINITY ? 0.0f : expf(m - mx);  // empty split
    w_s[s] = w;
    l = fmaf(w, ml[2 * s + 1], l);
  }
  l = repro::warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();
  l = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) l += red[w];

  const int col = threadIdx.x % D, grp = threadIdx.x / D;
  const float* pa = part_acc + row * n_splits * D + col;
  float acc = 0.0f;
#pragma unroll 4
  for (int s = grp; s < n_splits; s += SG) {
    const float x = pa[(size_t)s * D];  // an empty split's acc is unwritten:
    const float w = w_s[s];             // its weight 0 discards it
    acc = w != 0.0f ? fmaf(w, x, acc) : acc;
  }
  sums[grp][col] = acc;
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int g = 1; g < SG; ++g) acc += sums[g][col];
    o[row * D + col] = repro::from_float<T>(acc / fmaxf(l, 1e-30f));
  }
}

// The masking arguments of one launch (k_pos and q_pos may be null).
struct Mask {
  const int* k_pos;
  const int* q_pos;
  int window;
};

template <typename T, int D>
cudaError_t launch_merge(float* part_acc, float* part_ml, void* o, int rows,
                         int n_splits, cudaStream_t stream);

// The tensor-core multi-query split kernel with MT 16-row tiles, then the
// merge.
template <int D, int MT>
cudaError_t launch_mma(const void* q, const void* kp, const void* vp,
                       const int* bt, const int* sl, const int* q_pos,
                       void* o, float* part_acc, float* part_ml, int B,
                       int S, int H, int KVH, int page, int pps, int split,
                       cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t smem = 4 * sizeof(T) * CHUNK * D;  // K and V, 2 stages each
  cudaError_t err = cudaFuncSetAttribute(
      paged_mma_kernel<D, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_splits = (pps * page + split - 1) / split;
  const int n_rt = (S * (H / KVH) + MAXROWS - 1) / MAXROWS;  // row tiles
  paged_mma_kernel<D, MT>
      <<<dim3(n_splits, KVH * n_rt, B), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, q_pos, part_acc, part_ml, S, H, KVH,
      page, pps, split, 1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T, D>(part_acc, part_ml, o, B * S * H, n_splits,
                            stream);
}

// S: query tokens per request (1 unless MODE is kMulti).
template <typename T, int D, int GMAX, int MODE>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* sl, Mask mask, void* o,
                   float* part_acc, float* part_ml, int B, int S, int H,
                   int KVH, int page, int pps, int split,
                   cudaStream_t stream) {
  const size_t smem = Layout<T, D, (GMAX > MAXG ? GMAX : MAXG)>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D, GMAX, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_splits = (pps * page + split - 1) / split;
  const int n_rt =  // row tiles (multi-query mode with S * G > MAXROWS)
      MODE == kMulti ? (S * (H / KVH) + MAXROWS - 1) / MAXROWS : 1;
  paged_split_kernel<T, D, GMAX, MODE>
      <<<dim3(n_splits, KVH * n_rt, B), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), bt, sl, mask.k_pos, mask.q_pos,
          mask.window, part_acc, part_ml, S, H, KVH, page, pps, split,
          1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_merge<T, D>(part_acc, part_ml, o, B * S * H, n_splits,
                            stream);
}

// The merge of ``rows`` output rows, each over ``n_splits`` partials.
template <typename T, int D>
cudaError_t launch_merge(float* part_acc, float* part_ml, void* o, int rows,
                         int n_splits, cudaStream_t stream) {
  // the merge's weights, one per split, may exceed the default 48 KB
  const size_t merge_smem = sizeof(float) * n_splits;
  cudaError_t err;
  err = cudaFuncSetAttribute(paged_combine_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)merge_smem);
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the merge's launch overlaps the split
  // kernel's tail instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(D * SG);
  cfg.dynamicSmemBytes = merge_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_combine_kernel<T, D>,
                            static_cast<const float*>(part_acc),
                            static_cast<const float*>(part_ml),
                            static_cast<T*>(o), n_splits);
}

// The instantiation whose GMAX bounds the CTA's rows R = S * H / KVH, at
// most MAXROWS (more rows take more row-tile CTAs): 4, 8 and 16, then 64
// (one-query G = 48 of granite-34b, and multi-query rows past 16; float32
// multi-query also has 32); bf16 multi-query with S >= 2 takes the
// tensor-core kernel.
template <typename T, int D, int MODE>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const int* bt, const int* sl, Mask mask, void* o,
                     float* part_acc, float* part_ml, int B, int S, int H,
                     int KVH, int page, int pps, int split,
                     cudaStream_t stream) {
  const int R = min(S * (H / KVH), MAXROWS);
  if constexpr (MODE == kMulti && std::is_same<T, __nv_bfloat16>::value) {
    if (S >= 2) {  // tensor cores: 1, 2 or 4 row tiles of 16
#define REPRO_MMA(MT)                                                       \
  return launch_mma<D, MT>(q, kp, vp, bt, sl, mask.q_pos, o, part_acc,      \
                           part_ml, B, S, H, KVH, page, pps, split, stream)
      // at D = 32 one warp's share of the columns with a single row tile
      // would be one n-tile; V's fragments load two, so take two row tiles
      if constexpr (D >= 64) {
        if (R <= 16) REPRO_MMA(1);
      }
      if (R <= 32) REPRO_MMA(2);
      REPRO_MMA(4);
#undef REPRO_MMA
    }
  }
#define REPRO_LAUNCH(GM)                                                    \
  return launch<T, D, GM, MODE>(q, kp, vp, bt, sl, mask, o, part_acc,       \
                                part_ml, B, S, H, KVH, page, pps, split,    \
                                stream)
  if (R <= 4) REPRO_LAUNCH(4);
  if (R <= 8) REPRO_LAUNCH(8);
  if (R <= 16) REPRO_LAUNCH(16);
  if constexpr (MODE == kMulti && std::is_same<T, float>::value) {
    if (R <= 32) REPRO_LAUNCH(32);
  }
  REPRO_LAUNCH(64);
#undef REPRO_LAUNCH
}

template <typename T, int D>
cudaError_t launch_m(const void* q, const void* kp, const void* vp,
                     const int* bt, const int* sl, Mask mask, void* o,
                     float* part_acc, float* part_ml, int B, int S, int H,
                     int KVH, int page, int pps, int split,
                     cudaStream_t stream) {
  if (S > 0)  // multi-query mode (q_pos [B, S])
    return launch_g<T, D, kMulti>(q, kp, vp, bt, sl, mask, o, part_acc,
                                  part_ml, B, S, H, KVH, page, pps, split,
                                  stream);
  if (mask.k_pos != nullptr || mask.window > 0)
    return launch_g<T, D, kMasked>(q, kp, vp, bt, sl, mask, o, part_acc,
                                   part_ml, B, 1, H, KVH, page, pps, split,
                                   stream);
  return launch_g<T, D, kPlain>(q, kp, vp, bt, sl, mask, o, part_acc,
                                part_ml, B, 1, H, KVH, page, pps, split,
                                stream);
}

// Dispatch on (dtype, D); S = 0 is the one-query kernel, S >= 1 the
// multi-query mode.
cudaError_t dispatch(const void* q, const void* k_pages, const void* v_pages,
                     const int* bt, const int* sl, Mask mask, void* o,
                     float* pa, float* pm, int B, int S, int H, int KVH,
                     int D, int page, int pps, int split, int dtype,
                     cudaStream_t s) {
#define REPRO_D(T, DD)                                                      \
  if (D == DD)                                                              \
    return launch_m<T, DD>(q, k_pages, v_pages, bt, sl, mask, o, pa, pm, B, \
                           S, H, KVH, page, pps, split, s);
  if (dtype == repro::kFloat32) {
    REPRO_D(float, 32)
    REPRO_D(float, 64)
    REPRO_D(float, 128)
    REPRO_D(float, 192)
  }
  if (dtype == repro::kBFloat16) {
    REPRO_D(__nv_bfloat16, 32)
    REPRO_D(__nv_bfloat16, 64)
    REPRO_D(__nv_bfloat16, 128)
    REPRO_D(__nv_bfloat16, 192)
  }
#undef REPRO_D
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,H,D] (S = 0) or [B,S,H,D] (multi-query mode, S >= 1; the S * H / KVH
// rows of a kv head go to row tiles of MAXROWS), k/v pages [P,page,KVH,D],
// block_table [B,pps] int32 (entries in [0, P)), seq_lens [B] int32, o
// shaped as q; all contiguous, one dtype (0 float32, 1 bfloat16), D in
// {32, 64, 128, 192}, H / KVH <= 64.
// One-query masked mode: k_pos [P,page] int32 or null, q_pos [B] int32
// (needed when k_pos is given or window > 0, else may be null),
// window >= 0. Multi-query mode: q_pos [B,S] int32 (each query's
// position), no k_pos and no window; token t of request b is a key of
// query i iff t < seq_lens[b] and t <= q_pos[b, i]. `split` tokens per CTA
// (>= 1); part_acc [rows, ceil(pps*page/split), D] and part_ml
// [rows, ceil(pps*page/split), 2] are float32 scratch, rows = B*H (times S
// in the multi-query mode). Returns the CUDA error of the launches (0 on
// success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* block_table,
                                   const void* seq_lens, const void* k_pos,
                                   const void* q_pos, int window, void* o,
                                   void* part_acc, void* part_ml, int B,
                                   int S, int H, int KVH, int D, int page,
                                   int pps, int split, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  const Mask mask = {static_cast<const int*>(k_pos),
                     static_cast<const int*>(q_pos), window};
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  // the merge keeps one weight per split in shared memory: at most 192 KB
  // beside its ~2 KB of static arrays, inside a CTA's 227 KB
  if (H % KVH != 0 || H / KVH > MAXROWS || split < 1 ||
      (pps * page + split - 1) / split > 48 * 1024 || window < 0 ||
      ((k_pos != nullptr || window > 0) && q_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S != 0 && (S < 1 || q_pos == nullptr || k_pos != nullptr || window > 0))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(q, k_pages, v_pages, bt, sl, mask, o, pa, pm, B, S, H,
                       KVH, D, page, pps, split, dtype, s);
}

// Dynamic shared memory of one split-kernel CTA for (dtype, D) at up to
// 16 rows, in bytes (reported by chip_smoke.py's build phase; ptxas prints
// only static), or -1 for a head dim the kernel does not take.
extern "C" int paged_attention_smem_bytes(int dtype, int D) {
  if (dtype == repro::kFloat32)
    return D == 32    ? (int)Layout<float, 32>::bytes
           : D == 64  ? (int)Layout<float, 64>::bytes
           : D == 128 ? (int)Layout<float, 128>::bytes
           : D == 192 ? (int)Layout<float, 192>::bytes
                      : -1;
  return D == 32    ? (int)Layout<__nv_bfloat16, 32>::bytes
         : D == 64  ? (int)Layout<__nv_bfloat16, 64>::bytes
         : D == 128 ? (int)Layout<__nv_bfloat16, 128>::bytes
         : D == 192 ? (int)Layout<__nv_bfloat16, 192>::bytes
                    : -1;
}
