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
//     8 predicated iterations, not 16. The CTA writes the partial
//     (m, l, acc[G, D]) of its split to float32 scratch.
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

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 32;     // tokens per cp.async stage (one per lane)
constexpr int MAXG = 16;      // query heads per kv head

template <typename T, int D>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte piece
  static constexpr int PIECES = D / VEC;      // pieces per row, >= 8
  static constexpr size_t stage = sizeof(T) * CHUNK * D;  // one K or V chunk
  static constexpr size_t q_off = 0;                      // f32 [MAXG][D]
  static constexpr size_t k_off = repro::align128(4 * MAXG * D);
  static constexpr size_t v_off = k_off + 2 * stage;
  static constexpr size_t p_off = v_off + 2 * stage;      // f32 [MAXG][CHUNK]
  static constexpr size_t c_off = p_off + 4 * MAXG * CHUNK;  // f32 [MAXG]
  static constexpr size_t kp_off = c_off + 4 * MAXG;  // int [2][CHUNK] k_pos
  static constexpr size_t bytes = kp_off + 4 * 2 * CHUNK;
  static_assert(PIECES >= 8, "the swizzle permutes 8 pieces");
  static_assert(CHUNK * PIECES % THREADS == 0, "whole pieces per thread");
};

// Shared-memory element offset of (token t, column d) in a chunk.
template <typename T, int D>
__device__ __forceinline__ int swz(int t, int d) {
  constexpr int VEC = Layout<T, D>::VEC;
  return t * D + (((d / VEC) ^ (t & 7)) * VEC) + d % VEC;
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

// GMAX (4, 8 or 16) bounds G = H / KVH, so the per-head loops run no more
// predicated-off iterations than needed (G = 6 takes GMAX = 8). MASKED
// takes k_pos (may be null), q_pos and window (the header's masked mode).
template <typename T, int D, int GMAX, bool MASKED>
__global__ void __launch_bounds__(THREADS)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp,
                       const int* __restrict__ block_table,
                       const int* __restrict__ seq_lens,
                       const int* __restrict__ k_pos,
                       const int* __restrict__ q_pos, int window,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int H, int KVH, int page,
                       int pps, int split, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* P = reinterpret_cast<float*>(smem + L::p_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::c_off);
  int* kpos_s = reinterpret_cast<int*>(smem + L::kp_off);

  // the merge kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x, G = H / KVH;
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
  const T* qr = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = threadIdx.x; i < G * D; i += THREADS)
    qs[i] = repro::to_float<T>(qr[i]) * scale;

  const int n_read = seq > 0 ? min(seq, n_tok) : n_tok;
  const int j_end = min(j_begin + split, n_read);
  // partial of query head g of this split: row (b * H + kvh * G + g) of
  // [B * H, n_splits]
  const size_t prow = ((size_t)b * H + (size_t)kvh * G) * n_splits + s;

  if (j_begin >= j_end) {  // the split holds none of the request's tokens
    if (threadIdx.x < G) {
      part_ml[2 * (prow + (size_t)threadIdx.x * n_splits)] = -INFINITY;
      part_ml[2 * (prow + (size_t)threadIdx.x * n_splits) + 1] = 0.0f;
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

  // score/softmax role: warp w owns heads w + WARPS * gi; lane = token
  constexpr int GPW = GMAX / WARPS;
  float m_r[GPW], l_r[GPW];
#pragma unroll
  for (int gi = 0; gi < GPW; ++gi) {
    m_r[gi] = -INFINITY;
    l_r[gi] = 0.0f;
  }
  // P V role: thread owns columns d2, d2 + 1 of heads set + NS * gi
  constexpr int NS = THREADS / (D / 2);
  constexpr int GPS = GMAX / NS;
  const int d2 = 2 * (threadIdx.x % (D / 2)), set = threadIdx.x / (D / 2);
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
          if (g < G) {
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
      if (g < G) {
        // past the split's tokens: not a key; seq_len 0 or a masked
        // token: the sentinel
        const float sc = lane >= nc         ? -INFINITY
                         : seq > 0 && is_key ? dot[gi]
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
      if (g < G) {
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
        if (g < G) {
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
    if (g < G && lane == 0) {
      part_ml[2 * (prow + (size_t)g * n_splits)] = m_r[gi];
      part_ml[2 * (prow + (size_t)g * n_splits) + 1] = l_r[gi];
    }
  }
#pragma unroll
  for (int gi = 0; gi < GPS; ++gi) {
    const int g = set + NS * gi;
    if (g < G)
      *reinterpret_cast<float2*>(part_acc + (prow + (size_t)g * n_splits) * D +
                                 d2) = make_float2(acc[gi][0], acc[gi][1]);
  }
}

// Merge the split partials of one (request, query head) row. The weights
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
  const size_t row = blockIdx.x;  // b * H + h
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

template <typename T, int D, int GMAX, bool MASKED>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* sl, Mask mask, void* o,
                   float* part_acc, float* part_ml, int B, int H, int KVH,
                   int page, int pps, int split, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D, GMAX, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_splits = (pps * page + split - 1) / split;
  paged_split_kernel<T, D, GMAX, MASKED>
      <<<dim3(n_splits, KVH, B), THREADS, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), bt, sl, mask.k_pos, mask.q_pos,
          mask.window, part_acc, part_ml, H, KVH, page, pps, split,
          1.0f / sqrtf((float)D));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the merge's weights, one per split, may exceed the default 48 KB
  const size_t merge_smem = sizeof(float) * n_splits;
  err = cudaFuncSetAttribute(paged_combine_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)merge_smem);
  if (err != cudaSuccess) return err;
  // programmatic dependent launch: the merge's launch overlaps the split
  // kernel's tail instead of following its end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
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

template <typename T, int D, bool MASKED>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const int* bt, const int* sl, Mask mask, void* o,
                     float* part_acc, float* part_ml, int B, int H, int KVH,
                     int page, int pps, int split, cudaStream_t stream) {
  const int G = H / KVH;
  if (G <= 4)
    return launch<T, D, 4, MASKED>(q, kp, vp, bt, sl, mask, o, part_acc,
                                   part_ml, B, H, KVH, page, pps, split,
                                   stream);
  if (G <= 8)
    return launch<T, D, 8, MASKED>(q, kp, vp, bt, sl, mask, o, part_acc,
                                   part_ml, B, H, KVH, page, pps, split,
                                   stream);
  return launch<T, D, 16, MASKED>(q, kp, vp, bt, sl, mask, o, part_acc,
                                  part_ml, B, H, KVH, page, pps, split,
                                  stream);
}

template <typename T, int D>
cudaError_t launch_m(const void* q, const void* kp, const void* vp,
                     const int* bt, const int* sl, Mask mask, void* o,
                     float* part_acc, float* part_ml, int B, int H, int KVH,
                     int page, int pps, int split, cudaStream_t stream) {
  if (mask.k_pos != nullptr || mask.window > 0)
    return launch_g<T, D, true>(q, kp, vp, bt, sl, mask, o, part_acc,
                                part_ml, B, H, KVH, page, pps, split, stream);
  return launch_g<T, D, false>(q, kp, vp, bt, sl, mask, o, part_acc, part_ml,
                               B, H, KVH, page, pps, split, stream);
}

}  // namespace

// q [B,H,D], k/v pages [P,page,KVH,D], block_table [B,pps] int32 (entries in
// [0, P)), seq_lens [B] int32, o [B,H,D]; all contiguous, one dtype
// (0 float32, 1 bfloat16), D in {64, 128}, H / KVH <= 16. Masked mode:
// k_pos [P,page] int32 or null, q_pos [B] int32 (needed when k_pos is given
// or window > 0, else may be null), window >= 0. `split` tokens per CTA
// (>= 1); part_acc [B*H, ceil(pps*page/split), D] and part_ml
// [B*H, ceil(pps*page/split), 2] are float32 scratch. Returns the CUDA error
// of the launches (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* block_table,
                                   const void* seq_lens, const void* k_pos,
                                   const void* q_pos, int window, void* o,
                                   void* part_acc, void* part_ml, int B,
                                   int H, int KVH, int D, int page, int pps,
                                   int split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  const Mask mask = {static_cast<const int*>(k_pos),
                     static_cast<const int*>(q_pos), window};
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  // the merge keeps one weight per split in shared memory: at most 192 KB
  // beside its ~2 KB of static arrays, inside a CTA's 227 KB
  if (H % KVH != 0 || H / KVH > MAXG || split < 1 ||
      (pps * page + split - 1) / split > 48 * 1024 || window < 0 ||
      ((k_pos != nullptr || window > 0) && q_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == repro::kFloat32 && D == 64)
    return launch_m<float, 64>(q, k_pages, v_pages, bt, sl, mask, o, pa, pm,
                               B, H, KVH, page, pps, split, s);
  if (dtype == repro::kFloat32 && D == 128)
    return launch_m<float, 128>(q, k_pages, v_pages, bt, sl, mask, o, pa, pm,
                                B, H, KVH, page, pps, split, s);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch_m<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, sl, mask, o,
                                       pa, pm, B, H, KVH, page, pps, split, s);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch_m<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, sl, mask, o,
                                        pa, pm, B, H, KVH, page, pps, split,
                                        s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one split-kernel CTA for (dtype, D), in bytes
// (reported by chip_smoke.py's build phase; ptxas prints only static).
extern "C" int paged_attention_smem_bytes(int dtype, int D) {
  if (dtype == repro::kFloat32)
    return D == 64 ? (int)Layout<float, 64>::bytes
                   : (int)Layout<float, 128>::bytes;
  return D == 64 ? (int)Layout<__nv_bfloat16, 64>::bytes
                 : (int)Layout<__nv_bfloat16, 128>::bytes;
}
