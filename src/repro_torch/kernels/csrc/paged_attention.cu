// Paged decode attention for Hopper (sm_90a): the port's decode kernel.
//
// Replaces the Pallas TPU kernel `paged_attention` / `_paged_kernel` of
// src/repro/kernels/paged_attention.py. Same function: one query token per
// request against a paged KV pool [P, page, KVH, D], read through
// block_table [B, pages_per_seq]; positions >= seq_lens[b] are masked; online
// softmax in float32 across pages; the G = H / KVH query heads of a kv head
// share every K/V row read.
//
// Design. On the TPU the pages are a sequential grid axis and the block
// table is a scalar-prefetch operand that drives the DMA gather. Hopper has
// no scalar prefetch: one CTA per (request, kv head) reads its own
// block_table row and seq_lens[b], gathers 64 tokens' K and V rows at a time
// (16-byte loads, any page size) into shared memory as float32, scores the G
// query rows against them, and carries (m, l, acc) across chunks in
// registers. It walks only the ceil(seq_len / page) pages that hold valid
// tokens; a request with seq_len == 0 walks every page of its table with
// every score masked, which returns the mean of V over those slots exactly
// as the reference kernel and its oracle do.
//
// What bounds it. Decode attention moves 2 * seq_len * KVH * D elements of
// K/V per request for 4 * H * seq_len * D operations: it is bounded by
// bytes. This first version runs one CTA per (request, kv head), so at small
// batch it occupies a few SMs and is bounded by their load latency, not by
// device memory bandwidth; a split over pages with a final reduction
// (flash-decoding) is the next step.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int CHUNK = 64;     // tokens staged per step
constexpr int MAXG = 16;      // query heads per kv head
constexpr int RPW = MAXG / (THREADS / 32);  // query rows per warp, at most

template <int D>
struct Layout {
  static constexpr int LDK = D + 1;  // +1: conflict-free score reads
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = repro::align128(sizeof(float) * MAXG * D);
  static constexpr size_t v_off = repro::align128(k_off + sizeof(float) * CHUNK * LDK);
  static constexpr size_t s_off = repro::align128(v_off + sizeof(float) * CHUNK * D);
  static constexpr size_t c_off = repro::align128(s_off + sizeof(float) * MAXG * CHUNK);
  static constexpr size_t l_off = c_off + sizeof(float) * MAXG;
  static constexpr size_t bytes = l_off + sizeof(float) * MAXG;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                        const T* __restrict__ vp,
                        const int* __restrict__ block_table,
                        const int* __restrict__ seq_lens, T* __restrict__ o,
                        int H, int KVH, int page, int pps, float scale) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::c_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int b = blockIdx.x, kvh = blockIdx.y, G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int seq = seq_lens[b];
  const int n_pages = seq > 0 ? min(pps, (seq + page - 1) / page) : pps;
  const int n_tok = n_pages * page;
  const int* bt = block_table + (size_t)b * pps;
  const size_t q_row0 = (size_t)b * H + (size_t)kvh * G;

  for (int i = threadIdx.x; i < G * D; i += THREADS)
    qs[i] = repro::to_float<T>(q[q_row0 * D + i]) * scale;

  float m_r[RPW], l_r[RPW];
#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    m_r[t] = repro::kNegBig;
    l_r[t] = 0.0f;
  }
  constexpr int NPER = MAXG * D / THREADS;  // (g, d) outputs per thread
  float acc[NPER];
#pragma unroll
  for (int t = 0; t < NPER; ++t) acc[t] = 0.0f;

  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int j0 = 0; j0 < n_tok; j0 += CHUNK) {
    const int nc = min(CHUNK, n_tok - j0);
    __syncthreads();  // previous chunk fully consumed (and qs written)
    // gather K/V rows of tokens j0 .. j0+nc through the block table
    for (int i = threadIdx.x; i < nc * VPR; i += THREADS) {
      const int c = i / VPR, d = (i % VPR) * VEC, j = j0 + c;
      const size_t row =
          ((size_t)bt[j / page] * page + j % page) * KVH + kvh;
      const int4 k4 = *reinterpret_cast<const int4*>(kp + row * D + d);
      const int4 v4 = *reinterpret_cast<const int4*>(vp + row * D + d);
      const T* ke = reinterpret_cast<const T*>(&k4);
      const T* ve = reinterpret_cast<const T*>(&v4);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[c * L::LDK + d + e] = repro::to_float<T>(ke[e]);
        Vs[c * D + d + e] = repro::to_float<T>(ve[e]);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * CHUNK; i += THREADS) {
      const int g = i / CHUNK, c = i % CHUNK, j = j0 + c;
      float s = -INFINITY;  // past the visited pages: not a key at all
      if (c < nc) {
        const float* qr = qs + g * D;
        const float* kr = Ks + c * L::LDK;
        float dot = 0.0f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = j < seq ? dot : repro::kNegBig;
      }
      S[i] = s;
    }
    __syncthreads();
    // one warp per query row; every lane keeps the row's m and l
#pragma unroll
    for (int t = 0; t < RPW; ++t) {
      const int g = warp + t * (THREADS / 32);
      if (g < G) {
        const float s0 = S[g * CHUNK + lane], s1 = S[g * CHUNK + lane + 32];
        const float m_new = fmaxf(m_r[t], repro::warp_max(fmaxf(s0, s1)));
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        const float sum = repro::warp_sum(p0 + p1);
        const float corr = expf(m_r[t] - m_new);
        S[g * CHUNK + lane] = p0;
        S[g * CHUNK + lane + 32] = p1;
        l_r[t] = l_r[t] * corr + sum;
        m_r[t] = m_new;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < NPER; ++t) {
      const int i = threadIdx.x + t * THREADS;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pr = S + g * CHUNK;
        float a = acc[t] * corr_s[g];
        for (int c = 0; c < nc; ++c) a = fmaf(pr[c], Vs[c * D + d], a);
        acc[t] = a;
      }
    }
  }
#pragma unroll
  for (int t = 0; t < RPW; ++t) {
    const int g = warp + t * (THREADS / 32);
    if (g < G && lane == 0) l_s[g] = l_r[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < NPER; ++t) {
    const int i = threadIdx.x + t * THREADS;
    if (i < G * D)
      o[q_row0 * D + i] =
          repro::from_float<T>(acc[t] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const int* bt, const int* sl, void* o, int B, int H,
                   int KVH, int page, int pps, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, KVH);
  paged_decode_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, sl, static_cast<T*>(o), H, KVH, page, pps,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q [B,H,D], k/v pages [P,page,KVH,D], block_table [B,pps] int32 (entries in
// [0, P)), seq_lens [B] int32, o [B,H,D]; all contiguous, one dtype
// (0 float32, 1 bfloat16), D in {64, 128}, H / KVH <= 16. Returns the CUDA
// error of the launch (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages,
                                   const void* v_pages, const void* block_table,
                                   const void* seq_lens, void* o, int B, int H,
                                   int KVH, int D, int page, int pps,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  if (H % KVH != 0 || H / KVH > MAXG) return (int)cudaErrorInvalidValue;
  if (dtype == repro::kFloat32 && D == 64)
    return launch<float, 64>(q, k_pages, v_pages, bt, sl, o, B, H, KVH, page,
                             pps, s);
  if (dtype == repro::kFloat32 && D == 128)
    return launch<float, 128>(q, k_pages, v_pages, bt, sl, o, B, H, KVH, page,
                              pps, s);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k_pages, v_pages, bt, sl, o, B, H, KVH,
                                     page, pps, s);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k_pages, v_pages, bt, sl, o, B, H,
                                      KVH, page, pps, s);
  return (int)cudaErrorInvalidValue;
}
