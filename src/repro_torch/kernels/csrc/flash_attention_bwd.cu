// Backward of the GQA flash attention kernel (flash_attention.cu) for
// Hopper (sm_90a): the gradient the port trains through.
//
// It has no Pallas counterpart: the reference trains through its jnp
// `blockwise_sdpa` (src/repro/models/attention.py:76), which JAX
// differentiates, and its Pallas flash kernel has no custom_vjp. On the
// card the port's training attention is the flash kernel, so its gradient
// is a kernel too. Same function as autograd through the plain version
// (kernels/ref.py, `flash_attention_bwd_ref`), in the closed form
//
//   P  = exp(S - lse)           S = scale * Q K^T, masked keys P = 0
//   dV = P^T dO                 summed over the kv head's G q heads
//   dP = dO V^T
//   dS = P * (dP - delta)       delta = rowsum(dO * O)
//   dQ = scale * dS K,   dK = scale * dS^T Q
//
// with `lse` the log-sum-exp of each row's scaled scores that the forward
// writes. The masks are the forward's: k < kv_len, causal k <= q + q_offset,
// window k > q + q_offset - window. A row with no visible key (the forward
// averages V over all Sk keys for it) has P = 1/Sk on every key and dS = 0:
// it adds its dO / Sk to every key's dV and nothing to dQ or dK.
//
// What bounds it. Five products of 2 * D operations per visible (query,
// key) pair on (4 Sq + 4 Sk) * D elements read or written: bounded by
// operations at every training shape, so the bf16 products must run on the
// tensor cores, whose full rate only `wgmma` reaches.
//
// Routes, chosen by (dtype, D) alone (`flash_attention_bwd_route`):
//   bfloat16, D 32 / 64 / 128   wgmma: TMA-fed tensor-core kernels
//   bfloat16, D 192             fma: dK and dV of a 64-key tile are 192
//                               float32 registers a thread in one
//                               warpgroup, beside S and dP: no room
//   float32, every D            fma: float32 FMAs, so the float32 result
//                               keeps its tight check against the plain
//                               version (as the forward's float32 path)
// A launch or build that fails on a route raises; no route falls back to
// another.
//
// wgmma route (deterministic: no atomics, fixed summation orders, so a
// resumed run replays the same gradients). Four launches:
//  1. prep: 16-byte loads, D / 8 lanes a row: delta = rowsum(dO * O) and
//     lse * log2(e), into float32 arrays padded to whole 64-row q tiles
//     (pad rows: lse +inf and delta 0, so their P and dS are 0).
//  2. dK / dV (FlashAttention-2's outer loop over keys): one CTA owns a
//     64-key tile of one (batch, kv head) and a group of that kv head's q
//     heads, and walks the (q head, q tile) pairs that can see its keys.
//     256 threads, two warpgroups: warpgroup 1 gives its registers away
//     (setmaxnreg 24 / 232) and one of its threads issues the loads: K
//     and V once (TMA), then per pair Q and dO (TMA; 128-byte swizzle,
//     64-byte at D = 32) and the tile's 64 lse and delta values (bulk
//     copies) into a ring (2 stages at D = 128, 4 below) under full /
//     empty mbarriers. Warpgroup 0 (64 key rows, 16 a warp) per pair:
//     S^T = K Q^T and dP^T = V dO^T (`wgmma`, both operands K-major in
//     shared memory); P^T = exp2(S^T scale log2e - lse log2e) on the
//     accumulators while dP^T runs, masks only on pairs that cross an
//     edge; dS^T = P^T (dP^T - delta); P^T and dS^T rounded to bf16 in
//     registers are the A operands of dV += P^T dO and dK += dS^T Q (an
//     m64n64 accumulator fragment is an m64k16 A fragment, hopper.cuh;
//     dO and Q read MN-major). dK and dV stay in float32 registers over
//     the walk (64 + 64 a thread at D = 128): with S^T and dP^T that is
//     192, so the score accumulators are zeroed before each pair's
//     products (their last values die once packed) and nothing is in
//     flight across pairs, or ptxas serialises the wgmmas for want of
//     registers. Two CTAs an SM (98 KB of shared memory each at D = 128):
//     one CTA's exp2 and packing overlap the other's products.
//     Above BWD_HILO_G = 8 q heads a kv head (granite-34b's 48), P^T and
//     dS^T each enter their product as bf16 hi + lo (two products): one
//     bf16 rounding, summed over G x Sq terms into a dK or dV element,
//     puts elements over the bf16 bars (tests/test_torch_flash_bwd_tiles.py
//     models both).
//  3. reduce (when a kv head's q heads are split over CTAs): the groups'
//     float32 shares [B, KVH, splits, Sk, D] summed in group order.
//  4. dQ: one CTA per (batch, q head, 64-row q tile), heaviest first, the
//     forward's shape: a producer warp loads Q and dO once and K / V
//     tiles into the ring; the consumer warpgroup computes S = Q K^T and
//     dP = dO V^T (`wgmma`, shared memory), P and dS on the accumulators
//     and dQ += dS K (dS bf16 from registers, K read MN-major). Two CTAs
//     an SM. (Two q tiles a CTA sharing each K / V load, one CTA an SM,
//     was slower: PERF.md §6.)
// S and dP are computed in both 2 and 4: seven products where the bound
// counts five. A dQ summed across the key tiles' CTAs by atomics would
// save two, but its bits would change from run to run.
//
// GQA (the reckoning behind 2). One CTA per (batch, q head, key tile)
// with float32 shares of every q head reduced afterwards moves
// 2 x B x H x Sk x D x 4 bytes twice: 107 MB at the training shape (B 4,
// H 12 / KVH 2, 1088 tokens, D 128), ~32 us at 3.35 TB/s, as long as the
// whole bound. One CTA per (batch, kv head, key tile) that loops over its
// G q heads needs no scratch, but gives 136 CTAs there whose causal work
// runs from 6 to 102 tile pairs: the heaviest alone takes 1.8x the mean.
// So the wrapper (`bwd_splits`) cuts each kv head's q heads into the
// fewest groups (a divisor of G) that give three CTAs an SM, launched
// heaviest key tile first so that the light ones fill in behind: 3
// groups of 2 at the training shape (408 CTAs of 2 to 34 pairs; 27 MB of
// shares written and read, ~16 us), 24 groups of 2 at G 48; one group
// writes dK and dV in bf16 itself and needs no reduce.
//
// What still holds it back (PERF.md): one consumer warpgroup a CTA (the
// tensor cores wait while it packs P and dS unless the SM's other CTA has
// products ready), each CTA streaming its own copy of the tiles it shares
// with its neighbours through L2, the recomputed S and dP of the dQ
// kernel, and the prep and reduce passes over HBM.
//
// fma route (float32, and bf16 at D 192). Float FMAs on tiles staged in
// shared memory as float (bf16 inputs widened on load), four launches:
//  1. delta: one warp per query row, rowsum(dO * O) in float32.
//  2. dK / dV: one CTA per (batch, q head, 64-key tile), looping over the
//     q tiles that can see its keys; thread (tx, ty) of 256 owns key rows
//     ty + 16 i and head columns tx + 16 j. Its q head's share goes to a
//     float32 scratch [B, H, Sk, D].
//  3. reduce: a kv head's G shares summed in head order.
//  4. dQ: one CTA per (batch, q head, 64-row q tile).
// Tiles are 64 x 64, except at D = 192, where the q tile of 2 and the key
// tile of 4 are 32 rows so that the float tiles fit in shared memory.

#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

struct Strides {
  long long b, n, s;
};

struct Problem {
  int B, H, KVH, Sq, Sk, kv_len, q_offset, causal, window;
  float scale;
};

__device__ __forceinline__ int kmax_of(const Problem& p) {
  return min(p.kv_len, p.Sk);
}

// Is key `kpos` visible to the query at absolute position `qpos`? A row
// with no visible key sees none (the caller adds its share of dV apart).
__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  if (kpos >= kmax_of(p)) return false;
  if (!p.causal) return true;
  return kpos <= qpos && (p.window <= 0 || kpos > qpos - p.window);
}

// The rows with no visible key: [0, a) and [c, Sq). They are the rows
// before position 0 (causal), past the window's reach of the last key
// (causal window), or every row when no key is valid.
struct Keyless {
  int a, c;
};

__device__ __forceinline__ Keyless keyless_rows(const Problem& p) {
  const int kmax = kmax_of(p);
  int a = 0, c = p.Sq;
  if (kmax <= 0) {
    a = p.Sq;
  } else if (p.causal) {
    a = min(p.Sq, max(0, -p.q_offset));
    if (p.window > 0) c = max(a, kmax + p.window - 1 - p.q_offset);
  }
  return {a, min(c, p.Sq)};
}

// The query rows [lo, hi) that can see a key of [k0, k0 + nk).
__device__ __forceinline__ int2 seeing_rows(const Problem& p, int k0,
                                            int nk) {
  int lo = 0, hi = p.Sq;
  if (k0 >= kmax_of(p)) hi = 0;
  if (p.causal) {
    lo = max(0, k0 - p.q_offset);
    if (p.window > 0) hi = min(hi, k0 + nk - 1 + p.window - p.q_offset);
  }
  return make_int2(lo, hi);
}

// The keys [lo, hi) that the query rows [q0, q0 + nq) can see.
__device__ __forceinline__ int2 seen_keys(const Problem& p, int q0, int nq) {
  int lo = 0, hi = kmax_of(p);
  if (p.causal) {
    hi = min(hi, q0 + nq + p.q_offset);
    if (p.window > 0) lo = max(0, q0 + p.q_offset - p.window + 1);
  }
  return make_int2(lo, hi);
}

// dk[b, kvh, s, :] = sum over the `shares` float32 shares
// part[b, kvh, i, s, :] in share order, cast to T (same for dv); four
// consecutive elements a thread (D is a multiple of 4).
template <typename T>
__global__ void __launch_bounds__(256)
    flash_bwd_reduce_kernel(const float* __restrict__ dk_part,
                            const float* __restrict__ dv_part,
                            T* __restrict__ dk, T* __restrict__ dv, int B,
                            int KVH, int Sk, int D, int shares, Strides dks,
                            Strides dvs) {
  const long long n = (long long)B * KVH * Sk * D / 4;
  for (long long e4 = (long long)blockIdx.x * 256 + threadIdx.x; e4 < n;
       e4 += (long long)gridDim.x * 256) {
    const long long e = 4 * e4;
    const int d = (int)(e % D);
    const int s = (int)((e / D) % Sk);
    const long long bk = e / ((long long)D * Sk);  // b * KVH + kvh
    const int kvh = (int)(bk % KVH), b = (int)(bk / KVH);
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int g = 0; g < shares; ++g) {
      const long long src = ((bk * shares + g) * Sk + s) * D + d;
      const float4 a = *reinterpret_cast<const float4*>(dk_part + src);
      const float4 c = *reinterpret_cast<const float4*>(dv_part + src);
      sk.x += a.x;
      sk.y += a.y;
      sk.z += a.z;
      sk.w += a.w;
      sv.x += c.x;
      sv.y += c.y;
      sv.z += c.z;
      sv.w += c.w;
    }
    T* kp = dk + b * dks.b + kvh * dks.n + s * dks.s + d;
    T* vp = dv + b * dvs.b + kvh * dvs.n + s * dvs.s + d;
    kp[0] = repro::from_float<T>(sk.x);
    kp[1] = repro::from_float<T>(sk.y);
    kp[2] = repro::from_float<T>(sk.z);
    kp[3] = repro::from_float<T>(sk.w);
    vp[0] = repro::from_float<T>(sv.x);
    vp[1] = repro::from_float<T>(sv.y);
    vp[2] = repro::from_float<T>(sv.z);
    vp[3] = repro::from_float<T>(sv.w);
  }
}

template <typename T>
cudaError_t launch_reduce(const float* dk_part, const float* dv_part, T* dk,
                          T* dv, int B, int KVH, int Sk, int D, int shares,
                          Strides dks, Strides dvs, cudaStream_t stream) {
  const long long n = (long long)B * KVH * Sk * D / 4;
  const long long want = (n + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  flash_bwd_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      dk_part, dv_part, dk, dv, B, KVH, Sk, D, shares, dks, dvs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fma route: float32, and bf16 at D = 192
// ---------------------------------------------------------------------------

namespace fma_route {

constexpr int THREADS = 256;  // 16 x 16: tx = threadIdx.x % 16, ty = / 16
constexpr int TILE = 64;      // rows of the tile a CTA owns

// 16-byte loads widened to float.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// `rows` rows of D elements (global row stride `stride`) into shared rows
// of stride LD floats; rows at or past `valid` are zero.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int rows,
                                          int valid) {
  constexpr int N = Vec<T>::N, VPR = D / N;
  for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * N;
    float x[N];
    if (r < valid) {
      Vec<T>::load(src + r * stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.0f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) dst[r * LD + c + e] = x[e];
  }
}

// S = Q K^T and dP = dO V^T of a [RQ x RK] tile pair: thread (tx, ty) owns
// rows ty + 16 i and columns tx + 16 j. Q / dO rows and K / V rows are
// shared tiles of stride LD.
template <int D, int LD, int NI, int NJ>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       float (&s)[NI][NJ],
                                       float (&dp)[NI][NJ]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[NI], ov[NI], kv[NJ], vv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      qv[i] = Qs[(ty + 16 * i) * LD + d];
      ov[i] = dOs[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      kv[j] = Ks[(tx + 16 * j) * LD + d];
      vv[j] = Vs[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// ------------------------------------------------------------------ 1 ---
// delta[b, h, i] = sum_d dO * O, one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, Problem p, int D, Strides os,
                 Strides dos) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.H * p.Sq) return;
  const int i = (int)(row % p.Sq);
  const int h = (int)((row / p.Sq) % p.H);
  const int b = (int)(row / ((long long)p.Sq * p.H));
  const T* op = o + b * os.b + h * os.n + i * os.s;
  const T* dp = dout + b * dos.b + h * dos.n + i * dos.s;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(repro::to_float(op[d]), repro::to_float(dp[d]), acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) delta[row] = acc;
}

// ------------------------------------------------------------------ 2 ---
template <int D, int BQ>
struct KVSmem {
  static constexpr int LD = D + 1;       // conflict-free column reads
  static constexpr int LDP = TILE + 1;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + 4 * TILE * LD;
  static constexpr size_t q_off = v_off + 4 * TILE * LD;
  static constexpr size_t o_off = q_off + 4 * BQ * LD;
  static constexpr size_t p_off = o_off + 4 * BQ * LD;
  static constexpr size_t ds_off = p_off + 4 * BQ * LDP;
  static constexpr size_t lse_off = ds_off + 4 * BQ * LDP;
  static constexpr size_t delta_off = lse_off + 4 * BQ;
  static constexpr size_t bytes = delta_off + 4 * BQ;
};

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk_part,
                float* __restrict__ dv_part, Problem p, Strides qs,
                Strides ks, Strides vs, Strides dos) {
  using L = KVSmem<D, BQ>;
  constexpr int LD = L::LD, NI = BQ / 16, NR = TILE / 16, NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::o_off);
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);
  float* dSs = reinterpret_cast<float*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int nk = min(TILE, p.Sk - k0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kp = k + b * ks.b + kvh * ks.n + k0 * ks.s;
  const T* vp = v + b * vs.b + kvh * vs.n + k0 * vs.s;
  const T* qp = q + b * qs.b + h * qs.n;
  const T* dop = dout + b * dos.b + h * dos.n;
  const float* lsep = lse + ((long long)b * p.H + h) * p.Sq;
  const float* deltap = delta + ((long long)b * p.H + h) * p.Sq;

  load_tile<T, D, LD>(Ks, kp, ks.s, TILE, nk);
  load_tile<T, D, LD>(Vs, vp, vs.s, TILE, nk);

  float dk[NR][NC], dv[NR][NC];
#pragma unroll
  for (int i = 0; i < NR; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[i][j] = dv[i][j] = 0.0f;

  const int2 rows = seeing_rows(p, k0, nk);
  for (int q0 = (rows.x / BQ) * BQ; q0 < rows.y; q0 += BQ) {
    const int nq = min(BQ, p.Sq - q0);
    __syncthreads();  // the previous q tile is consumed
    load_tile<T, D, LD>(Qs, qp + q0 * qs.s, qs.s, BQ, nq);
    load_tile<T, D, LD>(dOs, dop + q0 * dos.s, dos.s, BQ, nq);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      lse_s[r] = r < nq ? lsep[q0 + r] : 0.0f;
      delta_s[r] = r < nq ? deltap[q0 + r] : 0.0f;
    }
    __syncthreads();
    // rows: q rows ty + 16 i; columns: keys tx + 16 j
    float s[NI][NR], dp[NI][NR];
    scores<D, LD, NI, NR>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r + p.q_offset;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int c = tx + 16 * j;
        const bool ok = r < nq && c < nk && visible(p, qpos, k0 + c);
        const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.0f;
        Ps[r * L::LDP + c] = pr;
        dSs[r * L::LDP + c] = ok ? pr * (dp[i][j] - delta_s[r]) : 0.0f;
      }
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[NR], sv[NR];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        pv[i] = Ps[r * L::LDP + ty + 16 * i];
        sv[i] = dSs[r * L::LDP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float ov = dOs[r * LD + tx + 16 * j];
        const float qv = Qs[r * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          dv[i][j] = fmaf(pv[i], ov, dv[i][j]);
          dk[i][j] = fmaf(sv[i], qv, dk[i][j]);
        }
      }
    }
  }

  // keyless rows: each adds dO / Sk to every key's dV
  const Keyless kl = keyless_rows(p);
  if (kl.a > 0 || kl.c < p.Sq) {
    __syncthreads();
    float sum[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) sum[j] = 0.0f;
    for (int i = ty; i < p.Sq; i += 16) {
      if (i >= kl.a && i < kl.c) continue;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        sum[j] += repro::to_float(dop[i * dos.s + tx + 16 * j]);
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) Qs[ty * LD + tx + 16 * j] = sum[j];
    __syncthreads();
    const float inv = 1.0f / (float)p.Sk;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float tot = 0.0f;
      for (int t = 0; t < 16; ++t) tot += Qs[t * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < NR; ++i) dv[i][j] = fmaf(tot, inv, dv[i][j]);
    }
  }

  // this q head's share, float32 [B, H, Sk, D]
  const long long base = (((long long)b * p.H + h) * p.Sk + k0) * D;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk_part[base + (long long)r * D + tx + 16 * j] = dk[i][j] * p.scale;
      dv_part[base + (long long)r * D + tx + 16 * j] = dv[i][j];
    }
  }
}

// ------------------------------------------------------------------ 4 ---
template <int D, int BK>
struct QSmem {
  static constexpr int LD = D + 1;
  static constexpr int LDS = BK + 1;
  static constexpr size_t q_off = 0;
  static constexpr size_t o_off = q_off + 4 * TILE * LD;
  static constexpr size_t k_off = o_off + 4 * TILE * LD;
  static constexpr size_t v_off = k_off + 4 * BK * LD;
  static constexpr size_t ds_off = v_off + 4 * BK * LD;
  static constexpr size_t lse_off = ds_off + 4 * TILE * LDS;
  static constexpr size_t delta_off = lse_off + 4 * TILE;
  static constexpr size_t bytes = delta_off + 4 * TILE;
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, Problem p, Strides qs, Strides ks,
              Strides vs, Strides dos, Strides dqs) {
  using L = QSmem<D, BK>;
  constexpr int LD = L::LD, NI = TILE / 16, NJ = BK / 16, NC = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::o_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* dSs = reinterpret_cast<float*>(smem + L::ds_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KVH);
  const int nq = min(TILE, p.Sq - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kp = k + b * ks.b + kvh * ks.n;
  const T* vp = v + b * vs.b + kvh * vs.n;
  const long long row0 = ((long long)b * p.H + h) * p.Sq + q0;

  load_tile<T, D, LD>(Qs, q + b * qs.b + h * qs.n + q0 * qs.s, qs.s, TILE,
                      nq);
  load_tile<T, D, LD>(dOs, dout + b * dos.b + h * dos.n + q0 * dos.s, dos.s,
                      TILE, nq);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    lse_s[r] = r < nq ? lse[row0 + r] : 0.0f;
    delta_s[r] = r < nq ? delta[row0 + r] : 0.0f;
  }

  float acc[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  // the keys the tile's rows can see (none: every row is keyless, dq = 0)
  const int2 keys = seen_keys(p, q0, nq);
  for (int k0 = (keys.x / BK) * BK; k0 < keys.y; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous key tile is consumed
    load_tile<T, D, LD>(Ks, kp + k0 * ks.s, ks.s, BK, nk);
    load_tile<T, D, LD>(Vs, vp + k0 * vs.s, vs.s, BK, nk);
    __syncthreads();
    float s[NI][NJ], dp[NI][NJ];
    scores<D, LD, NI, NJ>(Qs, dOs, Ks, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r + p.q_offset;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        const bool ok = r < nq && c < nk && visible(p, qpos, k0 + c);
        const float pr = ok ? expf(s[i][j] * p.scale - lse_s[r]) : 0.0f;
        dSs[r * L::LDS + c] = ok ? pr * (dp[i][j] - delta_s[r]) : 0.0f;
      }
    }
    __syncthreads();
    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float sv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) sv[i] = dSs[(ty + 16 * i) * L::LDS + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float kv = Ks[c * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i) acc[i][j] = fmaf(sv[i], kv, acc[i][j]);
      }
    }
  }

  T* dqp = dq + b * dqs.b + h * dqs.n + q0 * dqs.s;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dqp[r * dqs.s + tx + 16 * j] = repro::from_float<T>(acc[i][j] * p.scale);
  }
}

// q tile of kernel 2 and key tile of kernel 4 at head dim D
template <int D> constexpr int inner_rows() { return D == 192 ? 32 : TILE; }

// scratch: delta [B, H, Sq] (padded to 64 values), then the dK and dV
// shares [B, H, Sk, D]
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* scratch,
                   const Problem& p, const Strides* st, cudaStream_t stream) {
  constexpr int BI = inner_rows<D>();
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)p.B * p.H * p.Sq;
  const long long part = (long long)p.B * p.H * p.Sk * D;
  float* delta = scratch;
  float* dk_part = scratch + (rows + 63) / 64 * 64;  // 256-byte aligned
  float* dv_part = dk_part + part;
  // st: q, k, v, o, dout, dq, dk, dv
  const unsigned delta_blocks =
      (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_bwd_delta_kernel<T><<<delta_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, p, D, st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t kv_smem = KVSmem<D, BI>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D, BI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kv_smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D, BI>
      <<<dim3((p.Sk + TILE - 1) / TILE, p.H, p.B), THREADS, kv_smem,
         stream>>>(qt, kt, vt, dot, lse, delta, dk_part, dv_part, p, st[0],
                   st[1], st[2], st[4]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_reduce<T>(dk_part, dv_part, static_cast<T*>(dk),
                         static_cast<T*>(dv), p.B, p.KVH, p.Sk, D,
                         p.H / p.KVH, st[6], st[7], stream);
  if (err != cudaSuccess) return err;

  const size_t q_smem = QSmem<D, BI>::bytes;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, BI>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_smem);
  if (err != cudaSuccess) return err;
  const dim3 q_grid((p.Sq + TILE - 1) / TILE, p.H, p.B);
  flash_bwd_dq_kernel<T, D, BI><<<q_grid, THREADS, q_smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), p, st[0], st[1],
      st[2], st[4], st[5]);
  return cudaGetLastError();
}

template <int D>
size_t smem_bytes() {
  constexpr int BI = inner_rows<D>();
  return KVSmem<D, BI>::bytes > QSmem<D, BI>::bytes ? KVSmem<D, BI>::bytes
                                                     : QSmem<D, BI>::bytes;
}

}  // namespace fma_route

// ---------------------------------------------------------------------------
// wgmma route: bf16 at D = 32, 64, 128
// ---------------------------------------------------------------------------

namespace wgmma_route {

using namespace repro::sm90;

constexpr int TILE = 64;    // keys of a dK/dV CTA, q rows of a dQ CTA, and
                            // the rows of each streamed tile
// ring depth: 2 at D = 128 (two CTAs an SM), 4 below, where a tile's
// products are short beside a TMA load's latency
template <int D> constexpr int stages() { return D == 128 ? 2 : 4; }
constexpr int WG = 128;     // threads of a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// The swizzled TMA box of a head dim, as the forward's. D >= 64: boxes of
// 64 columns (128-byte rows) with the 128-byte swizzle, D / 64 a tile row;
// D = 32: one box of 32 columns (64-byte rows), 64-byte swizzle. A box
// holds 64 rows, its 8-row groups are ROWB * 8 bytes apart, and a 16-element
// k-step is 32 bytes along a row, ROWB / 32 k-steps per box.
template <int D>
struct Box {
  static constexpr int COLS = D >= 64 ? 64 : 32;
  static constexpr uint32_t ROWB = COLS * 2;
  static constexpr uint32_t BYTES = TILE * ROWB;
  static constexpr int NC = D / COLS;
  static constexpr int KPB = ROWB / 32;
  static constexpr uint64_t LAYOUT = D >= 64 ? kSwizzle128B : kSwizzle64B;
  static constexpr uint32_t TILE_BYTES = NC * BYTES;  // [64 rows][D] bf16
  static_assert(D == 32 || D == 64 || D == 128, "wgmma route head dims");
};

template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return wgmma_desc(addr, lbo, sbo, Box<D>::LAYOUT);
}

// acc[64 x 64] = A B^T over D: A and B are [64 rows][D] tiles in shared
// memory (K-major, swizzled). One commit group.
template <int D>
__device__ __forceinline__ void issue_ss(float (&acc)[32], uint32_t a,
                                         uint32_t b) {
  using X = Box<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / X::KPB) * X::BYTES + (kk % X::KPB) * 32;
    wgmma_ss_m64n64k16(acc, desc<D>(a + off, 16, 8 * X::ROWB),
                       desc<D>(b + off, 16, 8 * X::ROWB), kk > 0);
  }
  wgmma_commit();
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&acc)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n32k16_tb(acc, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n64k16_tb(acc, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_m64n128k16_tb(acc, a, b);
}

// acc[64 x D] += A B: A [64 x 64] as bf16 fragments in registers, B a
// [64 rows][D] tile in shared memory read MN-major. Committed as one
// group, unless `commit` is false (the hi half of a hi + lo pair).
template <int D>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b, bool commit = true) {
  using X = Box<D>;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
    wgmma_rs<D>(acc, a[kk], desc<D>(b + kk * 16 * X::ROWB, X::BYTES,
                                    8 * X::ROWB));
  if (commit) wgmma_commit();
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

// A [64 x 64] float accumulator -> the bf16 A fragments of a product over
// its 64 columns: k-step kk's registers are the accumulator's n8 blocks 2kk
// and 2kk+1 (hopper.cuh).
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(x[4 * j], x[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// x = hi + lo to about 2^-16 of x: hi = bf16(x), lo = bf16(x - hi), as
// the A fragments `pack` makes.
__device__ __forceinline__ void pack_hilo(const float (&x)[32],
                                          uint32_t (&hi)[4][4],
                                          uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
      const float2 hf = __bfloat1622float2(h);
      hi[j / 2][(j % 2) * 2 + r] = *reinterpret_cast<const uint32_t*>(&h);
      lo[j / 2][(j % 2) * 2 + r] = pack_bf16(x[4 * j + 2 * r] - hf.x,
                                             x[4 * j + 2 * r + 1] - hf.y);
    }
}

struct TcProblem {
  Problem p;
  int sq_pad;      // rows of the lse / delta arrays a (batch, q head)
  int splits;      // q-head groups a kv head (dK / dV CTAs)
  float scale_log2;
};

// ------------------------------------------------------------------ 1 ---
// stats[0][row] = lse * log2(e), stats[1][row] = rowsum(dO * O), rows
// (b, h, i < sq_pad); pad rows lse +inf, delta 0. L = D / 8 lanes a row,
// one 16-byte load of O and of dO each.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ stats, TcProblem q2, Strides os,
                          Strides dos) {
  constexpr int L = D / 8, RPW = 32 / L;
  const Problem& p = q2.p;
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)p.B * p.H * q2.sq_pad;
  const long long row =
      ((long long)blockIdx.x * 8 + threadIdx.x / 32) * RPW + lane / L;
  const int i = (int)(row % q2.sq_pad);
  const long long bh = row / q2.sq_pad;
  const bool real = row < rows && i < p.Sq;
  float acc = 0.0f;
  if (real) {
    const int h = (int)(bh % p.H), b = (int)(bh / p.H), c = (lane % L) * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(o + b * os.b + h * os.n +
                                                     i * os.s + c);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + b * dos.b + h * dos.n + i * dos.s + c);
    const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(oh[e]), g = __bfloat1622float2(gh[e]);
      acc = fmaf(a.x, g.x, acc);
      acc = fmaf(a.y, g.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && lane % L == 0) {
    stats[row] = real ? lse[bh * p.Sq + i] * kLog2e : INFINITY;
    stats[rows + row] = real ? acc : 0.0f;
  }
}

// ------------------------------------------------------------------ 2 ---
template <int D>
struct KVSmem {
  static constexpr int STAGES = stages<D>();
  static constexpr uint32_t tile = Box<D>::TILE_BYTES;
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = tile;
  static constexpr uint32_t q_off = 2 * tile;                 // + s * tile
  static constexpr uint32_t do_off = q_off + STAGES * tile;   // + s * tile
  // stage s: lse * log2(e) [64], then delta [64], float32
  static constexpr uint32_t st_off = do_off + STAGES * tile;  // + s * 512
  static constexpr uint32_t bar_off = st_off + STAGES * 512;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr uint32_t n_bars = 1 + 2 * STAGES;
  // + 1 KB: the swizzled boxes need a 1024-byte aligned base
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
};

constexpr int KV_THREADS = 2 * WG;  // warpgroup 0 computes, 1 loads
// registers a thread after setmaxnreg, two CTAs an SM:
// 128 x (24 + 232) = 65,536 / 2
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 232;

// Grid (B * KVH * splits, key tiles): blockIdx.x = (b * KVH + kvh) *
// splits + group, blockIdx.y = the key tile (causal: tile 0 sees the most
// q tiles, and the CTAs of a key tile are dispatched together).
template <int D, bool HILO>
__global__ void __launch_bounds__(KV_THREADS, 2)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ stats,
                             const __nv_bfloat16* __restrict__ dout,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ part, Strides dos,
                             Strides dks, Strides dvs, TcProblem q2) {
  using L = KVSmem<D>;
  using X = Box<D>;
  constexpr int STAGES = L::STAGES;
  const Problem& p = q2.p;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::bar_off;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto q_tile = [&](int s) { return base + L::q_off + s * L::tile; };
  auto do_tile = [&](int s) { return base + L::do_off + s * L::tile; };

  const int G = p.H / p.KVH, gs = G / q2.splits;
  const int grp = blockIdx.x % q2.splits;
  const int kvh = (blockIdx.x / q2.splits) % p.KVH;
  const int b = blockIdx.x / (q2.splits * p.KVH);
  const int h0 = kvh * G + grp * gs;  // the group's first q head
  const int k0 = blockIdx.y * TILE;
  const int nk = min(TILE, p.Sk - k0);
  // the q tiles [t_lo, t_lo + nt) that can see a key of the tile, for each
  // of the group's gs heads: n (head, q tile) pairs, heads outer
  const int2 rows = seeing_rows(p, k0, nk);
  const int t_lo = rows.x / TILE;
  const int nt = rows.y > rows.x ? (rows.y + TILE - 1) / TILE - t_lo : 0;
  const int n = nt > 0 ? nt * gs : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WG / 32) {
    // ------------------------------------------- producer warpgroup ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == WG && n > 0) {
      const long long rows_all = (long long)p.B * p.H * q2.sq_pad;
      mbar_expect_tx(kv_full, 2 * L::tile);
      for (int c = 0; c < X::NC; ++c) {
        tma_load(base + L::k_off + c * X::BYTES, &tm_k, kv_full, c * X::COLS,
                 k0, kvh, b);
        tma_load(base + L::v_off + c * X::BYTES, &tm_v, kv_full, c * X::COLS,
                 k0, kvh, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, h = h0 + i / nt;
        const int q0 = (t_lo + i % nt) * TILE;
        mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::tile + 512);
        for (int c = 0; c < X::NC; ++c) {
          tma_load(q_tile(s) + c * X::BYTES, &tm_q, full(s), c * X::COLS, q0,
                   h, b);
          tma_load(do_tile(s) + c * X::BYTES, &tm_do, full(s), c * X::COLS,
                   q0, h, b);
        }
        const float* src = stats + ((long long)b * p.H + h) * q2.sq_pad + q0;
        const uint32_t dst = base + L::st_off + s * 512;
        bulk_load(dst, src, 256, full(s));
        bulk_load(dst + 256, src + rows_all, 256, full(s));
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int row0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const int key0 = k0 + row0, key1 = key0 + 8;
  const int kmax = kmax_of(p);
  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);

  if (n > 0) {
    const uint32_t k_s = base + L::k_off, v_s = base + L::v_off;
    float st[32], dp[32];   // S^T then P^T; dP^T then dS^T
    uint32_t pa[4][4], da[4][4];
    uint32_t pl[HILO ? 4 : 1][4], dl[HILO ? 4 : 1][4];
    mbar_wait(kv_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      const int q0 = (t_lo + i % nt) * TILE;
      const float* lse2 =
          reinterpret_cast<const float*>(gbase + L::st_off + s * 512);
      const float* delta = lse2 + TILE;
      mbar_wait(full(s), (i / STAGES) & 1);
      // fresh accumulators: the last tile's P^T and dS^T die once packed
      // (the products' first k-step ignores these zeros)
      zero(st);
      zero(dp);
      wgmma_fence();
      issue_ss<D>(st, k_s, q_tile(s));
      issue_ss<D>(dp, v_s, do_tile(s));
      wgmma_wait<1>();  // S^T; dP^T may run on
      fence_regs(st);
      // the pair crosses a mask edge (rows past Sq have P = 0 by their
      // lse of +inf and need no mask)
      const bool edge =
          k0 + TILE > kmax ||
          (p.causal && (k0 + TILE - 1 > q0 + p.q_offset ||
                        (p.window > 0 &&
                         k0 <= q0 + TILE - 1 + p.q_offset - p.window)));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse2 + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = e ? l2.y : l2.x;
          float p0 = fast_exp2(st[4 * j + e] * q2.scale_log2 - l);
          float p1 = fast_exp2(st[4 * j + 2 + e] * q2.scale_log2 - l);
          if (edge) {
            const int qpos = q0 + 8 * j + col0 + e + p.q_offset;
            if (!visible(p, qpos, key0)) p0 = 0.0f;
            if (!visible(p, qpos, key1)) p1 = 0.0f;
          }
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
        }
      }
      wgmma_wait<0>();  // dP^T
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(delta + 8 * j + col0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = e ? d2.y : d2.x;
          dp[4 * j + e] = st[4 * j + e] * (dp[4 * j + e] - d);
          dp[4 * j + 2 + e] = st[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d);
        }
      }
      // P^T and dS^T (float32, 64 registers) become A fragments as the
      // products are issued: the peak stays at dK + dV + 64
      fence_regs(dva);
      fence_regs(dka);
      if constexpr (HILO) {
        pack_hilo(st, pa, pl);
        wgmma_fence();
        issue_rs<D>(dva, pa, do_tile(s), false);
        issue_rs<D>(dva, pl, do_tile(s));
        pack_hilo(dp, da, dl);
        wgmma_fence();
        issue_rs<D>(dka, da, q_tile(s), false);
        issue_rs<D>(dka, dl, q_tile(s));
      } else {
        pack(st, pa);
        wgmma_fence();
        issue_rs<D>(dva, pa, do_tile(s));
        pack(dp, da);
        wgmma_fence();
        issue_rs<D>(dka, da, q_tile(s));
      }
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      mbar_arrive(empty(s));  // Q and dO of the stage are consumed
    }
  }

  // keyless rows: each of the group's heads adds dO / Sk to every key's dV
  const Keyless kl = keyless_rows(p);
  if (kl.a > 0 || kl.c < p.Sq) {
    const float inv = 1.0f / (float)p.Sk;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float s0 = 0.0f, s1 = 0.0f;
      for (int g = 0; g < gs; ++g) {
        const __nv_bfloat16* src =
            dout + b * dos.b + (h0 + g) * dos.n + 8 * j + col0;
        for (int r = 0; r < p.Sq; ++r) {
          if (r == kl.a) r = kl.c;
          if (r >= p.Sq) break;
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src + r * dos.s));
          s0 += f.x;
          s1 += f.y;
        }
      }
      dva[4 * j] += s0 * inv;
      dva[4 * j + 1] += s1 * inv;
      dva[4 * j + 2] += s0 * inv;
      dva[4 * j + 3] += s1 * inv;
    }
  }

  const float scale = p.scale;
  if (q2.splits == 1) {  // the whole kv head: dK and dV in bf16
    __nv_bfloat16* kp = dk + b * dks.b + kvh * dks.n;
    __nv_bfloat16* vp = dv + b * dvs.b + kvh * dvs.n;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      if (key0 < p.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(kp + key0 * dks.s + c) =
            __floats2bfloat162_rn(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vp + key0 * dvs.s + c) =
            __floats2bfloat162_rn(dva[4 * j], dva[4 * j + 1]);
      }
      if (key1 < p.Sk) {
        *reinterpret_cast<__nv_bfloat162*>(kp + key1 * dks.s + c) =
            __floats2bfloat162_rn(dka[4 * j + 2] * scale,
                                  dka[4 * j + 3] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vp + key1 * dvs.s + c) =
            __floats2bfloat162_rn(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  } else {  // the group's float32 share [B, KVH, splits, Sk, D]
    const long long shares = (long long)p.B * p.KVH * q2.splits * p.Sk * D;
    float* kp = part + (long long)blockIdx.x * p.Sk * D;
    float* vp = kp + shares;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col0;
      if (key0 < p.Sk) {
        *reinterpret_cast<float2*>(kp + key0 * D + c) =
            make_float2(dka[4 * j] * scale, dka[4 * j + 1] * scale);
        *reinterpret_cast<float2*>(vp + key0 * D + c) =
            make_float2(dva[4 * j], dva[4 * j + 1]);
      }
      if (key1 < p.Sk) {
        *reinterpret_cast<float2*>(kp + key1 * D + c) =
            make_float2(dka[4 * j + 2] * scale, dka[4 * j + 3] * scale);
        *reinterpret_cast<float2*>(vp + key1 * D + c) =
            make_float2(dva[4 * j + 2], dva[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------------------------ 4 ---
template <int D>
struct QSmem {
  static constexpr int STAGES = stages<D>();
  static constexpr uint32_t tile = Box<D>::TILE_BYTES;
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = tile;
  static constexpr uint32_t k_off = 2 * tile;                // + s * tile
  static constexpr uint32_t v_off = k_off + STAGES * tile;   // + s * tile
  static constexpr uint32_t bar_off = v_off + STAGES * tile;
  // q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES], v_empty[STAGES]
  static constexpr uint32_t n_bars = 1 + 4 * STAGES;
  static constexpr size_t bytes = bar_off + 8 * n_bars + 1024;
};

constexpr int Q_THREADS = WG + 32;  // + the producer warp

// Grid (H, q tiles, B), q tiles in reverse order (causal: heaviest first).
template <int D>
__global__ void __launch_bounds__(Q_THREADS, 2)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ stats,
                           __nv_bfloat16* __restrict__ dq, Strides dqs,
                           TcProblem q2) {
  using L = QSmem<D>;
  using X = Box<D>;
  constexpr int STAGES = L::STAGES;
  const Problem& p = q2.p;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base + L::q_off, do_s = base + L::do_off;
  const uint32_t bars = base + L::bar_off;
  auto k_tile = [&](int s) { return base + L::k_off + s * L::tile; };
  auto v_tile = [&](int s) { return base + L::v_off + s * L::tile; };
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8u * (1 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8u * (1 + 3 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;
  const int kvh = h / (p.H / p.KVH);
  const int nq = min(TILE, p.Sq - q0);
  const int2 keys = seen_keys(p, q0, nq);
  const int t_lo = keys.x / TILE;
  const int n = keys.y > keys.x ? (keys.y + TILE - 1) / TILE - t_lo : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), WG);
      mbar_init(v_empty(s), WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WG / 32) {
    // ------------------------------------------------ producer warp ----
    // Stage i % STAGES holds key tile i: its V is free once dP of tile i
    // is done, its K once dQ += dS K of tile i is.
    if (lane == 0 && n > 0) {
      mbar_expect_tx(q_full, 2 * L::tile);
      for (int c = 0; c < X::NC; ++c) {
        tma_load(q_s + c * X::BYTES, &tm_q, q_full, c * X::COLS, q0, h, b);
        tma_load(do_s + c * X::BYTES, &tm_do, q_full, c * X::COLS, q0, h, b);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES, k0 = (t_lo + i) * TILE;
        const uint32_t free_ph = ((i / STAGES) & 1) ^ 1;
        mbar_wait(k_empty(s), free_ph);
        mbar_expect_tx(k_full(s), L::tile);
        for (int c = 0; c < X::NC; ++c)
          tma_load(k_tile(s) + c * X::BYTES, &tm_k, k_full(s), c * X::COLS,
                   k0, kvh, b);
        mbar_wait(v_empty(s), free_ph);
        mbar_expect_tx(v_full(s), L::tile);
        for (int c = 0; c < X::NC; ++c)
          tma_load(v_tile(s) + c * X::BYTES, &tm_v, v_full(s), c * X::COLS,
                   k0, kvh, b);
      }
    }
    return;
  }

  // ------------------------------------------------ consumer warpgroup ----
  const int row0 = warp * 16 + lane / 4, col0 = 2 * (lane % 4);
  const long long rows_all = (long long)p.B * p.H * q2.sq_pad;
  const float* lse2 = stats + ((long long)b * p.H + h) * q2.sq_pad + q0;
  const float l0 = lse2[row0], l1 = lse2[row0 + 8];
  const float d0 = lse2[rows_all + row0], d1 = lse2[rows_all + row0 + 8];
  const int qpos0 = q0 + row0 + p.q_offset, qpos1 = qpos0 + 8;
  const int kmax = kmax_of(p);
  const int q_first = q0 + p.q_offset, q_last = q0 + nq - 1 + p.q_offset;
  float dqa[D / 2];
  zero(dqa);

  if (n > 0) {
    float sc[32], dp[32];   // S then P; dP then dS
    uint32_t da[4][4];
    mbar_wait(q_full, 0);
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES, k0 = (t_lo + i) * TILE;
      const uint32_t ph = (i / STAGES) & 1;
      mbar_wait(k_full(s), ph);
      mbar_wait(v_full(s), ph);
      zero(sc);
      zero(dp);
      wgmma_fence();
      issue_ss<D>(sc, q_s, k_tile(s));
      issue_ss<D>(dp, do_s, v_tile(s));
      wgmma_wait<1>();  // S; dP may run on
      fence_regs(sc);
      const bool edge =
          k0 + TILE > kmax ||
          (p.causal && (k0 + TILE - 1 > q_first ||
                        (p.window > 0 && k0 <= q_last - p.window)));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p0 = fast_exp2(sc[4 * j + e] * q2.scale_log2 - l0);
          float p1 = fast_exp2(sc[4 * j + 2 + e] * q2.scale_log2 - l1);
          if (edge) {
            const int kpos = k0 + 8 * j + col0 + e;
            if (!visible(p, qpos0, kpos)) p0 = 0.0f;
            if (!visible(p, qpos1, kpos)) p1 = 0.0f;
          }
          sc[4 * j + e] = p0;
          sc[4 * j + 2 + e] = p1;
        }
      }
      wgmma_wait<0>();  // dP
      fence_regs(dp);
      mbar_arrive(v_empty(s));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - d0);
          dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - d1);
        }
      }
      pack(dp, da);
      fence_regs(dqa);
      wgmma_fence();
      issue_rs<D>(dqa, da, k_tile(s));
      wgmma_wait<0>();
      fence_regs(dqa);
      mbar_arrive(k_empty(s));
    }
  }

  __nv_bfloat16* op = dq + b * dqs.b + h * dqs.n;
  const int r0 = q0 + row0, r1 = r0 + 8;
  const float scale = p.scale;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + col0;
    if (r0 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + r0 * dqs.s + c) =
          __floats2bfloat162_rn(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
    if (r1 < p.Sq)
      *reinterpret_cast<__nv_bfloat162*>(op + r1 * dqs.s + c) =
          __floats2bfloat162_rn(dqa[4 * j + 2] * scale,
                                dqa[4 * j + 3] * scale);
  }
}

// A 4-d map of a [B, N, S, D] bf16 view (the forward's): boxes of 64 rows
// of one (b, n), 64 columns with the 128-byte swizzle (D = 32: 32 columns,
// 64-byte swizzle), zero fill past the ends.
bool make_map(CUtensorMap* map, const void* ptr, int B, int N, int S, int D,
              const Strides& st) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.n * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {D >= 64 ? 64u : 32u, (cuuint32_t)TILE, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// scratch: lse * log2(e) and delta [2][B, H, sq_pad], then, when splits >
// 1, the dK and dV shares [2][B, KVH, splits, Sk, D]
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* scratch,
                   const Problem& p, int splits, bool hilo,
                   const Strides* st, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, q, p.B, p.H, p.Sq, D, st[0]) ||
      !make_map(&tm_k, k, p.B, p.KVH, p.Sk, D, st[1]) ||
      !make_map(&tm_v, v, p.B, p.KVH, p.Sk, D, st[2]) ||
      !make_map(&tm_do, dout, p.B, p.H, p.Sq, D, st[4]))
    return cudaErrorInvalidValue;
  const int n_qt = (p.Sq + TILE - 1) / TILE, n_kt = (p.Sk + TILE - 1) / TILE;
  const TcProblem q2{p, n_qt * TILE, splits, p.scale * kLog2e};
  const long long rows = (long long)p.B * p.H * q2.sq_pad;
  float* stats = scratch;
  float* part = scratch + 2 * rows;
  const __nv_bfloat16* dot = static_cast<const __nv_bfloat16*>(dout);
  // st: q, k, v, o, dout, dq, dk, dv
  constexpr int rows_per_block = 8 * (32 / (D / 8));
  flash_bwd_prep_kernel<D>
      <<<(unsigned)((rows + rows_per_block - 1) / rows_per_block), 256, 0,
         stream>>>(static_cast<const __nv_bfloat16*>(o), dot, lse, stats, q2,
                   st[3], st[4]);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto kv_kernel = hilo ? flash_bwd_dkdv_tc_kernel<D, true>
                        : flash_bwd_dkdv_tc_kernel<D, false>;
  err = cudaFuncSetAttribute(kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KVSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3(p.B * p.KVH * splits, n_kt), KV_THREADS, KVSmem<D>::bytes,
              stream>>>(tm_q, tm_k, tm_v, tm_do, stats, dot,
                        static_cast<__nv_bfloat16*>(dk),
                        static_cast<__nv_bfloat16*>(dv), part, st[4], st[6],
                        st[7], q2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  if (splits > 1) {
    const long long shares = (long long)p.B * p.KVH * splits * p.Sk * D;
    err = launch_reduce<__nv_bfloat16>(
        part, part + shares, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), p.B, p.KVH, p.Sk, D, splits, st[6],
        st[7], stream);
    if (err != cudaSuccess) return err;
  }

  err = cudaFuncSetAttribute(flash_bwd_dq_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)QSmem<D>::bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_tc_kernel<D>
      <<<dim3(p.H, n_qt, p.B), Q_THREADS, QSmem<D>::bytes, stream>>>(
          tm_q, tm_k, tm_v, tm_do, stats, static_cast<__nv_bfloat16*>(dq),
          st[5], q2);
  return cudaGetLastError();
}

template <int D>
size_t smem_bytes() {
  return KVSmem<D>::bytes > QSmem<D>::bytes ? KVSmem<D>::bytes
                                            : QSmem<D>::bytes;
}

}  // namespace wgmma_route

bool tc_route(int dtype, int D) {
  return dtype == repro::kBFloat16 && (D == 32 || D == 64 || D == 128);
}

}  // namespace

// Gradients of flash_attention_fwd. q, o, dout, dq [B,H,Sq,D]; k, v, dk, dv
// [B,KVH,Sk,D]: views of one dtype (0 float32, 1 bfloat16) with a
// contiguous last dimension, 16-byte aligned bases and element strides
// (b, head, seq) in `strides` (24 values: q, k, v, o, dout, dq, dk, dv),
// each a multiple of 16 bytes. lse [B,H,Sq] float32 from the forward.
// D in {32, 64, 128, 192}; kv_len and q_offset resolved as for the
// forward; `scale` > 0 is the softmax scale, 0 means 1/sqrt(D). wgmma
// route: `splits` (a divisor of H / KVH) is the number of q-head groups a
// kv head's dK / dV is cut into, and `hilo` != 0 splits the P^T and dS^T
// operands of dV and dK into bf16 hi + lo parts. `scratch` is float32 and
// 256-byte aligned: fma route delta [B,H,Sq] padded to a multiple of 64
// values, then the q heads' dK and dV shares 2 x [B,H,Sk,D]; wgmma route
// lse * log2(e) and delta 2 x [B,H,Sq_pad] (Sq rounded up to 64), then,
// when splits > 1, the groups' shares 2 x [B,KVH,splits,Sk,D] (the
// wrapper's `bwd_scratch_floats`). Returns the first CUDA error of the
// launches (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* scratch, int B, int H, int KVH, int Sq, int Sk, int D, int kv_len,
    int q_offset, int causal, int window, float scale, int dtype,
    const long long* strides, int splits, int hilo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Problem p{B,      H,        KVH,    Sq,     Sk,
                  kv_len, q_offset, causal, window,
                  scale > 0.0f ? scale : 1.0f / sqrtf((float)D)};
  if (tc_route(dtype, D)) {
    if (splits < 1 || (H / KVH) % splits) return (int)cudaErrorInvalidValue;
#define REPRO_TC(DD)                                                         \
  if (D == DD)                                                               \
    return (int)wgmma_route::launch<DD>(q, k, v, o, lse, dout, dq, dk, dv,   \
                                        scratch, p, splits, hilo != 0,   \
                                        st, s);
    REPRO_TC(32)
    REPRO_TC(64)
    REPRO_TC(128)
#undef REPRO_TC
  }
#define REPRO_BWD(TT, DD)                                                    \
  if (D == DD)                                                               \
    return (int)fma_route::launch<TT, DD>(q, k, v, o, lse, dout, dq, dk,    \
                                          dv, scratch, p, st, s);
  if (dtype == repro::kFloat32) {
    REPRO_BWD(float, 32)
    REPRO_BWD(float, 64)
    REPRO_BWD(float, 128)
    REPRO_BWD(float, 192)
  }
  if (dtype == repro::kBFloat16) {
    REPRO_BWD(__nv_bfloat16, 192)
  }
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// 1 when (dtype, D) takes the wgmma route, 0 for the fma route.
extern "C" int flash_attention_bwd_route(int dtype, int D) {
  return tc_route(dtype, D) ? 1 : 0;
}

// Dynamic shared memory of the larger of the dK/dV and dQ CTAs for
// (dtype, D), or -1.
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int D) {
  if (tc_route(dtype, D))
    return D == 32 ? (int)wgmma_route::smem_bytes<32>()
           : D == 64 ? (int)wgmma_route::smem_bytes<64>()
                     : (int)wgmma_route::smem_bytes<128>();
  return D == 32    ? (int)fma_route::smem_bytes<32>()
         : D == 64  ? (int)fma_route::smem_bytes<64>()
         : D == 128 ? (int)fma_route::smem_bytes<128>()
         : D == 192 ? (int)fma_route::smem_bytes<192>()
                    : -1;
}
