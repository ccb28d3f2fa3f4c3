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
// operations at every training shape.
//
// Design (simple, deterministic: no atomics, so a resumed run replays the
// same gradients). Float FMAs on tiles staged in shared memory as float
// (bf16 inputs are widened on load), four launches:
//  1. delta: one warp per query row, rowsum(dO * O) in float32.
//  2. dK / dV: one CTA per (batch, q head, 64-key tile). It loops over the
//     q tiles whose rows can see those keys (the causal and window bounds),
//     recomputes S and dP for each, and accumulates its q head's share of
//     dK and dV in registers (256 threads; thread (tx, ty) owns key rows
//     ty + 16 i and head columns tx + 16 j, so the shared-memory reads of a
//     warp are broadcasts or 16 consecutive words). The share goes to a
//     float32 scratch [B, H, Sk, D]: one CTA per q head keeps the causal
//     work per CTA even (one CTA per kv head would loop over G times as
//     many q tiles, with the first key tiles doing all of them).
//  3. reduce: dK and dV of a kv head are the sum of its G q heads' shares
//     in a fixed order, cast to the input's dtype.
//  4. dQ: one CTA per (batch, q head, 64-row q tile), looping over the key
//     tiles its rows can see; dQ stays in registers.
// S and dP are computed twice (in 2 and 4): seven products where the bound
// counts five. Tiles are 64 x 64, except at D = 192, where the q tile of
// kernel 2 and the key tile of kernel 4 are 32 rows so that the float
// tiles fit in shared memory (one CTA an SM at D >= 128).
//
// What still holds it back (PERF.md): float FMAs. At the training shape
// (qwen2-vl-2b, 1088 tokens, bf16) its seven products run at ~19 TFLOP/s
// on an H100, 28% of the float32 rate, where the bf16 tensor cores offer
// 989; the redesign on `wgmma` with TMA is ROADMAP queue B.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // 16 x 16: tx = threadIdx.x % 16, ty = / 16
constexpr int TILE = 64;      // rows of the tile a CTA owns

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

  // the query rows that can see a key of [k0, k0 + nk)
  int i_lo = 0, i_hi = p.Sq;
  if (k0 >= kmax_of(p)) i_hi = 0;
  if (p.causal) {
    i_lo = max(0, k0 - p.q_offset);
    if (p.window > 0) i_hi = min(i_hi, k0 + nk - 1 + p.window - p.q_offset);
  }
  for (int q0 = (i_lo / BQ) * BQ; q0 < i_hi; q0 += BQ) {
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

  // rows with no visible key: each adds dO / Sk to every key's dV. They are
  // the rows before position 0 (causal), past the window's reach of the
  // last key (causal window), or every row when no key is valid.
  const int kmax = kmax_of(p);
  int a = 0, c = p.Sq;  // keyless rows: [0, a) and [c, Sq)
  if (kmax <= 0) {
    a = p.Sq;
  } else if (p.causal) {
    a = min(p.Sq, max(0, -p.q_offset));
    if (p.window > 0) c = max(a, kmax + p.window - 1 - p.q_offset);
  }
  if (a > 0 || c < p.Sq) {
    __syncthreads();
    float sum[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) sum[j] = 0.0f;
    for (int i = ty; i < p.Sq; i += 16) {
      if (i >= a && i < c) continue;
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

// ------------------------------------------------------------------ 3 ---
// dk[b, kvh, s, :] = sum over the kv head's G q heads of their shares, in
// head order, cast to T (same for dv).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_reduce_kernel(const float* __restrict__ dk_part,
                  const float* __restrict__ dv_part, T* __restrict__ dk,
                  T* __restrict__ dv, Problem p, int D, Strides dks,
                  Strides dvs) {
  const long long n = (long long)p.B * p.KVH * p.Sk * D;
  const int G = p.H / p.KVH;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += (long long)gridDim.x * THREADS) {
    const int d = (int)(e % D);
    const int s = (int)((e / D) % p.Sk);
    const int kvh = (int)((e / ((long long)D * p.Sk)) % p.KVH);
    const int b = (int)(e / ((long long)D * p.Sk * p.KVH));
    float sk = 0.0f, sv = 0.0f;
    for (int g = 0; g < G; ++g) {
      const long long src =
          (((long long)b * p.H + kvh * G + g) * p.Sk + s) * D + d;
      sk += dk_part[src];
      sv += dv_part[src];
    }
    dk[b * dks.b + kvh * dks.n + s * dks.s + d] = repro::from_float<T>(sk);
    dv[b * dvs.b + kvh * dvs.n + s * dvs.s + d] = repro::from_float<T>(sv);
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
  const int q_first = q0 + p.q_offset, q_last = q0 + nq - 1 + p.q_offset;
  int lo = 0, hi = kmax_of(p);
  if (p.causal) {
    hi = min(hi, q_last + 1);
    if (p.window > 0) lo = max(0, q_first - p.window + 1);
  }
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const float* lse, const void* dout,
                   void* dq, void* dk, void* dv, float* delta,
                   float* dk_part, float* dv_part, const Problem& p,
                   const Strides* st, cudaStream_t stream) {
  constexpr int BI = inner_rows<D>();
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  // st: q, k, v, o, dout, dq, dk, dv
  const long long rows = (long long)p.B * p.H * p.Sq;
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

  const long long n = (long long)p.B * p.KVH * p.Sk * D;
  const long long want = (n + THREADS - 1) / THREADS;
  const unsigned blocks = (unsigned)(want < 132 * 16 ? want : 132 * 16);
  flash_bwd_reduce_kernel<T><<<blocks, THREADS, 0, stream>>>(
      dk_part, dv_part, static_cast<T*>(dk), static_cast<T*>(dv), p, D,
      st[6], st[7]);
  err = cudaGetLastError();
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

}  // namespace

// Gradients of flash_attention_fwd. q, o, dout, dq [B,H,Sq,D]; k, v, dk, dv
// [B,KVH,Sk,D]: views of one dtype (0 float32, 1 bfloat16) with a
// contiguous last dimension, 16-byte aligned bases and element strides
// (b, head, seq) in `strides` (24 values: q, k, v, o, dout, dq, dk, dv),
// each a multiple of 16 bytes. lse [B,H,Sq] float32 from the forward.
// Scratch: delta [B,H,Sq] and dk_part, dv_part [B,H,Sk,D], float32,
// contiguous. D in {32, 64, 128, 192}; kv_len and q_offset resolved as for
// the forward; `scale` > 0 is the softmax scale, 0 means 1/sqrt(D).
// Returns the first CUDA error of the four launches (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, float* dk_part, float* dv_part, int B, int H, int KVH,
    int Sq, int Sk, int D, int kv_len, int q_offset, int causal, int window,
    float scale, int dtype, const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Strides st[8];
  for (int i = 0; i < 8; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Problem p{B,      H,        KVH,    Sq,     Sk,
                  kv_len, q_offset, causal, window,
                  scale > 0.0f ? scale : 1.0f / sqrtf((float)D)};
#define REPRO_BWD(TT, DD)                                                    \
  if (D == DD)                                                               \
    return (int)launch<TT, DD>(q, k, v, o, lse, dout, dq, dk, dv, delta,     \
                               dk_part, dv_part, p, st, s);
  if (dtype == repro::kFloat32) {
    REPRO_BWD(float, 32)
    REPRO_BWD(float, 64)
    REPRO_BWD(float, 128)
    REPRO_BWD(float, 192)
  }
  if (dtype == repro::kBFloat16) {
    REPRO_BWD(__nv_bfloat16, 32)
    REPRO_BWD(__nv_bfloat16, 64)
    REPRO_BWD(__nv_bfloat16, 128)
    REPRO_BWD(__nv_bfloat16, 192)
  }
#undef REPRO_BWD
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the larger of the dK/dV and dQ CTAs for D (the
// same for both dtypes: tiles are staged as float), or -1.
extern "C" int flash_attention_bwd_smem_bytes(int dtype, int D) {
  (void)dtype;
  return D == 32    ? (int)smem_bytes<32>()
         : D == 64  ? (int)smem_bytes<64>()
         : D == 128 ? (int)smem_bytes<128>()
         : D == 192 ? (int)smem_bytes<192>()
                    : -1;
}
