// Tiled GQA flash attention for Hopper (sm_90a): the port's prefill kernel.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py. Same function: online softmax
// (running max m, sum l and output accumulator in float32), scale 1/sqrt(D),
// masks k < kv_len, causal k <= q + q_offset, window k > q + q_offset - window.
//
// Design. The TPU grid walks kv-blocks in order and carries (m, l, acc) in
// VMEM scratch across grid steps; Hopper's CTAs run in no order, so one CTA
// owns one (batch, q-head, 64-row q tile) and loops over 64-key tiles
// itself. q-head h reads kv-head h / (H / KVH) (GQA), never a repeated copy.
// Tiles are staged in shared memory; bfloat16 products run on the tensor
// cores through WMMA (16x16x16, float32 accumulation), float32 inputs take
// a plain FMA path so the float32 result can be checked tightly. Only the
// key tiles a q tile can see are visited (causal and window bounds), which
// halves the work of a causal prefill.
//
// What bounds it. Prefill attention is bounded by operations (4*Sq*Sk*D/2
// per head causal, against Sq*D + 2*Sk*D elements moved). This first
// version stages tiles synchronously (no cp.async/TMA pipeline) and runs
// mma.sync-class WMMA rather than wgmma, so it sits well below the bf16
// tensor-core peak; the tiles are sized for 2 CTAs per SM.
//
// Rows with no valid key: the reference kernels visit every key and return
// the mean of V for such a row. When a q tile holds such a row this kernel
// visits all Sk keys too, with the same -1e30 sentinel, and so agrees.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps; warp w owns q rows 16w..16w+15
constexpr int LDS = BK + 4;   // float score row stride
constexpr int LDP = BK + 8;   // bf16 probability row stride
static_assert(LDP * 2 <= LDS * 4, "bf16 P rows must fit in the score rows");

// Shared-memory row strides. Rows of D bf16 (or D floats) would start on
// the same bank; +8 bf16 (+4 floats) shifts each row by 16 bytes, so the
// 8 rows a WMMA fragment load reads land on distinct banks.
template <typename T, int D>
struct Layout {
  static constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int LDQ = kTC ? D + 8 : D;
  static constexpr int LDK = kTC ? D + 8 : D + 1;  // +1: conflict-free FMA
  static constexpr int LDV = kTC ? D + 8 : D;
  static constexpr int LDO = D + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = repro::align128(q_off + sizeof(T) * BQ * LDQ);
  static constexpr size_t v_off = repro::align128(k_off + sizeof(T) * BK * LDK);
  static constexpr size_t s_off = repro::align128(v_off + sizeof(T) * BK * LDV);
  // the bf16 probabilities overwrite the scores they come from
  static constexpr size_t p_off = s_off;
  static constexpr size_t o_off = repro::align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t c_off = repro::align128(o_off + sizeof(float) * BQ * LDO);
  static constexpr size_t l_off = c_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
};

// Copy 64 rows of D elements (global row stride D) into shared rows of
// stride LD, 16 bytes per load; rows at or past `valid` are zero.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const int4*>(src + (size_t)r * D + c);
    if constexpr (LD % VEC == 0) {
      *reinterpret_cast<int4*>(dst + r * LD + c) = val;
    } else {
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[r * LD + c + j] = e[j];
    }
  }
}

// S = Q K^T (raw dot products) on the tensor cores: warp w computes its
// 16 rows x 64 keys.
template <int D, int LDQ, int LDK>
__device__ __forceinline__ void scores_tc(const __nv_bfloat16* Qs,
                                          const __nv_bfloat16* Ks, float* S) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, Qs + warp * 16 * LDQ + kk * 16, LDQ);
      wmma::load_matrix_sync(b, Ks + j * 16 * LDK + kk * 16, LDK);  // K^T
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(S + warp * 16 * LDS + j * 16, acc, LDS,
                            wmma::mem_row_major);
  }
}

// S = Q K^T in float32 FMA.
template <int D>
__device__ __forceinline__ void scores_fma(const float* Qs, const float* Ks,
                                           float* S) {
  for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    const float* qr = Qs + r * D;
    const float* kr = Ks + c * (D + 1);
    float acc = 0.0f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
    S[r * LDS + c] = acc;
  }
}

// Online-softmax step for one key tile. Threads 2r and 2r+1 own q row r
// (32 keys each) and keep its running max m and sum l in registers; the
// row's rescale factor goes to corr_s for the P.V step. Keys at or past
// Sk do not exist (p = 0); masked keys score -1e30. P is written over the
// score buffer (bf16 rows of stride LDP for the tensor cores).
template <bool TC>
__device__ __forceinline__ void softmax_tile(float* S, __nv_bfloat16* Pb,
                                             float* corr_s, float& m, float& l,
                                             int k0, int Sk, int qpos,
                                             int kv_len, int causal,
                                             int window, float scale) {
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float sv[BK / 2];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int c = half * (BK / 2) + i, kpos = k0 + c;
    float s = -INFINITY;
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
  __syncthreads();  // every score is read before P overwrites the buffer
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int c = half * (BK / 2) + i;
    const float p = expf(sv[i] - m_new);
    sum += p;
    if constexpr (TC) {
      Pb[r * LDP + c] = __float2bfloat16(p);
    } else {
      S[r * LDS + c] = p;
    }
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  const float corr = expf(m - m_new);
  l = l * corr + sum;
  m = m_new;
  if (half == 0) corr_s[r] = corr;
}

// O = O * corr + P V on the tensor cores: warp w rescales and updates its
// own 16 rows, with the accumulator fragments round-tripping through the
// float32 O tile in shared memory.
template <int D, int LDV, int LDO>
__device__ __forceinline__ void pv_tc(const __nv_bfloat16* Pb,
                                      const __nv_bfloat16* Vs, float* O,
                                      const float* corr_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = warp * 16 + i / D;
    O[r * LDO + i % D] *= corr_s[r];
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, O + warp * 16 * LDO + n * 16, LDO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
      wmma::load_matrix_sync(a, Pb + warp * 16 * LDP + kk * 16, LDP);
      wmma::load_matrix_sync(b, Vs + kk * 16 * LDV + n * 16, LDV);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(O + warp * 16 * LDO + n * 16, acc, LDO,
                            wmma::mem_row_major);
  }
}

// O = O * corr + P V in float32 FMA (P in the score buffer).
template <int D, int LDO>
__device__ __forceinline__ void pv_fma(const float* P, const float* Vs,
                                       float* O, const float* corr_s) {
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const float* pr = P + r * LDS;
    float acc = O[r * LDO + d] * corr_s[r];
#pragma unroll 16
    for (int c = 0; c < BK; ++c) acc = fmaf(pr[c], Vs[c * D + d], acc);
    O[r * LDO + d] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int KVH, int Sq, int Sk, int kv_len, int q_offset,
                     int causal, int window, float scale) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* S = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* Pb = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* O = reinterpret_cast<float*>(smem + L::o_off);
  float* corr_s = reinterpret_cast<float*>(smem + L::c_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int nq = min(BQ, Sq - q0);
  const T* qp = q + ((size_t)(b * H + h) * Sq + q0) * D;
  const T* kp = k + (size_t)(b * KVH + kvh) * Sk * D;
  const T* vp = v + (size_t)(b * KVH + kvh) * Sk * D;

  load_tile<T, D, L::LDQ>(Qs, qp, nq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) O[i] = 0.0f;

  // The keys this q tile can see: [lo, hi).
  const int kmax = min(kv_len, Sk);
  const int q_first = q0 + q_offset, q_last = q0 + nq - 1 + q_offset;
  int lo = 0, hi = kmax;
  bool empty_row = kmax <= 0;
  if (causal) {
    hi = min(kmax, q_last + 1);
    if (window > 0) lo = max(0, q_first - window + 1);
    empty_row = empty_row || q_first < 0 ||
                (window > 0 && q_last - window + 1 >= kmax);
  }
  if (empty_row || hi <= lo) {  // some row sees no key: visit all Sk keys
    lo = 0;
    hi = Sk;
  }

  float m = repro::kNegBig, l = 0.0f;
  const int qpos = q0 + (threadIdx.x >> 1) + q_offset;
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    const int nk = min(BK, Sk - k0);
    __syncthreads();  // previous tile fully consumed
    load_tile<T, D, L::LDK>(Ks, kp + (size_t)k0 * D, nk);
    load_tile<T, D, L::LDV>(Vs, vp + (size_t)k0 * D, nk);
    __syncthreads();
    if constexpr (L::kTC) {
      scores_tc<D, L::LDQ, L::LDK>(Qs, Ks, S);
    } else {
      scores_fma<D>(Qs, Ks, S);
    }
    __syncthreads();
    softmax_tile<L::kTC>(S, Pb, corr_s, m, l, k0, Sk, qpos, kv_len, causal,
                         window, scale);
    __syncthreads();
    if constexpr (L::kTC) {
      pv_tc<D, L::LDV, L::LDO>(Pb, Vs, O, corr_s);
    } else {
      pv_fma<D, L::LDO>(S, Vs, O, corr_s);
    }
  }
  if ((threadIdx.x & 1) == 0) l_s[threadIdx.x >> 1] = l;
  __syncthreads();
  T* op = o + ((size_t)(b * H + h) * Sq + q0) * D;
  for (int i = threadIdx.x; i < nq * D; i += THREADS) {
    const int r = i / D;
    op[i] = repro::from_float<T>(O[r * L::LDO + i % D] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int Sq, int Sk, int kv_len,
                   int q_offset, int causal, int window, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, Sq, Sk, kv_len,
      q_offset, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// q [B,H,Sq,D], k/v [B,KVH,Sk,D], o [B,H,Sq,D], all contiguous, of one
// dtype (0 float32, 1 bfloat16), D in {64, 128}. kv_len and q_offset are
// already resolved as the Pallas wrapper resolves them. Returns the CUDA
// error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int KVH, int Sq,
                                   int Sk, int D, int kv_len, int q_offset,
                                   int causal, int window, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32 && D == 64)
    return launch<float, 64>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len, q_offset,
                             causal, window, s);
  if (dtype == repro::kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len, q_offset,
                              causal, window, s);
  if (dtype == repro::kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len,
                                     q_offset, causal, window, s);
  if (dtype == repro::kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KVH, Sq, Sk, kv_len,
                                      q_offset, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
