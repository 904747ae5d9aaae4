// Flash-attention prefill kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/flash_prefill.py:_kernel
// (entry flash_prefill). Packed-GQA attention: q [B, G, S, R, hd] is viewed
// as [B*G, S*R, hd] rows against k/v [B, G, T, hd]; row r of (b, g) has
// sequence position q_offset + r / R and attends keys kpos <= qpos (causal),
// kpos > qpos - window (window > 0), or every key (non-causal). Online
// softmax in float32; the output is cast to q's dtype.
//
// Bound: compute at long sequences (4 * S * R * T * hd flops against
// (S * R + 2 * T) * hd elements moved). Design: grid (B*G, ceil(S*R / BM)),
// one block per BM = 64 query rows. The Pallas tiling (q_block * R = 256
// rows of f32 accumulators, 128 KB) does not fit a Hopper SM's registers, so
// each of the 256 threads owns a 4-row x (HD/16)-column slice of the
// output accumulator in registers and a 4 x 4 slice of each 64 x 64 score
// tile. Q, K, V and the probabilities live in shared memory as f32 with
// padded row strides (conflict-free reads); products are plain f32 FMAs.
// The kv loop visits only tiles inside the causal / window bound of the
// block's rows. q, k and v are read through their strides, so the model's
// moveaxis views need no copy. Later work: bf16 tensor-core products
// (mma.sync, then wgmma with TMA-fed tiles).

#include <stdint.h>

#include "common.cuh"

namespace relserve {
namespace {

constexpr int NT = 256;   // threads: 16 x 16
constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // keys per tile

template <int HD>
struct Smem {
  static constexpr int QS = HD + 4;   // q row stride (floats)
  static constexpr int KS = HD + 1;   // k row stride
  static constexpr int PS = BN + 4;   // probability row stride
  static constexpr int bytes =
      (BM * QS + BN * KS + BN * HD + BM * PS) * int(sizeof(float));
};

// Load `n_rows` rows of HD elements (row i at base + i * stride) into f32
// shared memory with row stride `dst_stride`; rows past `n_rows` are
// zero-filled. Neighbouring threads take neighbouring rows, so the scalar
// shared stores are conflict-free at an odd row stride.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const T* base, long long stride,
                                          int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int row = c % ROWS, j = c / ROWS;
    float vals[VEC];
    if (row < n_rows) {
      const uint4 raw =
          reinterpret_cast<const uint4*>(base + row * stride)[j];
      unpack16<T>(raw, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[row * dst_stride + j * VEC + e] = vals[e];
  }
}

// Same, into rows of exactly HD floats: row-major over chunks with 16-byte
// shared stores, so a warp's stores are contiguous instead of all landing in
// one bank.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows_dense(float* dst, const T* base,
                                                long long stride, int n_rows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int row = c / CPR, j = c % CPR;
    float vals[VEC];
    if (row < n_rows) {
      const uint4 raw =
          reinterpret_cast<const uint4*>(base + row * stride)[j];
      unpack16<T>(raw, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + row * HD + j * VEC);
#pragma unroll
    for (int e = 0; e < VEC / 4; ++e)
      d4[e] = make_float4(vals[4 * e], vals[4 * e + 1], vals[4 * e + 2],
                          vals[4 * e + 3]);
  }
}

// Rows of q are addressed through (s, r) = (row / R, row % R).
template <typename T, int HD>
__device__ __forceinline__ void load_q(float* dst, const T* q, long long sqs,
                                       long long sqr, int R, int row0,
                                       int n_rows, float scale) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = HD / VEC;
  for (int c = threadIdx.x; c < BM * CPR; c += NT) {
    const int row = c % BM, j = c / BM;
    float vals[VEC];
    if (row < n_rows) {
      const int rr = row0 + row;
      const T* src = q + (long long)(rr / R) * sqs + (long long)(rr % R) * sqr;
      unpack16<T>(reinterpret_cast<const uint4*>(src)[j], vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      dst[row * Smem<HD>::QS + j * VEC + e] = vals[e] * scale;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int G,
                     int S, int R, int T_len, long long sqb, long long sqg,
                     long long sqs, long long sqr, long long skb,
                     long long skg, long long skt, long long svb,
                     long long svg, long long svt, int causal, int window,
                     int q_offset, float scale) {
  using SM = Smem<HD>;
  constexpr int DJ = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BM][QS]
  float* Ks = Qs + BM * SM::QS;                 // [BN][KS]
  float* Vs = Ks + BN * SM::KS;                 // [BN][HD]
  float* Ps = Vs + BN * HD;                     // [BM][PS]

  const int bg = blockIdx.x;
  const int b = bg / G, g = bg % G;
  const int SR = S * R;
  const int row0 = blockIdx.y * BM;
  const int n_rows = min(BM, SR - row0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const T* qb = q + b * sqb + g * sqg;
  const T* kb = k + b * skb + g * skg;
  const T* vb = v + b * svb + g * svg;
  load_q<T, HD>(Qs, qb, sqs, sqr, R, row0, n_rows, scale);

  // kv range the block's rows can see
  const int qpos_lo = q_offset + row0 / R;
  const int qpos_hi = q_offset + (row0 + n_rows - 1) / R;
  const int k_end = causal ? min(T_len, qpos_hi + 1) : T_len;
  const int k_begin = window > 0 ? max(0, qpos_lo - window + 1) : 0;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = q_offset + (row0 + ty * 4 + i) / R;

  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (k_begin / BN) * BN; k0 < k_end; k0 += BN) {
    const int nk = min(BN, T_len - k0);
    __syncthreads();   // previous tile consumed (and Qs stored)
    load_rows<T, HD, BN>(Ks, SM::KS, kb + k0 * skt, skt, nk);
    load_rows_dense<T, HD, BN>(Vs, vb + k0 * svt, svt, nk);
    __syncthreads();

    // S = Q K^T on this thread's 4 x 4 slice: rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * SM::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * SM::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
    }

    // mask, then online softmax across the 16 threads sharing each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < T_len;
        if (causal) ok = ok && kpos <= qpos[i];
        if (window > 0) ok = ok && kpos > qpos[i] - window;
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * SM::PS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += P V on rows ty*4+i, columns tx+16*j (keys past T are zero rows)
#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * SM::PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += p[i] * vv[j];
    }
  }

  T* ob = out + ((long long)bg * SR + row0) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)row * HD + tx + 16 * j] = from_float<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int G, int S, int R, int T_len, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  const int smem = Smem<HD>::bytes;
  auto kernel = flash_prefill_kernel<T, HD>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = allow_shared(kernel, smem, granted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * G, (S * R + BM - 1) / BM);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), G, S, R, T_len, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], causal,
      window, q_offset, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int G, int S, int R, int T_len, const long long* st,
              int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace relserve

// Strides are in elements: q (b, g, s, r), k (b, g, t), v (b, g, t); the
// head dim is contiguous everywhere and out is contiguous [B, G, S, R, hd].
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* out, int B, int G,
    int S, int R, int T_len, int hd, long long sqb, long long sqg,
    long long sqs, long long sqr, long long skb, long long skg,
    long long skt, long long svb, long long svg, long long svt, int causal,
    int window, int q_offset, float scale, int dtype, void* stream) {
  using namespace relserve;
  const long long st[10] = {sqb, sqg, sqs, sqr, skb, skg, skt, svb, svg, svt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || G == 0 || S == 0 || R == 0) return 0;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, B, G, S, R, T_len, st, causal,
                            window, q_offset, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, G, S, R, T_len, st,
                                    causal, window, q_offset, scale, s);
  return int(cudaErrorInvalidValue);
}
