// RWKV6 chunked-WKV kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_chunk.py:_kernel (entry
// rwkv6_chunk), which computes what the RWKV6 model's prefill runs once per
// chunk (src/repro/models/rwkv6.py:wkv6_chunk). For one (batch, head) and a
// chunk of c tokens, all in float32:
//   ldi = cumsum_t(logw), lde = ldi - logw         (inclusive / exclusive)
//   A[t,j] = sum_k r[t,k] k[j,k] exp(min(lde[t,k] - ldi[j,k], 0))   (j < t)
//   A[t,t] = sum_k r[t,k] k[t,k] u[k]
//   o = (r * exp(lde)) @ S + A @ v
//   S' = exp(ldi[c-1]) * S + (k * exp(ldi[c-1] - ldi))^T @ v
//
// Bound: bytes. Per launch it reads r/k/v/logw ([B, c, H, K]), u and the
// [B, H, K, V] f32 state and writes o and the new state; at the model's
// [1, 16, 64, 64] the state alone is 2.1 MB of the 3.0 MB moved, against
// ~21 MFLOP. Design: one block per (b, h), everything in shared memory.
// The Pallas body holds a [c, c, K] f32 decay tile (1 MB at c = K = 64, more
// than an SM's 227 KB), so here the decays are never stored: each thread
// owns (t, j) pairs of A and computes exp on the fly while it loops over k
// (c*c*K/2 exps per block). Rows of r, k, ldi and lde use an odd stride
// (K + 1), so a warp reading column k of 32 rows hits 32 banks. o and S' are
// plain f32 FMAs. r/k/v/logw are read through their (batch, time, head)
// strides, so the model's chunk slices of [B, S, H, K] need no copy. Later
// work: one launch per layer that walks all chunks with the state kept on
// chip, instead of one launch per chunk that moves the whole state.

#include <stdint.h>

#include "common.cuh"

namespace relserve {
namespace {

constexpr int NT = 256;

// Shared floats: r, k, ldi, lde as [c][K + 1]; v as [c][V]; the state as
// [K][V]; A as [c][c + 1].
inline int smem_floats(int c, int K, int V) {
  return 4 * c * (K + 1) + c * V + K * V + c * (c + 1);
}

template <typename TI, typename TW, typename TO>
__global__ void __launch_bounds__(NT)
rwkv6_chunk_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                   const TI* __restrict__ v, const TW* __restrict__ logw,
                   const float* __restrict__ u,
                   const float* __restrict__ state, TO* __restrict__ out,
                   float* __restrict__ state_out, int H, int c, int K, int V,
                   long long srb, long long srt, long long srh,
                   long long skb, long long skt, long long skh,
                   long long svb, long long svt, long long svh,
                   long long swb, long long swt, long long swh) {
  extern __shared__ __align__(16) float sm[];
  const int KP = K + 1, AP = c + 1;
  float* Rs = sm;               // r, then r * exp(lde)
  float* Ks = Rs + c * KP;      // k, then k * exp(ldi[c-1] - ldi)
  float* Li = Ks + c * KP;      // ldi
  float* Le = Li + c * KP;      // logw, then lde
  float* Vs = Le + c * KP;      // [c][V]
  float* Ss = Vs + c * V;       // [K][V]
  float* As = Ss + K * V;       // [c][AP]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;

  const TI* rb = r + b * srb + h * srh;
  const TI* kb = k + b * skb + h * skh;
  const TI* vb = v + b * svb + h * svh;
  const TW* wb = logw + b * swb + h * swh;
  for (int i = tid; i < c * K; i += NT) {
    const int t = i / K, kk = i % K;
    Rs[t * KP + kk] = to_float(rb[t * srt + kk]);
    Ks[t * KP + kk] = to_float(kb[t * skt + kk]);
    Le[t * KP + kk] = to_float(wb[t * swt + kk]);
  }
  for (int i = tid; i < c * V; i += NT) {
    const int t = i / V, j = i % V;
    Vs[t * V + j] = to_float(vb[t * svt + j]);
  }
  const float* sb = state + (long long)bh * K * V;
  for (int i = tid; i < K * V; i += NT) Ss[i] = sb[i];
  __syncthreads();

  // cumulative log-decays over the chunk, one channel per thread, in token
  // order as the reference's cumsum
  for (int kk = tid; kk < K; kk += NT) {
    float acc = 0.f;
    for (int t = 0; t < c; ++t) {
      const float w = Le[t * KP + kk];
      acc += w;
      Li[t * KP + kk] = acc;
      Le[t * KP + kk] = acc - w;
    }
  }
  __syncthreads();

  // intra-chunk A: strictly lower part with the decay computed on the fly,
  // the bonus u on the diagonal, zeros above
  const float* uh = u + h * K;
  for (int p = tid; p < c * c; p += NT) {
    const int t = p / c, j = p % c;
    float a = 0.f;
    if (j < t) {
      for (int kk = 0; kk < K; ++kk)
        a += Rs[t * KP + kk] * Ks[j * KP + kk] *
             expf(fminf(Le[t * KP + kk] - Li[j * KP + kk], 0.f));
    } else if (j == t) {
      for (int kk = 0; kk < K; ++kk)
        a += Rs[t * KP + kk] * Ks[t * KP + kk] * uh[kk];
    }
    As[t * AP + j] = a;
  }
  __syncthreads();

  for (int i = tid; i < c * K; i += NT) {
    const int t = i / K, kk = i % K;
    Rs[t * KP + kk] *= expf(Le[t * KP + kk]);
    Ks[t * KP + kk] *= expf(Li[(c - 1) * KP + kk] - Li[t * KP + kk]);
  }
  __syncthreads();

  // o[t, :] = (r * exp(lde))[t] @ S + A[t, :t+1] @ v; o is [B, c, H, V]
  for (int i = tid; i < c * V; i += NT) {
    const int t = i / V, vv = i % V;
    float acc = 0.f;
    for (int kk = 0; kk < K; ++kk) acc += Rs[t * KP + kk] * Ss[kk * V + vv];
    for (int j = 0; j <= t; ++j) acc += As[t * AP + j] * Vs[j * V + vv];
    out[((long long)(b * c + t) * H + h) * V + vv] = from_float<TO>(acc);
  }

  // S'[kk, :] = exp(ldi[c-1, kk]) S[kk, :] + sum_j ks[j, kk] v[j, :]
  float* so = state_out + (long long)bh * K * V;
  for (int i = tid; i < K * V; i += NT) {
    const int kk = i / V, vv = i % V;
    float acc = Ss[i] * expf(Li[(c - 1) * KP + kk]);
    for (int j = 0; j < c; ++j) acc += Ks[j * KP + kk] * Vs[j * V + vv];
    so[i] = acc;
  }
}

template <typename TI, typename TW, typename TO>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, const float* state, void* out, float* state_out,
           int B, int c, int H, int K, int V, const long long* st,
           cudaStream_t stream) {
  const int smem = smem_floats(c, K, V) * int(sizeof(float));
  auto kernel = rwkv6_chunk_kernel<TI, TW, TO>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = allow_shared(kernel, smem, granted);
  if (err != cudaSuccess) return int(err);
  kernel<<<B * H, NT, smem, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TW*>(logw), u, state,
      static_cast<TO*>(out), state_out, H, c, K, V, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return int(cudaGetLastError());
}

template <typename TI, typename TW>
int launch_out(int out_dtype, const void* r, const void* k, const void* v,
               const void* logw, const float* u, const float* state,
               void* out, float* state_out, int B, int c, int H, int K, int V,
               const long long* st, cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<TI, TW, float>(r, k, v, logw, u, state, out, state_out, B,
                                 c, H, K, V, st, stream);
  if (out_dtype == 1)
    return launch<TI, TW, __nv_bfloat16>(r, k, v, logw, u, state, out,
                                         state_out, B, c, H, K, V, st, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace relserve

// r/k/logw [B, c, H, K] and v [B, c, H, V], read through their (batch, time,
// head) strides in elements with the last dim contiguous; u [H, K] and state
// [B, H, K, V] contiguous float32; out [B, c, H, V] and state_out contiguous.
// dtypes: 0 = float32, 1 = bfloat16; r, k and v share in_dtype, logw is
// float32 or in_dtype. Returns cudaGetLastError() after the launch.
extern "C" int rwkv6_chunk_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state, void* out, void* state_out, int B,
    int c, int H, int K, int V, long long srb, long long srt, long long srh,
    long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, long long swb, long long swt,
    long long swh, int in_dtype, int w_dtype, int out_dtype, void* stream) {
  using namespace relserve;
  const long long st[12] = {srb, srt, srh, skb, skt, skh,
                            svb, svt, svh, swb, swt, swh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(state);
  float* so = static_cast<float*>(state_out);
  if (B == 0 || H == 0) return 0;
  if (in_dtype == 0 && w_dtype == 0)
    return launch_out<float, float>(out_dtype, r, k, v, logw, uf, sf, out, so,
                                    B, c, H, K, V, st, s);
  if (in_dtype == 1 && w_dtype == 0)
    return launch_out<__nv_bfloat16, float>(out_dtype, r, k, v, logw, uf, sf,
                                            out, so, B, c, H, K, V, st, s);
  if (in_dtype == 1 && w_dtype == 1)
    return launch_out<__nv_bfloat16, __nv_bfloat16>(
        out_dtype, r, k, v, logw, uf, sf, out, so, B, c, H, K, V, st, s);
  return int(cudaErrorInvalidValue);
}
