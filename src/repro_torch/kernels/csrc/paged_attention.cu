// Paged-attention decode kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py:_kernel
// (entry paged_attention). For each sequence b and packed KV slot h, the
// Qt*Qp query rows attend the sequence's pages block_tables[b, i] with an
// online softmax in float32; query token t sits at position ctx - Qt + t and
// sees keys at positions <= its own. A sequence with ctx == 0 gets zeros.
//
// Bound: memory. Each (b, h) block reads its ctx tokens of K and V once
// (ctx * hd * 2 * sizeof(T) bytes) and does 4 * rows * hd flops per token,
// about 2 flops per byte at rows = 2 — far below the ~295 flop/byte ridge.
// Design: grid (B, KVs), so blocks of different sequences and slots stream
// their pages in parallel; each block walks only ceil(ctx / page) pages (no
// scalar prefetch on Hopper: it reads context_lens[b] and block_tables[b, :]
// itself), staging TILE tokens of K and V at a time through shared memory with
// 16-byte loads, and keeps the query rows, scores and f32 accumulators in
// shared memory. Later work: split long contexts across blocks and overlap
// the next tile's loads (cp.async / TMA) with this tile's math.

#include <stdint.h>

#include "common.cuh"

namespace relserve {
namespace {

constexpr int NT = 128;    // threads per block: 4 warps
constexpr int TILE = 64;   // tokens staged per iteration

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const T* __restrict__ q,        // [B, KV, rows, HD]
                       const T* __restrict__ k_pages,  // [P, page, KV, HD]
                       const T* __restrict__ v_pages,
                       const int* __restrict__ block_tables,  // [B, max_pages]
                       const int* __restrict__ context_lens,  // [B]
                       T* __restrict__ out,                   // [B, KV, rows, HD]
                       int KV, int rows, int q_per_token, int num_q_tokens,
                       int page, int max_pages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                     // [TILE][HD]
  T* vs = ks + TILE * HD;                                 // [TILE][HD]
  float* qs = reinterpret_cast<float*>(vs + TILE * HD);   // [rows][HD]
  float* acc = qs + rows * HD;                            // [rows][HD]
  float* ps = acc + rows * HD;                            // [rows][TILE]
  float* m_s = ps + rows * TILE;                          // [rows]
  float* l_s = m_s + rows;                                // [rows]
  float* c_s = l_s + rows;                                // [rows]

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int NW = NT / 32;
  const int ctx = context_lens[b];
  const int* table = block_tables + (long long)b * max_pages;
  const long long qbase = ((long long)b * KV + h) * rows * HD;

  for (int i = tid; i < rows * HD; i += NT) {
    qs[i] = to_float(q[qbase + i]) * scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte chunk
  constexpr int CPR = HD / VEC;         // chunks per token row
  const int ntok = min(ctx, max_pages * page);
  for (int t0 = 0; t0 < ntok; t0 += TILE) {
    const int nt = min(TILE, ntok - t0);
    __syncthreads();   // previous tile fully consumed (and the init above)
    for (int c = tid; c < TILE * CPR; c += NT) {
      const int t = c / CPR, j = c % CPR;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;
      if (t < nt) {
        const int tok = t0 + t;
        const long long row =
            ((long long)table[tok / page] * page + tok % page) * KV + h;
        kraw = reinterpret_cast<const uint4*>(k_pages + row * HD)[j];
        vraw = reinterpret_cast<const uint4*>(v_pages + row * HD)[j];
      }
      reinterpret_cast<uint4*>(ks + t * HD)[j] = kraw;
      reinterpret_cast<uint4*>(vs + t * HD)[j] = vraw;
    }
    __syncthreads();

    // scores: one warp per (row, token) pair, lanes across the head dim
    for (int pi = warp; pi < rows * TILE; pi += NW) {
      const int r = pi / TILE, t = pi % TILE;
      float s = 0.f;
#pragma unroll
      for (int d = lane; d < HD; d += 32) s += qs[r * HD + d] * to_float(ks[t * HD + d]);
      s = warp_sum(s);
      if (lane == 0) {
        const int qpos = ctx - num_q_tokens + r / q_per_token;
        ps[r * TILE + t] = (t < nt && t0 + t <= qpos) ? s : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax statistics: one warp per row
    for (int r = warp; r < rows; r += NW) {
      float mx = NEG_INF;
      for (int t = lane; t < TILE; t += 32) mx = fmaxf(mx, ps[r * TILE + t]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TILE; t += 32) {
        const float p = expf(ps[r * TILE + t] - m_new);
        ps[r * TILE + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V; the zero-filled tail of the tile adds nothing
    for (int i = tid; i < rows * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      const float* pr = ps + r * TILE;
      float a = acc[i] * c_s[r];
#pragma unroll 8
      for (int t = 0; t < TILE; ++t) a += pr[t] * to_float(vs[t * HD + d]);
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += NT) {
    out[qbase + i] = from_float<T>(acc[i] / fmaxf(l_s[i / HD], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* cl, void* out, int B, int KV, int rows,
           int num_q_tokens, int page, int max_pages, float scale,
           cudaStream_t stream) {
  const int smem = 2 * TILE * HD * int(sizeof(T)) +
                   (2 * rows * HD + rows * TILE + 3 * rows) * int(sizeof(float));
  auto kernel = paged_attention_kernel<T, HD>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = allow_shared(kernel, smem, granted);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(B, KV), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, cl, static_cast<T*>(out), KV, rows,
      rows / num_q_tokens, num_q_tokens, page, max_pages, scale);
  return int(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* bt, const int* cl, void* out, int B, int KV,
              int rows, int num_q_tokens, int page, int max_pages,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, bt, cl, out, B, KV, rows, num_q_tokens, page, max_pages, scale, stream);
    case 32: return launch<T, 32>(q, k, v, bt, cl, out, B, KV, rows, num_q_tokens, page, max_pages, scale, stream);
    case 64: return launch<T, 64>(q, k, v, bt, cl, out, B, KV, rows, num_q_tokens, page, max_pages, scale, stream);
    case 128: return launch<T, 128>(q, k, v, bt, cl, out, B, KV, rows, num_q_tokens, page, max_pages, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace relserve

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      int B, int KV, int rows, int hd,
                                      int num_q_tokens, int page,
                                      int max_pages, float scale, int dtype,
                                      void* stream) {
  using namespace relserve;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_pages, v_pages, bt, cl, out, B, KV, rows,
                            num_q_tokens, page, max_pages, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, bt, cl, out, B,
                                    KV, rows, num_q_tokens, page, max_pages,
                                    scale, s);
  return int(cudaErrorInvalidValue);
}
