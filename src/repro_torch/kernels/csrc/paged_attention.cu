// Paged-attention decode kernel for Hopper (sm_90a): split-KV
// (flash-decoding) with register-resident math.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py:_kernel
// (entry paged_attention). For each sequence b and packed KV slot h, the
// rows = Qt*Qp query rows attend the sequence's pages block_tables[b, i]
// with an online softmax in float32; query token t sits at position
// ctx - Qt + t and sees keys at positions <= its own. A sequence with
// ctx == 0 gets zeros.
//
// Bound: memory. Each (b, h) reads its ctx tokens of K and V once
// (ctx * hd * 2 * sizeof(T) bytes) and does 4 * rows * hd flops per token,
// about 2 flops per byte at rows = 2, far below the ~295 flop/byte ridge.
// At the serve's decode shape (q [32, 8, 2, 128] bf16, ragged contexts
// <= 1024) that is 77.7 MB, 0.0232 ms at 3.35 TB/s.
//
// Design. Grid (n_split, KV, B): the wrapper's split plan cuts the block
// table into n_split spans of pages_per_split pages (256 tokens at page 16),
// from block_tables.shape[1] and the page size alone, so there is no host
// sync; a block whose span starts at or past ctx writes an empty partial
// (m = NEG_INF, l = 0) and returns. A block copies its span's table entries
// to shared memory, and its 4 warps take the span in chunks of tokens in
// turn. A lane holds 16 contiguous bytes of a K or V row (16 lanes per
// token for hd 128 in bf16, two tokens per warp-wide load), and the next
// chunk's K and V loads are issued into a second set of registers before
// this chunk's math (a register double buffer), so each warp keeps a chunk
// in flight while it computes: 2 KB at hd 128 in bf16 (two loads of two
// tokens), and at the decode path's 96 registers (ptxas, rows = 2) five
// blocks of 4 warps fit an SM, about 40 KB in flight per SM. The query rows sit in registers, scaled in
// f32; each K row is loaded once for all rows of its kv slot, and a score
// is reduced over the lanes of its token with log2(lanes) shuffles, never
// written to shared memory. Each warp keeps its own online softmax and
// accumulator in registers; the warps merge through shared memory at the
// end of the span. Rows are register-resident in groups of RG = 2, 4 or 8
// (chosen by the row count); more rows (up to 32) loop over groups. With
// n_split == 1 the block writes the output; otherwise it writes f32
// partials (o unnormalised, m, l) to the wrapper's workspace, and a second
// kernel merges the splits by log-sum-exp and casts to q's dtype. All math
// is in f32, so the output is the f32 result rounded once.

#include <stdint.h>

#include "common.cuh"

namespace relserve {
namespace {

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;

template <typename T, int HD>
struct Geo {
  static constexpr int VEC = 16 / int(sizeof(T));   // elements per lane load
  static constexpr int LPT = HD / VEC;              // lanes per token row
  static constexpr int TPL = 32 / LPT;              // tokens per warp load
  static constexpr int NL = 2;                      // loads per lane per chunk
  static constexpr int TW = TPL * NL;               // tokens per warp chunk
};

// Dynamic shared memory: the span's table entries (padded to 16 bytes),
// then m, l and the unnormalised accumulator of every warp for RG rows.
template <int HD, int RG>
inline int smem_bytes(int pages_per_split) {
  return (pages_per_split + 3) / 4 * 16 + NW * RG * (HD + 2) * int(sizeof(float));
}

// The K and V chunk of tokens t0 + c * TW + i * TPL + grp (i < NL); tokens
// at or past t1 read nothing and give zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(
    uint4 (&kc)[Geo<T, HD>::NL], uint4 (&vc)[Geo<T, HD>::NL],
    const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* tab, int c, int t0, int t1, int page, int KV, int h, int grp,
    int sub) {
  using G = Geo<T, HD>;
#pragma unroll
  for (int i = 0; i < G::NL; ++i) {
    const int tok = t0 + c * G::TW + i * G::TPL + grp;
    kc[i] = vc[i] = make_uint4(0, 0, 0, 0);
    if (tok < t1) {
      const int lt = tok - t0;
      const long long row =
          ((long long)tab[lt / page] * page + lt % page) * KV + h;
      kc[i] = reinterpret_cast<const uint4*>(k_pages + row * HD)[sub];
      vc[i] = reinterpret_cast<const uint4*>(v_pages + row * HD)[sub];
    }
  }
}

template <typename T, int HD, int RG>
__global__ void __launch_bounds__(NT)
paged_attention_split_kernel(const T* __restrict__ q,        // [B, KV, rows, HD]
                             const T* __restrict__ k_pages,  // [P, page, KV, HD]
                             const T* __restrict__ v_pages,
                             const int* __restrict__ block_tables,  // [B, max_pages]
                             const int* __restrict__ context_lens,  // [B]
                             T* __restrict__ out,        // [B, KV, rows, HD]
                             float* __restrict__ ws_o,   // [B, KV, n_split, rows, HD]
                             float* __restrict__ ws_m,   // [B, KV, n_split, rows]
                             float* __restrict__ ws_l,   // [B, KV, n_split, rows]
                             int KV, int rows, int q_per_token,
                             int num_q_tokens, int page, int max_pages,
                             int pages_per_split, float scale) {
  using G = Geo<T, HD>;
  constexpr int VEC = G::VEC, LPT = G::LPT, NL = G::NL, TW = G::TW;
  extern __shared__ __align__(16) unsigned char smem[];
  int* tab = reinterpret_cast<int*>(smem);
  float* m_s = reinterpret_cast<float*>(smem + (pages_per_split + 3) / 4 * 16);
  float* l_s = m_s + NW * RG;           // [NW][RG]
  float* o_s = l_s + NW * RG;           // [NW][RG][HD]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane / LPT, sub = lane % LPT, d0 = sub * VEC;
  const int ctx = context_lens[b];
  const int t0 = split * pages_per_split * page;
  const int t1 = min(min(ctx, t0 + pages_per_split * page), max_pages * page);
  const long long bh = (long long)b * KV + h;
  const long long part = (bh * n_split + split) * rows;   // workspace row 0

  if (t0 >= t1) {   // no token of this sequence in the span
    if (n_split == 1) {
      for (int i = tid; i < rows * HD; i += NT)
        out[bh * rows * HD + i] = from_float<T>(0.f);
    } else {
      for (int r = tid; r < rows; r += NT) {
        ws_m[part + r] = NEG_INF;
        ws_l[part + r] = 0.f;
      }
    }
    return;
  }
  const int n_pages = (t1 - t0 + page - 1) / page;
  const int* table = block_tables + (long long)b * max_pages + t0 / page;
  for (int i = tid; i < n_pages; i += NT) tab[i] = table[i];
  __syncthreads();

  const int n_chunks = (t1 - t0 + TW - 1) / TW;
  for (int r0 = 0; r0 < rows; r0 += RG) {
    float qr[RG][VEC], acc[RG][VEC], m[RG], l[RG];
    int qpos[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const int row = r0 + r;
      float vals[VEC];
      if (row < rows) {
        unpack16<T>(reinterpret_cast<const uint4*>(
                        q + (bh * rows + row) * HD)[sub], vals);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[r][e] = vals[e] * scale;
        acc[r][e] = 0.f;
      }
      qpos[r] = ctx - num_q_tokens + row / q_per_token;
      m[r] = NEG_INF;
      l[r] = 0.f;
    }

    uint4 kc[NL], vc[NL], kn[NL], vn[NL];
    if (warp < n_chunks)
      load_chunk<T, HD>(kc, vc, k_pages, v_pages, tab, warp, t0, t1, page,
                            KV, h, grp, sub);
    for (int c = warp; c < n_chunks; c += NW) {
      if (c + NW < n_chunks)   // next chunk's loads before this chunk's math
        load_chunk<T, HD>(kn, vn, k_pages, v_pages, tab, c + NW, t0, t1,
                              page, KV, h, grp, sub);

      // scores of this lane's tokens: dot over the token's LPT lanes
      float s[RG][NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int tok = t0 + c * TW + i * G::TPL + grp;
        float kf[VEC];
        unpack16<T>(kc[i], kf);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) x += qr[r][e] * kf[e];
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          s[r][i] = (tok < t1 && tok <= qpos[r]) ? x : NEG_INF;
        }
      }

      // online softmax: the max over the warp's tokens, masked keys add 0
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int i = 0; i < NL; ++i) mx = fmaxf(mx, s[r][i]);
#pragma unroll
        for (int o = LPT; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float corr = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int i = 0; i < NL; ++i)
          s[r][i] = s[r][i] == NEG_INF ? 0.f : expf(s[r][i] - m_new);
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float vf[VEC];
        unpack16<T>(vc[i], vf);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          l[r] += s[r][i];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] += s[r][i] * vf[e];
        }
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        kc[i] = kn[i];
        vc[i] = vn[i];
      }
    }

    // sum the warp's token groups; m is already uniform across the warp
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int o = LPT; o < 32; o <<= 1) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      }
      if (grp == 0) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o_s[(warp * RG + r) * HD + d0 + e] = acc[r][e];
      }
      if (lane == 0) {
        m_s[warp * RG + r] = m[r];
        l_s[warp * RG + r] = l[r];
      }
    }
    __syncthreads();

    // merge the warps: the span's (o, m, l), or the output when unsplit
    for (int i = tid; i < RG * HD; i += NT) {
      const int r = i / HD, d = i % HD, row = r0 + r;
      if (row >= rows) continue;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w * RG + r]);
      float L = 0.f, O = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = expf(m_s[w * RG + r] - M);
        L += l_s[w * RG + r] * f;
        O += o_s[(w * RG + r) * HD + d] * f;
      }
      if (n_split == 1) {
        out[(bh * rows + row) * HD + d] = from_float<T>(O / fmaxf(L, 1e-30f));
      } else {
        ws_o[(part + row) * HD + d] = O;
        if (d == 0) {
          ws_m[part + row] = M;
          ws_l[part + row] = L;
        }
      }
    }
    __syncthreads();   // m_s / l_s / o_s are reused by the next row group
  }
}

// out[b, h, r, :] = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M) over the
// splits with l_s > 0 (an empty split, or one whose tokens all lie after
// row r's position, adds nothing); zeros when no split has a token.
template <typename T>
__global__ void __launch_bounds__(NT)
paged_attention_merge_kernel(const float* __restrict__ ws_o,
                             const float* __restrict__ ws_m,
                             const float* __restrict__ ws_l,
                             T* __restrict__ out, int rows, int hd,
                             int n_split) {
  const long long bh = blockIdx.x;
  for (int i = threadIdx.x; i < rows * hd; i += NT) {
    const int r = i / hd, d = i % hd;
    float M = NEG_INF;
    for (int s = 0; s < n_split; ++s) {
      const long long p = (bh * n_split + s) * rows + r;
      if (ws_l[p] > 0.f) M = fmaxf(M, ws_m[p]);
    }
    float L = 0.f, O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long p = (bh * n_split + s) * rows + r;
      const float l = ws_l[p];
      if (!(l > 0.f)) continue;
      const float f = expf(ws_m[p] - M);
      L += l * f;
      O += ws_o[p * hd + d] * f;
    }
    out[bh * rows * hd + i] = from_float<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, int RG>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* cl, void* out, float* ws_o, float* ws_m, float* ws_l,
           int B, int KV, int rows, int num_q_tokens, int page, int max_pages,
           int pages_per_split, int n_split, float scale,
           cudaStream_t stream) {
  const int smem = smem_bytes<HD, RG>(pages_per_split);
  auto kernel = paged_attention_split_kernel<T, HD, RG>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = allow_shared(kernel, smem, granted);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(n_split, KV, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, cl, static_cast<T*>(out), ws_o, ws_m,
      ws_l, KV, rows, rows / num_q_tokens, num_q_tokens, page, max_pages,
      pages_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return int(err);
  paged_attention_merge_kernel<T><<<B * KV, NT, 0, stream>>>(
      ws_o, ws_m, ws_l, static_cast<T*>(out), rows, HD, n_split);
  return int(cudaGetLastError());
}

template <typename T, int HD>
int launch_rows(const void* q, const void* k, const void* v, const int* bt,
                const int* cl, void* out, float* ws_o, float* ws_m,
                float* ws_l, int B, int KV, int rows, int num_q_tokens,
                int page, int max_pages, int pages_per_split, int n_split,
                float scale, cudaStream_t stream) {
  if (rows <= 2)
    return launch<T, HD, 2>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
  if (rows <= 4)
    return launch<T, HD, 4>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
  return launch<T, HD, 8>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* bt, const int* cl, void* out, float* ws_o,
              float* ws_m, float* ws_l, int B, int KV, int rows,
              int num_q_tokens, int page, int max_pages, int pages_per_split,
              int n_split, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_rows<T, 16>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
    case 32: return launch_rows<T, 32>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
    case 64: return launch_rows<T, 64>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
    case 128: return launch_rows<T, 128>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, B, KV, rows, num_q_tokens, page, max_pages, pages_per_split, n_split, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace relserve

// The split plan (pages_per_split, n_split) comes from the wrapper; with
// n_split > 1, ws_o / ws_m / ws_l are its f32 workspace
// ([B, KV, n_split, rows, hd] and [B, KV, n_split, rows] twice), else they
// may be null. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launches.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const void* block_tables,
                                      const void* context_lens, void* out,
                                      void* ws_o, void* ws_m, void* ws_l,
                                      int B, int KV, int rows, int hd,
                                      int num_q_tokens, int page,
                                      int max_pages, int pages_per_split,
                                      int n_split, float scale, int dtype,
                                      void* stream) {
  using namespace relserve;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* wo = static_cast<float*>(ws_o);
  float* wm = static_cast<float*>(ws_m);
  float* wl = static_cast<float*>(ws_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || KV == 0 || rows == 0) return 0;
  if (pages_per_split < 1 || n_split < 1 ||
      (long long)n_split * pages_per_split < max_pages ||
      (n_split > 1 && (!wo || !wm || !wl)))
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_pages, v_pages, bt, cl, out, wo, wm, wl,
                            B, KV, rows, num_q_tokens, page, max_pages,
                            pages_per_split, n_split, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, bt, cl, out, wo,
                                    wm, wl, B, KV, rows, num_q_tokens, page,
                                    max_pages, pages_per_split, n_split,
                                    scale, s);
  return int(cudaErrorInvalidValue);
}
