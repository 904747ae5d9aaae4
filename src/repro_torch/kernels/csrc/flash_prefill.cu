// Flash-attention prefill kernels for Hopper (sm_90a).
//
// Replace the Pallas kernel src/repro/kernels/flash_prefill.py:_kernel
// (entry flash_prefill). Packed-GQA attention: q [B, G, S, R, hd] is viewed
// as [B*G, S*R, hd] rows against k/v [B, G, T, hd]; row r of (b, g) has
// sequence position q_offset + r / R and attends keys kpos <= qpos (causal),
// kpos > qpos - window (window > 0), or every key (non-causal). Online
// softmax in float32; the output is the f32 result cast once to q's dtype.
//
// Bound: at the serve's prompts, bytes; at long ones, operations. At q
// [4, 8, 512, 2, 128] causal, bf16, the call moves 25.2 MB (0.0075 ms at
// 3.35 TB/s) against 4.30 GFLOP of unmasked products (0.0043 ms at 989
// TFLOP/s); at S = 32,768 (qwen3-1.7b's prefill cell: [1, 8, 32768, 2, 128])
// the products take 4.447 ms and the bytes 0.08 ms. The split P below costs
// a second P V product: 1.5x the tensor-core work the bound counts.
//
// Two kernels, chosen in flash_prefill_launch by dtype and head dim:
//
// bfloat16, hd 64 and 128 (every model path) — wgmma on a TMA-fed ring.
// A block is three warpgroups over BM = 128 packed q rows of one (b, g):
// the first is the producer (setmaxnreg down to 24 registers; one thread
// issues every load), the other two are consumers of 64 rows each (240
// registers). K and V tiles of BN = 128 keys go through a ring of 2 stages
// (hd 128; 3 at hd 64) in the 128-byte swizzle, loaded by TMA from 4-D
// tensor maps (hd, T, G, B) over the callers' own strides (the model's
// movedim views need no copy; keys past T read zeros), boxes of 64 columns
// x 128 keys, each stage completing on its own mbarriers for K and for V
// and released on a third. The maps are encoded per call on the host
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint) and
// passed as __grid_constant__ parameters. Each consumer warpgroup copies its
// 64 rows of Q once, unscaled, into the same swizzle with 16-byte cp.async
// (rows end inside a position at R 5 and 6, which a box cannot express;
// rows past S*R read zeros and are not written), then per tile:
//   S = Q K^T  wgmma m64n128k16, both operands from shared memory, K as the
//              K-major B operand, f32 accumulators in registers;
//   softmax    S scaled by log2(e)/sqrt(hd) in f32, masked by position on
//              the tiles that cross a bound of the warpgroup's rows, online
//              max and sum over a quad's lanes, exp2 on the SFU (relative
//              error ~2^-22, far below the check's 2e-5 slack);
//   O += P V   P split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), both
//              register A operands (the RS form) of wgmma m64n{hd}k16 into
//              the one f32 accumulator, V as the MN-major B operand (the
//              transpose bit), so P carries ~17 bits (relative residual
//              <= 2^-18) and the output is the f32 result rounded once. A
//              single bf16 P would add up to 2^-9 relative error to every
//              term (on the CPU rehearsal of this arithmetic it misses the
//              half-ulp bound by 67x; the split meets it).
// The accumulator of wgmma m64nN holds, per warp, the same fragments as
// mma.m16n8k16's C, so S's registers are P's A fragments with no data
// movement. Each warpgroup's loop is software-pipelined as FlashAttention-3
// does: iteration j issues S(j) and then P(j-1) V(j-1), and runs tile j's
// softmax while the second product is on the tensor cores; K(j) is released
// as soon as S(j) is done and V(j-1) once its product is, on separate
// barriers, so two stages suffice at hd 128. The two warpgroups take turns
// issuing their products (two named barriers, FA3's ping-pong), so one's
// softmax overlaps the other's products. Both walk every tile of the
// block's range (a tile one of them cannot see is fully masked and adds
// exactly 0), which keeps their releases and turns in step; q blocks with
// the most kv tiles are launched first. The output is staged through the
// warpgroup's Q buffer (free after its last S) and written with 16-byte
// coalesced stores.
//
// float32, and bfloat16 at hd 16 and 32 (test dtypes and widths only; no
// model path takes them) — a SIMT kernel: 64 rows per block, each of 256
// threads owns a 4-row slice of the accumulator; Q, K, V and P in f32
// shared memory; plain f32 FMAs (TF32 would break the 1e-5 f32 tolerance),
// so a bf16 output is the f32 result rounded once. wgmma's 128-byte swizzle
// atom is 64 columns wide; the narrow widths take this kernel rather than a
// 32- or 64-byte swizzle variant of it.
//
// Both skip kv tiles outside the causal / window bound of the block's rows
// and read q, k and v through their strides. Later work: fp8 and a
// persistent grid.

#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace relserve {
namespace {

// ---------------------------------------------------------------------------
// float32 inputs, and bfloat16 at head dims 16 and 32: plain f32 FMAs
// ---------------------------------------------------------------------------
namespace simt {

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


}  // namespace simt

// P for the wgmma kernel's P V product: two f32 values as bf16 hi + lo
// pairs, hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// ---------------------------------------------------------------------------
// bfloat16 inputs, head dims 64 and 128: wgmma on a TMA-fed ring
// ---------------------------------------------------------------------------
namespace wg {

using bf16 = __nv_bfloat16;


constexpr int NC = 2;                  // consumer warpgroups, 64 q rows each
constexpr int BM = 64 * NC;            // q rows per block
constexpr int BN = 128;                // keys per tile
constexpr int NT = 128 * (NC + 1);     // + the producer warpgroup
constexpr int ATOM = 64;               // head-dim columns per 128-byte row

template <int HD>
struct Geo {
  static constexpr int NSUB = HD / ATOM;            // 128-byte column blocks
  static constexpr int STAGES = HD == 128 ? 2 : 3;  // K/V ring depth
  static constexpr int Q_SUB = 64 * 128;            // [64 rows][64 cols]
  static constexpr int Q_BYTES = NC * NSUB * Q_SUB;
  static constexpr int KV_SUB = BN * 128;           // [BN keys][64 cols]
  static constexpr int TILE = NSUB * KV_SUB;        // one K or V tile
  static constexpr int RING = STAGES * 2 * TILE;
  // 1024 bytes of slack to align the base for the swizzle, then Q, the
  // ring, and four barriers per stage (K and V full, K and V empty)
  static constexpr int bytes = 1024 + Q_BYTES + RING + 4 * STAGES * 8;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                   uint64_t db);
template <>
__device__ __forceinline__ void pv<64>(float (&o)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void pv<128>(float (&o)[64], const uint32_t (&a)[4],
                                        uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// The online softmax of one tile's scores, in place (registers of this
// thread's two rows, scaled to log2 units and masked where the tile crosses a
// bound of the warpgroup's rows): p = 2^(s - m), the row max m and this
// lane's share of the row sum l updated, corr = 2^(m_old - m).
__device__ __forceinline__ void softmax_scores(
    float (&sc)[BN / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    bool masked, int k0, int T_len, int causal, int window, int qp0, int qp1,
    int t4, float scale_log2) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2;
      if (masked) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const int pos = (e >> 1) ? qp1 : qp0;
        bool ok = kpos < T_len;
        if (causal) ok = ok && kpos <= pos;
        if (window > 0) ok = ok && kpos > pos - window;
        x = ok ? x : NEG_INF;
      }
      sc[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    l[i] *= corr[i];   // this lane's share of the row sum
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = ex2(sc[4 * j + e] - m[e >> 1]);
      l[e >> 1] += sc[4 * j + e];
    }
}

// P = p_hi + p_lo, each a register A operand of the P V product.
__device__ __forceinline__ void to_p(const float (&sc)[BN / 2],
                                     uint32_t (&ph)[BN / 16][4],
                                     uint32_t (&pl)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], ph[kk][e],
                 pl[kk][e]);
}

template <int HD>
__device__ __forceinline__ void rescale(float (&o)[HD / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
}

// Issue S = Q K^T for one tile (64 rows x BN keys, f32; K is the K-major B
// operand), zero-initialised, as one wgmma group.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[BN / 2], uint32_t qw,
                                         uint32_t kt) {
  using Gm = Geo<HD>;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t qa = qw + (kk >> 2) * Gm::Q_SUB + (kk & 3) * 32;
    const uint32_t ka = kt + (kk >> 2) * Gm::KV_SUB + (kk & 3) * 32;
    wgmma_ss_n128(sc, desc_sw128(qa, 16, 1024), desc_sw128(ka, 16, 1024),
                  kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V for one tile, P = p_hi + p_lo from registers (the RS form;
// V is the MN-major B operand: the transpose bit), as one wgmma group.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&ph)[BN / 16][4],
                                         const uint32_t (&pl)[BN / 16][4],
                                         uint32_t vt) {
  using Gm = Geo<HD>;
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = desc_sw128(vt + kk * 16 * 128, Gm::KV_SUB, 1024);
    pv<HD>(o, ph[kk], dv);
    pv<HD>(o, pl[kk], dv);
  }
  wgmma_commit();
}

// Accumulator layout of wgmma m64nN (f32), for thread (warp w of the
// warpgroup, lane = 4 g + t): d[4 j + e] is row 16 w + g + 8 (e >> 1),
// column 8 j + 2 t + (e & 1). The A fragment of m64k16 from registers has
// the layout of mma.m16n8k16's A per warp, so the score accumulators of keys
// 16 kk .. 16 kk + 15 (d[8 kk .. 8 kk + 7]) are P's A fragment of k-step kk
// with no data movement.
//
// A consumer warpgroup's loop is software-pipelined (FlashAttention-3's
// intra-warpgroup overlap): iteration j issues S(j) = Q K(j)^T and then
// O += P(j-1) V(j-1), and runs tile j's softmax while the second product is
// on the tensor cores. K(j) is released as soon as S(j) is done, V(j-1) once
// its product is, each on its own barrier, so the producer refills K ahead
// of V. Both warpgroups walk every tile of the block's range (the one a
// warpgroup cannot see is fully masked and adds exactly 0), so their
// releases stay in step with the ring's phases.
template <int HD>
__global__ void __launch_bounds__(NT, 1)
flash_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const bf16* __restrict__ q, bf16* __restrict__ out,
                           int G, int S, int R, int T_len, long long sqb,
                           long long sqg, long long sqs, long long sqr,
                           int causal, int window, int q_offset,
                           float scale_log2) {
  using Gm = Geo<HD>;
  constexpr int ST = Gm::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                      // [NC][NSUB][64][64]
  const uint32_t ring = base + Gm::Q_BYTES;       // [ST][K, V][NSUB][BN][64]
  const uint32_t bars = ring + Gm::RING;
  auto full_k = [&](int s) { return bars + 8u * s; };
  auto full_v = [&](int s) { return bars + 8u * (ST + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 * ST + s); };
  auto empty_v = [&](int s) { return bars + 8u * (3 * ST + s); };

  const int bg = blockIdx.x;
  const int b = bg / G, g = bg % G;
  const int SR = S * R;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;   // most kv tiles first
  const int n_rows = min(BM, SR - row0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // kv tiles the block's rows can see
  const int qpos_lo = q_offset + row0 / R;
  const int qpos_hi = q_offset + (row0 + n_rows - 1) / R;
  const int k_end = causal ? min(T_len, qpos_hi + 1) : T_len;
  const int k_first = window > 0 ? (max(0, qpos_lo - window + 1) / BN) * BN : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BN - 1) / BN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), NC * 4);   // one arrival per consumer warp
      mbar_init(empty_v(s), NC * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % ST;
        const uint32_t prev = ((it / ST) - 1) & 1;
        const int k0 = k_first + it * BN;
        const uint32_t kd = ring + s * 2 * Gm::TILE, vd = kd + Gm::TILE;
        if (it >= ST) mbar_wait(empty_k(s), prev);
        mbar_expect_tx(full_k(s), Gm::TILE);
#pragma unroll
        for (int c = 0; c < Gm::NSUB; ++c)
          tma_load_4d(kd + c * Gm::KV_SUB, &kmap, full_k(s), c * ATOM, k0, g, b);
        if (it >= ST) mbar_wait(empty_v(s), prev);
        mbar_expect_tx(full_v(s), Gm::TILE);
#pragma unroll
        for (int c = 0; c < Gm::NSUB; ++c)
          tma_load_4d(vd + c * Gm::KV_SUB, &vmap, full_v(s), c * ATOM, k0, g, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 q rows each ----
    setmaxnreg_inc<240>();
    const int wgi = (warp >> 2) - 1, wl = warp & 3;
    const int tid = threadIdx.x & 127;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int wrow0 = 64 * wgi;                  // first row, block-relative
    const int wrows = min(64, n_rows - wrow0);   // may be <= 0
    const uint32_t qw = q_s + wgi * Gm::NSUB * Gm::Q_SUB;

    // Q once, unscaled, into the 128-byte swizzle that TMA would write:
    // 16-byte chunk j of row r at r * 128 + ((j ^ r) % 8) * 16 of its
    // column block; rows past the end read zeros
    const bf16* qb = q + b * sqb + g * sqg;
    for (int c = tid; c < 64 * (HD / 8); c += 128) {
      const int r = c / (HD / 8), j = c % (HD / 8);
      const bool ok = r < wrows;
      const int rr = row0 + wrow0 + r;
      const bf16* src =
          ok ? qb + (long long)(rr / R) * sqs + (long long)(rr % R) * sqr + j * 8
             : qb;
      cp_async16(qw + (j >> 3) * Gm::Q_SUB + r * 128 + (((j ^ r) & 7) << 4),
                 src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    named_sync(1 + wgi, 128);

    // this thread's two rows, and the warpgroup's position range (rows past
    // the end compute on zeros and are not written)
    const int ra = row0 + wrow0 + 16 * wl + g8;
    const int qp0 = q_offset + ra / R, qp1 = q_offset + (ra + 8) / R;
    const int w_lo = q_offset + (row0 + wrow0) / R;
    const int w_hi = q_offset + (row0 + wrow0 + max(wrows, 1) - 1) / R;
    auto masked = [&](int k0) {
      return k0 + BN > T_len || (causal && k0 + BN - 1 > w_lo) ||
             (window > 0 && k0 <= w_hi - window);
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
    float sc[BN / 2];
    uint32_t ph[BN / 16][4], pl[BN / 16][4];

    // the two warpgroups take turns issuing their products (barriers 3 and
    // 4): one's softmax runs while the other's products do
    if (wgi == 1) named_arrive(3, 256);   // warpgroup 0 issues first
    if (n_tiles > 0) {
      // tile 0: S, its softmax, P
      mbar_wait(full_k(0), 0);
      named_sync(3 + wgi, 256);
      issue_qk<HD>(sc, qw, ring);
      named_arrive(4 - wgi, 256);
      wgmma_wait<0>();
      fence_regs(sc);
      release(empty_k(0));
      softmax_scores(sc, m, l, corr, masked(k_first), k_first, T_len, causal,
                     window, qp0, qp1, t4, scale_log2);
      to_p(sc, ph, pl);
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % ST, sp = (it - 1) % ST;
        const int k0 = k_first + it * BN;
        const uint32_t kt = ring + s * 2 * Gm::TILE;
        const uint32_t vt = ring + sp * 2 * Gm::TILE + Gm::TILE;
        mbar_wait(full_k(s), (it / ST) & 1);
        named_sync(3 + wgi, 256);
        issue_qk<HD>(sc, qw, kt);               // S(it)
        rescale<HD>(o, corr);
        mbar_wait(full_v(sp), ((it - 1) / ST) & 1);
        issue_pv<HD>(o, ph, pl, vt);            // O += P(it-1) V(it-1)
        named_arrive(4 - wgi, 256);
        wgmma_wait<1>();                        // S(it) is done
        fence_regs(sc);
        release(empty_k(s));
        // softmax(it) while the P V product runs; P(it) is written only
        // once that product no longer reads P(it-1)
        softmax_scores(sc, m, l, corr, masked(k0), k0, T_len, causal, window,
                       qp0, qp1, t4, scale_log2);
        wgmma_wait<0>();
        fence_regs(o);
        release(empty_v(sp));
        to_p(sc, ph, pl);
      }
      // the last tile's P V
      const int sl = (n_tiles - 1) % ST;
      rescale<HD>(o, corr);
      mbar_wait(full_v(sl), ((n_tiles - 1) / ST) & 1);
      issue_pv<HD>(o, ph, pl, ring + sl * 2 * Gm::TILE + Gm::TILE);
      wgmma_wait<0>();
      fence_regs(o);
      release(empty_v(sl));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    bf16* ob = out + ((long long)bg * SR + row0) * HD;
    // through the warpgroup's Q buffer (free once its last S is done), 16
    // bytes per chunk swizzled by the row, then 16-byte coalesced stores
    unsigned char* qbuf = smem_raw + (qw - smem_u32(smem_raw));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * wl + g8 + 8 * i;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(
            qbuf + r * (HD * 2) + ((j ^ (r & 7)) << 4) + 4 * t4) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
    named_sync(1 + wgi, 128);
    for (int c = tid; c < 64 * (HD / 8); c += 128) {
      const int r = c / (HD / 8), j = c % (HD / 8);
      if (r >= wrows) break;
      *reinterpret_cast<uint4*>(ob + (long long)(wrow0 + r) * HD + 8 * j) =
          *reinterpret_cast<const uint4*>(qbuf + r * (HD * 2) +
                                          ((j ^ (r & 7)) << 4));
    }
  }
}

// K and V as 4-D maps (hd, T, G, B) over the callers' strides, boxes of
// (64 columns, BN keys) in the 128-byte swizzle; keys past T read zeros.
inline int kv_map(CUtensorMap* map, const void* p, int HD, int T_len, int G,
                  int B, long long sb, long long sg, long long st) {
  const long long dims[4] = {HD, T_len, G, B};
  const long long strides[3] = {st * 2, sg * 2, sb * 2};
  const int box[4] = {ATOM, BN, 1, 1};
  return encode_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, dims,
                       strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int G, int S, int R, int T_len, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap km, vm;
  int err = kv_map(&km, k, HD, T_len, G, B, st[4], st[5], st[6]);
  if (err) return err;
  err = kv_map(&vm, v, HD, T_len, G, B, st[7], st[8], st[9]);
  if (err) return err;
  auto kernel = flash_prefill_wgmma_kernel<HD>;
  static int granted[kMaxDevices] = {};
  cudaError_t cerr = allow_shared(kernel, Geo<HD>::bytes, granted);
  if (cerr != cudaSuccess) return int(cerr);
  const dim3 grid(B * G, (S * R + BM - 1) / BM);
  kernel<<<grid, NT, Geo<HD>::bytes, stream>>>(
      km, vm, static_cast<const bf16*>(q), static_cast<bf16*>(out), G, S, R,
      T_len, st[0], st[1], st[2], st[3], causal, window, q_offset,
      float(double(scale) * 1.4426950408889634));
  return int(cudaGetLastError());
}

}  // namespace wg

// One head-dim switch for both dtypes: Launch<HD>::run.
template <template <int> class Launch>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int G, int S, int R, int T_len, const long long* st,
              int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 16: return Launch<16>::run(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
    case 32: return Launch<32>::run(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
    case 64: return Launch<64>::run(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
    case 128: return Launch<128>::run(q, k, v, out, B, G, S, R, T_len, st, causal, window, q_offset, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

template <int HD>
struct SimtF32 {
  template <typename... A>
  static int run(A... a) { return simt::launch<float, HD>(a...); }
};

// wgmma at the model widths, the SIMT kernel below them.
template <int HD>
struct BF16 {
  template <typename... A>
  static int run(A... a) {
    if constexpr (HD >= 64)
      return wg::launch<HD>(a...);
    else
      return simt::launch<__nv_bfloat16, HD>(a...);
  }
};

}  // namespace
}  // namespace relserve

// Strides are in elements: q (b, g, s, r), k (b, g, t), v (b, g, t); the
// head dim is contiguous everywhere and out is contiguous [B, G, S, R, hd].
// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (wgmma kernel at hd 64
// and 128, the SIMT kernel below). Returns cudaGetLastError() after launch, or the
// driver's error if a tensor map cannot be encoded.
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
    return launch_hd<SimtF32>(hd, q, k, v, out, B, G, S, R, T_len, st, causal,
                              window, q_offset, scale, s);
  if (dtype == 1)
    return launch_hd<BF16>(hd, q, k, v, out, B, G, S, R, T_len, st,
                                     causal, window, q_offset, scale, s);
  return int(cudaErrorInvalidValue);
}

// Packed q rows per block of the kernel that flash_prefill_launch picks for
// (hd, dtype): gridDim.y is ceil(S * R / this).
extern "C" int flash_prefill_block_rows(int hd, int dtype) {
  using namespace relserve;
  return dtype == 1 && hd >= 64 ? wg::BM : 64;
}

// Instance i of the kernels the paths launch: a label, registers, shared
// memory (static + dynamic), threads and resident blocks per SM. Returns 0,
// -1 past the last instance, or a CUDA error. The wgmma kernel's registers
// are its count at launch, before setmaxnreg moves them to the consumers.
extern "C" int flash_prefill_occupancy(int i, char* label, int label_len,
                                       int* regs, int* smem, int* threads,
                                       int* blocks) {
  using namespace relserve;
  static const char* labels[] = {"bf16 hd 128, wgmma", "bf16 hd 64, wgmma",
                                 "f32 hd 128, SIMT", "f32 hd 64, SIMT"};
  static int granted[4][kMaxDevices] = {};
  if (i < 0 || i >= 4) return -1;
  snprintf(label, label_len, "%s", labels[i]);
  switch (i) {
    case 0:
      *threads = wg::NT;
      return occupancy(wg::flash_prefill_wgmma_kernel<128>, wg::NT,
                       wg::Geo<128>::bytes, granted[0], regs, smem, blocks);
    case 1:
      *threads = wg::NT;
      return occupancy(wg::flash_prefill_wgmma_kernel<64>, wg::NT,
                       wg::Geo<64>::bytes, granted[1], regs, smem, blocks);
    case 2:
      *threads = simt::NT;
      return occupancy(simt::flash_prefill_kernel<float, 128>, simt::NT,
                       simt::Smem<128>::bytes, granted[2], regs, smem, blocks);
    default:
      *threads = simt::NT;
      return occupancy(simt::flash_prefill_kernel<float, 64>, simt::NT,
                       simt::Smem<64>::bytes, granted[3], regs, smem, blocks);
  }
}
