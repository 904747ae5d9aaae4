// Flash-attention prefill kernels for Hopper (sm_90a).
//
// Replace the Pallas kernel src/repro/kernels/flash_prefill.py:_kernel
// (entry flash_prefill). Packed-GQA attention: q [B, G, S, R, hd] is viewed
// as [B*G, S*R, hd] rows against k/v [B, G, T, hd]; row r of (b, g) has
// sequence position q_offset + r / R and attends keys kpos <= qpos (causal),
// kpos > qpos - window (window > 0), or every key (non-causal). Online
// softmax in float32; the output is the f32 result cast once to q's dtype.
//
// Bound: at the serve's prompts, bytes. At q [4, 8, 512, 2, 128] causal,
// bf16, the call moves 25.2 MB (0.0075 ms at 3.35 TB/s) against 4.30 GFLOP
// of unmasked products (0.0043 ms at 989 TFLOP/s); long prompts turn it
// compute-bound (4 * S * R * T * hd flops against (S*R + 2*T) * hd elements).
//
// Two kernels, chosen by the input dtype in flash_prefill_launch:
//
// bfloat16 (the serve's dtype) — tensor cores, FA2-shaped. A block holds
// BM = 64 packed q rows, one warp per 16 rows, for one (b, g); q blocks
// with the most kv tiles are launched first (causal work is triangular).
// The Q tile is copied once, in bf16 and unscaled, into shared memory and
// from there by ldmatrix into mma.sync.m16n8k16 A fragments that stay in
// registers for the whole kv loop. K and V tiles of 32 keys go through a
// 3-stage cp.async ring (16-byte copies through the callers' strides, rows
// past T zero-filled), so the next tiles' copies overlap this tile's
// products; rows are padded by 16 bytes, so the 8 rows one ldmatrix reads
// fall in 8 distinct bank groups (ldmatrix.trans for V). 32-key tiles took
// less time than 64-key ones on the H100 (fewer registers and less shared
// memory per block, so more blocks per SM). S = Q K^T comes out of the
// tensor cores in f32 (bf16 x bf16 products are exact there); the scale
// 1/sqrt(hd) is applied to S in f32, the masks use positions as below (on
// the tiles that cross a bound only), and the online softmax runs in
// registers with quad shuffles and the SFU's exp (__expf, relative error
// ~2^-21, far below the check's 2e-5 slack). A warp skips a kv tile that
// its 16 rows cannot see. P V keeps f32 accuracy: p is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both go through
// mma.sync into the same f32 accumulator, so P carries
// ~17 bits (relative residual <= 2^-18) and the output is the f32 result
// rounded once to bf16. A single bf16 P would add up to 2^-9 relative
// error to every term (on the CPU rehearsal of this arithmetic it misses
// the half-ulp bound by 67x; the split meets it). The split costs a second
// P V product: 1.5x the tensor-core work of Q K^T + P V in bf16.
//
// float32 (a test dtype) — a SIMT kernel: 64 rows per block, each of
// 256 threads owns a 4-row slice of the accumulator; Q, K, V and P in f32
// shared memory; plain f32 FMAs. TF32 would break the 1e-5 f32 tolerance.
//
// Both skip kv tiles outside the causal / window bound of the block's rows
// and read q, k and v through their strides, so the model's movedim views
// need no copy. Later work: wgmma with TMA-fed tiles and warp
// specialisation.

#include <stdint.h>

#include "common.cuh"

namespace relserve {
namespace {

// ---------------------------------------------------------------------------
// float32 inputs: plain f32 FMAs
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

// ---------------------------------------------------------------------------
// bfloat16 inputs: mma.sync tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NW = 4;          // warps per block
constexpr int NT = NW * 32;
constexpr int BM = NW * 16;    // q rows per block: 16 per warp
constexpr int BN = 32;         // keys per tile
constexpr int STAGES = 3;      // K/V ring depth

template <int HD>
struct Smem {
  static constexpr int LD = HD + 8;   // row stride (elements): +16 bytes
  static constexpr int TILE = BN * LD;
  static constexpr int bytes = (BM * LD + STAGES * 2 * TILE) * int(sizeof(bf16));
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two f32 values as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Copy BN rows of HD elements (row i at base + i * stride) into a padded
// shared tile; rows past n_rows are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long stride, int n_rows) {
  constexpr int CPR = HD / 8;   // 16-byte chunks per row
  for (int c = threadIdx.x; c < BN * CPR; c += NT) {
    const int row = c / CPR, j = c % CPR;
    const bool ok = row < n_rows;
    const bf16* src = ok ? base + row * stride + j * 8 : base;
    cp_async16(smem_u32(dst + row * Smem<HD>::LD + j * 8), src, ok);
  }
}

// The BM q rows of the block, row r at (s, r') = (r / R, r % R), unscaled.
template <int HD>
__device__ __forceinline__ void load_q(bf16* dst, const bf16* q, long long sqs,
                                       long long sqr, int R, int row0,
                                       int n_rows) {
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < BM * CPR; c += NT) {
    const int row = c / CPR, j = c % CPR;
    const bool ok = row < n_rows;
    const int rr = row0 + row;
    const bf16* src =
        ok ? q + (long long)(rr / R) * sqs + (long long)(rr % R) * sqr + j * 8
           : q;
    cp_async16(smem_u32(dst + row * Smem<HD>::LD + j * 8), src, ok);
  }
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): g = lane / 4,
// t = lane % 4. A: a0 (row g, k 2t..2t+1), a1 (row g+8), a2 (row g, k
// 2t+8..), a3 (row g+8, k 2t+8..). B: b0 (k 2t..2t+1, col g), b1 (k
// 2t+8..). C: c0 c1 (row g, cols 2t, 2t+1), c2 c3 (row g+8). So the C
// fragments of two adjacent 8-key score tiles are the A fragment of P for
// those 16 keys, with no data movement.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out,
                         int G, int S, int R, int T_len, long long sqb,
                         long long sqg, long long sqs, long long sqr,
                         long long skb, long long skg, long long skt,
                         long long svb, long long svg, long long svt,
                         int causal, int window, int q_offset, float scale) {
  constexpr int LD = Smem<HD>::LD;
  constexpr int TILE = Smem<HD>::TILE;
  constexpr int KT = HD / 16;   // k-steps of Q K^T
  constexpr int DN = HD / 8;    // 8-column tiles of the output
  constexpr int SN = BN / 8;    // 8-key tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);   // [BM][LD]
  bf16* Ks = Qs + BM * LD;                    // [STAGES][BN][LD]
  bf16* Vs = Ks + STAGES * TILE;              // [STAGES][BN][LD]

  const int bg = blockIdx.x;
  const int b = bg / G, g = bg % G;
  const int SR = S * R;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BM;   // most kv tiles first
  const int n_rows = min(BM, SR - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  const bf16* qb = q + b * sqb + g * sqg;
  const bf16* kb = k + b * skb + g * skg;
  const bf16* vb = v + b * svb + g * svg;

  // kv range the block's rows can see
  const int qpos_lo = q_offset + row0 / R;
  const int qpos_hi = q_offset + (row0 + n_rows - 1) / R;
  const int k_end = causal ? min(T_len, qpos_hi + 1) : T_len;
  const int k_first = window > 0 ? (max(0, qpos_lo - window + 1) / BN) * BN : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BN - 1) / BN : 0;

  // this thread's two rows (g and g + 8 of the warp's 16) and the warp's
  // position range
  const int wrow = warp * 16;
  const int qp[2] = {q_offset + (row0 + wrow + gid) / R,
                     q_offset + (row0 + wrow + gid + 8) / R};
  const int w_lo = q_offset + (row0 + wrow) / R;
  const int w_hi = q_offset + (row0 + wrow + 15) / R;
  const bool warp_live = wrow < n_rows;

  // prologue: Q and the first STAGES - 1 tiles, one copy group per tile
  load_q<HD>(Qs, qb, sqs, sqr, R, row0, n_rows);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      const int k0 = k_first + st * BN;
      load_tile<HD>(Ks + st * TILE, kb + k0 * skt, skt, T_len - k0);
      load_tile<HD>(Vs + st * TILE, vb + k0 * svt, svt, T_len - k0);
    }
    cp_async_commit();
  }

  uint32_t qf[KT][4];
  float o[DN][4];
#pragma unroll
  for (int d = 0; d < DN; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * BN;
    const int pf = it + STAGES - 1;   // prefetch into the stage freed last
    if (pf < n_tiles) {
      const int kp = k_first + pf * BN;
      load_tile<HD>(Ks + (pf % STAGES) * TILE, kb + kp * skt, skt, T_len - kp);
      load_tile<HD>(Vs + (pf % STAGES) * TILE, vb + kp * svt, svt, T_len - kp);
    }
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // tile it (and Q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const int row = wrow + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = kk * 16 + ((lane >> 4) << 3);
        ldmatrix_x4(qf[kk], smem_u32(Qs + row * LD + col));
      }
    }
    const bool visible =
        warp_live && !(causal && k0 > w_hi) &&
        !(window > 0 && k0 + BN - 1 <= w_lo - window);
    if (visible) {
      const bf16* Kt = Ks + (it % STAGES) * TILE;
      const bf16* Vt = Vs + (it % STAGES) * TILE;

      // S = Q K^T, 16 rows x BN keys per warp, f32
      float s[SN][4];
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int np = 0; np < SN / 2; ++np) {
          uint32_t r[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = kk * 16 + (((lane >> 3) & 1) << 3);
          ldmatrix_x4(r, smem_u32(Kt + key * LD + col));
          mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
        }
      }

      // scale, mask (only on tiles that cross a bound of the warp's rows),
      // online softmax (a row lives in the 4 lanes of a quad)
      const bool masked = k0 + BN > T_len ||
                          (causal && k0 + BN - 1 > w_lo) ||
                          (window > 0 && k0 <= w_hi - window);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= scale;
          if (masked) {
            const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
            const int pos = qp[e >> 1];
            bool ok = kpos < T_len;
            if (causal) ok = ok && kpos <= pos;
            if (window > 0) ok = ok && kpos > pos - window;
            s[j][e] = ok ? s[j][e] : NEG_INF;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        corr[i] = __expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= corr[i];   // this lane's share of the row sum
      }
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - m[e >> 1]);
          l[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int d = 0; d < DN; ++d) {
        o[d][0] *= corr[0];
        o[d][1] *= corr[0];
        o[d][2] *= corr[1];
        o[d][3] *= corr[1];
      }

      // O += P V with P = p_hi + p_lo, 16 keys per step
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t ah[4], al[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int dp = 0; dp < DN / 2; ++dp) {
          uint32_t r[4];
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = dp * 16 + ((lane >> 4) << 3);
          ldmatrix_x4_trans(r, smem_u32(Vt + key * LD + col));
          mma_bf16(o[2 * dp], ah, r[0], r[1]);
          mma_bf16(o[2 * dp], al, r[0], r[1]);
          mma_bf16(o[2 * dp + 1], ah, r[2], r[3]);
          mma_bf16(o[2 * dp + 1], al, r[2], r[3]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  bf16* ob = out + ((long long)bg * SR + row0) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow + gid + 8 * i;
    if (row >= n_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int d = 0; d < DN; ++d)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * HD + d * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(o[d][2 * i] * inv, o[d][2 * i + 1] * inv);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int G, int S, int R, int T_len, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  const int smem = Smem<HD>::bytes;
  auto kernel = flash_prefill_mma_kernel<HD>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = allow_shared(kernel, smem, granted);
  if (err != cudaSuccess) return int(err);
  const dim3 grid(B * G, (S * R + BM - 1) / BM);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), G, S, R, T_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      causal, window, q_offset, scale);
  return int(cudaGetLastError());
}

}  // namespace tc

// One head-dim switch for both kernels: Kernel<HD>::launch.
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

template <int HD>
struct TensorCoreBF16 {
  template <typename... A>
  static int run(A... a) { return tc::launch<HD>(a...); }
};

}  // namespace
}  // namespace relserve

// Strides are in elements: q (b, g, s, r), k (b, g, t), v (b, g, t); the
// head dim is contiguous everywhere and out is contiguous [B, G, S, R, hd].
// dtype: 0 = float32 (SIMT kernel), 1 = bfloat16 (tensor-core kernel).
// Returns cudaGetLastError() after launch.
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
    return launch_hd<TensorCoreBF16>(hd, q, k, v, out, B, G, S, R, T_len, st,
                                     causal, window, q_offset, scale, s);
  return int(cudaErrorInvalidValue);
}
