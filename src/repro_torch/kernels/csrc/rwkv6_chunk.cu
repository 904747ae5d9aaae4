// RWKV6 chunked-WKV kernels for Hopper (sm_90a): one call per layer, a
// chunk-parallel pass and the state carry.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_chunk.py:_kernel (entry
// rwkv6_chunk), which computes one chunk of what the RWKV6 model's prefill
// runs as a loop over chunks (src/repro/models/rwkv6.py:wkv6_chunk). Here
// one call runs that whole loop: n = S / c chunks, each with the one-chunk
// arithmetic, all in float32. For one (batch, head) and chunk:
//   ldi = cumsum_t(logw), lde = ldi - logw  (chunk-local, inclusive/exclusive)
//   A[t,j] = sum_k r[t,k] k[j,k] exp(min(lde[t,k] - ldi[j,k], 0))   (j < t)
//   A[t,t] = sum_k r[t,k] k[t,k] u[k]
//   o = (r * exp(lde)) @ S + A @ v
//   S' = exp(ldi[c-1]) * S + (k * exp(ldi[c-1] - ldi))^T @ v
// At n = 1 this is the Pallas kernel's function; every chunk's arithmetic is
// the same whatever n and the chunk's position, so an n-chunk call computes
// bit for bit what n chained one-chunk calls compute.
//
// Bound, at one rwkv6-7b layer's call at S = 256 (r/k/v bf16 [1, 256, 64,
// 64], logw/u/state f32, o f32): bytes, 16.79 MB (5.01 us at 3.35 TB/s);
// the operations take 2.0 us (the three products in 3xTF32 at 495 TFLOP/s,
// three TF32 products per f32 one, two with a bf16 v; A, the decays and
// the state's decay at 67 TFLOP/s). Bytes bound every shape up to S =
// 12288. The workspace below is the kernels' own and is not counted.
//
// Only S_n = d_n * S_{n-1} + U_n is serial. Everything else of a chunk
// depends on its own inputs, or (o) on S_{n-1} without feeding the chain.
// So two kernels, launched back to back on the caller's stream, the second
// as the first's programmatic dependent (its blocks start as the first
// drains and wait for it before their first load):
//
// 1. Intra pass, one team of TEAM_WARPS warps per 16 tokens for each
//    (batch, head, chunk), as many teams per block of at most 256 threads
//    as shared memory holds, each on its own shared memory, mbarrier and
//    named barrier. One thread loads the chunk's r, k, v and logw tiles by
//    TMA (4-D tensor maps over the callers' strided views). Then, as the
//    one-chunk kernel did: each channel's log-decays summed in token order
//    from 0 at the chunk start; r~ = r exp(lde), k~ = k exp(ldi[c-1] -
//    ldi), d = exp(ldi[c-1]); A in 4x4 tiles of (t, j) pairs, each over K
//    by 16 lanes of 4 channels with the per-(t, j, k) decays on the SFU's
//    exp, summed by a reduce-scatter of shuffles. The decays of A do not
//    factor into exp(lde[t]) exp(-ldi[j]): logw reaches -2e4 and exp(-ldi)
//    overflows, so A stays on f32 FMAs. Then A v and U = k~^T v on the
//    tensor cores (mma.sync m16n8k8, TF32 operands, 3xTF32: each f32
//    operand split into a TF32 high part and the rest, three products
//    summed in f32; a bf16 v is exact in TF32, so two). The chunk's record
//    goes to a float32 workspace: r~, U, A v and d, each laid out as the
//    carry's fragments want them.
// 2. Carry pass, grid (B*H, V / CARRY_COLS): each 16 state columns are
//    held by CARRY_KW warps, each the k rows of its share as the A
//    fragments of S^T in an m16n8k8 product (k permuted within each group
//    of 8: slot i holds k = 2i, slot i + 4 holds 2i + 1, for r~ and S
//    alike). A producer warp brings each chunk's record (r~ and d whole,
//    U and A v of the block's columns) through a ring of shared-memory
//    stages by TMA bulk copies. Per chunk: each warp's share of o^T = S^T
//    r~^T (3xTF32), the shares summed in shared memory in k order, +
//    (A v)^T, rounded once to o's dtype; then S = d S + U (one FMA per
//    element: the chain).
//
// The workspace is B*H*n*(c*K + V*K + V*c + K) floats: 25.4 MB at S = 256,
// 102 MB at S = 1024. TEAM_WARPS, CARRY_COLS, CARRY_KW and the split were
// chosen by timing builds of variants; per layer at [1, 256] c 16 and
// [1, 12288] c 64 (NVIDIA H100 80GB HBM3, 700 W): the values below 0.0332
// and 1.6917 ms; 64 carry columns 0.0367 and 1.8744; one warp per 16
// columns 0.0428 and 2.0838; one-warp teams 0.0345 and 2.1394; the split
// by cvt.rna.tf32 0.0370 and 1.8987 (PERF.md). The intra pass is bound by
// its own latency (one warp per 16 tokens leaves a chunk to too few warps,
// a 256-thread block per chunk runs in waves), the carry by how fast each
// SM takes in the records (U, K x V floats a chunk, is most of them), not
// by its arithmetic.

#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace relserve {
namespace {

constexpr int KMAX = 64;             // K and V: multiples of 16, at most 64
constexpr int LANES = 16;            // lanes that sum one 4x4 tile of A over K
constexpr int NT = 256;              // intra-pass threads per block, at most
constexpr int CARRY_COLS = 32;       // state columns per carry block
constexpr int CARRY_KW = 4;          // warps per 16 of them
constexpr int TEAM_WARPS = 2;        // intra-pass warps per 16 tokens
constexpr int MAX_STAGES = 8;
constexpr int RING_BYTES = 200 * 1024;          // carry ring + partial sums
static_assert(CARRY_COLS % 16 == 0 && CARRY_COLS <= KMAX, "carry columns");

// One chunk's record in the workspace, in floats:
//   r~  [c/8][K/8][32][2]  the carry's B fragments: lane (g, i) of (nt, s)
//                          holds r~[8nt + g][8s + 2i + {0, 1}]
//   U   [V/16][K/8][32][4] the carry's A fragments of U^T: lane (g, i) of
//                          (w, s) holds (16w + g, 8s + 2i), (16w + g + 8,
//                          8s + 2i), (16w + g, 8s + 2i + 1), (16w + g + 8,
//                          8s + 2i + 1) as (v, k)
//   Av  [V/16][c/8][32][4] the carry's accumulators of o^T: (v, t) = (16w
//                          + g, 8nt + 2i), (.., + 1), (16w + g + 8, 8nt +
//                          2i), (.., + 1)
//   d   [K]
// (g = lane / 4, i = lane % 4.) Every part is a multiple of 16 bytes.
struct Rec {
  int u, y, d, size;
  __host__ __device__ Rec(int C, int K, int V)
      : u(C * K), y(C * K + V * K), d(C * K + V * K + V * C),
        size(C * K + V * K + V * C + K) {}
};

__host__ __device__ inline int up128(int x) { return (x + 127) / 128 * 128; }

// Shared memory of one chunk's team in the intra pass, in bytes from a
// 128-byte aligned base: the TMA tiles r, k, v [C][K or V] in TI and logw
// [C][K] in TW, then floats: ldi and k~ as [C][K + 4], A as [C][C + 8] (row
// strides that keep the fragment loads free of bank conflicts); the
// mbarrier. lde is ldi - logw, formed where it is read.
template <typename TI, typename TW, int C>
struct TeamSmem {
  int rr, kr, vr, wr, li, ks, as, bar, bytes;
  __host__ __device__ TeamSmem(int K, int V) {
    rr = 0;
    kr = up128(rr + C * K * int(sizeof(TI)));
    vr = up128(kr + C * K * int(sizeof(TI)));
    wr = up128(vr + C * V * int(sizeof(TI)));
    li = up128(wr + C * K * int(sizeof(TW)));
    ks = li + C * (K + 4) * 4;
    as = ks + C * (K + 4) * 4;
    bar = as + C * (C + 8) * 4;
    bytes = up128(bar + 8);
  }
};

constexpr int SMEM_MAX = 232448;     // a block's shared memory on sm_90

// Warps of the team that computes one chunk in the intra pass: TEAM_WARPS
// per 16 tokens.
template <int C>
__host__ __device__ constexpr int team_warps() {
  return TEAM_WARPS * C / 16;
}

// Chunks per intra block: one team each, up to NT threads, as many teams
// as shared memory holds.
template <typename TI, typename TW, int C>
__host__ __device__ inline int intra_teams(int K, int V) {
  const int fit = (SMEM_MAX - 128) / TeamSmem<TI, TW, C>(K, V).bytes;
  const int most = NT / (32 * team_warps<C>());
  return fit < 1 ? 1 : fit < most ? fit : most;
}
static_assert(32 * TEAM_WARPS * 4 <= NT, "a chunk of 64 in one block");

// Four consecutive elements (16 or 8 bytes, aligned) as floats.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float comp(const float4& x, int c) {
  return c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
}

// exp(min(lde[t,k] - ldi[j,k], 0)), on the SFU
__device__ __forceinline__ float decay(float lde_t, float ldi_j) {
  return __expf(fminf(lde_t - ldi_j, 0.f));
}

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128 - (smem_u32(p) & 127)) & 127);
}

// Programmatic dependent launch: the carry may start once every intra block
// has run allow_dependent_grid(); wait_for_producer_grid() then blocks until
// the intra pass has completed and its writes are visible.
__device__ __forceinline__ void wait_for_producer_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_dependent_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync
// ---------------------------------------------------------------------------
// x = hi + lo: hi keeps the sign, exponent and top 10 mantissa bits (a TF32
// value), lo = x - hi exactly; the tensor cores read lo's top 19 bits, so
// the split keeps ~21 bits of x. Two instructions, where rounding both
// parts with cvt.rna.tf32 measured slower (PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: m16n8k8, a 16 x 8 (row), b 8 x 8 (col), TF32 in, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// intra pass
// ---------------------------------------------------------------------------
// One 4x4 tile (ti, tj) of A over this lane's 4 channels k0..k0+3, then
// summed over the 16 lanes of the tile: lane p keeps pair (4 ti + p / 4,
// 4 tj + p % 4). Pairs above the diagonal stay 0; the diagonal uses u.
template <typename TI, typename TW>
__device__ __forceinline__ float a_tile(const TI* Rr, const TI* Kr,
                                        const TW* Wr, const float* Li,
                                        const float4& u4, int ti, int tj,
                                        int k0, int K, int KP, int lane16,
                                        unsigned mask) {
  float acc[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) acc[p] = 0.f;
  if (k0 < K) {
    float4 r4[4], e4[4], k4[4], l4[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      r4[a] = load4(Rr + (4 * ti + a) * K + k0);
      const float4 li = load4(Li + (4 * ti + a) * KP + k0);
      const float4 w = load4(Wr + (4 * ti + a) * K + k0);
      e4[a] = make_float4(li.x - w.x, li.y - w.y, li.z - w.z, li.w - w.w);
      k4[a] = load4(Kr + (4 * tj + a) * K + k0);
      l4[a] = load4(Li + (4 * tj + a) * KP + k0);
    }
    if (ti != tj) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[4 * a + b] += comp(r4[a], c) * comp(k4[b], c) *
                              decay(comp(e4[a], c), comp(l4[b], c));
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b <= a; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float rk = comp(r4[a], c) * comp(k4[b], c);
            const float w = b == a ? comp(u4, c)
                                   : decay(comp(e4[a], c), comp(l4[b], c));
            acc[4 * a + b] += rk * w;
          }
    }
  }
  // reduce-scatter over the 16 lanes: 16 -> 8 -> 4 -> 2 -> 1 values
  float v8[8], v4[4], v2[2];
  const bool h8 = lane16 & 8, h4 = lane16 & 4, h2 = lane16 & 2, h1 = lane16 & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v8[i] = (h8 ? acc[i + 8] : acc[i]) +
            __shfl_xor_sync(mask, h8 ? acc[i] : acc[i + 8], 8);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v4[i] = (h4 ? v8[i + 4] : v8[i]) +
            __shfl_xor_sync(mask, h4 ? v8[i] : v8[i + 4], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v2[i] = (h2 ? v4[i + 2] : v4[i]) +
            __shfl_xor_sync(mask, h2 ? v4[i] : v4[i + 2], 2);
  return (h1 ? v2[1] : v2[0]) + __shfl_xor_sync(mask, h1 ? v2[0] : v2[1], 1);
}

// One team of team_warps<C>() warps per (batch, head, chunk) item,
// intra_teams() teams per block, each on its own shared memory, mbarrier and
// named barrier: no barrier spans the block.
template <typename TI, typename TW, int C>
__global__ void __launch_bounds__(NT, 2)
rwkv6_intra_kernel(const __grid_constant__ CUtensorMap rmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ u, float* __restrict__ ws, int H,
                   int n_chunks, int items, int K, int V) {
  constexpr int TWARPS = team_warps<C>(), TT = 32 * TWARPS;
  constexpr int T = C / 4;                       // tile rows of A
  constexpr int NTILE = T * (T + 1) / 2;         // lower tiles
  constexpr int TPP = TT / LANES;                // tiles per pass
  constexpr int AP = C + 8;                      // row stride of A
  constexpr int JS = C / 8;                      // k-steps over the tokens
  allow_dependent_grid();
  extern __shared__ unsigned char sm_raw[];
  const TeamSmem<TI, TW, C> L(K, V);
  const int team = threadIdx.x / TT, tt = threadIdx.x % TT;
  const int lane = tt & 31, wt = tt >> 5;
  const int item = blockIdx.x * (blockDim.x / TT) + team;
  if (item >= items) return;
  unsigned char* sm = align128(sm_raw) + team * L.bytes;
  const Rec rec(C, K, V);
  const TI* Rr = reinterpret_cast<const TI*>(sm + L.rr);
  const TI* Kr = reinterpret_cast<const TI*>(sm + L.kr);
  const TI* Vr = reinterpret_cast<const TI*>(sm + L.vr);
  const TW* Wr = reinterpret_cast<const TW*>(sm + L.wr);
  float* Li = reinterpret_cast<float*>(sm + L.li);   // ldi
  float* Ks = reinterpret_cast<float*>(sm + L.ks);   // k * exp(ldi[c-1] - ldi)
  float* As = reinterpret_cast<float*>(sm + L.as);
  const uint32_t bar = smem_u32(sm + L.bar);
  const int bid = 1 + team;                      // the team's named barrier
  const int KP = K + 4;

  const int bh = item / n_chunks, chunk = item % n_chunks;
  const int b = bh / H, h = bh % H;
  float* out = ws + (long long)item * rec.size;

  if (tt == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, C * (2 * K + V) * sizeof(TI) + C * K * sizeof(TW));
    const int t0 = chunk * C;
    tma_load_4d(smem_u32(Rr), &rmap, bar, 0, h, t0, b);
    tma_load_4d(smem_u32(Kr), &kmap, bar, 0, h, t0, b);
    tma_load_4d(smem_u32(Vr), &vmap, bar, 0, h, t0, b);
    tma_load_4d(smem_u32(Wr), &wmap, bar, 0, h, t0, b);
  }
  // A is summed over every j below by the tensor cores: zero its upper part
  for (int x = tt; x < C * AP; x += TT) As[x] = 0.f;
  named_sync(bid, TT);
  mbar_wait(bar, 0);

  // each channel's log-decay sums, in token order from 0
  for (int kk = tt; kk < K; kk += TT) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      acc += to_float(Wr[t * K + kk]);
      Li[t * KP + kk] = acc;
    }
  }
  named_sync(bid, TT);

  // r~ = r exp(ldi - logw) into the record in the carry's fragment order
  // (pair p: lane p % 32 of fragment (nt, s) = p / 32); k~ and d. Indices
  // step without division.
  const int KS = K / 8;
  {
    const int g = lane >> 2, kq = 2 * (lane & 3);
    int s = wt % KS, nt = wt / KS;
    for (int p = tt; p < C * K / 2; p += TT) {
      const int t = 8 * nt + g, kk = 8 * s + kq;
      float2 x;
      x.x = to_float(Rr[t * K + kk]) *
            expf(Li[t * KP + kk] - to_float(Wr[t * K + kk]));
      x.y = to_float(Rr[t * K + kk + 1]) *
            expf(Li[t * KP + kk + 1] - to_float(Wr[t * K + kk + 1]));
      *reinterpret_cast<float2*>(out + 2 * p) = x;
      for (s += TWARPS; s >= KS; s -= KS) ++nt;
    }
  }
  const float* last = Li + (C - 1) * KP;
  {
    int t = tt / K, kk = tt % K;
    for (int x = tt; x < C * K; x += TT) {
      Ks[t * KP + kk] = to_float(Kr[x]) * expf(last[kk] - Li[t * KP + kk]);
      t += TT / K, kk += TT % K;
      if (kk >= K) kk -= K, ++t;
    }
  }
  for (int kk = tt; kk < K; kk += TT) out[rec.d + kk] = expf(last[kk]);

  // A: lane16 owns channels k0 .. k0+3 of the tile of its half-warp; the
  // T diagonal tiles first, then the strictly lower ones by rows (T and
  // TPP are even, so the two half-warps of a warp take the same path)
  {
    const int lane16 = tt % LANES, slot = tt / LANES, k0 = 4 * lane16;
    const unsigned mask = 0xffffu << (tt & 16);
    const float4 u4 = k0 < K ? load4(u + h * K + k0) : make_float4(0, 0, 0, 0);
#pragma unroll 1
    for (int pass = 0; pass < (NTILE + TPP - 1) / TPP; ++pass) {
      const int tile = pass * TPP + slot;
      if (tile < NTILE) {
        int ti = tile, tj = tile;
        if (tile >= T) {
          const int o = tile - T;
          ti = 1;
          while ((ti + 1) * ti / 2 <= o) ++ti;
          tj = o - ti * (ti - 1) / 2;
        }
        const float a = a_tile(Rr, Kr, Wr, Li, u4, ti, tj, k0, K, KP, lane16,
                               mask);
        const int t = 4 * ti + lane16 / 4, j = 4 * tj + lane16 % 4;
        if (j <= t) As[t * AP + j] = a;
      }
    }
  }
  named_sync(bid, TT);

  // (A v)^T = v^T A^T and U^T = v^T k~ on the tensor cores: for each m-tile
  // of 16 rows v, the team's warps take every TWARPS-th n-tile of [A: c/8 |
  // k~: K/8]. The reduction runs over the chunk's tokens j, permuted within
  // each group of 8 as the record's k is.
  const int g = lane >> 2, i = lane & 3;
  const int NA = C / 8, NN = NA + K / 8;
  constexpr bool exact_v = sizeof(TI) == 2;   // bf16 v is exact in TF32
  for (int mt = 0; mt < V / 16; ++mt) {
    uint32_t ahi[JS][4], alo[JS][4];
#pragma unroll
    for (int js = 0; js < JS; ++js) {
      const TI* v0 = Vr + (8 * js + 2 * i) * V + 16 * mt + g;
      const float x[4] = {to_float(v0[0]), to_float(v0[8]), to_float(v0[V]),
                          to_float(v0[V + 8])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (exact_v) {
          ahi[js][e] = __float_as_uint(x[e]);
          alo[js][e] = 0u;
        } else {
          split_tf32(x[e], ahi[js][e], alo[js][e]);
        }
      }
    }
#pragma unroll 2
    for (int nt = wt; nt < NN; nt += TWARPS) {
      float hh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f},
            lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int js = 0; js < JS; ++js) {
        float b0, b1;
        if (nt < NA) {
          const float2 p = *reinterpret_cast<const float2*>(
              As + (8 * nt + g) * AP + 8 * js + 2 * i);
          b0 = p.x, b1 = p.y;
        } else {
          const float* kq = Ks + (8 * js + 2 * i) * KP + 8 * (nt - NA) + g;
          b0 = kq[0], b1 = kq[KP];
        }
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(b0, bh0, bl0);
        split_tf32(b1, bh1, bl1);
        mma_tf32(hh, ahi[js], bh0, bh1);
        mma_tf32(hl, ahi[js], bl0, bl1);
        if (!exact_v) mma_tf32(lh, alo[js], bh0, bh1);
      }
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = hh[e] + (hl[e] + lh[e]);
      if (nt < NA)
        *reinterpret_cast<float4*>(out + rec.y + ((mt * NA + nt) * 32 + lane) * 4) =
            make_float4(d[0], d[1], d[2], d[3]);
      else
        *reinterpret_cast<float4*>(
            out + rec.u + ((mt * (K / 8) + nt - NA) * 32 + lane) * 4) =
            make_float4(d[0], d[2], d[1], d[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// carry pass
// ---------------------------------------------------------------------------
// A ring stage: the record's r~ and d whole, U and A v of this block's
// columns: [r~ | U cols | Av cols | d], in floats.
struct Stage {
  int u, y, d, size;
  __host__ __device__ Stage(int C, int K, int VT)
      : u(C * K), y(C * K + 16 * VT * K), d(C * K + 16 * VT * K + 16 * VT * C),
        size(C * K + 16 * VT * K + 16 * VT * C + K) {}
};

// Floats of the partial sums of o^T that the KW warps of a column tile hand
// to each other: two buffers (chunk parity) of [VT][KW][C/8][32][4].
template <int C, int VT, int KW>
__host__ __device__ constexpr int partial_floats() {
  return KW == 1 ? 0 : 2 * VT * KW * (C / 8) * 128;
}

template <int C, int VT, int KW>
__host__ __device__ inline int carry_stages(int stage_floats) {
  const int n = (RING_BYTES - partial_floats<C, VT, KW>() * 4) /
                (stage_floats * 4);
  return n < 2 ? 2 : n > MAX_STAGES ? MAX_STAGES : n;
}

template <int C, int VT, int KW>
__host__ __device__ inline int carry_smem(int stage_floats) {
  return carry_stages<C, VT, KW>(stage_floats) * stage_floats * 4 +
         partial_floats<C, VT, KW>() * 4 + 2 * MAX_STAGES * 8 + 128;
}

// VT column tiles of 16 state columns, each split over KW warps by the k
// rows of the state (k-steps of 8, in contiguous groups): warp vt * KW + kw
// holds S^T[16 vt.., its k rows] and sums o over them; the KW partial sums
// of a tile meet in shared memory, summed in kw order. Warp VT * KW is the
// producer.
template <typename TO, int C, int VT, int KW>
__global__ void __launch_bounds__(32 * (VT * KW + 1))
rwkv6_carry_kernel(const float* __restrict__ ws,
                   const float* __restrict__ state, TO* __restrict__ out,
                   float* __restrict__ state_out, int H, int n_chunks, int K,
                   int V) {
  constexpr int NA = C / 8, NW = VT * KW;
  constexpr int KSW = (KMAX / 8 + KW - 1) / KW;   // k-steps per warp, at most
  extern __shared__ unsigned char sm_raw[];
  unsigned char* sm = align128(sm_raw);
  const Rec rec(C, K, V);
  const Stage stg(C, K, VT);
  const int NS = carry_stages<C, VT, KW>(stg.size);
  float* ring = reinterpret_cast<float*>(sm);
  float* part = ring + NS * stg.size;
  const uint32_t bars = smem_u32(part + partial_floats<C, VT, KW>());
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };

  const int bh = blockIdx.x, w0 = blockIdx.y * VT;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int KS = K / 8;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), NW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {
    if (lane == 0) {
      wait_for_producer_grid();
      const float* src = ws + (long long)bh * n_chunks * rec.size;
      for (int c = 0; c < n_chunks; ++c, src += rec.size) {
        const int s = c % NS;
        if (c >= NS) mbar_wait(empty(s), (c / NS - 1) & 1);
        const uint32_t dst = smem_u32(ring + s * stg.size);
        mbar_expect_tx(full(s), stg.size * 4);
        bulk_load(dst, src, C * K * 4, full(s));
        bulk_load(dst + stg.u * 4, src + rec.u + w0 * KS * 128,
                  VT * KS * 128 * 4, full(s));
        bulk_load(dst + stg.y * 4, src + rec.y + w0 * NA * 128,
                  VT * NA * 128 * 4, full(s));
        bulk_load(dst + stg.d * 4, src + rec.d, K * 4, full(s));
      }
    }
    return;
  }

  // this warp's k-steps s0 .. s1-1; its lanes' A fragments of S^T: rows
  // v0 + g (+ 8), k = 8s + 2i (+ 1)
  const int vt = warp / KW, kw = warp % KW;
  const int per = (KS + KW - 1) / KW;
  const int s0 = kw * per, ns = max(0, min(KS, s0 + per) - s0);
  const int g = lane >> 2, i = lane & 3;
  const int v0 = 16 * (w0 + vt);
  float S[KSW][4];
  const float* sb = state + (long long)bh * K * V;
#pragma unroll
  for (int q = 0; q < KSW; ++q) {
    if (q < ns) {
      const float* p = sb + (8 * (s0 + q) + 2 * i) * V + v0 + g;
      S[q][0] = p[0], S[q][1] = p[8], S[q][2] = p[V], S[q][3] = p[V + 8];
    }
  }
  const long long seq = (long long)n_chunks * C;
  const long long row = (long long)H * V;
  TO* ob = out + ((long long)b * seq * H + h) * V + v0 + g;

  for (int c = 0; c < n_chunks; ++c) {
    const int s_ = c % NS;
    mbar_wait(full(s_), (c / NS) & 1);
    const float* st = ring + s_ * stg.size;
    uint32_t shi[KSW][4], slo[KSW][4];
#pragma unroll
    for (int q = 0; q < KSW; ++q)
      if (q < ns)
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(S[q][e], shi[q][e], slo[q][e]);
    // o^T = S^T r~^T over this warp's k rows, 8 tokens per n-tile
    float4 o4[NA];
#pragma unroll
    for (int nt = 0; nt < NA; ++nt) {
      float hh[4] = {0.f, 0.f, 0.f, 0.f}, hl[4] = {0.f, 0.f, 0.f, 0.f},
            lh[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < KSW; ++q) {
        if (q < ns) {
          const float2 p = *reinterpret_cast<const float2*>(
              st + ((nt * KS + s0 + q) * 32 + lane) * 2);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(p.x, bh0, bl0);
          split_tf32(p.y, bh1, bl1);
          mma_tf32(hh, shi[q], bh0, bh1);
          mma_tf32(hl, shi[q], bl0, bl1);
          mma_tf32(lh, slo[q], bh0, bh1);
        }
      }
      o4[nt] = make_float4(hh[0] + (hl[0] + lh[0]), hh[1] + (hl[1] + lh[1]),
                           hh[2] + (hl[2] + lh[2]), hh[3] + (hl[3] + lh[3]));
    }
    if (KW > 1) {
      float* pw = part + (c & 1) * (partial_floats<C, VT, KW>() / 2) +
                  (vt * KW + kw) * NA * 128;
#pragma unroll
      for (int nt = 0; nt < NA; ++nt)
        *reinterpret_cast<float4*>(pw + (nt * 32 + lane) * 4) = o4[nt];
      named_sync(1, 32 * NW);
    }
    // warp kw finishes the n-tiles nt = kw, kw + KW, ...: the partial sums
    // in kw order, + (A v)^T, rounded once to o's dtype
#pragma unroll
    for (int nt = 0; nt < NA; ++nt) {
      if (nt % KW != kw) continue;
      float4 o = o4[nt];
      if (KW > 1) {
        const float* pt = part + (c & 1) * (partial_floats<C, VT, KW>() / 2) +
                          vt * KW * NA * 128 + (nt * 32 + lane) * 4;
        o = *reinterpret_cast<const float4*>(pt);
#pragma unroll
        for (int q = 1; q < KW; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(pt + q * NA * 128);
          o.x += x.x, o.y += x.y, o.z += x.z, o.w += x.w;
        }
      }
      const float4 y = *reinterpret_cast<const float4*>(
          st + stg.y + ((vt * NA + nt) * 32 + lane) * 4);
      TO* dst = ob + ((long long)c * C + 8 * nt + 2 * i) * row;
      dst[0] = from_float<TO>(o.x + y.x);
      dst[row] = from_float<TO>(o.y + y.y);
      dst[8] = from_float<TO>(o.z + y.z);
      dst[row + 8] = from_float<TO>(o.w + y.w);
    }
    // the chain: S = d S + U
#pragma unroll
    for (int q = 0; q < KSW; ++q) {
      if (q < ns) {
        const float4 uu = *reinterpret_cast<const float4*>(
            st + stg.u + ((vt * KS + s0 + q) * 32 + lane) * 4);
        const float2 d = *reinterpret_cast<const float2*>(
            st + stg.d + 8 * (s0 + q) + 2 * i);
        S[q][0] = fmaf(S[q][0], d.x, uu.x);
        S[q][1] = fmaf(S[q][1], d.x, uu.y);
        S[q][2] = fmaf(S[q][2], d.y, uu.z);
        S[q][3] = fmaf(S[q][3], d.y, uu.w);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s_));
  }

  float* so = state_out + (long long)bh * K * V;
#pragma unroll
  for (int q = 0; q < KSW; ++q) {
    if (q < ns) {
      float* p = so + (8 * (s0 + q) + 2 * i) * V + v0 + g;
      p[0] = S[q][0], p[8] = S[q][1], p[V] = S[q][2], p[V + 8] = S[q][3];
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------
struct Strides {
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
};

// A [B, S, H, D] view as the 4-D map (D, H, S, B) over its strides (in
// elements); a box is one chunk of one head, (D, 1, C, 1), no swizzle.
inline int seq_map(CUtensorMap* map, const void* p, int esize, int D, int H,
                   long long S, int B, long long sb, long long st,
                   long long sh, int C) {
  const long long dims[4] = {D, H, S, B};
  const long long strides[3] = {sh * esize, st * esize, sb * esize};
  const int box[4] = {D, 1, C, 1};
  return encode_map_4d(map,
                       esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       esize, p, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The carry as the intra pass's programmatic dependent: its blocks may
// start while the intra pass drains, and wait for it before the first load.
template <typename TO, int C, int VT, int KW>
int launch_carry(const float* ws, const float* state, void* out,
                 float* state_out, int B, int n_chunks, int H, int K, int V,
                 cudaStream_t stream) {
  auto carry = rwkv6_carry_kernel<TO, C, VT, KW>;
  static int granted[kMaxDevices] = {};
  const int smem = carry_smem<C, VT, KW>(Stage(C, K, VT).size);
  cudaError_t err = allow_shared(carry, smem, granted);
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, V / (16 * VT));
  cfg.blockDim = dim3(32 * (VT * KW + 1));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return int(cudaLaunchKernelEx(&cfg, carry, ws, state, static_cast<TO*>(out),
                                state_out, H, n_chunks, K, V));
}

template <typename TI, typename TW, typename TO, int C>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, const float* state, void* out, float* state_out,
           float* ws, int B, int n_chunks, int H, int K, int V,
           const Strides& st, cudaStream_t stream) {
  const long long S = (long long)n_chunks * C;
  const int ei = sizeof(TI), ew = sizeof(TW);
  CUtensorMap rm, km, vm, wm;
  int err = seq_map(&rm, r, ei, K, H, S, B, st.rb, st.rt, st.rh, C);
  if (!err) err = seq_map(&km, k, ei, K, H, S, B, st.kb, st.kt, st.kh, C);
  if (!err) err = seq_map(&vm, v, ei, V, H, S, B, st.vb, st.vt, st.vh, C);
  if (!err) err = seq_map(&wm, logw, ew, K, H, S, B, st.wb, st.wt, st.wh, C);
  if (err) return err;

  auto intra = rwkv6_intra_kernel<TI, TW, C>;
  static int granted_i[kMaxDevices] = {};
  const int teams = intra_teams<TI, TW, C>(K, V);
  const int smem_i = teams * TeamSmem<TI, TW, C>(K, V).bytes + 128;
  cudaError_t cerr = allow_shared(intra, smem_i, granted_i);
  if (cerr != cudaSuccess) return int(cerr);
  const int items = B * H * n_chunks;
  intra<<<(items + teams - 1) / teams, teams * 32 * team_warps<C>(), smem_i,
          stream>>>(
      rm, km, vm, wm, u, ws, H, n_chunks, items, K, V);
  cerr = cudaGetLastError();
  if (cerr != cudaSuccess) return int(cerr);

  // CARRY_COLS state columns per block where V allows it, else 16
  constexpr int VT = CARRY_COLS / 16;
  if (V % CARRY_COLS == 0)
    return launch_carry<TO, C, VT, CARRY_KW>(ws, state, out, state_out, B,
                                             n_chunks, H, K, V, stream);
  return launch_carry<TO, C, 1, CARRY_KW>(ws, state, out, state_out, B,
                                          n_chunks, H, K, V, stream);
}

template <typename TI, typename TW, typename TO>
int launch_c(int c, const void* r, const void* k, const void* v,
             const void* logw, const float* u, const float* state, void* out,
             float* state_out, float* ws, int B, int n_chunks, int H, int K,
             int V, const Strides& st, cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch<TI, TW, TO, 16>(r, k, v, logw, u, state, out, state_out,
                                    ws, B, n_chunks, H, K, V, st, stream);
    case 32:
      return launch<TI, TW, TO, 32>(r, k, v, logw, u, state, out, state_out,
                                    ws, B, n_chunks, H, K, V, st, stream);
    case 64:
      return launch<TI, TW, TO, 64>(r, k, v, logw, u, state, out, state_out,
                                    ws, B, n_chunks, H, K, V, st, stream);
  }
  return int(cudaErrorInvalidValue);
}

template <typename TI, typename TW>
int launch_out(int out_dtype, int c, const void* r, const void* k,
               const void* v, const void* logw, const float* u,
               const float* state, void* out, float* state_out, float* ws,
               int B, int n_chunks, int H, int K, int V, const Strides& st,
               cudaStream_t stream) {
  if (out_dtype == 0)
    return launch_c<TI, TW, float>(c, r, k, v, logw, u, state, out, state_out,
                                   ws, B, n_chunks, H, K, V, st, stream);
  if (out_dtype == 1)
    return launch_c<TI, TW, __nv_bfloat16>(c, r, k, v, logw, u, state, out,
                                           state_out, ws, B, n_chunks, H, K, V,
                                           st, stream);
  return int(cudaErrorInvalidValue);
}

// Instances at K = V = 64 (rwkv6-7b's heads): registers, shared memory,
// threads and resident blocks per SM.
template <typename TI, typename TW, int C>
int query_intra(int* regs, int* smem, int* threads, int* blocks) {
  static int granted[kMaxDevices] = {};
  const int teams = intra_teams<TI, TW, C>(KMAX, KMAX);
  *threads = teams * 32 * team_warps<C>();
  return occupancy(rwkv6_intra_kernel<TI, TW, C>, *threads,
                   teams * TeamSmem<TI, TW, C>(KMAX, KMAX).bytes + 128,
                   granted, regs, smem, blocks);
}

template <typename TO, int C>
int query_carry(int* regs, int* smem, int* threads, int* blocks) {
  static int granted[kMaxDevices] = {};
  constexpr int VT = CARRY_COLS / 16;
  *threads = 32 * (VT * CARRY_KW + 1);
  return occupancy(rwkv6_carry_kernel<TO, C, VT, CARRY_KW>, *threads,
                   carry_smem<C, VT, CARRY_KW>(Stage(C, KMAX, VT).size),
                   granted, regs, smem, blocks);
}

}  // namespace
}  // namespace relserve

// Floats of the workspace for n_chunks chunks of c tokens of B*H heads.
extern "C" long long rwkv6_chunk_workspace(int B, int H, int n_chunks, int c,
                                           int K, int V) {
  return (long long)B * H * n_chunks * relserve::Rec(c, K, V).size;
}

// r/k/logw [B, S, H, K] and v [B, S, H, V], read through their (batch,
// time, head) strides in elements, with the last dim contiguous and every
// row 16-byte aligned; u [H, K] and state [B, H, K, V] contiguous float32;
// out [B, S, H, V] and state_out contiguous; ws a float32 workspace of
// rwkv6_chunk_workspace(...) floats, 16-byte aligned. S = n_chunks * c, c
// in {16, 32, 64}; K and V multiples of 16, at most 64, V a multiple of the
// carry's columns. dtypes: 0 = float32, 1 = bfloat16; r, k and v share
// in_dtype, logw is float32 or in_dtype. Launches the two passes on
// `stream`; returns the first CUDA error (a tensor map's encode, a launch),
// else 0.
extern "C" int rwkv6_chunk_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state, void* out, void* state_out, void* ws,
    int B, int n_chunks, int c, int H, int K, int V, long long srb,
    long long srt, long long srh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long swb, long long swt,
    long long swh, int in_dtype, int w_dtype, int out_dtype, void* stream) {
  using namespace relserve;
  const Strides st{srb, srt, srh, skb, skt, skh, svb, svt, svh, swb, swt, swh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(state);
  float* so = static_cast<float*>(state_out);
  float* w = static_cast<float*>(ws);
  if (B == 0 || H == 0 || n_chunks == 0) return 0;
  if (K % 16 || V % 16 || K > KMAX || V > KMAX)
    return int(cudaErrorInvalidValue);
  if (in_dtype == 0 && w_dtype == 0)
    return launch_out<float, float>(out_dtype, c, r, k, v, logw, uf, sf, out,
                                    so, w, B, n_chunks, H, K, V, st, s);
  if (in_dtype == 1 && w_dtype == 0)
    return launch_out<__nv_bfloat16, float>(out_dtype, c, r, k, v, logw, uf,
                                            sf, out, so, w, B, n_chunks, H, K,
                                            V, st, s);
  if (in_dtype == 1 && w_dtype == 1)
    return launch_out<__nv_bfloat16, __nv_bfloat16>(
        out_dtype, c, r, k, v, logw, uf, sf, out, so, w, B, n_chunks, H, K,
        V, st, s);
  return int(cudaErrorInvalidValue);
}

// Instance i of the kernels the paths launch (the model's r/k/v in bf16,
// logw, u and the state in f32, o in f32): a label, registers, shared
// memory (static + dynamic), threads and resident blocks per SM. Returns
// 0, -1 past the last instance, or a CUDA error.
extern "C" int rwkv6_chunk_occupancy(int i, char* label, int label_len,
                                     int* regs, int* smem, int* threads,
                                     int* blocks) {
  using namespace relserve;
  using bf = __nv_bfloat16;
  static const char* labels[] = {
      "intra, bf16 r/k/v, chunk 16", "intra, bf16 r/k/v, chunk 32",
      "intra, bf16 r/k/v, chunk 64", "intra, f32 r/k/v, chunk 16",
      "carry, o f32, chunk 16",      "carry, o f32, chunk 32",
      "carry, o f32, chunk 64"};
  if (i < 0 || i >= 7) return -1;
  snprintf(label, label_len, "%s", labels[i]);
  switch (i) {
    case 0: return query_intra<bf, float, 16>(regs, smem, threads, blocks);
    case 1: return query_intra<bf, float, 32>(regs, smem, threads, blocks);
    case 2: return query_intra<bf, float, 64>(regs, smem, threads, blocks);
    case 3: return query_intra<float, float, 16>(regs, smem, threads, blocks);
    case 4: return query_carry<float, 16>(regs, smem, threads, blocks);
    case 5: return query_carry<float, 32>(regs, smem, threads, blocks);
    default: return query_carry<float, 64>(regs, smem, threads, blocks);
  }
}
