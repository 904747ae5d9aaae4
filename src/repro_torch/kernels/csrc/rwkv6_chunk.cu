// RWKV6 chunked-WKV kernel for Hopper (sm_90a): one launch walks every chunk
// of a layer's prefill with the WKV state kept on chip.
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6_chunk.py:_kernel (entry
// rwkv6_chunk), which computes one chunk of what the RWKV6 model's prefill
// runs as a loop over chunks (src/repro/models/rwkv6.py:wkv6_chunk). Here
// one launch runs that whole loop: n = S / c chunks, in order, each with the
// one-chunk arithmetic, all in float32. For one (batch, head) and chunk:
//   ldi = cumsum_t(logw), lde = ldi - logw  (chunk-local, inclusive/exclusive)
//   A[t,j] = sum_k r[t,k] k[j,k] exp(min(lde[t,k] - ldi[j,k], 0))   (j < t)
//   A[t,t] = sum_k r[t,k] k[t,k] u[k]
//   o = (r * exp(lde)) @ S + A @ v
//   S' = exp(ldi[c-1]) * S + (k * exp(ldi[c-1] - ldi))^T @ v
// At n = 1 this is the Pallas kernel's function; the n-chunk launch computes
// bit for bit what n chained one-chunk launches compute.
//
// Bound, at one rwkv6-7b layer's call at S = 256 (r/k/v bf16 [1, 256, 64,
// 64], logw/u/state f32, o f32): bytes, 16.79 MB (5.01 us at 3.35 TB/s),
// with the f32 operations (4.85 us at 67 TFLOP/s) as large. One launch per
// chunk moved the whole [K, V] state (2.1 MB of its 3.0 MB) every time; here
// it is read once and written once per layer.
//
// Design. Grid (B*H, V / VS), VS = 32 state columns per block where V
// allows it, else 16: a block owns S[:, v0:v0+VS] of one (b, h) for the
// whole walk (128 blocks of 512 threads at B = 1, H = 64, one per SM).
// 4*VS of its threads keep that slice in registers (a 4x4 tile each), with
// a copy in shared memory (double-buffered) that the o products read. A
// block computes its chunk's A itself: A needs every K channel of r and k,
// splitting K would need a reduction across blocks, and sharing A between
// the blocks of a head through a thread block cluster's shared memory
// measured slower (two cluster barriers per chunk); 32 columns per block
// halve how often A is computed, and measured faster than 16 at every
// shape tried. A 2-stage cp.async ring brings the next chunk's r, k, logw
// and v[:, v0:] tiles (16-byte copies through the callers' strides) into
// shared memory while this chunk computes. Chunk i takes two barrier
// intervals, software-pipelined with its neighbours:
//   X(i), beside Z(i-1), on the last warps: each channel's log-decays
//     summed in token order from 0 at the chunk start (as the reference's
//     cumsum; never one cumsum over the whole sequence);
//   Y(i), every warp: r * exp(lde), k * exp(ldi[c-1] - ldi), exp(ldi[c-1]),
//     then A in 4x4 tiles of (t, j) pairs (diagonal tiles first, so no warp
//     splits between the two kinds), each over K by 16 lanes of 4 channels
//     (float4 reads; the per-(t, j, k) decays on the SFU's exp), summed
//     across the lanes by a reduce-scatter of shuffles that leaves one
//     pair's sum in each lane;
//   Z(i), beside X(i+1): the first 4*VS threads update the state,
//     S' = exp(ldi[c-1]) S + ks^T v, over j; the next 8*VS compute
//     o = (r * exp(lde)) @ S over K, + A @ v over j, and store it. Only Z
//     reads the carried state.
// The decays of A do not factor into exp(lde[t]) * exp(-ldi[j]): logw
// reaches -2e4 and exp(-ldi) overflows, so A is not a plain product and
// stays on f32 FMAs. The two products with the state stay on f32 FMAs too:
// per block and chunk they are 2 x c x VS x K FMAs, a small part of the
// chunk's time next to A's exps and the barriers (PERF.md), so a
// tensor-core form (bf16 hi + lo, or 3xTF32) was not tried.

#include <stdint.h>
#include <stdio.h>

#include "common.cuh"

namespace relserve {
namespace {

constexpr int KMAX = 64;
constexpr int LANES = 16;           // lanes that sum one 4x4 tile of A over K

template <int C, int VS>
struct Geo {
  static constexpr int NT = 16 * VS;
  static constexpr int STATE_THREADS = 4 * VS;   // 4x4 tiles of [KMAX][VS]
  static constexpr int O_THREADS = 8 * VS;       // 2 columns of C/16 rows
  static constexpr int T = C / 4;                      // tile rows of A
  static constexpr int NTILE = T * (T + 1) / 2;        // lower tiles
  static constexpr int TPP = NT / LANES;               // tiles per pass
  static constexpr int PASSES = (NTILE + TPP - 1) / TPP;
  static constexpr int RPT = C / 16;                   // o rows per thread
  static constexpr int AP = C + 1;                     // row stride of A
  static_assert(C % 16 == 0 && NT - STATE_THREADS - O_THREADS >= KMAX,
                "thread roles");
};

struct Strides {
  long long rb, rt, rh, kb, kt, kh, vb, vt, vh, wb, wt, wh;
};

// Bytes of one ring stage: r, k and logw [C][K], v [C][VS], each a multiple
// of 16 bytes since K is a multiple of 16.
template <typename TI, typename TW, int C, int VS>
__host__ __device__ inline int stage_bytes(int K) {
  return C * K * int(2 * sizeof(TI) + sizeof(TW)) + C * VS * int(sizeof(TI));
}

// Shared memory: the ring, then floats: lde, ldi, r * exp(lde),
// k * exp(ldi[c-1] - ldi) as [C][K + 4]; v as [C][VS]; A as [C][C + 1]; the
// state slice twice as [K][VS]; exp(ldi[c-1]) as [K].
template <typename TI, typename TW, int C, int VS>
inline int smem_bytes(int K) {
  const int floats = 4 * C * (K + 4) + C * VS + C * (C + 1) + 2 * K * VS + K;
  return 2 * stage_bytes<TI, TW, C, VS>(K) + floats * int(sizeof(float));
}

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

// Copy chunk `chunk`'s tiles into a ring stage: every row is K (or VS)
// contiguous elements, 16 bytes at a time.
template <typename TI, typename TW, int C, int VS>
__device__ __forceinline__ void issue_chunk(unsigned char* stage,
                                            const TI* rb, const TI* kb,
                                            const TI* vb, const TW* wb,
                                            const Strides& st, int chunk,
                                            int K) {
  const long long t0 = (long long)chunk * C;
  const int tid = threadIdx.x;
  TI* Rr = reinterpret_cast<TI*>(stage);
  TI* Kr = Rr + C * K;
  TW* Wr = reinterpret_cast<TW*>(Kr + C * K);
  TI* Vr = reinterpret_cast<TI*>(Wr + C * K);
  constexpr int NT = Geo<C, VS>::NT;
  const int rseg = K * int(sizeof(TI)) / 16;
  for (int x = tid; x < C * rseg; x += NT) {
    const int t = x / rseg, j = x % rseg;
    cp_async16(smem_u32(Rr + t * K) + 16 * j,
               reinterpret_cast<const char*>(rb + (t0 + t) * st.rt) + 16 * j);
    cp_async16(smem_u32(Kr + t * K) + 16 * j,
               reinterpret_cast<const char*>(kb + (t0 + t) * st.kt) + 16 * j);
  }
  const int wseg = K * int(sizeof(TW)) / 16;
  for (int x = tid; x < C * wseg; x += NT) {
    const int t = x / wseg, j = x % wseg;
    cp_async16(smem_u32(Wr + t * K) + 16 * j,
               reinterpret_cast<const char*>(wb + (t0 + t) * st.wt) + 16 * j);
  }
  constexpr int vseg = VS * int(sizeof(TI)) / 16;
  for (int x = tid; x < C * vseg; x += NT) {
    const int t = x / vseg, j = x % vseg;
    cp_async16(smem_u32(Vr + t * VS) + 16 * j,
               reinterpret_cast<const char*>(vb + (t0 + t) * st.vt) + 16 * j);
  }
}

// One 4x4 tile (ti, tj) of A over this lane's 4 channels k0..k0+3, then
// summed over the 16 lanes of the tile: lane p keeps pair (4 ti + p / 4,
// 4 tj + p % 4). Pairs above the diagonal stay 0; the diagonal uses u.
template <typename TI>
__device__ __forceinline__ float a_tile(const TI* Rr, const TI* Kr,
                                        const float* Le, const float* Li,
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
      e4[a] = load4(Le + (4 * ti + a) * KP + k0);
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

template <typename TI, typename TW, typename TO, int C, int VS>
__global__ void __launch_bounds__(16 * VS)
rwkv6_chunk_kernel(const TI* __restrict__ r, const TI* __restrict__ k,
                   const TI* __restrict__ v, const TW* __restrict__ logw,
                   const float* __restrict__ u,
                   const float* __restrict__ state, TO* __restrict__ out,
                   float* __restrict__ state_out, int H, int n_chunks, int K,
                   int V, Strides st) {
  using G = Geo<C, VS>;
  constexpr int NT = G::NT, STATE_THREADS = G::STATE_THREADS,
                O_THREADS = G::O_THREADS;
  extern __shared__ __align__(16) unsigned char sm[];
  const int KP = K + 4;
  const int sbytes = stage_bytes<TI, TW, C, VS>(K);
  float* Le = reinterpret_cast<float*>(sm + 2 * sbytes);   // lde
  float* Li = Le + C * KP;                                 // ldi
  float* Rd = Li + C * KP;                                 // r * exp(lde)
  float* Ks = Rd + C * KP;                    // k * exp(ldi[c-1] - ldi)
  float* Vf = Ks + C * KP;                                 // [C][VS]
  float* As = Vf + C * VS;                                 // [C][AP]
  float* Ss = As + C * G::AP;                              // 2 x [K][VS]
  float* dT = Ss + 2 * K * VS;                             // exp(ldi[c-1])

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int v0 = blockIdx.y * VS;
  const int tid = threadIdx.x;
  const long long S = (long long)n_chunks * C;

  const TI* rb = r + b * st.rb + h * st.rh;
  const TI* kb = k + b * st.kb + h * st.kh;
  const TI* vb = v + b * st.vb + h * st.vh + v0;
  const TW* wb = logw + b * st.wb + h * st.wh;

  issue_chunk<TI, TW, C, VS>(sm, rb, kb, vb, wb, st, 0, K);
  cp_async_commit();

  // Roles between the barriers of Z: the first STATE_THREADS update the
  // state (a 4x4 tile each: rows 4 kt.., columns 4 vt..), the next
  // O_THREADS compute o (columns 2 vp, 2 vp + 1 of rows tr + 16 m), the
  // rest the next chunk's X (channel xk).
  const int kt = tid / (VS / 4), vt = tid % (VS / 4);
  const int oid = tid - STATE_THREADS, vp = oid % (VS / 2), tr = oid / (VS / 2);
  const int xk = tid - STATE_THREADS - O_THREADS;
  const bool state_thread = tid < STATE_THREADS && 4 * kt < K;
  const bool o_thread = oid >= 0 && oid < O_THREADS;
  float sreg[4][4];
  const float* sb = state + ((long long)bh * K) * V + v0;
  if (state_thread) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 x = load4(sb + (long long)(4 * kt + a) * V + 4 * vt);
      sreg[a][0] = x.x, sreg[a][1] = x.y, sreg[a][2] = x.z, sreg[a][3] = x.w;
      *reinterpret_cast<float4*>(Ss + (4 * kt + a) * VS + 4 * vt) = x;
    }
  }
  // A work: lane16 owns channels k0 .. k0+3 of the tile of its half-warp
  const int lane16 = tid % LANES, slot = tid / LANES;
  const int k0 = 4 * lane16;
  const unsigned mask = 0xffffu << (tid & 16);
  const float4 u4 = k0 < K ? load4(u + h * K + k0) : make_float4(0, 0, 0, 0);

  int cur = 0;
  for (int ci = 0; ci <= n_chunks; ++ci) {
    const unsigned char* stage = sm + (ci & 1) * sbytes;
    const TI* Rr = reinterpret_cast<const TI*>(stage);
    const TI* Kr = Rr + C * K;
    const TW* Wr = reinterpret_cast<const TW*>(Kr + C * K);
    const TI* Vr = reinterpret_cast<const TI*>(Wr + C * K);
    if (ci < n_chunks) cp_async_wait<0>();
    __syncthreads();
    if (ci + 1 < n_chunks) {
      issue_chunk<TI, TW, C, VS>(sm + ((ci + 1) & 1) * sbytes, rb, kb, vb, wb,
                                 st, ci + 1, K);
      cp_async_commit();
    }

    // Z(ci-1): the state update and o of the previous chunk
    if (ci > 0 && state_thread) {
      // S'[kr, vv] = S[kr, vv] exp(ldi[c-1, kr]) + sum_j ks[j, kr] v[j, vv]
      const float4 d = load4(dT + 4 * kt);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sreg[a][c] *= comp(d, a);
      for (int j = 0; j < C; ++j) {
        const float4 ks = load4(Ks + j * KP + 4 * kt);
        const float4 vf = load4(Vf + j * VS + 4 * vt);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sreg[a][c] += comp(ks, a) * comp(vf, c);
      }
      float* Sn = Ss + (cur ^ 1) * K * VS;
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(Sn + (4 * kt + a) * VS + 4 * vt) =
            make_float4(sreg[a][0], sreg[a][1], sreg[a][2], sreg[a][3]);
    } else if (ci > 0 && o_thread) {
      // o[t, :] = (r * exp(lde))[t] @ S (over K, in four partial sums),
      // then + A[t, :t+1] @ v; o is [B, S, H, V]
      const float* Sc = Ss + cur * K * VS;
      float p[G::RPT][2][4];
#pragma unroll
      for (int m = 0; m < G::RPT; ++m)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) p[m][e][c] = 0.f;
      for (int kk = 0; kk < K; kk += 4) {
        float2 s2[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s2[c] = *reinterpret_cast<const float2*>(Sc + (kk + c) * VS + 2 * vp);
#pragma unroll
        for (int m = 0; m < G::RPT; ++m) {
          const float4 rd = load4(Rd + (tr + 16 * m) * KP + kk);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            p[m][0][c] += comp(rd, c) * s2[c].x;
            p[m][1][c] += comp(rd, c) * s2[c].y;
          }
        }
      }
      const long long row0 = b * S + (long long)(ci - 1) * C;
#pragma unroll
      for (int m = 0; m < G::RPT; ++m) {
        const int t = tr + 16 * m;
        float o0 = (p[m][0][0] + p[m][0][1]) + (p[m][0][2] + p[m][0][3]);
        float o1 = (p[m][1][0] + p[m][1][1]) + (p[m][1][2] + p[m][1][3]);
        for (int j = 0; j <= t; ++j) {
          const float a = As[t * G::AP + j];
          const float2 vf =
              *reinterpret_cast<const float2*>(Vf + j * VS + 2 * vp);
          o0 += a * vf.x;
          o1 += a * vf.y;
        }
        TO* dst = out + ((row0 + t) * H + h) * V + v0 + 2 * vp;
        dst[0] = from_float<TO>(o0);
        dst[1] = from_float<TO>(o1);
      }
    }
    if (ci > 0) cur ^= 1;
    if (ci == n_chunks) break;

    // X(ci): channel xk's log-decay sums, in token order from 0
    if (xk >= 0 && xk < K) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const float w = to_float(Wr[t * K + xk]);
        acc += w;
        Li[t * KP + xk] = acc;
        Le[t * KP + xk] = acc - w;
      }
    }
    __syncthreads();

    // Y(ci): the decayed r and k, exp(ldi[c-1]) and v in f32; then A
    {
      const int kk = tid % K, t0 = tid / K, tstep = NT / K;
      if (t0 < tstep) {
        const float last = Li[(C - 1) * KP + kk];
        for (int t = t0; t < C; t += tstep) {
          Rd[t * KP + kk] = to_float(Rr[t * K + kk]) * expf(Le[t * KP + kk]);
          Ks[t * KP + kk] =
              to_float(Kr[t * K + kk]) * expf(last - Li[t * KP + kk]);
        }
        if (t0 == 0) dT[kk] = expf(last);
      }
      for (int x = tid; x < C * VS; x += NT) Vf[x] = to_float(Vr[x]);
    }
#pragma unroll 1
    for (int pass = 0; pass < G::PASSES; ++pass) {
      const int tile = pass * G::TPP + slot;
      if (tile < G::NTILE) {
        // the T diagonal tiles first, then the strictly lower ones by rows:
        // T is even, so the two half-warps of a warp take the same path
        int ti = tile, tj = tile;
        if (tile >= G::T) {
          const int o = tile - G::T;
          ti = 1;
          while ((ti + 1) * ti / 2 <= o) ++ti;
          tj = o - ti * (ti - 1) / 2;
        }
        const float a = a_tile(Rr, Kr, Le, Li, u4, ti, tj, k0, K, KP, lane16,
                               mask);
        const int t = 4 * ti + lane16 / 4, j = 4 * tj + lane16 % 4;
        if (j <= t) As[t * G::AP + j] = a;
      }
    }
  }

  if (state_thread) {
    float* so = state_out + ((long long)bh * K) * V + v0;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(so + (long long)(4 * kt + a) * V + 4 * vt) =
          make_float4(sreg[a][0], sreg[a][1], sreg[a][2], sreg[a][3]);
  }
}

template <typename TI, typename TW, typename TO, int C, int VS>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const float* u, const float* state, void* out, float* state_out,
           int B, int n_chunks, int H, int K, int V, const Strides& st,
           cudaStream_t stream) {
  const int smem = smem_bytes<TI, TW, C, VS>(K);
  auto kernel = rwkv6_chunk_kernel<TI, TW, TO, C, VS>;
  static int granted[kMaxDevices] = {};
  cudaError_t err = allow_shared(kernel, smem, granted);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3(B * H, V / VS), Geo<C, VS>::NT, smem, stream>>>(
      static_cast<const TI*>(r), static_cast<const TI*>(k),
      static_cast<const TI*>(v), static_cast<const TW*>(logw), u, state,
      static_cast<TO*>(out), state_out, H, n_chunks, K, V, st);
  return int(cudaGetLastError());
}

template <typename TI, typename TW, typename TO, int VS>
int launch_c(int c, const void* r, const void* k, const void* v,
             const void* logw, const float* u, const float* state, void* out,
             float* state_out, int B, int n_chunks, int H, int K, int V,
             const Strides& st, cudaStream_t stream) {
  switch (c) {
    case 16:
      return launch<TI, TW, TO, 16, VS>(r, k, v, logw, u, state, out,
                                        state_out, B, n_chunks, H, K, V, st,
                                        stream);
    case 32:
      return launch<TI, TW, TO, 32, VS>(r, k, v, logw, u, state, out,
                                        state_out, B, n_chunks, H, K, V, st,
                                        stream);
    case 64:
      return launch<TI, TW, TO, 64, VS>(r, k, v, logw, u, state, out,
                                        state_out, B, n_chunks, H, K, V, st,
                                        stream);
  }
  return int(cudaErrorInvalidValue);
}

// A block owns 32 state columns where V allows it (half the blocks of 16
// columns, so each chunk's A and decayed r and k are computed half as
// often; faster at every measured shape), else 16.
template <typename TI, typename TW, typename TO>
int launch_chunk(int c, const void* r, const void* k, const void* v,
                 const void* logw, const float* u, const float* state,
                 void* out, float* state_out, int B, int n_chunks, int H,
                 int K, int V, const Strides& st, cudaStream_t stream) {
  if (V % 32 == 0)
    return launch_c<TI, TW, TO, 32>(c, r, k, v, logw, u, state, out,
                                    state_out, B, n_chunks, H, K, V, st,
                                    stream);
  return launch_c<TI, TW, TO, 16>(c, r, k, v, logw, u, state, out, state_out,
                                  B, n_chunks, H, K, V, st, stream);
}

// One instance at K = 64 (rwkv6-7b's heads): registers, shared memory,
// threads and resident blocks per SM.
template <typename TI, typename TW, typename TO, int C, int VS>
int query(int* regs, int* smem, int* threads, int* blocks) {
  static int granted[kMaxDevices] = {};
  *threads = Geo<C, VS>::NT;
  return occupancy(rwkv6_chunk_kernel<TI, TW, TO, C, VS>, Geo<C, VS>::NT,
                   smem_bytes<TI, TW, C, VS>(KMAX), granted, regs, smem,
                   blocks);
}

template <typename TI, typename TW>
int launch_out(int out_dtype, int c, const void* r, const void* k,
               const void* v, const void* logw, const float* u,
               const float* state, void* out, float* state_out, int B,
               int n_chunks, int H, int K, int V, const Strides& st,
               cudaStream_t stream) {
  if (out_dtype == 0)
    return launch_chunk<TI, TW, float>(c, r, k, v, logw, u, state, out,
                                       state_out, B, n_chunks, H, K, V, st,
                                       stream);
  if (out_dtype == 1)
    return launch_chunk<TI, TW, __nv_bfloat16>(c, r, k, v, logw, u, state,
                                               out, state_out, B, n_chunks, H,
                                               K, V, st, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace relserve

// r/k/logw [B, S, H, K] and v [B, S, H, V], read through their (batch,
// time, head) strides in elements, with the last dim contiguous and every
// row 16-byte aligned; u [H, K] and state [B, H, K, V] contiguous float32;
// out [B, S, H, V] and state_out contiguous. S = n_chunks * c, c in
// {16, 32, 64}; K and V multiples of 16, at most 64. dtypes: 0 = float32,
// 1 = bfloat16; r, k and v share in_dtype, logw is float32 or in_dtype.
// Returns cudaGetLastError() after the launch.
extern "C" int rwkv6_chunk_launch(
    const void* r, const void* k, const void* v, const void* logw,
    const void* u, const void* state, void* out, void* state_out, int B,
    int n_chunks, int c, int H, int K, int V, long long srb, long long srt,
    long long srh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, long long swb,
    long long swt, long long swh, int in_dtype, int w_dtype, int out_dtype,
    void* stream) {
  using namespace relserve;
  const Strides st{srb, srt, srh, skb, skt, skh, svb, svt, svh, swb, swt, swh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* sf = static_cast<const float*>(state);
  float* so = static_cast<float*>(state_out);
  if (B == 0 || H == 0 || n_chunks == 0) return 0;
  if (K % 16 || V % 16 || K > KMAX || V > KMAX)
    return int(cudaErrorInvalidValue);
  if (in_dtype == 0 && w_dtype == 0)
    return launch_out<float, float>(out_dtype, c, r, k, v, logw, uf, sf, out,
                                    so, B, n_chunks, H, K, V, st, s);
  if (in_dtype == 1 && w_dtype == 0)
    return launch_out<__nv_bfloat16, float>(out_dtype, c, r, k, v, logw, uf,
                                            sf, out, so, B, n_chunks, H, K, V,
                                            st, s);
  if (in_dtype == 1 && w_dtype == 1)
    return launch_out<__nv_bfloat16, __nv_bfloat16>(
        out_dtype, c, r, k, v, logw, uf, sf, out, so, B, n_chunks, H, K, V,
        st, s);
  return int(cudaErrorInvalidValue);
}

// Instance i of the kernels the paths launch (the model's r/k/v in bf16,
// logw, u and the state in f32, o in f32, 32 state columns per block):
// a label, registers, shared memory (static + dynamic), threads and resident
// blocks per SM. Returns 0, -1 past the last instance, or a CUDA error.
extern "C" int rwkv6_chunk_occupancy(int i, char* label, int label_len,
                                     int* regs, int* smem, int* threads,
                                     int* blocks) {
  using namespace relserve;
  using bf = __nv_bfloat16;
  static const char* labels[] = {"bf16 r/k/v, chunk 16", "bf16 r/k/v, chunk 32",
                                 "bf16 r/k/v, chunk 64", "f32 r/k/v, chunk 16"};
  if (i < 0 || i >= 4) return -1;
  snprintf(label, label_len, "%s", labels[i]);
  switch (i) {
    case 0: return query<bf, float, float, 16, 32>(regs, smem, threads, blocks);
    case 1: return query<bf, float, float, 32, 32>(regs, smem, threads, blocks);
    case 2: return query<bf, float, float, 64, 32>(regs, smem, threads, blocks);
    default: return query<float, float, float, 16, 32>(regs, smem, threads, blocks);
  }
}
