// Paged-attention decode kernel for Hopper (sm_90a): split-KV
// (flash-decoding), K and V pages through a TMA-fed shared-memory ring, the
// splits merged by the last block of each (sequence, kv slot).
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
// 2-16 flops per byte at rows 1-8, far below the ~295 flop/byte ridge. At
// the serve's decode shape (q [32, 8, 2, 128] bf16, ragged contexts <= 1024)
// that is 77.7 MB, 0.0232 ms at 3.35 TB/s; qwen2.5-32b's Qp 5 reads the same
// bytes (0.0233 ms), qwen3-moe's Qp 8 at KV 4 half (0.0117 ms).
//
// Design. Grid (n_split, KV, B): the wrapper's split plan cuts the block
// table into n_split spans of pages_per_split pages (256 tokens at page 16),
// from block_tables.shape[1] and the page size alone, so there is no host
// sync. A block is one producer warp and four consumer warps.
//  - The producer's lane 0 initialises the ring's barriers and issues its
//    first stages while the consumers load their q rows, before the block's
//    only __syncthreads. It reads the span's page ids from the block table
//    and loads each page of K and of V with one TMA box (hd, 1, page, 1) of
//    a 4-D map (hd, KV, page, P) over the pool, into a ring of 2-4 stages of
//    32 tokens (whole pages; 48 KB at hd 128 in bf16, so four blocks, 192 KB
//    in flight, fit an SM). A stage completes on its mbarrier; the consumer
//    warps release it on a second one. The bytes in flight per SM no longer
//    depend on the row count, and no register holds a K or V load.
//  - A consumer lane holds 16 bytes of a K or V row (VEC = 8 bf16 or 4 f32
//    columns); the LPT = hd / VEC lanes of a lane group share a token, and a
//    lane group holds RPT query rows (in bf16 2, or 3 at 5-6 rows so that
//    2 row units x 4 token groups keep every lane group busy; in f32 4; 2x
//    that when there are more rows than the block's lane groups can hold),
//    so a lane keeps 2 * RPT * VEC floats of q and accumulator whatever the
//    row count: the lane groups split into row units x token groups, and
//    the token groups take a stage's tokens NB = 4 (8 where there are at
//    most 2 token groups) at a time. A score is reduced over the group's
//    lanes with log2(LPT) shuffles and never written to shared memory; the
//    online softmax of each (token group, row) runs in registers, and the
//    groups merge through shared memory at the end of the span. Tokens past
//    the context read as zeros (a pool slot there may hold anything, and
//    0 * NaN is not 0). At 5-8 rows the f32 math, not the bytes, bounds the
//    kernel (PERF.md).
//  - With n_split == 1 the block writes the output. Otherwise it writes f32
//    partials (o unnormalised, m, l) to the wrapper's workspace, fences them
//    (__threadfence), and counts its arrival with an atomicAdd on an int32
//    counter per (b, h); the block that arrives last (blocks with an empty
//    span arrive too) resets the counter to 0 and merges the splits by
//    log-sum-exp in split order (every load of up to 8 splits' partials
//    issued at once), so one launch does the call. The counters stay zero
//    between calls, with no memset: the wrapper keeps one buffer per
//    device, and calls that share it must run on one stream.
// All math is in f32, so the output is the f32 result rounded once.

#include <stdint.h>
#include <stdio.h>

#include <algorithm>

#include "hopper.cuh"

namespace relserve {
namespace {

constexpr int NCW = 4;                 // consumer warps
constexpr int NCT = NCW * 32;          // consumer threads
constexpr int NT = NCT + 32;           // + the producer warp
constexpr int STAGE_TOKENS = 32;       // tokens per ring stage (whole pages)
constexpr int RING_BYTES = 48 * 1024;  // ring budget per block
constexpr int MAX_STAGES = 4;

template <typename T, int HD>
struct Geo {
  static constexpr int VEC = 16 / int(sizeof(T));   // elements per lane
  static constexpr int LPT = HD / VEC;              // lanes per (token, row)
  static constexpr int UNITS = NCT / LPT;           // lane groups per block
};

// The ring and merge geometry of one launch, from the page size alone.
struct Plan {
  int page;         // tokens per page
  int sp;           // pages per stage
  int stage_tok;    // sp * page
  int n_stages;     // ring depth, 2..MAX_STAGES
  int row_bytes;    // hd * sizeof(T)
  int slot_bytes;   // one page's box, rounded up to 128 bytes
  int dense;        // slot_bytes == page * row_bytes: tokens are contiguous
  int ru, tg;       // row units and token groups
  int smem;         // dynamic shared memory
};

template <typename T, int HD, int RPT>
inline Plan make_plan(int page, int rows) {
  using Gm = Geo<T, HD>;
  Plan p;
  p.page = page;
  p.sp = page >= STAGE_TOKENS ? 1 : STAGE_TOKENS / page;
  p.stage_tok = p.sp * page;
  p.row_bytes = HD * int(sizeof(T));
  const int box = page * p.row_bytes;
  p.slot_bytes = (box + 127) / 128 * 128;
  p.dense = p.slot_bytes == box;
  const int stage_bytes = 2 * p.sp * p.slot_bytes;
  p.n_stages = std::min(MAX_STAGES, std::max(2, RING_BYTES / stage_bytes));
  p.ru = (rows + RPT - 1) / RPT;
  p.tg = std::max(1, Gm::UNITS / p.ru);
  const int merge = Gm::UNITS * RPT * (HD + 2) * int(sizeof(float));
  p.smem = 128 + std::max(p.n_stages * stage_bytes, merge) +
           2 * MAX_STAGES * 8 + 16;
  return p;
}

// The pool [P, page, KV, hd] as a 4-D map (hd, KV, page, P); a box is one
// page of one kv slot, (hd, 1, page, 1), no swizzle.
template <typename T>
inline int pool_map(CUtensorMap* map, const void* p, int HD, int KV, int page,
                    long long P) {
  const long long es = sizeof(T);
  const long long dims[4] = {HD, KV, page, P};
  const long long strides[3] = {HD * es, KV * HD * es, page * KV * HD * es};
  const int box[4] = {HD, 1, page, 1};
  return encode_map_4d(map,
                       sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                       int(es), p, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
}

// out[b, h, r, :] = sum_s o_s e^(m_s - M) / sum_s l_s e^(m_s - M) over the
// splits s < n_live in order, those with l_s > 0 (a split whose tokens all
// lie after row r's position adds nothing); zeros when none has a token.
// The partials are read MS splits at a time, all loads of a pass issued
// together (one L2 round trip each); within a pass the merge is the
// reference's, across passes an online one.
constexpr int MS = 8;

template <typename T>
__device__ __forceinline__ void merge_splits(const float* ws_o,
                                             const float* ws_m,
                                             const float* ws_l, T* out,
                                             long long bh, int rows, int hd,
                                             int n_split, int n_live, int tid) {
  for (int i = tid; i < rows * hd; i += NCT) {
    const int r = i / hd, d = i % hd;
    float M = NEG_INF, L = 0.f, O = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += MS) {
      float mv[MS], lv[MS], ov[MS];
#pragma unroll
      for (int j = 0; j < MS; ++j) {
        const bool in = s0 + j < n_live;
        const long long p = (bh * n_split + (in ? s0 + j : s0)) * rows + r;
        lv[j] = in ? __ldcg(ws_l + p) : 0.f;
        mv[j] = in ? __ldcg(ws_m + p) : NEG_INF;
        ov[j] = in ? __ldcg(ws_o + p * hd + d) : 0.f;
      }
      float Mc = M;
#pragma unroll
      for (int j = 0; j < MS; ++j)
        if (lv[j] > 0.f) Mc = fmaxf(Mc, mv[j]);
      const float f0 = __expf(M - Mc);
      L *= f0;
      O *= f0;
#pragma unroll
      for (int j = 0; j < MS; ++j) {
        if (!(lv[j] > 0.f)) continue;
        const float f = __expf(mv[j] - Mc);
        L += lv[j] * f;
        O += ov[j] * f;
      }
      M = Mc;
    }
    out[bh * rows * hd + i] = from_float<T>(O / fmaxf(L, 1e-30f));
  }
}

// After this block's partial is in the workspace (or its span is empty):
// count the arrival of (b, h); the last of the n_split blocks resets the
// counter and merges. Consumer threads only.
template <typename T>
__device__ __forceinline__ void arrive_and_merge(
    int* counters, int* flag, const float* ws_o, const float* ws_m,
    const float* ws_l, T* out, long long bh, int rows, int hd, int n_split,
    int n_live, int tid) {
  __threadfence();
  named_sync(1, NCT);
  if (tid == 0) {
    const int last = atomicAdd(counters + bh, 1) == n_split - 1;
    if (last) counters[bh] = 0;   // zero again for the next call
    *flag = last;
  }
  named_sync(1, NCT);
  if (!*flag) return;
  __threadfence();
  merge_splits<T>(ws_o, ws_m, ws_l, out, bh, rows, hd, n_split, n_live, tid);
}

template <typename T, int HD, int RPT, int NB>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const T* __restrict__ q,               // [B, KV, rows, HD]
                       const int* __restrict__ block_tables,  // [B, max_pages]
                       const int* __restrict__ context_lens,  // [B]
                       T* __restrict__ out,                   // [B, KV, rows, HD]
                       float* __restrict__ ws_o,   // [B, KV, n_split, rows, HD]
                       float* __restrict__ ws_m,   // [B, KV, n_split, rows]
                       float* __restrict__ ws_l,   // [B, KV, n_split, rows]
                       int* __restrict__ counters, // [>= B * KV], zero
                       const Plan plan, int KV, int rows, int q_per_token,
                       int num_q_tokens, int max_pages, int pages_per_split,
                       float scale) {
  using Gm = Geo<T, HD>;
  constexpr int VEC = Gm::VEC, LPT = Gm::LPT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 127u) & ~127u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int stage_bytes = 2 * plan.sp * plan.slot_bytes;
  const int region = max(plan.n_stages * stage_bytes,
                         Gm::UNITS * RPT * (HD + 2) * int(sizeof(float)));
  const uint32_t bars = base + region;
  int* flag = reinterpret_cast<int*>(gbase + region + 2 * MAX_STAGES * 8);
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (MAX_STAGES + s); };

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int page = plan.page;
  const int ctx = context_lens[b];
  const int span = pages_per_split * page;
  const int t_end = min(ctx, max_pages * page);
  const int t0 = split * span;
  const int t1 = min(t_end, t0 + span);
  const long long bh = (long long)b * KV + h;
  const long long part = (bh * n_split + split) * rows;   // workspace row 0
  const int n_live = t_end > 0 ? (t_end + span - 1) / span : 0;

  if (t0 >= t1) {   // no token of this sequence in the span
    if (warp == NCW) return;
    if (n_split == 1) {
      for (int i = tid; i < rows * HD; i += NCT)
        out[bh * rows * HD + i] = from_float<T>(0.f);
      return;
    }
    arrive_and_merge<T>(counters, flag, ws_o, ws_m, ws_l, out, bh, rows, HD,
                        n_split, n_live, tid);
    return;
  }

  const int n_pages = (t1 - t0 + page - 1) / page;
  const int n_stage = (n_pages + plan.sp - 1) / plan.sp;
  const int NS = plan.n_stages;
  const int* table = block_tables + (long long)b * max_pages + t0 / page;
  const uint32_t box = uint32_t(page * plan.row_bytes);
  // stage `it`'s pages of K and V, one TMA box each, completing on full(s)
  auto issue = [&](int it) {
    const int s = it % NS;
    const int p0 = it * plan.sp, np = min(plan.sp, n_pages - p0);
    const uint32_t kd = base + s * stage_bytes;
    const uint32_t vd = kd + plan.sp * plan.slot_bytes;
    mbar_expect_tx(full(s), 2u * np * box);
    for (int j = 0; j < np; ++j) {
      const int pid = __ldg(table + p0 + j);
      tma_load_4d(kd + j * plan.slot_bytes, &kmap, full(s), 0, h, 0, pid);
      tma_load_4d(vd + j * plan.slot_bytes, &vmap, full(s), 0, h, 0, pid);
    }
  };

  // consumers: lane group u = (row unit ru, token group tg) holds RPT rows x
  // VEC columns; its LPT lanes share a token
  const float inv_page = 1.f / page;
  const int u = tid / LPT, sub = tid % LPT, d0 = sub * VEC;
  const int TG = plan.tg;
  const int tg = u % TG, ru = u / TG;
  float qr[RPT][VEC], acc[RPT][VEC], m[RPT], l[RPT];
  int qpos[RPT];

  // the producer initialises the ring and fills it while the consumers
  // load their q rows; both before the block's one barrier
  if (warp == NCW) {
    if (lane == 0) {
      for (int s = 0; s < NS; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), NCW);
      }
      mbar_fence_init();
      for (int it = 0; it < min(NS, n_stage); ++it) issue(it);
    }
  } else {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ru * RPT + r;
      float vals[VEC];
      if (ru < plan.ru && row < rows) {
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
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer: refill each stage once the consumer warps release it
    if (lane == 0) {
      for (int it = NS; it < n_stage; ++it) {
        mbar_wait(empty(it % NS), ((it / NS) - 1) & 1);
        issue(it);
      }
    }
    return;
  }

  for (int it = 0; it < n_stage; ++it) {
    const int s = it % NS;
    mbar_wait(full(s), (it / NS) & 1);
    const int tb = t0 + it * plan.stage_tok;          // stage's first token
    const int n_tok = min(plan.stage_tok, t1 - tb);
    const unsigned char* kst = gbase + s * stage_bytes;
    const unsigned char* vst = kst + plan.sp * plan.slot_bytes;
    for (int jb = 0; jb < n_tok; jb += TG * NB) {   // uniform trip count
      uint4 kc[NB];
      bool ok[NB];
      int off[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int i = jb + tg + n * TG;
        ok[n] = i < n_tok;
        const int ic = ok[n] ? i : 0;   // addresses stay inside the stage
        // (i + 0.5) / page in f32 is never within rounding of an integer
        // for i < 2^16, so its truncation is i / page with no division
        const int slot = plan.dense ? 0 : int((ic + 0.5f) * inv_page);
        off[n] = plan.dense ? ic * plan.row_bytes
                            : slot * plan.slot_bytes +
                                  (ic - slot * page) * plan.row_bytes;
        kc[n] = ok[n] ? reinterpret_cast<const uint4*>(kst + off[n])[sub]
                      : make_uint4(0, 0, 0, 0);
      }
      // scores: a dot over the unit's LPT lanes
      float sc[RPT][NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float kf[VEC];
        unpack16<T>(kc[n], kf);
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) x += qr[r][e] * kf[e];
#pragma unroll
          for (int o = LPT / 2; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          sc[r][n] = (ok[n] && tb + jb + tg + n * TG <= qpos[r]) ? x : NEG_INF;
        }
      }
      // online softmax over the step's tokens; masked tokens add 0
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < NB; ++n) mx = fmaxf(mx, sc[r][n]);
        const float m_new = fmaxf(m[r], mx);
        const float corr = __expf(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
          sc[r][n] = sc[r][n] == NEG_INF ? 0.f : __expf(sc[r][n] - m_new);
          l[r] += sc[r][n];
        }
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        // tokens past the span read nothing: a pool slot past the context
        // may hold anything, and 0 * NaN would not be 0
        const uint4 vc = ok[n] ? reinterpret_cast<const uint4*>(vst + off[n])[sub]
                               : make_uint4(0, 0, 0, 0);
        float vf[VEC];
        unpack16<T>(vc, vf);
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] += sc[r][n] * vf[e];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
  }

  // merge the token groups through shared memory (the ring is free now)
  named_sync(1, NCT);
  float* m_s = reinterpret_cast<float*>(gbase);    // [TG][rows]
  float* l_s = m_s + TG * rows;                    // [TG][rows]
  float* o_s = l_s + TG * rows;                    // [TG][rows][HD]
  if (ru < plan.ru) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ru * RPT + r;
      if (row >= rows) continue;
      const int at = tg * rows + row;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o_s[at * HD + d0 + e] = acc[r][e];
      if (sub == 0) {
        m_s[at] = m[r];
        l_s[at] = l[r];
      }
    }
  }
  named_sync(1, NCT);
  for (int i = tid; i < rows * HD; i += NCT) {
    const int row = i / HD, d = i % HD;
    float M = NEG_INF;
    for (int w = 0; w < TG; ++w) M = fmaxf(M, m_s[w * rows + row]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < TG; ++w) {
      const float f = __expf(m_s[w * rows + row] - M);
      L += l_s[w * rows + row] * f;
      O += o_s[(w * rows + row) * HD + d] * f;
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
  if (n_split > 1)
    arrive_and_merge<T>(counters, flag, ws_o, ws_m, ws_l, out, bh, rows, HD,
                        n_split, n_live, tid);
}

template <typename T, int HD, int RPT, int NB>
int launch(const void* q, const void* k, const void* v, const int* bt,
           const int* cl, void* out, float* ws_o, float* ws_m, float* ws_l,
           int* counters, int B, int KV, int rows, int num_q_tokens, int page,
           int max_pages, long long num_pages, int pages_per_split,
           int n_split, float scale, cudaStream_t stream) {
  const Plan plan = make_plan<T, HD, RPT>(page, rows);
  if (plan.ru > Geo<T, HD>::UNITS || page > 256)
    return int(cudaErrorInvalidValue);
  CUtensorMap km, vm;
  int err = pool_map<T>(&km, k, HD, KV, page, num_pages);
  if (err) return err;
  err = pool_map<T>(&vm, v, HD, KV, page, num_pages);
  if (err) return err;
  auto kernel = paged_attention_kernel<T, HD, RPT, NB>;
  static int granted[kMaxDevices] = {};
  cudaError_t cerr = allow_shared(kernel, plan.smem, granted);
  if (cerr != cudaSuccess) return int(cerr);
  kernel<<<dim3(n_split, KV, B), NT, plan.smem, stream>>>(
      km, vm, static_cast<const T*>(q), bt, cl, static_cast<T*>(out), ws_o,
      ws_m, ws_l, counters, plan, KV, rows, rows / num_q_tokens,
      num_q_tokens, max_pages, pages_per_split, scale);
  return int(cudaGetLastError());
}

// The instance for `rows` rows. RPT, rows per lane group: the fewest that
// keep 16 floats of accumulator per lane (2 in bf16, 4 in f32), 3 at 5-6
// rows in bf16 (2 row units x 4 token groups: no lane group idle), doubled
// when the rows need more lane groups than the block has. NB, tokens per
// step: 8 in bf16 at 2 rows per group where there are at most 2 token
// groups (a group then takes 16 or 32 tokens of a stage), else 4 (measured:
// 8 is faster at Qp 8, slower at Qp 4 and below).
template <typename T, int HD>
int launch_rows(const void* q, const void* k, const void* v, const int* bt,
                const int* cl, void* out, float* ws_o, float* ws_m,
                float* ws_l, int* counters, int B, int KV, int rows,
                int num_q_tokens, int page, int max_pages, long long num_pages,
                int pages_per_split, int n_split, float scale,
                cudaStream_t stream) {
  constexpr int UNITS = Geo<T, HD>::UNITS;
#define RELSERVE_PA_ARGS q, k, v, bt, cl, out, ws_o, ws_m, ws_l, counters, B, KV, rows, num_q_tokens, page, max_pages, num_pages, pages_per_split, n_split, scale, stream
  if constexpr (sizeof(T) == 2) {
    if (rows > 4 && rows <= 6) return launch<T, HD, 3, 4>(RELSERVE_PA_ARGS);
    if ((rows + 1) / 2 <= UNITS) {
      if (UNITS / ((rows + 1) / 2) <= 2)
        return launch<T, HD, 2, 8>(RELSERVE_PA_ARGS);
      return launch<T, HD, 2, 4>(RELSERVE_PA_ARGS);
    }
    return launch<T, HD, 4, 4>(RELSERVE_PA_ARGS);
  } else {
    if ((rows + 3) / 4 <= UNITS) return launch<T, HD, 4, 4>(RELSERVE_PA_ARGS);
    return launch<T, HD, 8, 4>(RELSERVE_PA_ARGS);
  }
#undef RELSERVE_PA_ARGS
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const int* bt, const int* cl, void* out, float* ws_o,
              float* ws_m, float* ws_l, int* counters, int B, int KV,
              int rows, int num_q_tokens, int page, int max_pages,
              long long num_pages, int pages_per_split, int n_split,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_rows<T, 16>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, counters, B, KV, rows, num_q_tokens, page, max_pages, num_pages, pages_per_split, n_split, scale, stream);
    case 32: return launch_rows<T, 32>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, counters, B, KV, rows, num_q_tokens, page, max_pages, num_pages, pages_per_split, n_split, scale, stream);
    case 64: return launch_rows<T, 64>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, counters, B, KV, rows, num_q_tokens, page, max_pages, num_pages, pages_per_split, n_split, scale, stream);
    case 128: return launch_rows<T, 128>(q, k, v, bt, cl, out, ws_o, ws_m, ws_l, counters, B, KV, rows, num_q_tokens, page, max_pages, num_pages, pages_per_split, n_split, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

// One instance of the paths' kernels, at the serve's geometry (16-token
// pages, 2 rows): registers, shared memory, threads, resident blocks per SM.
template <typename T, int HD, int RPT, int NB>
int query(int* regs, int* smem, int* threads, int* blocks) {
  static int granted[kMaxDevices] = {};
  *threads = NT;
  return occupancy(paged_attention_kernel<T, HD, RPT, NB>, NT,
                   make_plan<T, HD, RPT>(16, 2).smem, granted, regs, smem,
                   blocks);
}

}  // namespace
}  // namespace relserve

// The split plan (pages_per_split, n_split) comes from the wrapper; with
// n_split > 1, ws_o / ws_m / ws_l are its f32 workspace
// ([B, KV, n_split, rows, hd] and [B, KV, n_split, rows] twice) and
// counters its int32 arrival counters (at least B * KV, all zero; zero again
// when the launch ends), else all four may be null. num_pages is the pool's
// first dim. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError()
// after the launch, or the driver's error if a tensor map cannot be encoded.
extern "C" int paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* context_lens, void* out,
    void* ws_o, void* ws_m, void* ws_l, void* counters, int B, int KV,
    int rows, int hd, int num_q_tokens, int page, int max_pages,
    long long num_pages, int pages_per_split, int n_split, float scale,
    int dtype, void* stream) {
  using namespace relserve;
  const int* bt = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  float* wo = static_cast<float*>(ws_o);
  float* wm = static_cast<float*>(ws_m);
  float* wl = static_cast<float*>(ws_l);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || KV == 0 || rows == 0) return 0;
  if (pages_per_split < 1 || n_split < 1 ||
      (long long)n_split * pages_per_split < max_pages ||
      (n_split > 1 && (!wo || !wm || !wl || !cnt)))
    return int(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k_pages, v_pages, bt, cl, out, wo, wm, wl,
                            cnt, B, KV, rows, num_q_tokens, page, max_pages,
                            num_pages, pages_per_split, n_split, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, bt, cl, out, wo,
                                    wm, wl, cnt, B, KV, rows, num_q_tokens,
                                    page, max_pages, num_pages,
                                    pages_per_split, n_split, scale, s);
  return int(cudaErrorInvalidValue);
}

// Instance i of the kernels the paths launch: a label, registers, shared
// memory (static + dynamic), threads and resident blocks per SM. Returns 0,
// -1 past the last instance, or a CUDA error.
extern "C" int paged_attention_occupancy(int i, char* label, int label_len,
                                         int* regs, int* smem, int* threads,
                                         int* blocks) {
  using namespace relserve;
  using bf = __nv_bfloat16;
  static const char* labels[] = {
      "bf16 hd 128, 2 rows per lane group, 4 tokens a step (1-4 rows)",
      "bf16 hd 128, 2 rows per lane group, 8 tokens a step (7-16 rows)",
      "bf16 hd 128, 3 rows per lane group (5-6 rows)",
      "bf16 hd 128, 4 rows per lane group (17-32 rows)",
      "bf16 hd 64, 2 rows per lane group, 4 tokens a step (1-4 rows)",
      "bf16 hd 64, 3 rows per lane group (5-6 rows)",
      "f32 hd 128, 4 rows per lane group (up to 16 rows)",
      "f32 hd 64, 4 rows per lane group (up to 32 rows)"};
  if (i < 0 || i >= 8) return -1;
  snprintf(label, label_len, "%s", labels[i]);
  switch (i) {
    case 0: return query<bf, 128, 2, 4>(regs, smem, threads, blocks);
    case 1: return query<bf, 128, 2, 8>(regs, smem, threads, blocks);
    case 2: return query<bf, 128, 3, 4>(regs, smem, threads, blocks);
    case 3: return query<bf, 128, 4, 4>(regs, smem, threads, blocks);
    case 4: return query<bf, 64, 2, 4>(regs, smem, threads, blocks);
    case 5: return query<bf, 64, 3, 4>(regs, smem, threads, blocks);
    case 6: return query<float, 128, 4, 4>(regs, smem, threads, blocks);
    default: return query<float, 64, 4, 4>(regs, smem, threads, blocks);
  }
}
