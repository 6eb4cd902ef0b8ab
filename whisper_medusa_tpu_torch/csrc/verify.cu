// K4 — fused verification with in-kernel row construction (verify_hidden),
// and K5 — fused verification of prebuilt rows (verify_rows).
//
// Replaces whisper_medusa_tpu/ops/verify.py::_kernel_hidden (TPU, launched
// by verify_hidden).  The TPU kernel builds the (R, D) rows in VMEM at grid
// step 0 and then streams the tied embedding, folding per-row statistics
// across the sequential grid.  Hopper's CTAs run in parallel and in no
// order, so the fold becomes a reduction across CTAs — three launches behind
// one C entry:
//
//  (A) rows[k * BN + n] = src[n] + bf16(SiLU(src[n] @ W_k + b_k)) for every
//      head k: the heads mode of wgemm.cuh's weight-streaming wgmma GEMM,
//      the head its grid's z and the stack's layer coordinate (row block 0
//      is head 0 — the base_head verification row — or the hidden state
//      itself when identity0, copied first);
//  (B) the vocab stream (score_rows): the rows' logits against every
//      64-entry vocab tile on the tensor cores, processed with suppress /
//      begin-suppress / exponential EOS decay exactly as _process_tile
//      (verify.py:100-128), into per-(tile, row) partial max, argmax, sum of
//      exp and the value at gcol;
//  (C) one warp per row combines the tiles.  Argmax ties break to the
//      lowest column inside a tile and across tiles (the JAX fold keeps the
//      earlier maximum); suppressed columns take NEG = -f32max/2, not -inf,
//      so fully suppressed rows still give finite statistics.
//
// The logits never exist in device memory.  Bound on H100: the 133 MB
// embedding stream (40 us at 3.35 TB/s) up to R ~ 250 rows, then the
// 2 * R * V * D products (R = 1024: 136 GFLOP, 0.14 ms at 989 TFLOP/s;
// counted from the shapes); stage A streams the 11 heads (36 MB).
//
// K4 takes the JAX kernel's R <= 1024 rows (VH_MAX_ROWS).  Stage A runs
// over the BN source rows in blocks of up to 192 (VH_SRC_BLOCK, the heads
// mode's rows a launch), in order: within one block the launch writes the
// rows in place, as it always did; past it each block's launch writes the
// wrapper's staging rows (NH, 192, D) and one 2-D copy puts head k's block
// at rows k BN + r0.  A head row's sum is cut by D alone, so its bits do
// not depend on the block, on BN or on R.
//
// Stage A reads the BN source rows through a tensor map over exactly BN
// rows (TMA zero-fills the rest of the 16-row tile: no staging copy) and
// runs under programmatic dependent launch: it lets the vocab stream launch
// early, but the stream is launched without the attribute (it has no
// griddepcontrol.wait), so it starts only once stage A has finished; stage
// A itself waits for the kernel before it and touches neither the rows the
// identity0 copy writes nor anything that copy reads.
//
// K5 replaces whisper_medusa_tpu/ops/verify.py::_kernel (TPU, launched by
// verify_rows): stages B and C over R <= 1024 rows that the caller built —
// the B vanilla rows hidden[None], or the B*N head-0 verification rows of
// the two-pass loop at batch.  K4's stage B and K5 are one function, so a
// row scores alike in both (B = 8 gives each example its B = 1 tokens).
//
// Stage B is a persistent TMA-fed stream in the manner of K7 (qmm.cu):
//
//  * a grid as large as fits (one CTA an SM) walks the work items (pair of
//    vocab tiles, pass): ceil(V / 64) tiles of 64 entries, the rows cut into passes of up
//    to 192 (R <= 192: one pass), a pair's passes back to back so that its
//    E chunks come from L2 after the first;
//  * one producer warp keeps a ring of mbarrier stages in flight, each the
//    pair's E tiles of a 64-wide K chunk (2 x 64 entries x 64 K, bf16 with
//    the 128-byte swizzle as TMA writes it, 16 KB; int8 raw, 8 KB) and the
//    pass's rows of the same chunk (ceil(R / 16) * 16 rows, up to 192,
//    zero-filled past R), which both tiles share: the rows cross from L2
//    once per pair, not once per tile;
//  * two consumer warpgroups, one a tile, each run one wgmma m64nNk16 per
//    16-deep step, the E tile the 64-row A side and the rows its N side
//    (N = 16 ceil(R / 16), WgmmaN; an int8 E tile converted exactly to bf16
//    in shared memory first, as K7 does); at an item's last chunk each
//    stages its (rows x 64) f32 sums in shared memory, and each warp scores
//    four rows at a time: lanes hold columns l and l + 32, column v's sum
//    times s[v] at int8, the processors, then the partials by shuffles in a
//    fixed order.  Each sum is one chain of products over K in order, the
//    same instruction for every row tile (on the H100 an element of wgmma
//    does not depend on N), so a row's partials do not depend on R, on its
//    place among the rows, or on which CTA took the tile; the combine adds
//    the tiles in one fixed order.
//
// wm_head_rows is stage A alone: rows[k * M + m] = src[m] +
// bf16(SiLU(src[m] @ W_k + b_k)) for M <= 192 source rows, the same GEMM
// mode, epilogue and K slices (from D alone) as K4's stage A, so a head row
// has the same bits whether K4 builds it among 11 heads or the two-pass loop
// does alone, at any M.
//
// The timestamp mode (the JAX kernels' ts_cfg, verify.py:100-180) is the
// template flag TS of the vocab stream and a combine kernel of its own, so
// the other instantiations compile to the code they had without it.  Rows
// below n_verif take _process_tile's rule masks, tile-local predicates of
// the row's (pos, last, penult, maxts) and the column; the force rule needs
// the timestamp columns' max / sum / argmax and the text columns' max.  The
// timestamp columns are [ts_begin, V): every tile below ts_begin's tile is
// text and every tile above is timestamps, so their partials already are one
// side's; only the tile that straddles ts_begin (when ts_begin % 64 != 0)
// writes its split — (m_ts, s_ts, m_tx) f32 and a_ts int32 a row — and the
// combine folds the sides in the same pass over the tiles, then resolves
// _emit: a forced row takes (m_ts, m_ts + log s_ts, a_ts), and NEG as the
// gathered value of a text column.
//
// int8 serving (the JAX kernels' quant / hquant modes) rides the same three
// entries: an int8 embedding (V, D) with f32 scales (V,) streams as raw
// int8 tiles (66 MB instead of 133 MB) and column v's sum is multiplied by
// s[v] before the processors; int8 heads (nh, D, D) with f32 scales (nh, D)
// take the GEMM's W8 form (the raw tile converted exactly to bf16 in shared
// memory, the column's scale applied before the bias).  A null scale pointer
// selects the bf16 form.
#include <type_traits>

#include "common.cuh"
#include "ffma_gemm.cuh"
#include "ffma_stream.cuh"
#include "hopper.cuh"
#include "wgemm.cuh"

namespace wm {
namespace {

constexpr int VS_VT = 64;                    // vocab entries a tile: wgmma's M side
constexpr int VS_KC = 64;                    // K a ring stage holds
constexpr int VS_MAX_MT = 12;                // 16-row tiles a pass takes (192 rows)
constexpr int VS_NWG = 2;                    // consumer warpgroups: vocab tiles an item
constexpr int VS_THREADS = 128 * VS_NWG + 32;  // the consumer warpgroups + 1 producer warp
constexpr int VS_XT = 16 * VS_KC * 2;        // 16 rows of a K chunk, bytes
constexpr int VS_ETILE = VS_VT * VS_KC * 2;  // bf16 E tile, bytes
constexpr int VS_ERAW = VS_VT * VS_KC;       // int8 E tile, bytes
constexpr int VS_WBUF = 3;                   // converted bf16 E tiles (int8)
constexpr int VS_LDC = VS_VT + 4;            // f32 pitch of the staged sums
constexpr int VS_RB = 4;                     // rows a warp scores at once
constexpr int VH_MAX_ROWS = 1024;            // K4's rows (the JAX kernel's _MAX_R)
constexpr int VH_SRC_BLOCK = 192;            // stage A's source rows a launch (16 G_MAX_MT)

// Ring depth by row tiles: 8 stages at one or two row tiles, 3 at three to
// eight and 2 past them (a CTA of 192 rows and an int8 pair then holds
// 215 KB of shared memory).
__host__ __device__ constexpr int vs_stages(int mt) { return mt <= 2 ? 8 : (mt <= 8 ? 3 : 2); }

inline int vs_smem(int mt, bool q) {
  return 1024 + vs_stages(mt) * (mt * VS_XT + VS_NWG * (q ? VS_ERAW : VS_ETILE)) +
         VS_NWG * ((q ? VS_WBUF * VS_ETILE : 0) + 16 * mt * VS_LDC * 4) + 16 * vs_stages(mt);
}

struct VsArgs {
  const float* escale;     // (V,) f32 int8-embedding scales (int8 only)
  const int* pos;          // (R,) int32
  const int* gcol;         // (R,) int32
  const int8_t* sup;       // (2, V) int8 [suppress; begin-suppress]
  float* part_f;           // (3, R, tiles) f32: max, sum of exp, gathered
  int* part_a;             // (R, tiles) int32 argmax
  int v_dim, n_rows, chunks, tiles, groups, passes;
  int begin_index, eos_id, has_decay, decay_start;
  float log_factor;
};

// The timestamp mode's arguments (the TS instantiations' parameter).
struct VsTsArgs : VsArgs {
  const int* last;         // (R,) int32 each row's last token
  const int* penult;       // (R,) int32 the token before it
  const int* maxts;        // (R,) int32 the running max timestamp (0: none)
  float* ts_f;             // (3, R) f32 the straddling tile's m_ts, s_ts, m_tx
  int* ts_a;               // (R,) int32 its a_ts
  int n_verif, ts_begin, no_ts_id, ts_cap;   // ts_cap -1: no initial cap
};

// The tile that holds both text and timestamp columns, or -1.
__host__ __device__ __forceinline__ int ts_straddle(int ts_begin) {
  return ts_begin % VS_VT ? ts_begin / VS_VT : -1;
}

// The timestamp rules' predicates of one row (_process_tile's rule masks,
// rows < n_verif only): the no-timestamps column, the pairing rule both
// ways, the monotonic floor from maxts and the initial cap at begin_index.
struct TsRow {
  bool verif, sup_ts, sup_text;
  int floor_ts, cap_col;
};

__device__ __forceinline__ TsRow ts_row(const VsTsArgs& a, int r, int p) {
  const int last = a.last[r], pen = a.penult[r], mts = a.maxts[r];
  const int gen_len = p - a.begin_index;
  const bool last_ts = last >= a.ts_begin && gen_len >= 1;
  const bool pen_ts = gen_len < 2 || pen >= a.ts_begin;
  TsRow t;
  t.verif = r < a.n_verif;
  t.sup_ts = last_ts && pen_ts;
  t.sup_text = last_ts && !pen_ts;
  t.floor_ts = mts > 0 ? (t.sup_text ? mts : mts + 1) : a.ts_begin;
  t.cap_col = a.ts_cap >= 0 && p == a.begin_index ? a.ts_begin + a.ts_cap : 0x7fffffff;
  return t;
}

__device__ __forceinline__ bool ts_masked(const TsRow& t, const VsTsArgs& a, int c) {
  const bool is_ts = c >= a.ts_begin;
  return t.verif && (c == a.no_ts_id || (t.sup_ts && is_ts) || (t.sup_text && c < a.eos_id) ||
                     (is_ts && c < t.floor_ts) || c > t.cap_col);
}

// The partials of one (vocab tile, pass): rows [pass * 16 MT, + 16 MT) of
// the sums staged in cs (row r of the pass at r * VS_LDC).  Lane l holds
// columns l and l + 32, whose operands (scale, masks) it loads once; warp w
// of the tile's warpgroup takes rows [VS_RB (w + 4 k), + VS_RB), VS_RB at
// a time so that their shuffle chains overlap.  The processing is
// _process_tile's (verify.py:100-128); each row's arithmetic is the same
// whichever rows are beside it.  TS, the timestamp mode, adds the rules'
// masks after the processors and, in the tile that straddles ts_begin, the
// split; its code sits under if constexpr so that the TS = false
// instantiations compile to the code without the mode (kernel_ab.py holds
// their SASS to another build's).
template <bool Q, bool TS>
__device__ __forceinline__ void tile_stats(const float* cs,
                                           const std::conditional_t<TS, VsTsArgs, VsArgs>& a,
                                           int tile, int pass, int pass_rows) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int v0 = tile * VS_VT, r0 = pass * pass_rows;
  const int n = min(pass_rows, a.n_rows - r0);
  const size_t ntile_rows = (size_t)a.tiles * a.n_rows;
  int col[2];
  bool in[2], sup[2], bsup[2], eos[2];
  float esc[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    col[hh] = v0 + lane + 32 * hh;
    in[hh] = col[hh] < a.v_dim;
    sup[hh] = in[hh] && a.sup[col[hh]];
    bsup[hh] = in[hh] && a.sup[a.v_dim + col[hh]];
    eos[hh] = a.has_decay && col[hh] == a.eos_id;
    esc[hh] = Q && in[hh] ? a.escale[col[hh]] : 1.0f;
  }
  for (int rb = VS_RB * warp; rb < n; rb += 4 * VS_RB) {
    float x[VS_RB][2], m[VS_RB], s[VS_RB], g[VS_RB];
    int am[VS_RB];
#pragma unroll
    for (int j = 0; j < VS_RB; ++j) {
      const int rl = min(rb + j, n - 1);      // past n: a repeat, not stored
      const int p = a.pos[r0 + rl], gc = a.gcol[r0 + rl];
      [[maybe_unused]] TsRow tr;
      if constexpr (TS) tr = ts_row(a, r0 + rl, p);
      g[j] = NEG_VERIFY;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float val = cs[rl * VS_LDC + lane + 32 * hh];
        if (!in[hh]) {
          val = NEG_VERIFY;
        } else {
          if constexpr (Q) val *= esc[hh];
          if (sup[hh]) val = NEG_VERIFY;
          if (bsup[hh] && p == a.begin_index) val = NEG_VERIFY;
          if (eos[hh] && p > a.decay_start) {
            const float idx = (float)max(p - a.decay_start, 0);
            val = val + fabsf(val) * (expf(idx * a.log_factor) - 1.0f);
          }
          if constexpr (TS) {
            if (ts_masked(tr, a, col[hh])) val = NEG_VERIFY;
          }
        }
        x[j][hh] = val;
        if (col[hh] == gc) g[j] = val;
      }
      m[j] = x[j][0];
      am[j] = col[0];
      if (x[j][1] > m[j]) { m[j] = x[j][1]; am[j] = col[1]; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < VS_RB; ++j) {
        const float om = __shfl_xor_sync(0xffffffffu, m[j], o);
        const int oa = __shfl_xor_sync(0xffffffffu, am[j], o);
        if (om > m[j] || (om == m[j] && oa < am[j])) { m[j] = om; am[j] = oa; }
      }
#pragma unroll
    for (int j = 0; j < VS_RB; ++j) s[j] = expf(x[j][0] - m[j]) + expf(x[j][1] - m[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int j = 0; j < VS_RB; ++j) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
        g[j] = fmaxf(g[j], __shfl_xor_sync(0xffffffffu, g[j], o));
      }
    if (lane < VS_RB && rb + lane < n) {      // lane j stores row rb + j
      float mj = m[0], sj = s[0], gj = g[0];
      int aj = am[0];
#pragma unroll
      for (int j = 1; j < VS_RB; ++j)
        if (lane == j) { mj = m[j]; sj = s[j]; gj = g[j]; aj = am[j]; }
      const size_t idx = (size_t)(r0 + rb + lane) * a.tiles + tile;   // (R, tiles)
      a.part_f[idx] = mj;
      a.part_f[ntile_rows + idx] = sj;
      a.part_f[2 * ntile_rows + idx] = gj;
      a.part_a[idx] = aj;
    }
    if constexpr (TS) {
      if (tile == ts_straddle(a.ts_begin)) {
        // The split: the timestamp side's max, argmax (ties to the lowest
        // column) and sum of exp, the text side's max; -inf off each side.
        float mt[VS_RB], st[VS_RB], mx[VS_RB];
        int at[VS_RB];
#pragma unroll
        for (int j = 0; j < VS_RB; ++j) {
          const bool t0 = col[0] >= a.ts_begin, t1 = col[1] >= a.ts_begin;
          const float y0 = t0 ? x[j][0] : -INFINITY, y1 = t1 ? x[j][1] : -INFINITY;
          mt[j] = y0;
          at[j] = col[0];
          if (y1 > mt[j]) { mt[j] = y1; at[j] = col[1]; }
          mx[j] = fmaxf(t0 ? -INFINITY : x[j][0], t1 ? -INFINITY : x[j][1]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < VS_RB; ++j) {
            const float om = __shfl_xor_sync(0xffffffffu, mt[j], o);
            const int oa = __shfl_xor_sync(0xffffffffu, at[j], o);
            if (om > mt[j] || (om == mt[j] && oa < at[j])) { mt[j] = om; at[j] = oa; }
            mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
          }
#pragma unroll
        for (int j = 0; j < VS_RB; ++j)
          st[j] = (col[0] >= a.ts_begin ? expf(x[j][0] - mt[j]) : 0.0f) +
                  (col[1] >= a.ts_begin ? expf(x[j][1] - mt[j]) : 0.0f);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int j = 0; j < VS_RB; ++j) st[j] += __shfl_xor_sync(0xffffffffu, st[j], o);
        if (lane < VS_RB && rb + lane < n) {
          float mj = mt[0], sj = st[0], xj = mx[0];
          int aj = at[0];
#pragma unroll
          for (int j = 1; j < VS_RB; ++j)
            if (lane == j) { mj = mt[j]; sj = st[j]; xj = mx[j]; aj = at[j]; }
          const int r = r0 + rb + lane;
          a.ts_f[r] = mj;
          a.ts_f[a.n_rows + r] = sj;
          a.ts_f[2 * a.n_rows + r] = xj;
          a.ts_a[r] = aj;
        }
      }
    }
  }
}

// Persistent grid: CTA b takes work items b, b + grid, ... (item = group *
// passes + pass, a group the VS_NWG vocab tiles [VS_NWG group, + VS_NWG));
// for each, the 64-wide K chunks in order.  The producer warp streams
// (rows tile, VS_NWG E tiles) stages through the ring without a break
// between items; consumer warpgroup w takes the group's tile w: it runs one
// m64nNk16 product per 16-deep step (A its E tile, B the 16 MT rows, which
// the warpgroups share; both K-major, 128-byte swizzle; int8 E converted
// first), and at an item's last chunk stages its sums and writes its
// tile's partials.  mx: the rows (R, D) bf16, box (64, 16 MT); me: E (V,
// D), box (64, 64 VS_NWG), bf16 swizzled or int8 raw.
template <int MT, bool Q, bool TS>
__global__ void __launch_bounds__(VS_THREADS)
vocab_stream_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap me,
                    const std::conditional_t<TS, VsTsArgs, VsArgs> a) {
  constexpr int S = vs_stages(MT);
  constexpr int EB = Q ? VS_ERAW : VS_ETILE;   // bytes of one E tile in a stage
  constexpr int SB = MT * VS_XT + VS_NWG * EB; // bytes a stage
  constexpr int PR = 16 * MT;                  // rows a pass
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // Stage st: the rows tile at smem + st * SB, then the group's E tiles.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, tid = threadIdx.x & 127;   // consumer warpgroup, its thread
  constexpr int WB = Q ? VS_WBUF * VS_ETILE : 0;         // a warpgroup's converted tiles
  char* wb = smem + S * SB + wg * WB;                    // 1024-byte aligned (swizzle)
  float* cs = reinterpret_cast<float*>(smem + S * SB + VS_NWG * WB) + wg * PR * VS_LDC;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + S * SB + VS_NWG * (WB + PR * VS_LDC * 4));
  uint64_t* empty = full + S;
  const int items = a.groups * a.passes, chunks = a.chunks;
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int total = mine * chunks;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * VS_NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * VS_NWG) {   // producer
    if (lane == 0) {
      for (int it = 0; it < total; ++it) {
        const int st = it % S, c = it % chunks;
        const int item = blockIdx.x + (it / chunks) * gridDim.x;
        if (it >= S) mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        mbar_arrive_tx(&full[st], SB);
        tma_load_2d(smem + st * SB, &mx, &full[st], c * VS_KC, (item % a.passes) * PR);
        tma_load_2d(smem + st * SB + MT * VS_XT, &me, &full[st], c * VS_KC,
                    (item / a.passes) * VS_NWG * VS_VT);
      }
    }
    return;
  }

  float acc[MT * 8];
  int pend = -1;
  for (int it = 0; it < total; ++it) {
    const int st = it % S, c = it % chunks;
    mbar_wait(&full[st], (it / S) & 1);
    char* et = smem + st * SB + MT * VS_XT + wg * EB;
    if constexpr (Q) {
      // int8 (v, k) rows of 64 bytes -> bf16 rows of 128 bytes, chunk j of
      // row v stored at chunk j ^ (v % 8) (the 128-byte swizzle).
      char* wt = wb + (it % VS_WBUF) * VS_ETILE;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + 128 * h, vr = idx >> 2, q = idx & 3;
        const uint4 raw = *reinterpret_cast<const uint4*>(et + vr * 64 + q * 16);
        char* rowp = wt + vr * 128;
        *reinterpret_cast<uint4*>(rowp + (((2 * q) ^ (vr & 7)) * 16)) =
            i8x8_to_bf16(make_uint2(raw.x, raw.y));
        *reinterpret_cast<uint4*>(rowp + (((2 * q + 1) ^ (vr & 7)) * 16)) =
            i8x8_to_bf16(make_uint2(raw.z, raw.w));
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      et = wt;
    }
    const uint64_t adesc = sw128_desc(smem_addr(et));
    const uint64_t bdesc = sw128_desc(smem_addr(smem + st * SB));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < VS_KC / 16; ++kk)
      WgmmaN<MT, 0, 0>::run(acc, adesc + 2 * kk, bdesc + 2 * kk, c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (lane == 0 && pend >= 0) mbar_arrive(&empty[pend]);
    pend = st;
    if (c == chunks - 1) {     // the item's sums are complete
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[pend]);
      pend = -1;
      reg_fence(acc);
      const int item = blockIdx.x + (it / chunks) * gridDim.x;
      const int tile = (item / a.passes) * VS_NWG + wg;
      if (tile < a.tiles) {    // the last group may hold fewer tiles
        named_sync(1 + VS_NWG + wg, 128);   // the previous item's statistics have read cs
        // Element i of row tile t: vocab column 16 (warp % 4) + lane / 4
        // (+ 8), row 16 t + 8 (i / 4) + 2 (lane % 4) + i % 2 of the pass.
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = 16 * t + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            cs[row * VS_LDC + 16 * (warp & 3) + (lane >> 2) + ((i & 2) ? 8 : 0)] = acc[8 * t + i];
          }
        named_sync(1 + VS_NWG + wg, 128);
        tile_stats<Q, TS>(cs, a, tile, item % a.passes, PR);
      }
    }
  }
}

__device__ __forceinline__ void merge(float& m, int& a, float& s, float m2, int a2,
                                      float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) { m = m2; a = a2; s = s2; return; }
  const float mn = fmaxf(m, m2);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

__global__ void __launch_bounds__(256)
verify_combine_kernel(const float* __restrict__ part_f, const int* __restrict__ part_a,
                      int ntiles, int n_rows, float* __restrict__ o_max,
                      float* __restrict__ o_lse, int* __restrict__ o_arg,
                      float* __restrict__ o_gth) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const size_t nt = (size_t)ntiles * n_rows;
  float m = -INFINITY, s = 0.0f, g = NEG_VERIFY;
  int a = 0x7fffffff;
  for (int t = lane; t < ntiles; t += 32) {
    const size_t idx = (size_t)r * ntiles + t;
    merge(m, a, s, part_f[idx], part_a[idx], part_f[nt + idx]);
    g = fmaxf(g, part_f[2 * nt + idx]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, a, s, m2, a2, s2);
  }
  g = warp_max(g);
  if (lane == 0) {
    o_max[r] = m;
    o_lse[r] = m + logf(s);
    o_arg[r] = a;
    o_gth[r] = g;
  }
}

// The timestamp mode's combine: verify_combine_kernel's fold, plus the
// timestamp side (the timestamp tiles' partials and the straddling tile's
// split) and the text side's max in the same pass, then _emit's force rule
// for rows < n_verif.
__global__ void __launch_bounds__(256)
verify_combine_ts_kernel(const float* __restrict__ part_f, const int* __restrict__ part_a,
                         int ntiles, int n_rows, float* __restrict__ o_max,
                         float* __restrict__ o_lse, int* __restrict__ o_arg,
                         float* __restrict__ o_gth, const VsTsArgs a) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= n_rows) return;
  const size_t nt = (size_t)ntiles * n_rows;
  const int straddle = ts_straddle(a.ts_begin);
  float m = -INFINITY, s = 0.0f, g = NEG_VERIFY, mts = -INFINITY, sts = 0.0f, mtx = -INFINITY;
  int am = 0x7fffffff, ats = 0x7fffffff;
  for (int t = lane; t < ntiles; t += 32) {
    const size_t idx = (size_t)r * ntiles + t;
    const float pm = part_f[idx], ps = part_f[nt + idx];
    const int pa = part_a[idx];
    merge(m, am, s, pm, pa, ps);
    g = fmaxf(g, part_f[2 * nt + idx]);
    if (t * VS_VT >= a.ts_begin) merge(mts, ats, sts, pm, pa, ps);
    else if (t != straddle) mtx = fmaxf(mtx, pm);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const int a2 = __shfl_xor_sync(0xffffffffu, am, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge(m, am, s, m2, a2, s2);
    const float mt2 = __shfl_xor_sync(0xffffffffu, mts, o);
    const int at2 = __shfl_xor_sync(0xffffffffu, ats, o);
    const float st2 = __shfl_xor_sync(0xffffffffu, sts, o);
    merge(mts, ats, sts, mt2, at2, st2);
  }
  g = warp_max(g);
  mtx = warp_max(mtx);
  if (lane == 0) {
    if (straddle >= 0 && straddle < ntiles) {
      merge(mts, ats, sts, a.ts_f[r], a.ts_a[r], a.ts_f[n_rows + r]);
      mtx = fmaxf(mtx, a.ts_f[2 * n_rows + r]);
    }
    const float lse_ts = mts + logf(sts);
    const bool force = r < a.n_verif && lse_ts > mtx;
    o_max[r] = force ? mts : m;
    o_lse[r] = force ? lse_ts : m + logf(s);
    o_arg[r] = force ? ats : am;
    o_gth[r] = force && a.gcol[r] < a.ts_begin ? NEG_VERIFY : g;
  }
}

// Launches vocab_stream_kernel<mt, Q, TS> (mt in [MT, VS_MAX_MT]) on a grid
// of as many CTAs as fit on the card (found once per device), at most one
// per work item.
template <bool Q, bool TS, int MT = 1>
int vs_launch(int mt, int items, const CUtensorMap& mx, const CUtensorMap& me,
              const VsTsArgs& a, cudaStream_t st) {
  if (mt == MT) {
    constexpr int MAX_DEV = 16;
    static int fits[MAX_DEV] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
    const int smem = vs_smem(MT, Q);
    // Per launch: the attribute belongs to the current device's context.
    cudaFuncSetAttribute(vocab_stream_kernel<MT, Q, TS>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (fits[dev] == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vocab_stream_kernel<MT, Q, TS>,
                                                    VS_THREADS, smem);
      fits[dev] = (per_sm > 1 ? per_sm : 1) * sms;
    }
    const int grid = items < fits[dev] ? items : fits[dev];
    if constexpr (TS)
      vocab_stream_kernel<MT, Q, TS><<<grid, VS_THREADS, smem, st>>>(mx, me, a);
    else
      vocab_stream_kernel<MT, Q, TS><<<grid, VS_THREADS, smem, st>>>(
          mx, me, static_cast<const VsArgs&>(a));
    return (int)cudaGetLastError();
  }
  if constexpr (MT < VS_MAX_MT) return vs_launch<Q, TS, MT + 1>(mt, items, mx, me, a, st);
  return (int)cudaErrorInvalidValue;
}

// Stages B and C over rows (n_rows, D): the vocab stream's partials, then
// the per-row combine.  e is bf16, or int8 when escale is set.  rows and e
// 16-byte aligned (the tensor-map encoder refuses another address: the
// entry then returns TENSOR_MAP_ERROR + its error).
// ts: the timestamp mode's pointers (last, penult, maxts, ts_f, ts_a; nulls
// without it) and ts_ints (n_verif, on, ts_begin, no_ts_id, cap).
inline int score_rows(const bf16* rows, int n_rows, const void* e, const float* escale,
                      int v_dim, int d_dim, const int* pos, const int* gcol,
                      const int8_t* sup, int begin_index, int eos_id, int has_decay,
                      int decay_start, float log_factor, float* part_f, int* part_a,
                      float* o_max, float* o_lse, int* o_arg, float* o_gth, void* const* ts,
                      const int* ts_ints, cudaStream_t st) {
  const bool q = escale != nullptr;
  const int tiles = (v_dim + VS_VT - 1) / VS_VT;
  const int mt = ((n_rows < 16 * VS_MAX_MT ? n_rows : 16 * VS_MAX_MT) + 15) / 16;
  const int passes = (n_rows + 16 * mt - 1) / (16 * mt);
  const cuuint64_t xdims[2] = {(cuuint64_t)d_dim, (cuuint64_t)n_rows};
  const cuuint64_t xstrides[1] = {(cuuint64_t)d_dim * sizeof(bf16)};
  const cuuint32_t xbox[2] = {VS_KC, (cuuint32_t)(16 * mt)};
  const cuuint64_t edims[2] = {(cuuint64_t)d_dim, (cuuint64_t)v_dim};
  const cuuint64_t estrides[1] = {(cuuint64_t)d_dim * (q ? 1 : sizeof(bf16))};
  const cuuint32_t ebox[2] = {VS_KC, VS_NWG * VS_VT};
  CUtensorMap mx, me;
  int err = encode_map(&mx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, xdims, xstrides, xbox,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode_map_cached(
        &me, q ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, e, edims,
        estrides, ebox, q ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  VsTsArgs a;
  a.escale = escale;
  a.pos = pos;
  a.gcol = gcol;
  a.sup = sup;
  a.part_f = part_f;
  a.part_a = part_a;
  a.v_dim = v_dim;
  a.n_rows = n_rows;
  a.chunks = d_dim / VS_KC;
  a.tiles = tiles;
  a.groups = (tiles + VS_NWG - 1) / VS_NWG;
  a.passes = passes;
  a.begin_index = begin_index;
  a.eos_id = eos_id;
  a.has_decay = has_decay;
  a.decay_start = decay_start;
  a.log_factor = log_factor;
  const bool ts_on = ts_ints[1] != 0;
  a.last = static_cast<const int*>(ts[0]);
  a.penult = static_cast<const int*>(ts[1]);
  a.maxts = static_cast<const int*>(ts[2]);
  a.ts_f = static_cast<float*>(ts[3]);
  a.ts_a = static_cast<int*>(ts[4]);
  a.n_verif = ts_ints[0];
  a.ts_begin = ts_ints[2];
  a.no_ts_id = ts_ints[3];
  a.ts_cap = ts_ints[4];
  if (ts_on && (!a.last || !a.penult || !a.maxts || !a.ts_f || !a.ts_a))
    return (int)cudaErrorInvalidValue;
  const int items = a.groups * passes;
  if (ts_on)
    err = q ? vs_launch<true, true>(mt, items, mx, me, a, st)
            : vs_launch<false, true>(mt, items, mx, me, a, st);
  else
    err = q ? vs_launch<true, false>(mt, items, mx, me, a, st)
            : vs_launch<false, false>(mt, items, mx, me, a, st);
  if (err != 0) return err;
  if (ts_on)
    verify_combine_ts_kernel<<<(n_rows + 7) / 8, 256, 0, st>>>(part_f, part_a, tiles, n_rows,
                                                               o_max, o_lse, o_arg, o_gth, a);
  else
    verify_combine_kernel<<<(n_rows + 7) / 8, 256, 0, st>>>(part_f, part_a, tiles, n_rows,
                                                            o_max, o_lse, o_arg, o_gth);
  return (int)cudaGetLastError();
}

// Stage A: out (nh, m, d) = src + bf16(SiLU(src @ W_k + b_k)) for every head
// k on the heads mode of wgemm.cuh; w (nh, d, d) bf16, or int8 with f32
// scales ws (nh, d).  src and w 16-byte aligned (else TENSOR_MAP_ERROR +
// the encoder's error).
inline int head_rows(const bf16* src, const void* w, const bf16* b, const float* ws, bf16* out,
                     int m, int d, int nh, cudaStream_t st) {
  const bool w8 = ws != nullptr;
  const int mt = (m + 15) / 16;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)d, (cuuint64_t)nh};
  const cuuint64_t es = w8 ? 1 : sizeof(bf16);
  const cuuint64_t strides[2] = {(cuuint64_t)d * es, (cuuint64_t)d * d * es};
  const cuuint32_t box[3] = {G_TILE, G_TILE, 1};
  CUtensorMap mx, mw;
  int err = encode_x_map(&mx, src, m, d, mt);
  if (err == 0)
    err = encode_map_cached(
        &mw, w8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, dims,
        strides, box, w8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  const GemmJob job = gjob(b, out, EPI_SILU_RESID, src, 1.0f, ws);
  return w8 ? wgemm_heads_launch<true>(mt, st, mx, mw, job, nh, m, d, d)
            : wgemm_heads_launch<false>(mt, st, mx, mw, job, nh, m, d, d);
}

}  // namespace
}  // namespace wm

// Pointer table of wm_verify_hidden (ops/verify.py builds the same list).
enum VerifyPtr {
  V_HVER = 0,   // (BN, D) bf16 row-block-0 source (identity0 only)
  V_HSRC,       // (BN, D) bf16 draft-row source
  V_HEADS_W,    // (nh, D, D) bf16, or int8 with V_HEADS_S
  V_HEADS_B,    // (nh, D) bf16
  V_EMBED,      // (V, D) bf16, or int8 with V_EMBED_S
  V_POS,        // (R,) int32
  V_GCOL,       // (R,) int32
  V_SUP,        // (2, V) int8 [suppress; begin-suppress]
  V_ROWS,       // (R, D) bf16 scratch
  V_PART_F,     // (3, R, ntiles) f32 scratch
  V_PART_A,     // (R, ntiles) int32 scratch
  V_MAX, V_LSE, V_ARG, V_GTH,   // (R,) outputs
  V_EMBED_S,    // (V,) f32 int8-embedding scales, or null (bf16 embedding)
  V_HEADS_S,    // (nh, D) f32 int8-head scales, or null (bf16 heads)
  V_LAST,       // the timestamp mode (nulls without it): (R,) int32 last,
  V_PENULT,     //   penult and maxts, the straddling tile's (3, R) f32 and
  V_MAXTS,      //   (R,) int32 split
  V_TS_F,
  V_TS_A,
  V_COUNT       // bf16: (nh, 192, D) staging rows when BN > 192, else null
};

// ints: BN, D, V, n_heads, identity0, begin_index, eos_id, has_decay,
// decay_start, then the timestamp mode's n_verif, on, ts_begin, no_ts_id,
// cap (-1: none).  R = (n_heads + identity0) * BN <= 1024.
extern "C" int wm_verify_hidden(void** p, const int* ints, float log_factor,
                                void* stream) {
  using namespace wm;
  const int BN = ints[0], D = ints[1], V = ints[2], NH = ints[3], id0 = ints[4];
  const int begin_index = ints[5], eos_id = ints[6], has_decay = ints[7];
  const int decay_start = ints[8];
  const int R = (NH + id0) * BN;
  cudaStream_t st = (cudaStream_t)stream;
  if (BN < 1 || NH < 1 || R > VH_MAX_ROWS || D % VS_KC || (BN > VH_SRC_BLOCK && !p[V_COUNT]))
    return (int)cudaErrorInvalidValue;
  bf16* rows = static_cast<bf16*>(p[V_ROWS]);
  // (A) row construction, in blocks of up to VH_SRC_BLOCK source rows.
  if (id0)
    cudaMemcpyAsync(rows, p[V_HVER], (size_t)BN * D * sizeof(bf16),
                    cudaMemcpyDeviceToDevice, st);
  const bf16* src = static_cast<const bf16*>(p[V_HSRC]);
  const bf16* hb = static_cast<const bf16*>(p[V_HEADS_B]);
  const float* hs = static_cast<const float*>(p[V_HEADS_S]);
  bf16* hrows = rows + (size_t)id0 * BN * D;
  int err = 0;
  if (BN <= VH_SRC_BLOCK) {
    err = head_rows(src, p[V_HEADS_W], hb, hs, hrows, BN, D, NH, st);
  } else {
    bf16* stage = static_cast<bf16*>(p[V_COUNT]);
    const size_t row_bytes = (size_t)D * sizeof(bf16);
    for (int r0 = 0; r0 < BN && err == 0; r0 += VH_SRC_BLOCK) {
      const int m = BN - r0 < VH_SRC_BLOCK ? BN - r0 : VH_SRC_BLOCK;
      err = head_rows(src + (size_t)r0 * D, p[V_HEADS_W], hb, hs, stage, m, D, NH, st);
      if (err == 0)   // head k's m rows: stage[k] -> rows k BN + r0
        err = (int)cudaMemcpy2DAsync(hrows + (size_t)r0 * D, BN * row_bytes, stage,
                                     m * row_bytes, m * row_bytes, NH,
                                     cudaMemcpyDeviceToDevice, st);
    }
  }
  if (err != 0) return err;
  // (B) the vocab stream, (C) combine.
  err = score_rows(rows, R, p[V_EMBED], static_cast<const float*>(p[V_EMBED_S]), V, D,
             static_cast<const int*>(p[V_POS]), static_cast<const int*>(p[V_GCOL]),
             static_cast<const int8_t*>(p[V_SUP]), begin_index, eos_id, has_decay,
             decay_start, log_factor, static_cast<float*>(p[V_PART_F]),
             static_cast<int*>(p[V_PART_A]), static_cast<float*>(p[V_MAX]),
             static_cast<float*>(p[V_LSE]), static_cast<int*>(p[V_ARG]),
             static_cast<float*>(p[V_GTH]), p + V_LAST, ints + 9, st);
  return err != 0 ? err : (int)cudaGetLastError();
}

// Pointer table of wm_verify_rows (ops/verify.py builds the same list).
enum VerifyRowsPtr {
  VR_ROWS = 0,   // (R, D) bf16 rows to score
  VR_EMBED,      // (V, D) bf16, or int8 with VR_EMBED_S
  VR_POS,        // (R,) int32
  VR_GCOL,       // (R,) int32
  VR_SUP,        // (2, V) int8 [suppress; begin-suppress]
  VR_PART_F,     // (3, R, ntiles) f32 scratch
  VR_PART_A,     // (R, ntiles) int32 scratch
  VR_MAX, VR_LSE, VR_ARG, VR_GTH,   // (R,) outputs
  VR_EMBED_S,    // (V,) f32 int8-embedding scales, or null (bf16 embedding)
  VR_LAST,       // the timestamp mode, as V_LAST .. V_TS_A
  VR_PENULT,
  VR_MAXTS,
  VR_TS_F,
  VR_TS_A,
  VR_COUNT
};

constexpr int VR_MAX_ROWS = 1024;   // the JAX kernel's _MAX_R

// ints: R, D, V, begin_index, eos_id, has_decay, decay_start, then the
// timestamp mode's n_verif, on, ts_begin, no_ts_id, cap (-1: none).
extern "C" int wm_verify_rows(void** p, const int* ints, float log_factor,
                              void* stream) {
  using namespace wm;
  const int R = ints[0], D = ints[1], V = ints[2], begin_index = ints[3];
  const int eos_id = ints[4], has_decay = ints[5], decay_start = ints[6];
  if (R < 1 || R > VR_MAX_ROWS || D % VS_KC) return (int)cudaErrorInvalidValue;
  return score_rows(static_cast<const bf16*>(p[VR_ROWS]), R, p[VR_EMBED],
             static_cast<const float*>(p[VR_EMBED_S]), V, D, static_cast<const int*>(p[VR_POS]), static_cast<const int*>(p[VR_GCOL]),
             static_cast<const int8_t*>(p[VR_SUP]), begin_index, eos_id, has_decay,
             decay_start, log_factor, static_cast<float*>(p[VR_PART_F]),
             static_cast<int*>(p[VR_PART_A]), static_cast<float*>(p[VR_MAX]),
             static_cast<float*>(p[VR_LSE]), static_cast<int*>(p[VR_ARG]),
             static_cast<float*>(p[VR_GTH]), p + VR_LAST, ints + 7, (cudaStream_t)stream);
}

// out (NH, M, D) = src + bf16(SiLU(src @ W_k + b_k)) for each head k; src
// (M, D), w (NH, D, D), b (NH, D), all bf16; or w int8 with f32 scales ws
// (NH, D) (null for bf16 heads).  1 <= M <= 192, D % 64 == 0; src and w
// 16-byte aligned.
extern "C" int wm_head_rows(const void* src, const void* w, const void* b, void* out,
                            const void* ws, int m, int d, int nh, void* stream) {
  using namespace wm;
  if (m < 1 || m > 16 * G_MAX_MT || d < G_TILE || d % G_TILE || nh < 1)
    return (int)cudaErrorInvalidValue;
  const int err = head_rows(static_cast<const bf16*>(src), w, static_cast<const bf16*>(b),
                            static_cast<const float*>(ws), static_cast<bf16*>(out), m, d, nh,
                            (cudaStream_t)stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The f32 modes of K4 and K5 (the JAX package's default dtype): f32 rows
// against an f32 tied embedding, FFMA on the CUDA cores (the tensor cores
// take f32 only as TF32).
//
// Stage B is ffma_stream.cuh's f32 weight stream, K3 f32's, with FsScore as
// its epilogue: a persistent grid of two CTAs an SM over (64-entry vocab
// tile, pass of up to 64 rows) items, a producer warp's TMA ring (80-96 KB) of
// E chunks and the pass's rows, four consumer warps of 4 entries x TR rows
// a thread, each sum one fmaf chain over D in order from 0 (so a row's sums
// do not depend on R, on its pass or on the grid).  At an item's last chunk
// the consumers stage the (8 TR x 64) sums in shared memory of their own
// (pitch VS_LDC) and run the bf16 stream's tile_stats<Q, TS> on them: the
// processors, the timestamp rules and the straddling tile's split are the
// same code, the partials the same (3, R, tiles) + (R, tiles) layout.
// Stage C is the same combine kernels.  Stage A (K4) is ffma_gemm.cuh's f32
// weight stream over the heads (EPI_SILU_RESID, K slices from (D, D) alone,
// one launch), the same launch as wm_gemm_f32's for the two-pass loop's head
// rows, so a head row has the same bits in both.  Bound on H100: the 265.6
// MB f32 embedding stream (79 us at 3.35 TB/s) up to R ~ 40 rows, then the
// 2 R V D products at the CUDA cores' 67 TFLOP/s (R = 121: 16.1 GFLOP,
// 0.24 ms).
//
// W8A32 (the int8 copy of an f32 model) rides the same two entries: an int8
// embedding (V_EMBED_S / VR_EMBED_S given) streams as int8 chunks on the
// same ring (64-byte rows, converted exactly to f32 as the consumers read
// them, 66.4 MB instead of 265.6 MB) and column v's f32 sum is multiplied by
// s[v] before the processors (tile_stats<Q = true, TS>), in every mode of
// the f32 form (ts_cfg, identity0); int8 heads (V_HEADS_S given) run stage
// A on the int8-weight mode of ffma_gemm.cuh (the heads as a stack, the
// column's scale on the sum before the bias, EPI_SILU_RESID, one launch).
// The JAX kernels score the f32 rows against the embedding cast to f32
// (verify.py:208, :365) and cast int8 heads to the rows' dtype (:345-354).
namespace wm {
namespace {

// The f32 stream's scoring epilogue: the item's sums staged at pitch
// VS_LDC (row r of the pass at r * VS_LDC), then tile_stats over the pass's
// 8 TR rows.  The 128 consumer threads meet at named barrier 1 (the
// producer warp has returned): before the sums are written (the previous
// item's statistics have read them) and after.  tile_stats' warp index
// (threadIdx.x >> 5) & 3 is the consumer warp's own.
template <bool Q, bool TS>
struct FsScore {
  std::conditional_t<TS, VsTsArgs, VsArgs> a;
  __host__ __device__ static constexpr int staged(int tr) { return 8 * tr * VS_LDC * 4; }
  template <int TR>
  __device__ __forceinline__ void item(const float (&acc)[4][TR], int tile, int pass,
                                       float* cs, int we, int eg, int rg) const {
    named_sync(1, 128);
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) cs[(rg + 8 * i) * VS_LDC + 32 * we + eg + 8 * e] = acc[e][i];
    named_sync(1, 128);
    tile_stats<Q, TS>(cs, a, tile, pass, 8 * TR);
  }
};

template <bool Q, bool TS>
int fs_score(const float* rows, const void* e, const VsTsArgs& a, int d_dim, cudaStream_t st) {
  FsScore<Q, TS> epi;
  epi.a = a;   // TS = false: the VsArgs part
  return fs_launch<Q>(rows, e, epi, a.n_rows, a.v_dim, d_dim, st);
}

// Stages B and C over f32 rows (n_rows, D) and an f32 embedding e (V, D),
// or an int8 one (e_q) with its f32 scales (escale): score_rows' arguments.
inline int score_rows_f32(const float* rows, int n_rows, const void* e, const float* escale,
                          int v_dim, int d_dim,
                          const int* pos, const int* gcol, const int8_t* sup, int begin_index,
                          int eos_id, int has_decay, int decay_start, float log_factor,
                          float* part_f, int* part_a, float* o_max, float* o_lse, int* o_arg,
                          float* o_gth, void* const* ts, const int* ts_ints, cudaStream_t st) {
  const int tiles = (v_dim + VS_VT - 1) / VS_VT;
  VsTsArgs a{};   // chunks, groups, passes: the bf16 stream's, not read here
  a.escale = escale;
  a.pos = pos;
  a.gcol = gcol;
  a.sup = sup;
  a.part_f = part_f;
  a.part_a = part_a;
  a.v_dim = v_dim;
  a.n_rows = n_rows;
  a.tiles = tiles;
  a.begin_index = begin_index;
  a.eos_id = eos_id;
  a.has_decay = has_decay;
  a.decay_start = decay_start;
  a.log_factor = log_factor;
  const bool ts_on = ts_ints[1] != 0;
  a.last = static_cast<const int*>(ts[0]);
  a.penult = static_cast<const int*>(ts[1]);
  a.maxts = static_cast<const int*>(ts[2]);
  a.ts_f = static_cast<float*>(ts[3]);
  a.ts_a = static_cast<int*>(ts[4]);
  a.n_verif = ts_ints[0];
  a.ts_begin = ts_ints[2];
  a.no_ts_id = ts_ints[3];
  a.ts_cap = ts_ints[4];
  if (ts_on && (!a.last || !a.penult || !a.maxts || !a.ts_f || !a.ts_a))
    return (int)cudaErrorInvalidValue;
  int err = escale ? (ts_on ? fs_score<true, true>(rows, e, a, d_dim, st)
                            : fs_score<true, false>(rows, e, a, d_dim, st))
                   : (ts_on ? fs_score<false, true>(rows, e, a, d_dim, st)
                            : fs_score<false, false>(rows, e, a, d_dim, st));
  if (err != 0) return err;
  if (ts_on)
    verify_combine_ts_kernel<<<(n_rows + 7) / 8, 256, 0, st>>>(part_f, part_a, tiles, n_rows,
                                                               o_max, o_lse, o_arg, o_gth, a);
  else
    verify_combine_kernel<<<(n_rows + 7) / 8, 256, 0, st>>>(part_f, part_a, tiles, n_rows,
                                                            o_max, o_lse, o_arg, o_gth);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wm

// K4's f32 mode: wm_verify_hidden's pointer table and ints, every float
// operand f32 (the rows scratch (R, D) f32; W8A32: an int8 embedding and /
// or int8 heads with their f32 scales); the pointer at V_COUNT (the bf16
// mode's staging rows) is not read: stage A is one launch of ffma_gemm.cuh
// (f32 or int8 heads) and needs no scratch.
extern "C" int wm_verify_hidden_f32(void** p, const int* ints, float log_factor,
                                    void* stream) {
  using namespace wm;
  const int BN = ints[0], D = ints[1], V = ints[2], NH = ints[3], id0 = ints[4];
  const int R = (NH + id0) * BN;
  cudaStream_t st = (cudaStream_t)stream;
  if (BN < 1 || NH < 1 || R > VH_MAX_ROWS || D % VS_KC) return (int)cudaErrorInvalidValue;
  float* rows = static_cast<float*>(p[V_ROWS]);
  if (id0)
    cudaMemcpyAsync(rows, p[V_HVER], (size_t)BN * D * sizeof(float), cudaMemcpyDeviceToDevice,
                    st);
  const float* src = static_cast<const float*>(p[V_HSRC]);
  float* hrows = rows + (size_t)id0 * BN * D;
  // Stage A: f32 heads, or int8 heads with their scales (the W8A32 GEMM).
  const int err = fg_launch(src, p[V_HEADS_W], static_cast<const float*>(p[V_HEADS_S]),
                            static_cast<const float*>(p[V_HEADS_B]), src, hrows, BN, D, D, NH,
                            EPI_SILU_RESID, st);
  if (err != 0) return err;
  return score_rows_f32(rows, R, p[V_EMBED], static_cast<const float*>(p[V_EMBED_S]), V, D,
                        static_cast<const int*>(p[V_POS]), static_cast<const int*>(p[V_GCOL]),
                        static_cast<const int8_t*>(p[V_SUP]), ints[5], ints[6], ints[7],
                        ints[8], log_factor, static_cast<float*>(p[V_PART_F]),
                        static_cast<int*>(p[V_PART_A]), static_cast<float*>(p[V_MAX]),
                        static_cast<float*>(p[V_LSE]), static_cast<int*>(p[V_ARG]),
                        static_cast<float*>(p[V_GTH]), p + V_LAST, ints + 9, st);
}

// K5's f32 mode: wm_verify_rows' pointer table and ints, f32 rows and an
// f32 embedding (VR_EMBED_S null) or, W8A32, an int8 one with its f32
// scales at VR_EMBED_S.  Any R <= 1024 (passes of up to 64 rows).
extern "C" int wm_verify_rows_f32(void** p, const int* ints, float log_factor, void* stream) {
  using namespace wm;
  const int R = ints[0], D = ints[1], V = ints[2];
  if (R < 1 || R > VR_MAX_ROWS || D % VS_KC) return (int)cudaErrorInvalidValue;
  return score_rows_f32(static_cast<const float*>(p[VR_ROWS]), R, p[VR_EMBED],
                        static_cast<const float*>(p[VR_EMBED_S]), V, D,
                        static_cast<const int*>(p[VR_POS]), static_cast<const int*>(p[VR_GCOL]),
                        static_cast<const int8_t*>(p[VR_SUP]), ints[3], ints[4], ints[5],
                        ints[6], log_factor, static_cast<float*>(p[VR_PART_F]),
                        static_cast<int*>(p[VR_PART_A]), static_cast<float*>(p[VR_MAX]),
                        static_cast<float*>(p[VR_LSE]), static_cast<int*>(p[VR_ARG]),
                        static_cast<float*>(p[VR_GTH]), p + VR_LAST, ints + 7,
                        (cudaStream_t)stream);
}
