// Flash-attention forward of a query slice at context offset ctx, for Hopper.
//
// Replaces the TPU kernel repro/kernels/terapipe_attention.py::_fwd_kernel
// (launched by terapipe_attention_fwd).  Same function: causal attention of
// q (B, l, Hq, hd), absolute positions ctx..ctx+l-1, over k/v (B, Sk, Hkv, hd)
// with Sk >= ctx + l; key kv attends iff kv <= q_pos and kv < ctx + l (the
// stale cache tail is masked); GQA kv head = hq / rep; outputs O in the input
// dtype and lse = m + log(s) in f32, (B, Hq, l); f32 running max, denominator
// and accumulator; denominator clamped at 1e-30.
//
// What bounds it on the H100: arithmetic.  A prefill chunk does
// 4*hd*Hq*sum(attended keys) FLOPs over O((ctx+l)*Hkv*hd) bytes; at l = 1024 that
// is ~hundreds of FLOPs per byte, above the card's ridge point.  Two kernels,
// chosen by dtype:
//
// fwd_kernel_bf16 (bf16 inputs): a warp-specialised sm_90a kernel, both
// products as wgmma (sm90.cuh).
//  * persistent: at most one block per SM, each walking its share of the
//    (b, hq, 128-row q tile) work, numbered longest causal frontier first
//    and dealt out in a zigzag, so the short diagonal tiles form the tail
//    and every block's share is about the same.  A block has two consumer
//    warpgroups of 64 rows and one producer warpgroup, of which one thread
//    works;
//  * the producer loads each tile's Q, and 128-key K and V tiles through a
//    two-stage ring, by TMA (tensor maps over the strided (B, S, H, hd)
//    views, built per launch), each into swizzled shared memory with its
//    own "full" mbarrier; K and V stages are freed separately, K as soon as
//    S is computed, Q after a tile's last S, so the next tile's loads run
//    under this one's last P.V and stores.  K and V end at ctx + l in
//    their maps, so the stale tail is never read (TMA fills zeros), nor are
//    Q rows past l;
//  * setmaxnreg hands the producer's registers to the consumers (24 / 240);
//  * S = Q.K^T is wgmma with both operands in shared memory (K-major); the
//    online softmax runs on the accumulator fragments (a row lives in one
//    quad of lanes) in log2 units, with independent max and sum chains; P
//    is rounded to bf16 in registers and is the register A operand of
//    O += P.V, V read MN-major.  The denominator sums P in f32;
//  * S of tile j is issued before P.V of tile j - 1, so that product runs on
//    the tensor cores under tile j's softmax (each warpgroup keeps S, O and
//    the previous P in registers: 160 of its 240 at hd 128); where both
//    groups walk as many tiles, they also take turns to issue (ping-pong,
//    two named barriers), so one group's softmax runs under the other's
//    products;
//  * the ring stops at the q tile's causal frontier ctx + min(q0 + 128, l):
//    tiles past it are neither loaded nor computed, and each warpgroup stops
//    at its own 64 rows' frontier; only tiles that cross the diagonal, or
//    hold rows at and past l, are masked element by element;
//  * fully masked rows (pad rows past l) give 0, never NaN: the rescale is
//    guarded while the running max is -inf.  O is stored from registers,
//    rows at and past l never written.
// What holds it below its bound (PERF.md): one block per SM, whose start
// (barriers, Q, the first tiles) no other block's work overlaps, and the
// softmax's exponentials, which the P.V product hides only in part.
//
// fwd_kernel_f32 (f32 inputs): f32 SIMT FMAs, since the tensor cores have no
// f32 product of f32 accuracy (TF32 keeps ~3 decimal digits):
//  * one block per (b, hq, 32-row q tile); a loop inside the block walks
//    32-key K/V tiles, and stops at the tile's causal frontier
//    ctx + min(q0 + 32, l) — tiles past it are neither loaded nor computed;
//  * K/V tiles are staged once in shared memory and reused by all 32 query
//    rows; rows are padded by 4 floats so the lane-per-key float4 reads are
//    free of bank conflicts;
//  * each warp owns 8 query rows: lane j scores key j, a warp reduction gives
//    the tile's row max and sum, and for the PV product each lane owns the
//    output dims d = lane + 32*i, with p_j broadcast by shuffle.
//
// Both: GQA K/V are read for kv head hq / rep, never repeated in memory; ctx
// is a runtime argument, so one build serves every chunk offset.  The tile
// walk of fwd_kernel_bf16 is stated in Python in kernels/tile_walk.py.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

// ----------------------------------------------------- bf16, wgmma + TMA
constexpr int kBQ16 = 128;              // query rows per block: two consumer warpgroups of 64
constexpr int kBK16 = 128;              // keys per K/V tile
constexpr int kStages = 2;              // K/V tiles in flight
constexpr int kWsThreads = 384;         // consumer warpgroups 0 and 1, the producer's 2
constexpr int kProducerRegs = 24;       // setmaxnreg: 24 x 128 + 240 x 256 = 384 x 168
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory: Q (128 rows), then K[stage] and V[stage] (128 rows each),
// then the barriers; every tile in HeadLayout<HD>'s swizzled sub-tiles.
template <int HD>
struct FwdSmem {
  using L = sm90::HeadLayout<HD>;
  static constexpr int kQ = L::template tile_bytes<kBQ16>();
  static constexpr int kKV = L::template tile_bytes<kBK16>();
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBars = kV + kStages * kKV;
  static constexpr size_t kBytes = kBars + 8 * (2 + 4 * kStages) + 1024;
};

// The online softmax of one 64 x 128 score tile of a consumer warpgroup, on
// the accumulator fragments (a row lives in one quad of lanes): updates the
// running max m (raw score units) and this lane's part of the denominator
// s, turns the scores into P = 2^(scale_log2 * (x - m)) in place, and
// returns the rescale of each row's earlier sums in alpha.  Masked scores
// are -inf; a row with nothing seen yet keeps m = -inf and P = 0 (the
// guarded rescale: never NaN).  Independent max and sum chains keep the two
// warps of each scheduler busy.
template <int NS>
__device__ __forceinline__ void online_softmax(float (&sc)[4 * NS], float (&m)[2], float (&s)[2],
                                               float (&alpha)[2], float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
      mx[j & 3] = fmaxf(mx[j & 3], fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    const float m_new =
        fmaxf(m[r], sm90::quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
    alpha[r] = m[r] == -INFINITY ? 0.f : sm90::ex2((m[r] - m_new) * scale_log2);
    const float m_sub = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const float p = sm90::ex2(fmaf(sc[4 * j + e], scale_log2, -m_sub));
        sc[4 * j + e] = p;
        sum[j & 3] += p;
      }
    }
    s[r] = s[r] * alpha[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m[r] = m_new;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
fwd_kernel_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
                float* __restrict__ lse, int l, int n_heads, int rep, int ctx, int batch,
                int64_t o_sb, int64_t o_ss, float scale_log2) {
  using S = FwdSmem<HD>;
  constexpr int KT = HD / 16;           // k-steps of Q.K^T
  constexpr int NS = kBK16 / 8;         // column groups of S (8 keys each)
  constexpr int NO = HD / 8;            // column groups of O (8 dims each)
  constexpr int PK = kBK16 / 16;        // k-steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::smem_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::kBars);
  uint64_t* q_free = q_full + 1;        // all 8 consumer warps are done with Q
  uint64_t* k_full = q_free + 1;        // [stage]: the K tile has landed
  uint64_t* v_full = k_full + kStages;  // [stage]: the V tile has landed
  uint64_t* k_free = v_full + kStages;  // [stage]: all 8 consumer warps are done with K
  uint64_t* v_free = k_free + kStages;  // [stage]: ... with V

  // Persistent: the q tiles (b, hq, iq) are numbered longest causal
  // frontier first, and pass k of block x takes number k * grid + x, or
  // k * grid + grid - 1 - x on odd passes (a zigzag, so every block's share
  // of the causal work is about the same); the ring's stages and phases
  // run on across a block's tiles.
  const int nq = (l + kBQ16 - 1) / kBQ16;
  const int per_q = n_heads * batch;
  const int n_items = nq * per_q;
  struct Item {
    int h, b, q0, n_tiles;
  };
  auto number = [&](int k) {
    return k * int(gridDim.x) + ((k & 1) ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x));
  };
  auto item = [&](int i) {
    const int iq = nq - 1 - i / per_q;
    const int q0 = iq * kBQ16;
    const int kv_end = ctx + min(q0 + kBQ16, l);   // causal frontier of this q tile
    return Item{i % per_q % n_heads, i % per_q / n_heads, q0, (kv_end + kBK16 - 1) / kBK16};
  };
  // the warpgroup, broadcast from lane 0 so the compiler sees it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    sm90::bar_init(q_full, 1);
    sm90::bar_init(q_free, 8);
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(k_full + s, 1);
      sm90::bar_init(v_full + s, 1);
      sm90::bar_init(k_free + s, 8);
      sm90::bar_init(v_free + s, 8);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the Q buffer and the K/V ring full; the
    // rest of the group idles
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int c = 0;                                   // K/V tiles loaded so far
      for (int n = 0; number(n) < n_items; ++n) {
        const Item it = item(number(n));
        const int hk = it.h / rep;
        sm90::bar_wait(q_free, (n & 1) ^ 1);
        sm90::bar_arrive_tx(q_full, kBQ16 * HD * 2);
        sm90::tma_load_tile<HD, kBQ16>(sm, &tm_q, q_full, it.h, it.q0, it.b);
        for (int t = 0; t < it.n_tiles; ++t, ++c) {
          const int s = c % kStages;
          const uint32_t free_ph = ((c / kStages) & 1) ^ 1;
          sm90::bar_wait(k_free + s, free_ph);
          sm90::bar_arrive_tx(k_full + s, kBK16 * HD * 2);
          sm90::tma_load_tile<HD, kBK16>(sm + S::kK + s * S::kKV, &tm_k, k_full + s, hk,
                                         t * kBK16, it.b);
          sm90::bar_wait(v_free + s, free_ph);
          sm90::bar_arrive_tx(v_full + s, kBK16 * HD * 2);
          sm90::tma_load_tile<HD, kBK16>(sm + S::kV + s * S::kKV, &tm_v, v_full + s, hk,
                                         t * kBK16, it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each tile
    sm90::regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t base = sm90::smem_addr(sm);
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(bar);
    };
    float sc[4 * NS];                              // S, then P, of rows r0, r0 + 8
    float acc[HD / 2];                             // O of rows r0, r0 + 8
    uint32_t pa[PK][4];                            // P in bf16, the A operand of P.V
    int c = 0;                                     // K/V tiles consumed so far

    for (int n = 0; number(n) < n_items; ++n) {
      const Item itm = item(number(n));
      const int h = itm.h, b = itm.b, q0 = itm.q0, n_tiles = itm.n_tiles;
      const int w0 = q0 + 64 * wg;
      const int w_end = ctx + min(w0 + 64, l);     // this group's own causal frontier
      // the tiles it computes: a prefix of the block's, and one (tile 0, on
      // zero rows, storing nothing) for a group whose rows all lie past l,
      // so that no product sits on a path the compiler sees as divergent
      auto tiles_of = [&](int first_row, int end) {
        return first_row < l ? min((end + kBK16 - 1) / kBK16, n_tiles) : 1;
      };
      const int n_w = tiles_of(w0, w_end);
      // Ping-pong: where both groups walk as many tiles, they take turns to
      // issue their products (named barriers 1 and 2, one per group), so
      // one group's softmax runs under the other's products instead of
      // beside it.  Group 0 goes first; every turn but group 1's last passes.
      const int w0_other = q0 + 64 * (1 - wg);
      const bool pingpong = n_w == tiles_of(w0_other, ctx + min(w0_other + 64, l));
      auto turn_wait = [&] {
        if (pingpong) sm90::named_sync(1 + wg, 256);
      };
      auto turn_pass = [&] {
        if (pingpong) sm90::named_arrive(2 - wg, 256);
      };
      const int r0 = w0 + 16 * warp + g;           // this thread's rows: r0 and r0 + 8
      // S_t = Q.K_t^T, both operands K-major in shared memory
      auto issue_s = [&](int t) {
        const uint32_t k_base = base + S::kK + ((c + t) % kStages) * S::kKV;
        sm90::Wgmma<kBK16>::ss0(sc, sm90::desc_k<HD, kBQ16>(base, 64 * wg, 0),
                                sm90::desc_k<HD, kBK16>(k_base, 0, 0));
#pragma unroll
        for (int kk = 1; kk < KT; ++kk)
          sm90::Wgmma<kBK16>::ss(sc, sm90::desc_k<HD, kBQ16>(base, 64 * wg, kk),
                                 sm90::desc_k<HD, kBK16>(k_base, 0, kk), 1);
        sm90::wgmma_commit();
      };
      // O += P.V_t: P in bf16 from registers, V MN-major
      auto issue_pv = [&](int t) {
        const int st = (c + t) % kStages;
        sm90::bar_wait(v_full + st, ((c + t) / kStages) & 1);
#pragma unroll
        for (int kk = 0; kk < PK; ++kk)
          sm90::Wgmma<HD>::rs(acc, pa[kk], sm90::desc_mn<HD, kBK16>(base + S::kV + st * S::kKV, kk),
                              1);
        sm90::wgmma_commit();
      };
      // -inf where a key is past a row's frontier or the row at and past l,
      // only in tiles that cross the diagonal of this group's rows or hold
      // such rows
      auto mask = [&](int t) {
        const int t0 = t * kBK16;
        if (t0 + kBK16 - 1 > ctx + w0 || w0 + 64 > l) {
#pragma unroll
          for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = r0 + (e >> 1) * 8;
              const int kpos = t0 + j * 8 + 2 * t4 + (e & 1);
              if (!(row < l && kpos <= ctx + row)) sc[4 * j + e] = -INFINITY;
            }
          }
        }
      };

#pragma unroll
      for (int k = 0; k < HD / 2; ++k) acc[k] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};         // running max, raw score units
      float s[2] = {0.f, 0.f};                     // this lane's part of the denominators
      float alpha[2];

      if (wg == 1) turn_pass();
      sm90::bar_wait(q_full, n & 1);
      sm90::bar_wait(k_full + c % kStages, (c / kStages) & 1);
      turn_wait();
      sm90::wgmma_fence();
      issue_s(0);
      turn_pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      release(k_free + c % kStages);
      mask(0);
      online_softmax<NS>(sc, m, s, alpha, scale_log2);
#pragma unroll
      for (int kk = 0; kk < PK; ++kk) sm90::pack_a(pa[kk], sc + 8 * kk);
      for (int t = 1; t < n_w; ++t) {
        // S_t, then O += P_(t-1).V_(t-1), whose product runs under this
        // tile's softmax
        sm90::bar_wait(k_full + (c + t) % kStages, ((c + t) / kStages) & 1);
        turn_wait();
        sm90::wgmma_fence();
        issue_s(t);
        issue_pv(t - 1);
        turn_pass();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(sc);
        release(k_free + (c + t) % kStages);
        mask(t);
        online_softmax<NS>(sc, m, s, alpha, scale_log2);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(pa);
        release(v_free + (c + t - 1) % kStages);
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          acc[4 * k] *= alpha[0];
          acc[4 * k + 1] *= alpha[0];
          acc[4 * k + 2] *= alpha[1];
          acc[4 * k + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < PK; ++kk) sm90::pack_a(pa[kk], sc + 8 * kk);
      }
      release(q_free);                             // every S of this tile is done
      turn_wait();                                 // O += P.V of the last tile
      sm90::wgmma_fence();
      issue_pv(n_w - 1);
      if (wg == 0) turn_pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(pa);
      release(v_free + (c + n_w - 1) % kStages);
      for (int t = n_w; t < n_tiles; ++t) {        // tiles past this group's frontier
        const int st = (c + t) % kStages;
        const uint32_t ph = ((c + t) / kStages) & 1;
        sm90::bar_wait(k_full + st, ph);
        release(k_free + st);
        sm90::bar_wait(v_full + st, ph);
        release(v_free + st);
      }
      c += n_tiles;

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float den = fmaxf(sm90::quad_sum(s[r]), 1e-30f);
        const int row = r0 + 8 * r;
        if (row >= l) continue;
        const float inv = 1.f / den;
        bf16* orow = o + b * o_sb + row * o_ss + int64_t(h) * HD + 2 * t4;
#pragma unroll
        for (int k = 0; k < NO; ++k)
          *reinterpret_cast<uint32_t*>(orow + k * 8) =
              sm90::pack_bf16x2(acc[4 * k + 2 * r] * inv, acc[4 * k + 2 * r + 1] * inv);
        if (t4 == 0)
          lse[(int64_t(b) * n_heads + h) * l + row] = m[r] * scale_log2 * kLn2 + logf(den);
      }
    }
  }
}

// ------------------------------------------------------------- f32, SIMT
constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile (lane j <-> key j)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;     // query rows per warp

template <int HD>
constexpr size_t smem_bytes() { return size_t(kBQ + 2 * kBK) * (HD + 4) * sizeof(float); }

template <int HD>
__global__ void __launch_bounds__(kThreads)
fwd_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int l, int n_heads, int rep, int ctx, int64_t q_sb, int64_t q_ss,
               int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t o_sb,
               int64_t o_ss, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NDL = (HD + 31) / 32;   // output dims per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = iq * kBQ;
  const int kv_end = ctx + min(q0 + kBQ, l);   // causal frontier of this q tile

  const float* qb = q + b * q_sb + int64_t(h) * HD;
  const float* kb = k + b * k_sb + int64_t(h / rep) * HD;
  const float* vb = v + b * v_sb + int64_t(h / rep) * HD;

  // Q tile; rows past l are zero and never stored
  for (int idx = tid; idx < kBQ * (HD / 4); idx += kThreads) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < l) x = load4(qb + (q0 + r) * q_ss + c);
    *reinterpret_cast<float4*>(Qs + r * LD + c) = x;
  }

  const int row0 = warp * kRows;
  float m[kRows], s[kRows], acc[kRows][NDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NDL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = 0; t0 < kv_end; t0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and Q is staged)
    // a compile-time trip count, unrolled: all of a thread's loads in flight
    static_assert(kBK * (HD / 4) % kThreads == 0, "tile loads divide evenly");
#pragma unroll
    for (int it = 0; it < kBK * (HD / 4) / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int j = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (t0 + j < kv_end) {
        kx = load4(kb + (t0 + j) * k_ss + c);
        vx = load4(vb + (t0 + j) * v_ss + c);
      }
      *reinterpret_cast<float4*>(Ks + j * LD + c) = kx;
      *reinterpret_cast<float4*>(Vs + j * LD + c) = vx;
    }
    __syncthreads();

    // scores: lane j holds key t0 + j for each of the warp's rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.f;
    const float* krow = Ks + lane * LD;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        sc[r] += dot4(*reinterpret_cast<const float4*>(Qs + (row0 + r) * LD + c), kk);
    }

    // online softmax, one row at a time; p[r] is this lane's probability
    const int kpos = t0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = ctx + q0 + row0 + r;
      const bool ok = kpos <= qpos && kpos < kv_end;
      const float x = ok ? sc[r] * scale : -INFINITY;   // q.k, then 1/sqrt(hd)
      const float m_new = fmaxf(m[r], warp_max(x));
      p[r] = ok ? expf(x - m_new) : 0.f;
      const float alpha = rescale(m[r], m_new);
      s[r] = s[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NDL; ++i) acc[r][i] *= alpha;
    }

    // PV: each lane accumulates its own output dims over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[NDL];
#pragma unroll
      for (int i = 0; i < NDL; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < HD ? Vs[j * LD + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(kFullMask, p[r], j);
#pragma unroll
        for (int i = 0; i < NDL; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    if (row >= l) continue;
    const float den = fmaxf(s[r], 1e-30f);
    float* orow = o + b * o_sb + row * o_ss + int64_t(h) * HD;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store1(orow + d, acc[r][i] / den);
    }
    if (lane == 0) lse[(int64_t(b) * n_heads + h) * l + row] = m[r] + logf(den);
  }
}

// ---------------------------------------------------------------- launch
template <typename Kern>
cudaError_t opt_in(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                        int B, int l, int Hq, int Hkv, int ctx, const long long* st,
                        cudaStream_t stream) {
  // K and V end at ctx + l for TMA: the stale tail past it reads as zeros
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = sm90::make_map<HD>(&tm_q, q, B, l, Hq, st[0], st[1], kBQ16);
  if (err == cudaSuccess) err = sm90::make_map<HD>(&tm_k, k, B, ctx + l, Hkv, st[2], st[3], kBK16);
  if (err == cudaSuccess) err = sm90::make_map<HD>(&tm_v, v, B, ctx + l, Hkv, st[4], st[5], kBK16);
  if (err != cudaSuccess) return err;
  auto kern = fwd_kernel_bf16<HD>;
  const size_t smem = FwdSmem<HD>::kBytes;
  err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  // one block per SM at most, each walking its share of the q tiles
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int items = (l + kBQ16 - 1) / kBQ16 * Hq * B;
  kern<<<min(items, sms), kWsThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), l, Hq, Hq / Hkv, ctx, B,
      st[6], st[7], rsqrtf(float(HD)) * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                       int B, int l, int Hq, int Hkv, int ctx, const long long* st,
                       cudaStream_t stream) {
  auto kern = fwd_kernel_f32<HD>;
  const size_t smem = smem_bytes<HD>();
  const cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((l + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse), l, Hq,
      Hq / Hkv, ctx, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      rsqrtf(float(HD)));
  return cudaGetLastError();
}

// bf16 -> the tensor-core kernel, f32 -> the SIMT kernel; nothing else.
cudaError_t dispatch(bool is_bf16, int hd, const void* q, const void* k, const void* v,
                     void* o, void* lse, int B, int l, int Hq, int Hkv, int ctx,
                     const long long* st, cudaStream_t stream) {
  switch (hd) {
#define CASE(HD)                                                                   \
    case HD:                                                                       \
      return is_bf16 ? launch_bf16<HD>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream) \
                     : launch_f32<HD>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
    CASE(16) CASE(32) CASE(64) CASE(96) CASE(128) CASE(160)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: q/k/v/o batch and sequence strides (the head and
// feature dims are dense).  Returns cudaGetLastError() after the launch.
extern "C" int terapipe_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int l,
    int Hq, int Hkv, int hd, int ctx, int is_bf16, long long q_sb, long long q_ss,
    long long k_sb, long long k_ss, long long v_sb, long long v_ss, long long o_sb,
    long long o_ss, void* stream) {
  const long long st[8] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss};
  return int(dispatch(is_bf16 != 0, hd, q, k, v, o, lse, B, l, Hq, Hkv, ctx, st,
                      static_cast<cudaStream_t>(stream)));
}
