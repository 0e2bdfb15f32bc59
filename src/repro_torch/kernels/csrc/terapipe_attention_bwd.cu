// Flash-attention backward of a query slice at context offset ctx, for Hopper:
// two kernels, dQ and dK/dV, that rebuild the probabilities tile by tile from
// the forward's lse and never hold an (l, ctx+l) matrix in device memory.
//
// Replaces the TPU kernels repro/kernels/terapipe_attention_bwd.py::_dq_kernel
// and ::_dkv_kernel (launched by terapipe_attention_bwd).  Same function:
// q, dO (B, l, Hq, hd) at absolute positions ctx..ctx+l-1; k, v
// (B, Sk, Hkv, hd) with Sk >= ctx + l; lse, delta (B, Hq, l) f32, where
// delta = rowsum(dO * O).  Key kv is seen by query row i iff kv <= ctx + i
// and kv < ctx + l; GQA kv head = hq / rep.  With P = exp(scale*Q.K^T - lse)
// under that mask and dS = P * (dO.V^T - delta):
//   dQ = scale * dS.K,   dK = scale * dS^T.Q,   dV = P^T.dO,
// dK and dV summed over the rep query heads of each kv head and written in the
// (B, Sk, Hkv, hd) layout; keys at and past ctx + l get exactly zero.
//
// What bounds it on the H100: arithmetic.  Per unmasked (query, key) pair
// and head, dQ does 6*hd FLOPs (Q.K, dO.V, dS.K) and dK/dV 8*hd (Q.K, dO.V,
// P^T.dO, dS^T.Q), against O((l + Sk)*H*hd) bytes: far above the ridge point
// at training lengths.  Neither kernel has a sequential grid: where the TPU
// kernels carry their accumulators in VMEM scratch across the innermost grid
// axis, here one block owns one output tile and loops over the other axis
// itself.  Each output element is written once by one block: no atomics, so
// the result is deterministic.  The first q tile that reaches a kv tile is
// max(k0 - ctx, 0) / BQ: clamped at 0 before the division, since C truncates
// toward zero where the TPU code floors.  ctx is a runtime argument, so one
// build serves every offset.
//
// dq_kernel_bf16 and dkv_kernel_bf16 (bf16 inputs): warp-specialised
// sm_90a kernels, every product a wgmma on bf16 operands with f32
// accumulators, fed by TMA through mbarrier rings (sm90.cuh).  Masked
// probabilities are selected as 0, never multiplied: 0 * NaN is NaN in a
// product, and the tiles are zero-filled past l and past the keys'
// frontier, so no stale shared memory meets a 0.  Rounding P^T and dS to
// bf16 (dS^T to a bf16 pair) are the numerical changes from the f32 SIMT
// kernels.  Both are persistent: at most one block per SM, each walking its
// share of the numbered work units, dealt out in a zigzag (pass k of block
// x takes number k * grid + x, or k * grid + grid - 1 - x on odd passes), so
// every block's share is about the same.  A block has two consumer
// warpgroups and one producer warpgroup, of which one warp works;
// setmaxnreg hands the producer's registers to the consumers (24 / 240).
//
// dq_kernel_bf16: the forward's tiling (terapipe_attention_fwd.cu), with
// P.V replaced by two products.
//  * units are (b, hq, 128-row q tile), numbered longest causal frontier
//    first; warpgroup w owns the tile's rows 64w .. 64w + 63;
//  * the producer loads a unit's Q and dO once by TMA (their maps end at l),
//    the next unit's under this one's last dS.K product and stores, and
//    64-key K and V tiles (32 at hd 160) through a three-stage ring with
//    "full" and "empty" mbarriers; K and V end at ctx + l in their maps, so
//    the stale tail reads as zeros.  The ring stops at the tile's frontier
//    ctx + min(q0 + 128, l), and each warpgroup at its own 64 rows';
//  * lse (in log2 units) and delta of a thread's two rows sit in registers;
//  * per K/V tile: S = Q.K^T and dP = dO.V^T (both operands K-major in
//    shared memory); P = exp2(S*scale*log2e - lse*log2e), masked only in
//    tiles that cross the diagonal or hold rows at and past l; dS = P * (dP
//    - delta) in f32, rounded to bf16 once; dQ += dS.K with dS the register
//    A operand and K read MN-major.  One rounding is enough here: K is not
//    scaled, so no large rows cancel as Q's do in dK.  V is freed once dP is
//    done, K once dS.K is;
//  * S and dP of tile j + 1 are issued before dQ += dS.K of tile j, so that
//    product runs under the next tile's exponentials (dQ 64, S and dP 32
//    each, dS 16 packed: ~150 of a thread's 240 registers at hd 128);
//    where both groups walk as many tiles they take turns to issue
//    (ping-pong, named barriers 1 and 2), as the forward does;
//  * dQ is scaled once, at the end, and stored from registers; rows at and
//    past l are never written.  It issues exactly the bound's 6*hd FLOPs a
//    pair, so 100% of the bound is its ceiling.
//
// dkv_kernel_bf16:
//  * units are (b, hkv, 128-key tile), numbered key tile first (the low
//    tiles, which walk the most query rows, first); warpgroup w owns the
//    unit's keys 64w .. 64w + 63.  A unit walks the rep query heads of its group
//    and, for each, the q tiles from the first one that reaches the key
//    tile; a warpgroup skips the tiles that do not reach its own 64 keys.
//    A unit wholly past ctx + l only writes zeros;
//  * a unit's K and V are loaded once by TMA (the next unit's under this
//    one's stores); 64-row Q and dO tiles (32 at hd 160)
//    arrive by TMA through a two-stage mbarrier ring, their lse (log2
//    units) and delta staged by the producer warp's 32 lanes beside them.
//    Both consumer warpgroups read each Q/dO tile as the B operand.  K and V
//    end at ctx + l in their tensor maps, Q and dO at l: TMA fills zeros;
//  * dK and dV accumulate in f32 registers (hd / 2 + hd / 2 a thread)
//    beside S^T and dP^T (BQ / 2 each);
//  * the two groups take turns to issue their products (ping-pong, two
//    named barriers; two turns an item, taken by both groups for every
//    item), so one group's exponentials run under the other's products;
//  * keys are the M dimension of every product: S^T = K.Q^T, then
//    dP^T = V.dO^T (both operands K-major in shared memory), whose product
//    runs under P^T = exp2(scale*log2e*S^T - lse[col]) (masked only in tiles
//    that cross the diagonal of the group's keys or hold rows at and past
//    l); dS^T = P^T * (dP^T - delta[col]) in f32; dV += bf16(P^T).dO and
//    dK += dS^T.Q with the A operands from registers, dO and Q MN-major.
//    dS^T goes in as a sum of two bf16 parts, hi + lo (two products): a
//    single bf16 rounding of dS^T lost to cancellation across large q rows
//    (logits x30).  So the kernel issues 10*hd FLOPs a pair against the
//    bound's 8*hd: 80% of the bound is its ceiling.  dK is scaled once, at
//    the end, and written with dV by the one warpgroup that owns the keys.
// The tile walks of dq_kernel_bf16 (tile_walk.dq_walk) and dkv_kernel_bf16
// (tile_walk.dkv_walk) are stated in Python in kernels/tile_walk.py.
//
// dq_kernel_f32 and dkv_kernel_f32 (f32 inputs): f32 SIMT FMAs out of
// shared memory; the tensor cores have no f32 product of f32 accuracy:
//  * dQ: one block per (b, hq, 32-row q tile), walking 32-key K/V tiles up
//    to the tile's causal frontier ctx + min(q0 + 32, l); dK/dV: one block
//    per (b, hkv, 32-key kv tile), walking the rep query heads of its group
//    and, for each, the q tiles from the first one whose frontier reaches
//    the kv tile.  Tiles past a frontier are neither loaded nor computed;
//  * tiles are staged once in shared memory as f32 (rows padded by 4 floats,
//    so the lane-per-row float4 reads are free of bank conflicts) and
//    reused by all 32 rows of the other operand; at hd 160 the four tiles
//    take 84 KB, opted in above 48 KB;
//  * each warp owns 8 rows of the block's own tile (q rows for dQ, keys for
//    dK/dV); lane j holds the score of the other tile's row j, and for the
//    accumulating products each lane owns the dims d = lane + 32*i, with the
//    per-pair P or dS broadcast by shuffle.
#include "common.cuh"
#include "sm90.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

// ------------------------------------------------- shared by dQ and dK/dV
constexpr int kWsThreads = 384;         // consumer warpgroups 0 and 1, the producer's 2
constexpr int kProducerRegs = 24;       // setmaxnreg: 24 x 128 + 240 x 256 = 384 x 168
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// --------------------------------------------------- bf16 dQ, wgmma + TMA
constexpr int kDqBQ = 128;              // query rows per unit: two consumer warpgroups of 64
constexpr int kDqStages = 3;            // K/V tiles in flight

// keys per streamed K/V tile (tile_walk.dq_bk): 64, and 32 at hd 160, where
// the dQ accumulator (hd / 2 f32 registers a thread) leaves less room for S
// and dP
template <int HD>
constexpr int kDqBK = HD <= 128 ? 64 : 32;

// Shared memory: Q and dO (128 rows), K[stage] and V[stage] (BK rows), then
// the barriers; every tile in HeadLayout<HD>'s swizzled sub-tiles.
template <int HD>
struct DqSmem {
  using L = sm90::HeadLayout<HD>;
  static constexpr int BK = kDqBK<HD>;
  static constexpr int kQt = L::template tile_bytes<kDqBQ>();
  static constexpr int kKV = L::template tile_bytes<BK>();
  static constexpr int kDo = kQt;
  static constexpr int kK = 2 * kQt;
  static constexpr int kV = kK + kDqStages * kKV;
  static constexpr int kBars = kV + kDqStages * kKV;
  static constexpr size_t kBytes = kBars + 8 * (2 + 4 * kDqStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
dq_kernel_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dq, int l, int n_heads, int rep, int ctx, int batch,
               int64_t dq_sb, int64_t dq_ss, float scale, float scale_log2) {
  using S = DqSmem<HD>;
  constexpr int BK = S::BK;
  constexpr int KT = HD / 16;           // k-steps of Q.K^T and dO.V^T
  constexpr int NS = BK / 8;            // column groups of S and dP (8 keys each)
  constexpr int NO = HD / 8;            // column groups of dQ (8 dims each)
  constexpr int PK = BK / 16;           // k-steps of dS.K
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::smem_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + S::kBars);   // Q and dO have landed
  uint64_t* q_free = q_full + 1;          // all 8 consumer warps are done with Q and dO
  uint64_t* k_full = q_free + 1;          // [stage]: the K tile has landed
  uint64_t* v_full = k_full + kDqStages;  // [stage]: the V tile has landed
  uint64_t* k_free = v_full + kDqStages;  // [stage]: all 8 consumer warps are done with K
  uint64_t* v_free = k_free + kDqStages;  // [stage]: ... with V

  // Persistent, as the forward: the (b, hq, 128-row q tile) units are
  // numbered longest causal frontier first, and pass k of block x takes
  // number k * grid + x, or k * grid + grid - 1 - x on odd passes (a
  // zigzag); the ring's stages and phases run on across a block's units.
  const int nq = (l + kDqBQ - 1) / kDqBQ;
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
    const int q0 = iq * kDqBQ;
    const int kv_end = ctx + min(q0 + kDqBQ, l);   // causal frontier of this q tile
    return Item{i % per_q % n_heads, i % per_q / n_heads, q0, (kv_end + BK - 1) / BK};
  };
  // the warpgroup, broadcast from lane 0 so the compiler sees it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    sm90::bar_init(q_full, 1);
    sm90::bar_init(q_free, 8);
    for (int s = 0; s < kDqStages; ++s) {
      sm90::bar_init(k_full + s, 1);
      sm90::bar_init(v_full + s, 1);
      sm90::bar_init(k_free + s, 8);
      sm90::bar_init(v_free + s, 8);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the Q/dO buffer and the K/V ring full; the
    // rest of the group idles
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      int c = 0;                                   // K/V tiles loaded so far
      for (int n = 0; number(n) < n_items; ++n) {
        const Item it = item(number(n));
        const int hk = it.h / rep;
        sm90::bar_wait(q_free, (n & 1) ^ 1);
        sm90::bar_arrive_tx(q_full, 2 * kDqBQ * HD * 2);
        sm90::tma_load_tile<HD, kDqBQ>(sm, &tm_q, q_full, it.h, it.q0, it.b);
        sm90::tma_load_tile<HD, kDqBQ>(sm + S::kDo, &tm_do, q_full, it.h, it.q0, it.b);
        for (int t = 0; t < it.n_tiles; ++t, ++c) {
          const int s = c % kDqStages;
          const uint32_t free_ph = ((c / kDqStages) & 1) ^ 1;
          sm90::bar_wait(k_free + s, free_ph);
          sm90::bar_arrive_tx(k_full + s, BK * HD * 2);
          sm90::tma_load_tile<HD, BK>(sm + S::kK + s * S::kKV, &tm_k, k_full + s, hk, t * BK,
                                      it.b);
          sm90::bar_wait(v_free + s, free_ph);
          sm90::bar_arrive_tx(v_full + s, BK * HD * 2);
          sm90::tma_load_tile<HD, BK>(sm + S::kV + s * S::kKV, &tm_v, v_full + s, hk, t * BK,
                                      it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 of each unit
    sm90::regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t base = sm90::smem_addr(sm);
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) sm90::bar_arrive(bar);
    };
    float sc[4 * NS];                              // S, then dS, of rows r0, r0 + 8
    float dp[4 * NS];                              // dP
    float acc[HD / 2];                             // dQ of rows r0, r0 + 8
    uint32_t dsa[PK][4];                           // dS in bf16, the A operand of dS.K
    int c = 0;                                     // K/V tiles consumed so far

    for (int n = 0; number(n) < n_items; ++n) {
      const Item itm = item(number(n));
      const int h = itm.h, b = itm.b, q0 = itm.q0, n_tiles = itm.n_tiles;
      const int w0 = q0 + 64 * wg;
      const int w_end = ctx + min(w0 + 64, l);     // this group's own causal frontier
      // the tiles it computes: a prefix of the unit's, and one (tile 0, on
      // zero rows, storing nothing) for a group whose rows all lie past l,
      // so that no product sits on a path the compiler sees as divergent
      auto tiles_of = [&](int first_row, int end) {
        return first_row < l ? min((end + BK - 1) / BK, n_tiles) : 1;
      };
      const int n_w = tiles_of(w0, w_end);
      // Ping-pong, as the forward: where both groups walk as many tiles,
      // they take turns to issue their products (named barriers 1 and 2),
      // so one group's exponentials run under the other's products.
      const int w0_other = q0 + 64 * (1 - wg);
      const bool pingpong = n_w == tiles_of(w0_other, ctx + min(w0_other + 64, l));
      auto turn_wait = [&] {
        if (pingpong) sm90::named_sync(1 + wg, 256);
      };
      auto turn_pass = [&] {
        if (pingpong) sm90::named_arrive(2 - wg, 256);
      };
      const int r0 = w0 + 16 * warp + g;           // this thread's rows: r0 and r0 + 8
      // lse (in log2 units) and delta of rows r0 and r0 + 8; 0 for rows at
      // and past l, which the mask covers
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const int64_t at = (int64_t(b) * n_heads + h) * l + row;
        lse2[r] = row < l ? lse[at] * kLog2e : 0.f;
        dl[r] = row < l ? delta[at] : 0.f;
      }
      // S_t = Q.K_t^T and dP_t = dO.V_t^T, all operands K-major in shared
      // memory, one commit group
      auto issue_sdp = [&](int t) {
        const int st = (c + t) % kDqStages;
        const uint32_t k_base = base + S::kK + st * S::kKV;
        const uint32_t v_base = base + S::kV + st * S::kKV;
        sm90::Wgmma<BK>::ss0(sc, sm90::desc_k<HD, kDqBQ>(base, 64 * wg, 0),
                             sm90::desc_k<HD, BK>(k_base, 0, 0));
#pragma unroll
        for (int kk = 1; kk < KT; ++kk)
          sm90::Wgmma<BK>::ss(sc, sm90::desc_k<HD, kDqBQ>(base, 64 * wg, kk),
                              sm90::desc_k<HD, BK>(k_base, 0, kk), 1);
        sm90::Wgmma<BK>::ss0(dp, sm90::desc_k<HD, kDqBQ>(base + S::kDo, 64 * wg, 0),
                             sm90::desc_k<HD, BK>(v_base, 0, 0));
#pragma unroll
        for (int kk = 1; kk < KT; ++kk)
          sm90::Wgmma<BK>::ss(dp, sm90::desc_k<HD, kDqBQ>(base + S::kDo, 64 * wg, kk),
                              sm90::desc_k<HD, BK>(v_base, 0, kk), 1);
        sm90::wgmma_commit();
      };
      // dQ += dS_t.K_t: dS in bf16 from registers, K MN-major
      auto issue_dq = [&](int t) {
        const uint32_t k_base = base + S::kK + ((c + t) % kDqStages) * S::kKV;
#pragma unroll
        for (int kk = 0; kk < PK; ++kk)
          sm90::Wgmma<HD>::rs(acc, dsa[kk], sm90::desc_mn<HD, BK>(k_base, kk), 1);
        sm90::wgmma_commit();
      };
      // P = 2^(scale*log2e*S - lse*log2e), selected as 0 where a key is past
      // a row's frontier or the row at and past l (only in tiles that cross
      // the diagonal of this group's rows or hold such rows), then dS = P *
      // (dP - delta) in f32, in place of S
      auto grads = [&](int t) {
        const int t0 = t * BK;
        const bool edge = t0 + BK - 1 > ctx + w0 || w0 + 64 > l;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = sm90::ex2(fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]));
            if (edge) {
              const int row = r0 + (e >> 1) * 8;
              const int kpos = t0 + j * 8 + 2 * t4 + (e & 1);
              if (!(row < l && kpos <= ctx + row)) p = 0.f;
            }
            sc[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
          }
        }
      };
      // dS rounded to bf16 once: K is not scaled, so no large rows cancel
      // as Q's do in dK
      auto pack = [&] {
#pragma unroll
        for (int kk = 0; kk < PK; ++kk) sm90::pack_a(dsa[kk], sc + 8 * kk);
      };

#pragma unroll
      for (int k = 0; k < HD / 2; ++k) acc[k] = 0.f;

      if (wg == 1) turn_pass();
      sm90::bar_wait(q_full, n & 1);
      sm90::bar_wait(k_full + c % kDqStages, (c / kDqStages) & 1);
      sm90::bar_wait(v_full + c % kDqStages, (c / kDqStages) & 1);
      turn_wait();
      sm90::wgmma_fence();
      issue_sdp(0);
      turn_pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      release(v_free + c % kDqStages);
      grads(0);
      pack();
      for (int t = 1; t < n_w; ++t) {
        // S_t and dP_t, then dQ += dS_(t-1).K_(t-1), whose product runs
        // under this tile's exponentials
        const int st = (c + t) % kDqStages;
        const uint32_t ph = ((c + t) / kDqStages) & 1;
        sm90::bar_wait(k_full + st, ph);
        sm90::bar_wait(v_full + st, ph);
        turn_wait();
        sm90::wgmma_fence();
        issue_sdp(t);
        issue_dq(t - 1);
        turn_pass();
        sm90::wgmma_wait<1>();
        sm90::fence_regs(sc);
        sm90::fence_regs(dp);
        release(v_free + st);
        grads(t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::fence_regs(dsa);
        release(k_free + (c + t - 1) % kDqStages);
        pack();
      }
      release(q_free);                             // every S and dP of this unit is done
      turn_wait();                                 // dQ += dS.K of the last tile
      sm90::wgmma_fence();
      issue_dq(n_w - 1);
      if (wg == 0) turn_pass();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(dsa);
      release(k_free + (c + n_w - 1) % kDqStages);
      for (int t = n_w; t < n_tiles; ++t) {        // tiles past this group's frontier
        const int st = (c + t) % kDqStages;
        const uint32_t ph = ((c + t) / kDqStages) & 1;
        sm90::bar_wait(k_full + st, ph);
        release(k_free + st);
        sm90::bar_wait(v_full + st, ph);
        release(v_free + st);
      }
      c += n_tiles;

      // dQ scaled once, stored from registers; rows at and past l never written
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= l) continue;
        bf16* out = dq + b * dq_sb + row * dq_ss + int64_t(h) * HD + 2 * t4;
#pragma unroll
        for (int k = 0; k < NO; ++k)
          *reinterpret_cast<uint32_t*>(out + k * 8) =
              sm90::pack_bf16x2(acc[4 * k + 2 * r] * scale, acc[4 * k + 2 * r + 1] * scale);
      }
    }
  }
}

// ----------------------------------------------- bf16 dK/dV, wgmma + TMA
constexpr int kDkvBK = 128;             // keys per block: two consumer warpgroups of 64
constexpr int kStages = 2;              // Q/dO tiles in flight

// query rows per streamed Q/dO tile: 64, and 32 at hd 160, where the dK and
// dV accumulators (hd f32 registers a thread) leave less room for S^T and dP^T
template <int HD>
constexpr int kDkvBQ = HD <= 128 ? 64 : 32;

// Shared memory: K and V (128 rows), Q[stage] and dO[stage], lse (log2
// units) and delta [stage][BQ] f32, then the barriers.
template <int HD>
struct DkvSmem {
  using L = sm90::HeadLayout<HD>;
  static constexpr int BQ = kDkvBQ<HD>;
  static constexpr int kKV = L::template tile_bytes<kDkvBK>();
  static constexpr int kQt = L::template tile_bytes<BQ>();
  static constexpr int kV = kKV;
  static constexpr int kQ = 2 * kKV;
  static constexpr int kDo = kQ + kStages * kQt;
  static constexpr int kLse = kDo + kStages * kQt;
  static constexpr int kDelta = kLse + kStages * BQ * 4;
  static constexpr int kBars = kDelta + kStages * BQ * 4;
  static constexpr size_t kBytes = kBars + 8 * (2 + 2 * kStages) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kWsThreads, 1)
dkv_kernel_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const float* __restrict__ lse, const float* __restrict__ delta,
                bf16* __restrict__ dk, bf16* __restrict__ dv, int l, int sk, int n_heads,
                int rep, int ctx, int batch, int64_t dk_sb, int64_t dk_ss, int64_t dv_sb,
                int64_t dv_ss, float scale, float scale_log2) {
  using S = DkvSmem<HD>;
  constexpr int BQ = S::BQ;
  constexpr int KT = HD / 16;           // k-steps of K.Q^T and V.dO^T
  constexpr int NQ = BQ / 8;            // column groups of S^T (8 query rows each)
  constexpr int NO = HD / 8;            // column groups of dK and dV (8 dims each)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::smem_1024(smem_raw);
  float* lse_s = reinterpret_cast<float*>(sm + S::kLse);
  float* dl_s = reinterpret_cast<float*>(sm + S::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + S::kBars);
  uint64_t* kv_free = kv_full + 1;      // all 8 consumer warps are done with K and V
  uint64_t* full = kv_free + 1;         // [stage]: Q, dO (TMA) and lse, delta (32 lanes) are in
  uint64_t* empty = full + kStages;     // [stage]: all 8 consumer warps are done with it

  // Persistent: the (b, hkv, key tile) units are numbered key tile first,
  // so the low tiles, which walk the most query rows, come first; pass k of
  // block x takes number k * grid + x, or k * grid + grid - 1 - x on odd
  // passes (a zigzag, so every block's share is about the same).  A unit
  // whose keys all lie at and past ctx + l only writes zeros.
  const int valid_end = ctx + l;        // keys at and past it get zero
  const int n_kv = n_heads / rep;
  const int per_k = n_kv * batch;
  const int n_units = (sk + kDkvBK - 1) / kDkvBK * per_k;
  const int n_q_tiles = (l + BQ - 1) / BQ;
  auto number = [&](int k) {
    return k * int(gridDim.x) + ((k & 1) ? int(gridDim.x) - 1 - int(blockIdx.x) : int(blockIdx.x));
  };
  struct Unit {
    int hk, b, k0, iq_first, per_head;
  };
  auto unit = [&](int u) {
    const int k0 = u / per_k * kDkvBK;
    // the first q tile whose frontier ctx + min(q0 + BQ, l) passes k0 (k0 -
    // ctx is clamped at 0 before the division: C truncates toward zero)
    const int iq_first = max(k0 - ctx, 0) / BQ;
    return Unit{u % per_k % n_kv, u % per_k / n_kv, k0, iq_first, n_q_tiles - iq_first};
  };
  // the warpgroup, broadcast from lane 0 so the compiler sees it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, int(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    sm90::bar_init(kv_full, 1);
    sm90::bar_init(kv_free, 8);
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(full + s, 1 + 32);
      sm90::bar_init(empty + s, 8);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: warp 0 of the group streams each unit's K, V and items;
    // lane 0 issues TMA, all 32 lanes stage lse and delta
    sm90::regs_dec<kProducerRegs>();
    if (threadIdx.x < 256 + 32) {
      const int lane = threadIdx.x % 32;
      int c = 0, m = 0;                            // items streamed, units with work
      for (int n = 0; number(n) < n_units; ++n) {
        const Unit u = unit(number(n));
        if (u.k0 >= valid_end) continue;
        sm90::bar_wait(kv_free, (m++ & 1) ^ 1);
        if (lane == 0) {
          sm90::bar_arrive_tx(kv_full, 2 * kDkvBK * HD * 2);
          sm90::tma_load_tile<HD, kDkvBK>(sm, &tm_k, kv_full, u.hk, u.k0, u.b);
          sm90::tma_load_tile<HD, kDkvBK>(sm + S::kV, &tm_v, kv_full, u.hk, u.k0, u.b);
        }
        for (int it = 0; it < rep * u.per_head; ++it, ++c) {
          const int s = c % kStages;
          const int h = u.hk * rep + it / u.per_head;
          const int q0 = (u.iq_first + it % u.per_head) * BQ;
          sm90::bar_wait(empty + s, ((c / kStages) & 1) ^ 1);
          if (lane == 0) {
            sm90::bar_arrive_tx(full + s, 2 * BQ * HD * 2);
            sm90::tma_load_tile<HD, BQ>(sm + S::kQ + s * S::kQt, &tm_q, full + s, h, q0, u.b);
            sm90::tma_load_tile<HD, BQ>(sm + S::kDo + s * S::kQt, &tm_do, full + s, h, q0, u.b);
          }
          const int64_t at = (int64_t(u.b) * n_heads + h) * l + q0;
          for (int i = lane; i < BQ; i += 32) {
            const bool ok = q0 + i < l;   // pad rows: 0, masked below
            lse_s[s * BQ + i] = ok ? lse[at + i] * kLog2e : 0.f;
            dl_s[s * BQ + i] = ok ? delta[at + i] : 0.f;
          }
          sm90::bar_arrive(full + s);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 of each unit
    sm90::regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const uint32_t base = sm90::smem_addr(sm);
    // Ping-pong: the groups take turns to issue their products (named
    // barriers 1 and 2, one per group), two turns an item (S^T and dP^T,
    // then dV and dK), taken for every item, computed or not, so one
    // group's exponentials and dS^T run under the other's products.  Group
    // 0 goes first; every turn but group 1's last of a unit passes it on.
    auto turn_wait = [&] { sm90::named_sync(1 + wg, 256); };
    auto turn_pass = [&] { sm90::named_arrive(2 - wg, 256); };
    float dka[HD / 2], dva[HD / 2];              // dK, dV of keys key0, key0 + 8
    float st[BQ / 2], dpt[BQ / 2];               // S^T then P^T; dP^T then dS^T
    int c = 0, m = 0;                            // items consumed, units with work

    for (int n = 0; number(n) < n_units; ++n) {
      const Unit u = unit(number(n));
      const int hk = u.hk, b = u.b, iq_first = u.iq_first, per_head = u.per_head;
      const int kw0 = u.k0 + 64 * wg;
      const bool live = kw0 < valid_end;
      const int key0 = kw0 + 16 * warp + g;      // this thread's keys: key0 and key0 + 8
      if (u.k0 >= valid_end) {                   // a stale tail unit: zeros only
        for (int i = tid; i < 64 * HD / 2; i += 128) {
          const int key = kw0 + i / (HD / 2), col = 2 * (i % (HD / 2));
          if (key >= sk) break;
          *reinterpret_cast<uint32_t*>(dk + b * dk_sb + key * dk_ss + int64_t(hk) * HD + col) = 0u;
          *reinterpret_cast<uint32_t*>(dv + b * dv_sb + key * dv_ss + int64_t(hk) * HD + col) = 0u;
        }
        continue;
      }
      const int n_items = rep * per_head;        // (query head, q tile) pairs, in order
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
      if (wg == 1) turn_pass();
      sm90::bar_wait(kv_full, m & 1);
      for (int it = 0; it < n_items; ++it, ++c) {
        const int s = c % kStages;
        const int q0 = (iq_first + it % per_head) * BQ;
        const uint32_t q_base = base + S::kQ + s * S::kQt;
        const uint32_t do_base = base + S::kDo + s * S::kQt;
        sm90::bar_wait(full + s, (c / kStages) & 1);
        const bool last = it == n_items - 1;
        if (live && kw0 < ctx + min(q0 + BQ, l)) {  // some row of the tile sees these keys
          // S^T = K.Q^T, then dP^T = V.dO^T (all operands K-major in shared
          // memory), whose product runs under the exponentials of P^T
          turn_wait();
          sm90::wgmma_fence();
          sm90::Wgmma<BQ>::ss0(st, sm90::desc_k<HD, kDkvBK>(base, 64 * wg, 0),
                               sm90::desc_k<HD, BQ>(q_base, 0, 0));
#pragma unroll
          for (int kk = 1; kk < KT; ++kk)
            sm90::Wgmma<BQ>::ss(st, sm90::desc_k<HD, kDkvBK>(base, 64 * wg, kk),
                                sm90::desc_k<HD, BQ>(q_base, 0, kk), 1);
          sm90::wgmma_commit();
          sm90::Wgmma<BQ>::ss0(dpt, sm90::desc_k<HD, kDkvBK>(base + S::kV, 64 * wg, 0),
                               sm90::desc_k<HD, BQ>(do_base, 0, 0));
#pragma unroll
          for (int kk = 1; kk < KT; ++kk)
            sm90::Wgmma<BQ>::ss(dpt, sm90::desc_k<HD, kDkvBK>(base + S::kV, 64 * wg, kk),
                                sm90::desc_k<HD, BQ>(do_base, 0, kk), 1);
          sm90::wgmma_commit();
          turn_pass();
          sm90::wgmma_wait<1>();
          sm90::fence_regs(st);

          // P^T = exp(scale*S^T - lse[col]), masked only where the tile crosses
          // the diagonal of this warpgroup's keys or holds rows at and past l
          const bool edge = kw0 + 63 > ctx + q0 || q0 + BQ > l;
          const float* lse_t = lse_s + s * BQ;
          const float* dl_t = dl_s + s * BQ;
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int col = j * 8 + 2 * t4;
            const float2 lc = *reinterpret_cast<const float2*>(lse_t + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = sm90::ex2(fmaf(st[4 * j + e], scale_log2, -((e & 1) ? lc.y : lc.x)));
              if (edge) {
                const int key = key0 + (e >> 1) * 8;
                const int row = q0 + col + (e & 1);
                if (!(row < l && key <= ctx + row)) p = 0.f;
              }
              st[4 * j + e] = p;
            }
          }
          // dS^T = P^T * (dP^T - delta[col]), in f32
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dpt);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const float2 dc = *reinterpret_cast<const float2*>(dl_t + j * 8 + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dc.y : dc.x));
          }

          // dV += bf16(P^T).dO and dK += (hi + lo)(dS^T).Q: A from registers,
          // dO and Q MN-major; one bf16 rounding of dS^T is not enough where
          // large q rows cancel in the sum
          uint32_t pa[BQ / 16][4], dsh[BQ / 16][4], dsl[BQ / 16][4];
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            sm90::pack_a(pa[kk], st + 8 * kk);
            sm90::pack_a_split(dsh[kk], dsl[kk], dpt + 8 * kk);
          }
          turn_wait();
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk)
            sm90::Wgmma<HD>::rs(dva, pa[kk], sm90::desc_mn<HD, BQ>(do_base, kk), 1);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            const uint64_t qd = sm90::desc_mn<HD, BQ>(q_base, kk);
            sm90::Wgmma<HD>::rs(dka, dsh[kk], qd, 1);
            sm90::Wgmma<HD>::rs(dka, dsl[kk], qd, 1);
          }
          sm90::wgmma_commit();
          if (!(last && wg == 1)) turn_pass();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(dva);
          sm90::fence_regs(dka);
          sm90::fence_regs(pa);
          sm90::fence_regs(dsh);
          sm90::fence_regs(dsl);
        } else {                                    // this item's two turns, unused
          turn_wait();
          turn_pass();
          turn_wait();
          if (!(last && wg == 1)) turn_pass();
        }
        __syncwarp();
        if (lane == 0) sm90::bar_arrive(empty + s);
      }
      __syncwarp();                              // every product of the unit is done
      if (lane == 0) sm90::bar_arrive(kv_free);
      ++m;

      // one writer per output element; keys at and past ctx + l hold exact
      // zeros (every pair with them was masked, or the group had no work)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key0 + 8 * r;
        if (key >= sk) continue;
        bf16* dk_row = dk + b * dk_sb + key * dk_ss + int64_t(hk) * HD + 2 * t4;
        bf16* dv_row = dv + b * dv_sb + key * dv_ss + int64_t(hk) * HD + 2 * t4;
#pragma unroll
        for (int k = 0; k < NO; ++k) {
          *reinterpret_cast<uint32_t*>(dk_row + k * 8) =
              sm90::pack_bf16x2(dka[4 * k + 2 * r] * scale, dka[4 * k + 2 * r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv_row + k * 8) =
              sm90::pack_bf16x2(dva[4 * k + 2 * r], dva[4 * k + 2 * r + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------- f32, SIMT
constexpr int kBQ = 32;                 // query rows per tile
constexpr int kBK = 32;                 // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32 / kWarps;      // rows of the block's own tile per warp

template <int HD>
constexpr size_t smem_bytes() {
  return size_t(2 * kBQ + 2 * kBK) * (HD + 4) * sizeof(float) + 2 * kBQ * sizeof(float);
}

// Stage 32 rows of a (.., rows, heads*hd) tensor, starting at `src`, into
// shared memory with row pitch HD + 4; rows at and past n_valid are zero.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int64_t row_stride,
                                      int n_valid, int tid) {
  constexpr int LD = HD + 4;
  static_assert(32 * (HD / 4) % kThreads == 0, "tile loads divide evenly");
#pragma unroll
  for (int it = 0; it < 32 * (HD / 4) / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// Dot products of the warp's 8 own rows (A, broadcast) with the row of B this
// lane holds, for two operand pairs at once: sa[r] = A1[r].B1[lane],
// sb[r] = A2[r].B2[lane].
template <int HD>
__device__ __forceinline__ void dots(const float* A1, const float* B1, const float* A2,
                                     const float* B2, int row0, int lane, float* sa,
                                     float* sb) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int r = 0; r < kRows; ++r) sa[r] = sb[r] = 0.f;
  const float* b1 = B1 + lane * LD;
  const float* b2 = B2 + lane * LD;
#pragma unroll 4
  for (int c = 0; c < HD; c += 4) {
    const float4 x1 = *reinterpret_cast<const float4*>(b1 + c);
    const float4 x2 = *reinterpret_cast<const float4*>(b2 + c);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      sa[r] += dot4(*reinterpret_cast<const float4*>(A1 + (row0 + r) * LD + c), x1);
      sb[r] += dot4(*reinterpret_cast<const float4*>(A2 + (row0 + r) * LD + c), x2);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int l, int n_heads, int rep, int ctx, int64_t q_sb,
              int64_t q_ss, int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss,
              int64_t do_sb, int64_t do_ss, int64_t dq_sb, int64_t dq_ss, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NDL = (HD + 31) / 32;   // output dims per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * LD;
  float* Ks = dOs + kBQ * LD;
  float* Vs = Ks + kBK * LD;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = iq * kBQ;
  const int kv_end = ctx + min(q0 + kBQ, l);   // causal frontier of this q tile

  stage<HD>(Qs, q + b * q_sb + q0 * q_ss + int64_t(h) * HD, q_ss, l - q0, tid);
  stage<HD>(dOs, dout + b * do_sb + q0 * do_ss + int64_t(h) * HD, do_ss, l - q0, tid);
  const float* kb = k + b * k_sb + int64_t(h / rep) * HD;
  const float* vb = v + b * v_sb + int64_t(h / rep) * HD;

  const int row0 = warp * kRows;
  float lse_r[kRows], dl_r[kRows], acc[kRows][NDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    const int64_t at = (int64_t(b) * n_heads + h) * l + row;
    lse_r[r] = row < l ? lse[at] : 0.f;
    dl_r[r] = row < l ? delta[at] : 0.f;
#pragma unroll
    for (int i = 0; i < NDL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = 0; t0 < kv_end; t0 += kBK) {
    __syncthreads();   // the previous tile is consumed (and Q, dO are staged)
    stage<HD>(Ks, kb + t0 * k_ss, k_ss, kv_end - t0, tid);
    stage<HD>(Vs, vb + t0 * v_ss, v_ss, kv_end - t0, tid);
    __syncthreads();

    // lane j <-> key t0 + j: s = q.k, dp = dO.v for each of the warp's rows
    float s[kRows], dp[kRows];
    dots<HD>(Qs, Ks, dOs, Vs, row0, lane, s, dp);
    const int kpos = t0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = q0 + row0 + r;
      const bool ok = row < l && kpos <= ctx + row;
      const float p = ok ? expf(s[r] * scale - lse_r[r]) : 0.f;
      ds[r] = p * (dp[r] - dl_r[r]);
    }

    // dQ += dS . K: each lane accumulates its own dims over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kj[NDL];
#pragma unroll
      for (int i = 0; i < NDL; ++i) {
        const int d = lane + 32 * i;
        kj[i] = d < HD ? Ks[j * LD + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(kFullMask, ds[r], j);
#pragma unroll
        for (int i = 0; i < NDL; ++i) acc[r][i] += dsj * kj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + row0 + r;
    if (row >= l) continue;
    float* out = dq + b * dq_sb + row * dq_ss + int64_t(h) * HD;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) out[d] = acc[r][i] * scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
dkv_kernel_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int l, int sk,
               int n_heads, int rep, int ctx, int64_t q_sb, int64_t q_ss, int64_t k_sb,
               int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t do_sb, int64_t do_ss,
               int64_t dk_sb, int64_t dk_ss, int64_t dv_sb, int64_t dv_ss, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NDL = (HD + 31) / 32;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * LD;
  float* Qs = Vs + kBK * LD;
  float* dOs = Qs + kBQ * LD;
  float* lse_s = dOs + kBQ * LD;
  float* dl_s = lse_s + kBQ;

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = ik * kBK;
  const int row0 = warp * kRows;
  const int valid_end = ctx + l;        // keys at and past it get zero

  float acc_k[kRows][NDL], acc_v[kRows][NDL];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < NDL; ++i) acc_k[r][i] = acc_v[r][i] = 0.f;

  if (k0 < valid_end) {
    stage<HD>(Ks, k + b * k_sb + k0 * k_ss + int64_t(hk) * HD, k_ss, valid_end - k0, tid);
    stage<HD>(Vs, v + b * v_sb + k0 * v_ss + int64_t(hk) * HD, v_ss, valid_end - k0, tid);
    // first q tile whose frontier ctx + min((iq+1)*32, l) passes k0
    const int iq_first = max(k0 - ctx, 0) / kBQ;
    const int n_qt = (l + kBQ - 1) / kBQ;
    for (int r = 0; r < rep; ++r) {
      const int h = hk * rep + r;
      const float* qh = q + b * q_sb + int64_t(h) * HD;
      const float* doh = dout + b * do_sb + int64_t(h) * HD;
      const int64_t row_at = (int64_t(b) * n_heads + h) * l;
      for (int iq = iq_first; iq < n_qt; ++iq) {
        const int q0 = iq * kBQ;
        __syncthreads();   // the previous q tile is consumed (and K, V are staged)
        stage<HD>(Qs, qh + q0 * q_ss, q_ss, l - q0, tid);
        stage<HD>(dOs, doh + q0 * do_ss, do_ss, l - q0, tid);
        if (tid < kBQ) {
          const bool in = q0 + tid < l;
          lse_s[tid] = in ? lse[row_at + q0 + tid] : 0.f;
          dl_s[tid] = in ? delta[row_at + q0 + tid] : 0.f;
        }
        __syncthreads();

        // lane i <-> query row q0 + i: s = k.q, dp = v.dO for the warp's keys
        float s[kRows], dp[kRows];
        dots<HD>(Ks, Qs, Vs, dOs, row0, lane, s, dp);
        const int qrow = q0 + lane;
        const bool q_ok = qrow < l;
        const float lse_i = lse_s[lane], dl_i = dl_s[lane];
        float p[kRows], ds[kRows];
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const int kpos = k0 + row0 + rr;
          const bool ok = q_ok && kpos <= ctx + qrow && kpos < valid_end;
          p[rr] = ok ? expf(s[rr] * scale - lse_i) : 0.f;
          ds[rr] = p[rr] * (dp[rr] - dl_i);
        }

        // dV += P^T . dO and dK += dS^T . Q over the tile's query rows
#pragma unroll 2
        for (int i = 0; i < kBQ; ++i) {
          float qi[NDL], doi[NDL];
#pragma unroll
          for (int t = 0; t < NDL; ++t) {
            const int d = lane + 32 * t;
            qi[t] = d < HD ? Qs[i * LD + d] : 0.f;
            doi[t] = d < HD ? dOs[i * LD + d] : 0.f;
          }
#pragma unroll
          for (int rr = 0; rr < kRows; ++rr) {
            const float pi = __shfl_sync(kFullMask, p[rr], i);
            const float dsi = __shfl_sync(kFullMask, ds[rr], i);
#pragma unroll
            for (int t = 0; t < NDL; ++t) {
              acc_v[rr][t] += pi * doi[t];
              acc_k[rr][t] += dsi * qi[t];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int key = k0 + row0 + rr;
    if (key >= sk) continue;
    float* dk_row = dk + b * dk_sb + key * dk_ss + int64_t(hk) * HD;
    float* dv_row = dv + b * dv_sb + key * dv_ss + int64_t(hk) * HD;
#pragma unroll
    for (int t = 0; t < NDL; ++t) {
      const int d = lane + 32 * t;
      if (d < HD) {
        store1(dk_row + d, acc_k[rr][t] * scale);
        store1(dv_row + d, acc_v[rr][t]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *o1, *o2;                  // dq (dQ) or dk, dv (dK/dV)
  int B, l, sk, Hq, Hkv, ctx;
  const long long* st;            // q, k, v, dO, out1[, out2] batch/seq strides
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t opt_in(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
}

template <int HD>
cudaError_t launch_dq_f32(const Args& a) {
  auto kern = dq_kernel_f32<HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  const long long* st = a.st;
  const dim3 grid((a.l + kBQ - 1) / kBQ, a.Hq, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.o1), a.l, a.Hq, a.Hq / a.Hkv, a.ctx, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], rsqrtf(float(HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dq_bf16(const Args& a) {
  // K and V end at ctx + l for TMA (the stale tail past it reads as zeros),
  // Q and dO at l
  using S = DqSmem<HD>;
  const long long* st = a.st;
  const int valid = a.ctx + a.l;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = sm90::make_map<HD>(&tm_q, a.q, a.B, a.l, a.Hq, st[0], st[1], kDqBQ);
  if (err == cudaSuccess)
    err = sm90::make_map<HD>(&tm_k, a.k, a.B, valid, a.Hkv, st[2], st[3], S::BK);
  if (err == cudaSuccess)
    err = sm90::make_map<HD>(&tm_v, a.v, a.B, valid, a.Hkv, st[4], st[5], S::BK);
  if (err == cudaSuccess)
    err = sm90::make_map<HD>(&tm_do, a.dout, a.B, a.l, a.Hq, st[6], st[7], kDqBQ);
  if (err != cudaSuccess) return err;
  auto kern = dq_kernel_bf16<HD>;
  err = opt_in(kern, S::kBytes);
  if (err != cudaSuccess) return err;
  // one block per SM at most, each walking its share of the q tiles
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int items = (a.l + kDqBQ - 1) / kDqBQ * a.Hq * a.B;
  kern<<<min(items, sms), kWsThreads, S::kBytes, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.o1), a.l, a.Hq, a.Hq / a.Hkv,
      a.ctx, a.B, st[8], st[9], rsqrtf(float(HD)), rsqrtf(float(HD)) * kLog2e);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_f32(const Args& a) {
  auto kern = dkv_kernel_f32<HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  const long long* st = a.st;
  const dim3 grid((a.sk + kBK - 1) / kBK, a.Hkv, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.o1), static_cast<float*>(a.o2), a.l, a.sk, a.Hq, a.Hq / a.Hkv,
      a.ctx, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], rsqrtf(float(HD)));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_dkv_bf16(const Args& a) {
  // K and V end at ctx + l for TMA: the stale tail past it reads as zeros
  constexpr int BQ = kDkvBQ<HD>;
  const long long* st = a.st;
  const int valid = a.ctx + a.l;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  cudaError_t err = sm90::make_map<HD>(&tm_q, a.q, a.B, a.l, a.Hq, st[0], st[1], BQ);
  if (err == cudaSuccess)
    err = sm90::make_map<HD>(&tm_k, a.k, a.B, valid, a.Hkv, st[2], st[3], kDkvBK);
  if (err == cudaSuccess)
    err = sm90::make_map<HD>(&tm_v, a.v, a.B, valid, a.Hkv, st[4], st[5], kDkvBK);
  if (err == cudaSuccess)
    err = sm90::make_map<HD>(&tm_do, a.dout, a.B, a.l, a.Hq, st[6], st[7], BQ);
  if (err != cudaSuccess) return err;
  auto kern = dkv_kernel_bf16<HD>;
  const size_t smem = DkvSmem<HD>::kBytes;
  err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  // one block per SM at most, each walking its share of the units
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const int units = (a.sk + kDkvBK - 1) / kDkvBK * a.Hkv * a.B;
  kern<<<min(units, sms), kWsThreads, smem, a.stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.o1), static_cast<bf16*>(a.o2),
      a.l, a.sk, a.Hq, a.Hq / a.Hkv, a.ctx, a.B, st[8], st[9], st[10], st[11],
      rsqrtf(float(HD)), rsqrtf(float(HD)) * kLog2e);
  return cudaGetLastError();
}

#define HEAD_DIMS(CASE) CASE(16) CASE(32) CASE(64) CASE(96) CASE(128) CASE(160)

// bf16 -> the tensor-core kernels, f32 -> the SIMT kernels; nothing else.
cudaError_t dispatch_dq(bool is_bf16, int hd, const Args& a) {
  switch (hd) {
#define CASE(HD) case HD: return is_bf16 ? launch_dq_bf16<HD>(a) : launch_dq_f32<HD>(a);
    HEAD_DIMS(CASE)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkv(bool is_bf16, int hd, const Args& a) {
  switch (hd) {
#define CASE(HD) case HD: return is_bf16 ? launch_dkv_bf16<HD>(a) : launch_dkv_f32<HD>(a);
    HEAD_DIMS(CASE)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}
#undef HEAD_DIMS

}  // namespace

// Strides are in elements: batch and sequence strides of q, k, v, dO and dq
// (the head and feature dims are dense); lse and delta are dense (B, Hq, l).
// Returns cudaGetLastError() after the launch.
extern "C" int terapipe_attention_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int l, int Hq, int Hkv, int hd, int ctx,
    int is_bf16, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss, long long dq_sb,
    long long dq_ss, void* stream) {
  const long long st[10] = {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss, dq_sb, dq_ss};
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, B, l, 0, Hq, Hkv, ctx, st,
               static_cast<cudaStream_t>(stream)};
  return int(dispatch_dq(is_bf16 != 0, hd, a));
}

// As terapipe_attention_dq, with Sk the keys of k/v and dk, dv (B, Sk, Hkv, hd)
// given by their batch and sequence strides.
extern "C" int terapipe_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int l, int Sk, int Hq, int Hkv, int hd,
    int ctx, int is_bf16, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss, long long dk_sb,
    long long dk_ss, long long dv_sb, long long dv_ss, void* stream) {
  const long long st[12] = {q_sb, q_ss, k_sb,  k_ss,  v_sb,  v_ss,
                            do_sb, do_ss, dk_sb, dk_ss, dv_sb, dv_ss};
  const Args a{q, k, v, dout, lse, delta, dk, dv, B, l, Sk, Hq, Hkv, ctx, st,
               static_cast<cudaStream_t>(stream)};
  return int(dispatch_dkv(is_bf16 != 0, hd, a));
}
