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
// fwd_kernel_bf16 (bf16 inputs): both products on the tensor cores
// (mma.m16n8k16, bf16 operands, f32 accumulators; mma.cuh).
//  * one block per (b, hq, 64-row q tile), 4 warps of 16 query rows; q tiles
//    are issued longest causal frontier first (grid z reversed), so the
//    short diagonal tiles form the tail, not the long ones;
//  * Q is staged once and held in registers as A fragments; 64-key K/V tiles
//    arrive through a two-stage cp.async ring, so the next tile's copy
//    overlaps this tile's products.  Tiles stay bf16 in shared memory, rows
//    padded by 8 so the ldmatrix loads are free of bank conflicts;
//  * S = Q.K^T stays in the accumulator registers; the online softmax runs
//    on the fragments (a row lives in one quad of lanes: a row max is two
//    shuffles), in log2 units; P is rounded to bf16 and reused in registers
//    as the A operand of P.V (V read with ldmatrix.trans) -- the one rounding
//    the f32 SIMT kernel does not make.  The denominator sums P in f32;
//  * the loop stops at the q tile's causal frontier ctx + min(q0 + 64, l):
//    tiles past it are neither loaded nor computed, and each warp skips the
//    tiles past its own 16 rows' frontier; only tiles that cross the
//    diagonal, or hold rows at and past l, are masked element by element;
//  * fully masked rows (pad rows past l) give 0, never NaN: the rescale is
//    guarded while the running max is -inf.
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
// is a runtime argument, so one build serves every chunk offset.
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace repro;
using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16, mma
constexpr int kMmaBQ = 64;              // query rows per block (16 per warp)
constexpr int kMmaBK = 64;              // keys per K/V tile
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
constexpr size_t mma_smem_bytes() {
  return size_t(kMmaBQ + 2 * 2 * kMmaBK) * (HD + kPad) * sizeof(bf16);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
fwd_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int l, int n_heads, int rep, int ctx, int64_t q_sb, int64_t q_ss,
                int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t o_sb,
                int64_t o_ss, float scale_log2) {
  constexpr int LD = HD + kPad;
  constexpr int KT = HD / 16;           // k-steps of Q.K^T
  constexpr int NS = kMmaBK / 8;        // n-tiles of S (8 keys each)
  constexpr int NO = HD / 8;            // n-tiles of O (8 dims each)
  extern __shared__ uint4 smem_u4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_u4);
  bf16* Ks = Qs + kMmaBQ * LD;          // [stage][kMmaBK][LD]
  bf16* Vs = Ks + 2 * kMmaBK * LD;

  const int h = blockIdx.x, b = blockIdx.y;
  const int iq = gridDim.z - 1 - blockIdx.z;   // longest frontier first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const LaneOffsets lo(lane);
  const int q0 = iq * kMmaBQ;
  const int kv_end = ctx + min(q0 + kMmaBQ, l);   // causal frontier of this q tile
  const int n_tiles = (kv_end + kMmaBK - 1) / kMmaBK;
  const int w0 = q0 + warp * 16;                 // first row of this warp
  const bool live = w0 < l;                      // the warp has rows to compute
  const int w_end = ctx + min(w0 + 16, l);       // this warp's own frontier

  const bf16* kb = k + b * k_sb + int64_t(h / rep) * HD;
  const bf16* vb = v + b * v_sb + int64_t(h / rep) * HD;
  auto load_kv = [&](int tile) {
    const int t0 = tile * kMmaBK, stage = tile & 1;
    cp_async_tile<kMmaBK, HD, kMmaThreads>(Ks + stage * kMmaBK * LD, kb + t0 * k_ss, k_ss,
                                           kv_end - t0, tid);
    cp_async_tile<kMmaBK, HD, kMmaThreads>(Vs + stage * kMmaBK * LD, vb + t0 * v_ss, v_ss,
                                           kv_end - t0, tid);
  };
  cp_async_tile<kMmaBQ, HD, kMmaThreads>(Qs, q + b * q_sb + q0 * q_ss + int64_t(h) * HD,
                                         q_ss, l - q0, tid);
  load_kv(0);
  cp_async_commit();

  uint32_t qa[KT][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float s[2] = {0.f, 0.f};              // this lane's part of the denominators

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_kv(it + 1);   // into the stage freed last iteration
    cp_async_commit();
    cp_async_wait<1>();                      // tile it (and Q) have landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldmatrix_x4(qa[kk], Qs + (warp * 16 + lo.a_row) * LD + kk * 16 + lo.a_col);
    }
    const int t0 = it * kMmaBK;
    if (live && t0 < w_end) {
      const bf16* Kt = Ks + (it & 1) * kMmaBK * LD;
      const bf16* Vt = Vs + (it & 1) * kMmaBK * LD;
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          uint32_t bk[4];
          ldmatrix_x4(bk, Kt + (jp * 16 + lo.b_row) * LD + kk * 16 + lo.b_col);
          mma_bf16(sc[2 * jp], qa[kk], bk[0], bk[1]);
          mma_bf16(sc[2 * jp + 1], qa[kk], bk[2], bk[3]);
        }
      }

      // scores in log2 units; the mask only where the tile crosses the
      // diagonal of this warp's rows or holds rows at and past l
      const bool edge = t0 + kMmaBK - 1 > ctx + w0 || w0 + 16 > l;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (edge) {
            const int row = w0 + g + (e >> 1) * 8;
            const int kpos = t0 + j * 8 + 2 * t4 + (e & 1);
            if (!(row < l && kpos <= ctx + row)) x = -INFINITY;
          }
          sc[j][e] = x;
        }
      }

      // online softmax on the fragments: row r of this lane is g + 8r
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));
        const float alpha = m[r] == -INFINITY ? 0.f : exp2f(m[r] - m_new);
        const float m_sub = m_new == -INFINITY ? 0.f : m_new;   // masked: exp2(-inf) = 0
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = exp2f(sc[j][e] - m_sub);
            sc[j][e] = p;
            sum += p;
          }
        }
        s[r] = s[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // O += P.V: P from registers (bf16), V through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4];
        pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < HD / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, Vt + (kk * 16 + lo.bt_row) * LD + dp * 16 + lo.bt_col);
          mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with stage it & 1 before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(quad_sum(s[r]), 1e-30f);
    const int row = w0 + g + 8 * r;
    if (row >= l) continue;
    const float inv = 1.f / den;
    bf16* orow = o + b * o_sb + row * o_ss + int64_t(h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t4 == 0) lse[(int64_t(b) * n_heads + h) * l + row] = m[r] * kLn2 + logf(den);
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
  auto kern = fwd_kernel_bf16<HD>;
  const size_t smem = mma_smem_bytes<HD>();
  const cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (l + kMmaBQ - 1) / kMmaBQ);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), l, Hq, Hq / Hkv, ctx, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], rsqrtf(float(HD)) * kLog2e);
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
