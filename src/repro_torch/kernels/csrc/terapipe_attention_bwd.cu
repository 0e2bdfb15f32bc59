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
// at training lengths.  This first version runs every product as f32 SIMT
// FMAs out of shared memory (no tensor cores), like the forward; its ceiling
// is the 67 TFLOP/s f32 rate.  mma/wgmma tiles are later work.  The design:
//  * no sequential grid: where the TPU kernels carry their accumulators in
//    VMEM scratch across the innermost grid axis, here one block owns one
//    output tile and loops over the other axis itself -- dQ: one block per
//    (b, hq, 32-row q tile), walking 32-key K/V tiles up to the tile's causal
//    frontier ctx + min(q0 + 32, l); dK/dV: one block per (b, hkv, 32-key kv
//    tile), walking the rep query heads of its group and, for each, the q
//    tiles from the first one whose frontier reaches the kv tile.  Tiles past
//    a frontier are neither loaded nor computed.  Each output element is
//    written once by one block: no atomics, so the result is deterministic;
//  * tiles are staged once in shared memory as f32 (rows padded by 4 floats,
//    so the lane-per-row float4 reads are free of bank conflicts) and
//    reused by all 32 rows of the other operand; at hd 160 the four tiles
//    take 84 KB, opted in above 48 KB;
//  * each warp owns 8 rows of the block's own tile (q rows for dQ, keys for
//    dK/dV); lane j holds the score of the other tile's row j, and for the
//    accumulating products each lane owns the dims d = lane + 32*i, with the
//    per-pair P or dS broadcast by shuffle;
//  * the frontier arithmetic is in this kernel's tile sizes, and the first q
//    tile of a kv tile is max(k0 - ctx, 0) / 32: clamped at 0 before the
//    division, since C truncates toward zero where the TPU code floors;
//  * ctx is a runtime argument, so one build serves every offset.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kBQ = 32;                 // query rows per tile
constexpr int kBK = 32;                 // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 32 / kWarps;      // rows of the block's own tile per warp

template <int HD>
constexpr size_t smem_bytes() {
  return size_t(2 * kBQ + 2 * kBK) * (HD + 4) * sizeof(float) + 2 * kBQ * sizeof(float);
}

// Stage 32 rows of a (.., rows, heads*hd) tensor, starting at `src`, as f32
// into shared memory with row pitch HD + 4; rows at and past n_valid are zero.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t row_stride,
                                      int n_valid, int tid) {
  constexpr int LD = HD + 4;
  static_assert(32 * (HD / 4) % kThreads == 0, "tile loads divide evenly");
#pragma unroll
  for (int it = 0; it < 32 * (HD / 4) / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = load4(src + r * row_stride + c);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int l, int n_heads,
          int rep, int ctx, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
          int64_t v_sb, int64_t v_ss, int64_t do_sb, int64_t do_ss, int64_t dq_sb,
          int64_t dq_ss, float scale) {
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

  stage<T, HD>(Qs, q + b * q_sb + q0 * q_ss + int64_t(h) * HD, q_ss, l - q0, tid);
  stage<T, HD>(dOs, dout + b * do_sb + q0 * do_ss + int64_t(h) * HD, do_ss, l - q0, tid);
  const T* kb = k + b * k_sb + int64_t(h / rep) * HD;
  const T* vb = v + b * v_sb + int64_t(h / rep) * HD;

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
    stage<T, HD>(Ks, kb + t0 * k_ss, k_ss, kv_end - t0, tid);
    stage<T, HD>(Vs, vb + t0 * v_ss, v_ss, kv_end - t0, tid);
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
    T* out = dq + b * dq_sb + row * dq_ss + int64_t(h) * HD;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store1(out + d, acc[r][i] * scale);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           int l, int sk, int n_heads, int rep, int ctx, int64_t q_sb, int64_t q_ss,
           int64_t k_sb, int64_t k_ss, int64_t v_sb, int64_t v_ss, int64_t do_sb,
           int64_t do_ss, int64_t dk_sb, int64_t dk_ss, int64_t dv_sb, int64_t dv_ss,
           float scale) {
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
    stage<T, HD>(Ks, k + b * k_sb + k0 * k_ss + int64_t(hk) * HD, k_ss, valid_end - k0, tid);
    stage<T, HD>(Vs, v + b * v_sb + k0 * v_ss + int64_t(hk) * HD, v_ss, valid_end - k0, tid);
    // first q tile whose frontier ctx + min((iq+1)*32, l) passes k0
    const int iq_first = max(k0 - ctx, 0) / kBQ;
    const int n_qt = (l + kBQ - 1) / kBQ;
    for (int r = 0; r < rep; ++r) {
      const int h = hk * rep + r;
      const T* qh = q + b * q_sb + int64_t(h) * HD;
      const T* doh = dout + b * do_sb + int64_t(h) * HD;
      const int64_t row_at = (int64_t(b) * n_heads + h) * l;
      for (int iq = iq_first; iq < n_qt; ++iq) {
        const int q0 = iq * kBQ;
        __syncthreads();   // the previous q tile is consumed (and K, V are staged)
        stage<T, HD>(Qs, qh + q0 * q_ss, q_ss, l - q0, tid);
        stage<T, HD>(dOs, doh + q0 * do_ss, do_ss, l - q0, tid);
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
    T* dk_row = dk + b * dk_sb + key * dk_ss + int64_t(hk) * HD;
    T* dv_row = dv + b * dv_sb + key * dv_ss + int64_t(hk) * HD;
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

template <typename T, int HD>
cudaError_t launch_dq(const Args& a) {
  auto kern = dq_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  const long long* st = a.st;
  const dim3 grid((a.l + kBQ - 1) / kBQ, a.Hq, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o1), a.l, a.Hq, a.Hq / a.Hkv,
      a.ctx, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      rsqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const Args& a) {
  auto kern = dkv_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = opt_in(kern, smem);
  if (err != cudaSuccess) return err;
  const long long* st = a.st;
  const dim3 grid((a.sk + kBK - 1) / kBK, a.Hkv, a.B);
  kern<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.o1), static_cast<T*>(a.o2),
      a.l, a.sk, a.Hq, a.Hq / a.Hkv, a.ctx, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], rsqrtf(float(HD)));
  return cudaGetLastError();
}

template <bool DQ, typename T>
cudaError_t dispatch(int hd, const Args& a) {
  switch (hd) {
#define CASE(HD) \
    case HD: return DQ ? launch_dq<T, HD>(a) : launch_dkv<T, HD>(a);
    CASE(16) CASE(32) CASE(64) CASE(96) CASE(128) CASE(160)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int run(int is_bf16, int hd, const Args& a) {
  return int(is_bf16 ? dispatch<DQ, __nv_bfloat16>(hd, a) : dispatch<DQ, float>(hd, a));
}

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
  return run<true>(is_bf16, hd, a);
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
  return run<false>(is_bf16, hd, a);
}
