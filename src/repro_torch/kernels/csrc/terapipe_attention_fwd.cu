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
// is ~hundreds of FLOPs per byte, above the card's ridge point.  This first
// version runs the two products as f32 SIMT FMAs (not tensor cores), so its
// ceiling is the 67 TFLOP/s f32 rate and shared-memory bandwidth; tensor-core
// (mma/wgmma) tiles are later work.  What the design does about it:
//  * no sequential grid: one block per (b, hq, 32-row q tile); a loop inside
//    the block walks 32-key K/V tiles, and stops at the tile's causal frontier
//    ctx + min(q0 + 32, l) — tiles past it are neither loaded nor computed;
//  * K/V tiles are staged once in shared memory as f32 and reused by all 32
//    query rows; rows are padded by 4 floats so the lane-per-key float4 reads
//    are free of bank conflicts;
//  * each warp owns 8 query rows: lane j scores key j, a warp reduction gives
//    the tile's row max and sum, and for the PV product each lane owns the
//    output dims d = lane + 32*i, with p_j broadcast by shuffle;
//  * GQA K/V are read for kv head hq / rep, never repeated in memory;
//  * ctx is a runtime argument, so one build serves every chunk offset.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kBQ = 32;                 // query rows per block
constexpr int kBK = 32;                 // keys per tile (lane j <-> key j)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;     // query rows per warp

template <int HD>
constexpr size_t smem_bytes() { return size_t(kBQ + 2 * kBK) * (HD + 4) * sizeof(float); }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int l, int n_heads, int rep,
           int ctx, int64_t q_sb, int64_t q_ss, int64_t k_sb, int64_t k_ss,
           int64_t v_sb, int64_t v_ss, int64_t o_sb, int64_t o_ss, float scale) {
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

  const T* qb = q + b * q_sb + int64_t(h) * HD;
  const T* kb = k + b * k_sb + int64_t(h / rep) * HD;
  const T* vb = v + b * v_sb + int64_t(h / rep) * HD;

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
    T* orow = o + b * o_sb + row * o_ss + int64_t(h) * HD;
#pragma unroll
    for (int i = 0; i < NDL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store1(orow + d, acc[r][i] / den);
    }
    if (lane == 0) lse[(int64_t(b) * n_heads + h) * l + row] = m[r] + logf(den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int l, int Hq, int Hkv, int ctx, const long long* st,
                   cudaStream_t stream) {
  auto kern = fwd_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((l + kBQ - 1) / kBQ, Hq, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), l, Hq, Hq / Hkv, ctx,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], rsqrtf(float(HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int l, int Hq, int Hkv, int ctx,
                     const long long* st, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
    case 96: return launch<T, 96>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
    case 160: return launch<T, 160>(q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, stream);
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, s)
              : dispatch<float>(hd, q, k, v, o, lse, B, l, Hq, Hkv, ctx, st, s);
  return int(err);
}
