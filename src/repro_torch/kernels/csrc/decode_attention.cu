// Flash-decode attention of one query token over a KV cache, for Hopper.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::_decode_kernel
// (launched by decode_attention_kernel).  Same function: q (B, 1, Hq, hd)
// over k/v (B, L, Hkv, hd) valid to kv_len[b] (a device int32 (B,) vector;
// the wrapper broadcasts a scalar), clamped to [0, L]; GQA kv head =
// hq / rep; softmax with f32 max, denominator and accumulator, denominator
// clamped at 1e-30 (kv_len = 0 gives 0); O in the input dtype.
//
// What bounds it on the H100: bytes.  Each cache entry up to kv_len is used
// for 2 FLOPs per query head of its group, far below the card's ridge point,
// so the least time is (K + V bytes up to kv_len) / 3.35 TB/s.  One serving
// round reads ~10 MB: the time goes to latency unless the whole card has
// copies in flight at once.  The design splits the sequence (split-K flash
// decode), in two kernels per call:
//  * decode_chunk_kernel: one block per (b, kv head, group of up to 4 query
//    heads, chunk of kChunk = 128 keys).  The grid's chunk axis is sized
//    from L; a block whose chunk starts at or past kv_len[b] exits, so K/V
//    past kv_len is never read.  At the serving shape (B 4, kv_len [1056,
//    544, 800, 160], Hkv 8) that is 184 live blocks for the 132 SMs, where
//    one block per (b, kv head) gave 32.  The block issues its whole chunk
//    of K and V (64 KB in bf16 at hd 128) as 16-byte cp.async copies at
//    once, zero-filled past kv_len, so one round trip to memory serves it.
//    The query heads of the group share that one read of their kv head's
//    cache.  Thread t scores key t against each query head (q pre-scaled by
//    scale*log2e, so scores are in log2 units; rows padded by 16 bytes, so
//    the 16-byte reads of 8 threads fall in distinct banks); a block max and
//    sum give the chunk's softmax state; for P.V each warp takes its own 32
//    keys, each lane 4 output dims, P broadcast by shuffle; the 4 warps' sums
//    are added through shared memory in a fixed order.  The block writes its
//    partial state (m, s, acc[hd]) in f32 to a workspace;
//  * decode_merge_kernel: one block per (b, query head) combines the live
//    chunks' states in chunk order: M = max m_c, out = sum_c acc_c *
//    2^(m_c - M) / max(sum_c s_c * 2^(m_c - M), 1e-30).
// Every output is written by one block in a fixed order, with no atomics:
// two calls on the same inputs agree bit for bit.
#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace repro;

constexpr int kChunk = 128;             // keys per block: thread t <-> key t
constexpr int kThreads = kChunk;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                // query heads per block (one GQA group, or part)
constexpr int kMergeThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// row pitch of the K/V chunk in shared memory, in elements: 16 bytes of pad
template <typename T, int HD>
constexpr int kChunkLd = HD + 16 / int(sizeof(T));

template <typename T, int HD>
constexpr size_t chunk_smem_bytes() {
  return size_t(2 * kChunk) * kChunkLd<T, HD> * sizeof(T);
}

// 16 bytes of shared memory widened to floats (8 bf16 or 4 f32)
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void widen16(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x; x[1] = f.y; x[2] = f.z; x[3] = f.w;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_acc, float* __restrict__ part_ms, int n_heads,
                    int rep, int n_groups, int L, int n_chunks, int64_t q_sb, int64_t k_sb,
                    int64_t k_ss, int64_t v_sb, int64_t v_ss, float scale_log2) {
  constexpr int LD = kChunkLd<T, HD>;
  constexpr int VEC = 16 / int(sizeof(T));   // elements per 16-byte copy
  constexpr int CPR = HD / VEC;              // 16-byte copies per row
  constexpr int NG = (HD + 127) / 128;       // 4-dim groups per lane: d = 4*lane + 128*g
  extern __shared__ uint4 smem_u4[];
  T* Ks = reinterpret_cast<T*>(smem_u4);
  T* Vs = Ks + kChunk * LD;
  __shared__ __align__(16) float Qs[kRows][HD];
  __shared__ float red_m[kWarps][kRows], red_s[kWarps][kRows];
  __shared__ __align__(16) float As[kWarps][kRows][HD];

  const int c = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
  const int h0 = hk * rep + grp * kRows;
  const int nrows = min(kRows, rep - grp * kRows);
  const int n = min(max(kv_len[b], 0), L);
  const int c0 = c * kChunk;
  if (c0 >= n) return;                       // past this sequence's cache
  const int nk = min(kChunk, n - c0);        // valid keys of the chunk
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the chunk's K and V rows in one round of copies; rows past nk zero-filled
  const T* kb = k + b * k_sb + c0 * k_ss + int64_t(hk) * HD;
  const T* vb = v + b * v_sb + c0 * v_ss + int64_t(hk) * HD;
#pragma unroll
  for (int it = 0; it < CPR; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx / CPR, col = (idx % CPR) * VEC;
    const bool ok = r < nk;
    cp_async16(Ks + r * LD + col, ok ? kb + r * k_ss + col : kb, ok);
    cp_async16(Vs + r * LD + col, ok ? vb + r * v_ss + col : vb, ok);
  }
  cp_async_commit();

  // the group's query rows in f32, pre-scaled to log2 units; pad rows zero
  for (int idx = tid; idx < kRows * (HD / 4); idx += kThreads) {
    const int r = idx / (HD / 4), col = (idx % (HD / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      x = load4(q + b * q_sb + int64_t(h0 + r) * HD + col);
      x = make_float4(x.x * scale_log2, x.y * scale_log2, x.z * scale_log2, x.w * scale_log2);
    }
    *reinterpret_cast<float4*>(&Qs[r][col]) = x;
  }
  cp_async_wait<0>();
  __syncthreads();

  // scores: thread t <-> key c0 + t
  float x[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) x[r] = 0.f;
  const T* krow = Ks + tid * LD;
#pragma unroll
  for (int col = 0; col < HD; col += VEC) {
    float kf[VEC];
    widen16(krow + col, kf);
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 kv = make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        x[r] += dot4(*reinterpret_cast<const float4*>(&Qs[r][col + e]), kv);
    }
  }

  // the chunk's softmax state: a block max, then p = 2^(x - m) and a block sum
  const bool valid = tid < nk;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    x[r] = valid ? x[r] : -INFINITY;
    const float mx = warp_max(x[r]);
    if (lane == 0) red_m[warp][r] = mx;
  }
  __syncthreads();
  float m[kRows], p[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = red_m[0][r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m[r] = fmaxf(m[r], red_m[w][r]);
    p[r] = exp2f(x[r] - m[r]);           // key 0 is valid: m is finite; masked -> 0
    const float sum = warp_sum(p[r]);
    if (lane == 0) red_s[warp][r] = sum;
  }

  // P.V over the warp's own 32 keys; lane j holds p of key 32*warp + j
  float acc[kRows][NG][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < NG; ++g) acc[r][g][0] = acc[r][g][1] = acc[r][g][2] = acc[r][g][3] = 0.f;
  const int n_keys = min(32, nk - warp * 32);   // warp-uniform
#pragma unroll 4
  for (int j = 0; j < n_keys; ++j) {
    const T* vrow = Vs + (warp * 32 + j) * LD;
    float4 vv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * lane + 128 * g;
      vv[g] = d < HD ? load4(vrow + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float pj = __shfl_sync(kFullMask, p[r], j);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[r][g][0] += pj * vv[g].x; acc[r][g][1] += pj * vv[g].y;
        acc[r][g][2] += pj * vv[g].z; acc[r][g][3] += pj * vv[g].w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int d = 4 * lane + 128 * g;
      if (d < HD)
        *reinterpret_cast<float4*>(&As[warp][r][d]) =
            make_float4(acc[r][g][0], acc[r][g][1], acc[r][g][2], acc[r][g][3]);
    }
  __syncthreads();

  // the partial state of each query head, warps added in order
  const int64_t slot = (int64_t(b) * n_heads + h0) * n_chunks + c;   // (b, h0, c)
  for (int idx = tid; idx < nrows * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    float a = As[0][r][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) a += As[w][r][d];
    part_acc[(slot + int64_t(r) * n_chunks) * HD + d] = a;
  }
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= nrows) break;
      float s = red_s[0][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += red_s[w][r];
      part_ms[(slot + int64_t(r) * n_chunks) * 2] = m[r];
      part_ms[(slot + int64_t(r) * n_chunks) * 2 + 1] = s;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ms,
                    const int* __restrict__ kv_len, T* __restrict__ o, int n_heads, int L,
                    int n_chunks, int64_t o_sb) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int n = min(max(kv_len[b], 0), L);
  const int nc = (n + kChunk - 1) / kChunk;   // the live chunks, all written
  const int64_t slot = (int64_t(b) * n_heads + h) * n_chunks;
  const float* ms = part_ms + slot * 2;
  const float* acc = part_acc + slot * HD;
  float mx = -INFINITY;
  for (int c = 0; c < nc; ++c) mx = fmaxf(mx, ms[2 * c]);
  float den = 0.f;
  for (int c = 0; c < nc; ++c) den += ms[2 * c + 1] * exp2f(ms[2 * c] - mx);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < HD; d += kMergeThreads) {
    float num = 0.f;
    for (int c = 0; c < nc; ++c) num += acc[int64_t(c) * HD + d] * exp2f(ms[2 * c] - mx);
    store1(o + b * o_sb + int64_t(h) * HD + d, num * inv);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const int* kv_len,
                   float* ws, int B, int Hq, int Hkv, int L, const long long* st,
                   cudaStream_t stream) {
  auto chunk = decode_chunk_kernel<T, HD>;
  const size_t smem = chunk_smem_bytes<T, HD>();
  cudaError_t err =
      cudaFuncSetAttribute(chunk, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int rep = Hq / Hkv, n_groups = (rep + kRows - 1) / kRows;
  const int n_chunks = (L + kChunk - 1) / kChunk;
  float* part_acc = ws;
  float* part_ms = ws + int64_t(B) * Hq * n_chunks * HD;
  chunk<<<dim3(n_chunks, Hkv * n_groups, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), kv_len,
      part_acc, part_ms, Hq, rep, n_groups, L, n_chunks, st[0], st[1], st[2], st[3], st[4],
      rsqrtf(float(HD)) * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T, HD><<<dim3(Hq, B), kMergeThreads, 0, stream>>>(
      part_acc, part_ms, kv_len, static_cast<T*>(o), Hq, L, n_chunks, st[5]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* q, const void* k, const void* v, void* o,
                     const int* kv_len, float* ws, int B, int Hq, int Hkv, int L,
                     const long long* st, cudaStream_t stream) {
  switch (hd) {
#define CASE(HD) \
    case HD: return launch<T, HD>(q, k, v, o, kv_len, ws, B, Hq, Hkv, L, st, stream);
    CASE(16) CASE(32) CASE(64) CASE(96) CASE(128) CASE(160)
#undef CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Strides are in elements: q and o batch strides, k/v batch and sequence
// strides (head and feature dims dense).  kv_len is a device int32 (B,)
// vector.  `workspace` holds B * Hq * ceil(L / chunk) * (hd + 2) floats, and
// `chunk` must be this build's kChunk (the wrapper sizes the workspace from
// it).  Returns cudaGetLastError() after the launches.
extern "C" int decode_attention(const void* q, const void* k, const void* v, void* o,
                                const void* kv_len, void* workspace, int B, int Hq,
                                int Hkv, int L, int hd, int is_bf16, int chunk,
                                long long q_sb, long long k_sb, long long k_ss,
                                long long v_sb, long long v_ss, long long o_sb,
                                void* stream) {
  if (chunk != kChunk) return int(cudaErrorInvalidValue);
  const long long st[6] = {q_sb, k_sb, k_ss, v_sb, v_ss, o_sb};
  const int* lens = static_cast<const int*>(kv_len);
  float* ws = static_cast<float*>(workspace);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, o, lens, ws, B, Hq, Hkv, L, st, s)
              : dispatch<float>(hd, q, k, v, o, lens, ws, B, Hq, Hkv, L, st, s);
  return int(err);
}
