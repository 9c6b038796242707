// The mixed slot's channel mix for Hopper (sm_90a): a 2×2 port mix of a
// two-port signal plus up to two single-port streams, each spread over the
// two ports by its own column, in one pass.
//
// Replaces no Pallas TPU kernel: the JAX package mixes in plain XLA
// (srsran_project_23_5_tpu/models/gnb_mixed.py _mix2 and _vecmix, written
// out as scalar·plane multiply-adds for the TPU).  It was added because the
// port's plain mix (ops/channel_mix.channel_mix_plain: a 2×2 einsum over
// the whole [B, 2, 14, nsc] grid, then a broadcast product and an add per
// single-port stream) lowered on the card to a transposing copy, a complex
// GEMM with M = K = 2 whose 32×64×8 tile is almost all empty, a permuted
// output that every consumer read strided, and two more full-grid passes
// and two adds in the uplink: the mixed slot's largest device op at 64
// slots a batch.
//
// What it computes, per element r of a batch row's flattened trailing axes
// and output port p:
//   out[b, p, r] = ((H[p,0]·g[b,0,r] + H[p,1]·g[b,1,r]) + v1[p]·x1[b,r])
//                  + v2[p]·x2[b,r]
// with 0, 1 or 2 single-port streams x_i.  A complex product is
// (a.re·b.re − a.im·b.im, a.re·b.im + a.im·b.re) and every operation is
// rounded once (the _rn intrinsics, -fmad=false), in the order above,
// which is the plain expression's on the CPU.
//
// What bounds it on the H100: bytes.  Per element it reads 16 B of the
// two-port signal and 8 B of each stream and writes 16 B; the coefficients
// (at most 8 complex values) are read by every thread from L1.  The mixed
// slot's grid at 64 slots a batch is 2.94 M elements a port: 47 MB in and
// 47 MB out in the downlink (28 us at 3.35 TB/s), 94 MB in and 47 MB out
// in the uplink with its two streams (42 us).
//
// The design: a batch row's ports and streams are read where they lie
// ([B, 2, R] and [B, R], contiguous), so there is no transpose, and the
// result is written contiguous [B, 2, R].  A thread takes two neighbouring
// elements of a row with one 16-B load from each input and one 16-B store
// to each output port, where the row length is even and every base pointer
// 16-B aligned; otherwise (an odd length, a view at an odd element offset)
// one element with 8-B loads.  The grid is (row chunk, batch row), the
// batch axis looping past 65535 rows; every size is a run-time argument.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxRowsInGrid = 65535;  // gridDim.y's limit

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// the two output ports of one element
template <int NS>
__device__ __forceinline__ void mix(const float2 (&h)[4],
                                    const float2 (&v)[2][2], float2 g0,
                                    float2 g1, const float2 (&x)[2],
                                    float2& o0, float2& o1) {
  o0 = cadd(cmul(h[0], g0), cmul(h[1], g1));
  o1 = cadd(cmul(h[2], g0), cmul(h[3], g1));
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    o0 = cadd(o0, cmul(v[i][0], x[i]));
    o1 = cadd(o1, cmul(v[i][1], x[i]));
  }
}

// W elements a thread: 2 (16-B accesses) or 1 (8-B accesses)
template <int NS, int W>
__global__ void __launch_bounds__(kThreads)
channel_mix_kernel(const float2* __restrict__ g,
                   const float2* __restrict__ x1,
                   const float2* __restrict__ x2, float2* __restrict__ out,
                   const float2* __restrict__ hp,
                   const float2* __restrict__ v1p,
                   const float2* __restrict__ v2p, long long batch,
                   long long len) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * W;
  if (e >= len) return;
  float2 h[4], v[2][2] = {};
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __ldg(hp + k);
  if (NS >= 1) v[0][0] = __ldg(v1p), v[0][1] = __ldg(v1p + 1);
  if (NS >= 2) v[1][0] = __ldg(v2p), v[1][1] = __ldg(v2p + 1);
  const float2* xs[2] = {x1, x2};
  for (long long b = blockIdx.y; b < batch; b += gridDim.y) {
    const long long row = 2 * b * len + e;  // port 0 of row b; port 1 + len
    const long long srow = b * len + e;     // a stream's row b
    if constexpr (W == 2) {
      const float4 a = *reinterpret_cast<const float4*>(g + row);
      const float4 c = *reinterpret_cast<const float4*>(g + row + len);
      float2 xa[2] = {}, xb[2] = {};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 s = *reinterpret_cast<const float4*>(xs[i] + srow);
        xa[i] = make_float2(s.x, s.y);
        xb[i] = make_float2(s.z, s.w);
      }
      float2 p0, p1, q0, q1;
      mix<NS>(h, v, make_float2(a.x, a.y), make_float2(c.x, c.y), xa, p0,
              p1);
      mix<NS>(h, v, make_float2(a.z, a.w), make_float2(c.z, c.w), xb, q0,
              q1);
      *reinterpret_cast<float4*>(out + row) = make_float4(p0.x, p0.y, q0.x,
                                                          q0.y);
      *reinterpret_cast<float4*>(out + row + len) =
          make_float4(p1.x, p1.y, q1.x, q1.y);
    } else {
      float2 xa[2] = {};
#pragma unroll
      for (int i = 0; i < NS; ++i) xa[i] = xs[i][srow];
      float2 o0, o1;
      mix<NS>(h, v, g[row], g[row + len], xa, o0, o1);
      out[row] = o0;
      out[row + len] = o1;
    }
  }
}

template <int NS>
void launch(const void* g, const void* x1, const void* x2, void* out,
            const void* h, const void* v1, const void* v2, long long batch,
            long long len, bool wide, cudaStream_t stream) {
  const long long per_block = kThreads * (wide ? 2LL : 1LL);
  const dim3 grid(static_cast<unsigned>((len + per_block - 1) / per_block),
                  static_cast<unsigned>(batch < kMaxRowsInGrid
                                            ? batch : kMaxRowsInGrid));
  const auto* gp = static_cast<const float2*>(g);
  const auto* x1p = static_cast<const float2*>(x1);
  const auto* x2p = static_cast<const float2*>(x2);
  auto* op = static_cast<float2*>(out);
  const auto* hp = static_cast<const float2*>(h);
  const auto* v1p = static_cast<const float2*>(v1);
  const auto* v2p = static_cast<const float2*>(v2);
  if (wide)
    channel_mix_kernel<NS, 2><<<grid, kThreads, 0, stream>>>(
        gp, x1p, x2p, op, hp, v1p, v2p, batch, len);
  else
    channel_mix_kernel<NS, 1><<<grid, kThreads, 0, stream>>>(
        gp, x1p, x2p, op, hp, v1p, v2p, batch, len);
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

// g [batch, 2, len] complex64 (interleaved float pairs), x1 and x2
// [batch, len] complex64 (the first `streams` of them; the others may be
// null), out [batch, 2, len] complex64, all contiguous and 8-B aligned, out
// apart from every input; h [2, 2] (row p: output port p's column of
// weights), v1 and v2 [2] complex64 on the device.  Launches nothing for
// an empty batch or row.  Returns cudaGetLastError().
extern "C" int channel_mix(const void* g, const void* x1, const void* x2,
                           void* out, const void* h, const void* v1,
                           const void* v2, long long batch, long long len,
                           int streams, void* stream) {
  const void* xs[2] = {x1, x2};
  const void* vs[2] = {v1, v2};
  if (batch < 0 || len < 0 || streams < 0 || streams > 2 || g == nullptr ||
      out == nullptr || h == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  bool wide = len % 2 == 0 && aligned(g, 16) && aligned(out, 16);
  bool ok = aligned(g, 8) && aligned(out, 8) && aligned(h, 8);
  for (int i = 0; i < streams; ++i) {
    if (xs[i] == nullptr || vs[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    ok = ok && aligned(xs[i], 8) && aligned(vs[i], 8);
    wide = wide && aligned(xs[i], 16);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || len == 0) return 0;
  const long long per_block = kThreads * (wide ? 2LL : 1LL);
  if ((len + per_block - 1) / per_block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (streams) {
    case 0: launch<0>(g, x1, x2, out, h, v1, v2, batch, len, wide, s); break;
    case 1: launch<1>(g, x1, x2, out, h, v1, v2, batch, len, wide, s); break;
    default: launch<2>(g, x1, x2, out, h, v1, v2, batch, len, wide, s);
  }
  return static_cast<int>(cudaGetLastError());
}
