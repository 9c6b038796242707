// Layered normalised min-sum LDPC decoder kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decoder_pallas._make_kernel /
// _decode_tiles / decode (srsran_project_23_5_tpu/ops/ldpc/decoder_pallas.py)
// with its exact semantics: app and c2v stored in bfloat16 and computed in
// float32, scale 0.8 applied to the min magnitude, sign by `t < 0`, syndrome and
// hard bits by `<= 0`, ties `|t| == min1` take min2, the first syndrome check
// after `check_period` sweeps, and per-codeblock freeze on convergence.
//
// What bounds it on the H100: the decoder state.  A codeblock's app [n*Z] and
// c2v [E*Z] in bf16 are 191,232 B at the flagship shape (BG2, Z=384, n=52,
// E=197), which fits the 232,448 B a block may hold; every layer reads and
// writes deg*Z app and c2v entries, so the work is shared-memory traffic plus
// one __syncthreads() per layer (42 per sweep for BG2), i.e. latency-bound
// per codeblock.  The design keeps the whole state of one codeblock in
// dynamic shared memory of one CTA (one thread per lane j < Z), so device
// memory sees only the LLR read and the bit write; the active layer's
// variable-to-check values stay in registers (fully unrolled over the row
// degree); the rotation is index arithmetic: lane j reads and writes
// app[c*Z + (j+s) mod Z], a bijection per edge, so no lane races another
// within a layer.  A CTA exits as soon as its codeblock's syndrome passes,
// which is the Pallas per-codeblock freeze: each codeblock's result does not
// depend on its neighbours.  Shapes whose state exceeds the shared-memory
// limit (the full BG1 graph at Z=384) are refused by the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;  // Z <= 384
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ int rot(int lane, int s, int z) {
  const int r = lane + s;
  return r >= z ? r - z : r;
}

// One layer (check row) of the layered min-sum schedule for lane j.
template <int D>
__device__ __forceinline__ void update_layer(__nv_bfloat16* app,
                                             __nv_bfloat16* c2v, int e0,
                                             int deg, const int* edge_col,
                                             const int* edge_shift, int z,
                                             int j, float scale) {
  float t[D];
  int idx[D];
  float m1 = kBig, m2 = kBig;
  bool neg_prod = false;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < deg) {
      idx[i] = edge_col[e0 + i] * z + rot(j, edge_shift[e0 + i], z);
      const float v = __fsub_rn(__bfloat162float(app[idx[i]]),
                                __bfloat162float(c2v[(e0 + i) * z + j]));
      t[i] = v;
      const float a = fabsf(v);
      m2 = (a < m1) ? m1 : fminf(m2, a);
      m1 = fminf(m1, a);
      neg_prod ^= (v < 0.0f);
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < deg) {
      const float v = t[i];
      const float mag = (fabsf(v) == m1) ? m2 : m1;
      float msg = __fmul_rn(scale, mag);
      if (neg_prod != (v < 0.0f)) msg = -msg;
      c2v[(e0 + i) * z + j] = __float2bfloat16_rn(msg);
      app[idx[i]] = __float2bfloat16_rn(__fadd_rn(v, msg));
    }
  }
}

// True (in every thread) iff every check row of the codeblock is satisfied.
__device__ bool syndrome_ok(const __nv_bfloat16* app, const int* layer_off,
                            const int* edge_col, const int* edge_shift,
                            int nof_layers, int z, int j) {
  bool ok = true;
  if (j < z) {
    for (int l = 0; l < nof_layers && ok; ++l) {
      bool odd = false;
      for (int e = layer_off[l]; e < layer_off[l + 1]; ++e)
        odd ^= __bfloat162float(
                   app[edge_col[e] * z + rot(j, edge_shift[e], z)]) <= 0.0f;
      ok = !odd;
    }
  }
  return __syncthreads_and(ok) != 0;
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads, 1)
ldpc_decode_kernel(const float* __restrict__ llr, long long stride,
                   int8_t* __restrict__ bits, uint8_t* __restrict__ ok,
                   const int* __restrict__ layer_off,
                   const int* __restrict__ edge_col,
                   const int* __restrict__ edge_shift, int nof_layers, int z,
                   int n_used, int k, int n_edges, int nof_steps,
                   int sweeps_per_step, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* app = reinterpret_cast<__nv_bfloat16*>(smem);  // [n_used*z]
  __nv_bfloat16* c2v = app + static_cast<size_t>(n_used) * z;    // [n_edges*z]
  const int j = threadIdx.x;
  const size_t cb = blockIdx.x;

  const float* in = llr + cb * static_cast<size_t>(stride);
  for (int i = j; i < n_used * z; i += blockDim.x)
    app[i] = __float2bfloat16_rn(in[i]);
  for (int i = j; i < n_edges * z; i += blockDim.x)
    c2v[i] = __float2bfloat16_rn(0.0f);
  __syncthreads();

  bool done = false;  // uniform across the CTA (from __syncthreads_and)
  for (int step = 0; step < nof_steps && !done; ++step) {
    for (int sweep = 0; sweep < sweeps_per_step; ++sweep) {
      for (int l = 0; l < nof_layers; ++l) {
        if (j < z) {
          const int e0 = layer_off[l];
          update_layer<D>(app, c2v, e0, layer_off[l + 1] - e0, edge_col,
                          edge_shift, z, j, scale);
        }
        __syncthreads();
      }
    }
    done = syndrome_ok(app, layer_off, edge_col, edge_shift, nof_layers, z, j);
  }

  int8_t* out = bits + cb * static_cast<size_t>(k * z);
  for (int i = j; i < k * z; i += blockDim.x)
    out[i] = __bfloat162float(app[i]) <= 0.0f ? 1 : 0;
  if (j == 0) ok[cb] = done ? 1 : 0;
}

template <int D>
int launch(const void* llr, long long stride, void* bits, void* ok, int batch,
           const void* layer_off, const void* edge_col,
           const void* edge_shift, int nof_layers, int z, int n_used, int k,
           int n_edges, int nof_steps, int sweeps_per_step, float scale,
           cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(n_used + n_edges) * z * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      ldpc_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (z + 31) / 32 * 32;
  ldpc_decode_kernel<D><<<batch, threads, smem, stream>>>(
      static_cast<const float*>(llr), stride, static_cast<int8_t*>(bits),
      static_cast<uint8_t*>(ok), static_cast<const int*>(layer_off),
      static_cast<const int*>(edge_col), static_cast<const int*>(edge_shift),
      nof_layers, z, n_used, k, n_edges, nof_steps, sweeps_per_step, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// llr [batch, >= n_used*z] float32 with row stride `stride` elements; bits
// [batch, k*z] int8; ok [batch] bool; layer_off [nof_layers+1], edge_col and
// edge_shift [n_edges] int32 on the device (compacted layer schedule).
// Runs up to nof_steps x (sweeps_per_step sweeps, then the syndrome check).
// Returns cudaGetLastError().
extern "C" int ldpc_decode(const void* llr, long long stride, void* bits,
                           void* ok, int batch, const void* layer_off,
                           const void* edge_col, const void* edge_shift,
                           int nof_layers, int z, int n_used, int k,
                           int n_edges, int d_max, int nof_steps,
                           int sweeps_per_step, float scale, void* stream) {
  if (batch <= 0) return 0;
  if (z <= 0 || z > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_max <= 10)
    return launch<10>(llr, stride, bits, ok, batch, layer_off, edge_col,
                      edge_shift, nof_layers, z, n_used, k, n_edges, nof_steps,
                      sweeps_per_step, scale, s);
  if (d_max <= 19)
    return launch<19>(llr, stride, bits, ok, batch, layer_off, edge_col,
                      edge_shift, nof_layers, z, n_used, k, n_edges, nof_steps,
                      sweeps_per_step, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
