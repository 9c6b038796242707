// QC-LDPC encoder kernel for Hopper (sm_90a), TS 38.212 §5.3.2.
//
// Replaces the Pallas TPU kernel encoder_pallas._make_kernel /
// _encode_tiles / encode (srsran_project_23_5_tpu/ops/ldpc/encoder_pallas.py).
//
// What it computes: the systematic encode of one codeblock per CTA.  Core
// parity p0 is the XOR of the 4 core rows rotated by the core p0 shift, p1..p3
// come by forward substitution along the double diagonal, and every
// extension parity is the XOR of rotated message and core-parity blocks.
//
// What bounds it on the H100: the encode is a few hundred byte XORs per lane
// over a codeword that fits in shared memory (52*384 = 19,968 B for BG2,
// 68*384 = 26,112 B for BG1); device-memory traffic is one read of the
// message and one write of the codeword, so the kernel is latency-bound
// (a chain of dependent steps separated by __syncthreads()), not
// bandwidth-bound.  The design keeps the whole codeword in shared memory,
// makes every rotation index arithmetic ((j+s) mod Z, no data movement) and
// runs one thread per lane j < Z, so each step is a single pass over the
// lanes; the graph (row offsets, columns, shifts) is read from small device
// arrays.  Many codeblocks per launch fill the SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;  // Z <= 384

// XOR over the edges of row r with column < max_col of the codeword block
// values at rotated lane (lane + shift) mod z.
__device__ __forceinline__ int8_t row_xor(const int8_t* w, const int* row_off,
                                          const int* edge_col,
                                          const int* edge_shift, int r,
                                          int max_col, int z, int lane) {
  int8_t acc = 0;
  for (int e = row_off[r]; e < row_off[r + 1]; ++e) {
    const int c = edge_col[e];
    if (c >= max_col) continue;
    int idx = lane + edge_shift[e];
    if (idx >= z) idx -= z;
    acc ^= w[c * z + idx];
  }
  return acc;
}

__global__ void __launch_bounds__(kMaxThreads)
ldpc_encode_kernel(const int8_t* __restrict__ msg, int8_t* __restrict__ cw,
                   const int* __restrict__ row_off,
                   const int* __restrict__ edge_col,
                   const int* __restrict__ edge_shift, int z, int k, int m,
                   int n, int p0_shift, int s1, int s2, int s3) {
  extern __shared__ int8_t w[];  // [n*z] codeword of this CTA's codeblock
  const int j = threadIdx.x;
  const size_t cb = blockIdx.x;
  const int8_t* in = msg + cb * static_cast<size_t>(k * z);
  for (int i = j; i < k * z; i += blockDim.x) w[i] = in[i];
  __syncthreads();

  // p0 = roll(XOR of the 4 core rows, p0_shift): lane j reads lane j - p0_shift
  if (j < z) {
    int i0 = j - p0_shift;
    if (i0 < 0) i0 += z;
    int8_t acc = 0;
    for (int r = 0; r < 4; ++r)
      acc ^= row_xor(w, row_off, edge_col, edge_shift, r, k, z, i0);
    w[k * z + j] = acc;
  }
  __syncthreads();

  // forward substitution: p_{r+1} = roll(row r over known columns, s_new)
  const int s_new[3] = {s1, s2, s3};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (j < z) {
      int i0 = j - s_new[r];
      if (i0 < 0) i0 += z;
      w[(k + 1 + r) * z + j] =
          row_xor(w, row_off, edge_col, edge_shift, r, k + 1 + r, z, i0);
    }
    __syncthreads();
  }

  // extension rows: single identity parity at column k + r
  if (j < z) {
    for (int r = 4; r < m; ++r)
      w[(k + r) * z + j] =
          row_xor(w, row_off, edge_col, edge_shift, r, k + 4, z, j);
  }
  __syncthreads();

  int8_t* out = cw + cb * static_cast<size_t>(n * z);
  for (int i = j; i < n * z; i += blockDim.x) out[i] = w[i];
}

}  // namespace

// msg [batch, k*z] int8, cw [batch, n*z] int8; row_off [m+1], edge_col and
// edge_shift [edges] int32 on the device.  Returns cudaGetLastError().
extern "C" int ldpc_encode(const void* msg, void* cw, int batch,
                           const void* row_off, const void* edge_col,
                           const void* edge_shift, int z, int k, int m, int n,
                           int p0_shift, int s1, int s2, int s3,
                           void* stream) {
  if (batch <= 0) return 0;
  if (z <= 0 || z > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (z + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(n) * z;
  ldpc_encode_kernel<<<batch, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(msg), static_cast<int8_t*>(cw),
      static_cast<const int*>(row_off), static_cast<const int*>(edge_col),
      static_cast<const int*>(edge_shift), z, k, m, n, p0_shift, s1, s2, s3);
  return static_cast<int>(cudaGetLastError());
}
