// QC-LDPC encoder kernel for Hopper (sm_90a), TS 38.212 §5.3.2.
//
// Replaces the Pallas TPU kernel encoder_pallas._make_kernel /
// _encode_tiles / encode (srsran_project_23_5_tpu/ops/ldpc/encoder_pallas.py).
//
// What it computes: the systematic encode of each codeblock.  Core parity p0
// is the XOR of the 4 core rows rotated by the core p0 shift, p1..p3 come by
// forward substitution along the double diagonal, and every extension parity
// is the XOR of rotated message and core-parity blocks.
//
// What bounds it on the H100: device memory sees one read of the message and
// one write of the codeword (bytes, one per bit: rate matching reads bytes),
// 2.1 MB at BG2 Z=384 x88, 0.6 us at 3.35 TB/s.  The XORs are few.  What
// costs is latency: four dependent core steps and one step of extension
// rows, each a pass over shared memory, one __syncthreads() apart.
//
// The design:
// - Bit-packed codeword.  Each Z-bit block lives in 32-bit words of shared
//   memory, stored twice back to back, so a rotation by s of 32 lanes is one
//   funnel shift of two words at bit offset 32w + s (the last word masked
//   where 32 does not divide Z).  6.8 KB per BG1 codeblock at Z=384.
// - Parallel work.  A work item is (row, 32-lane word).  The core parities
//   split their edges over the 4 lanes of a quad and XOR the parts with two
//   shuffles; every extension row then runs at once (504 items at BG1
//   Z=384, one per thread).  The wrapper folds each core step's roll into
//   its edges' shifts, and drops core-row edges that cancel in pairs.
//   Where Z is small, a CTA takes several codeblocks.
// - Schedule and I/O.  The edges live in shared memory.  Where 16 divides Z
//   the message is read with 16-B loads and packed by byte arithmetic, and
//   the codeword is unpacked with 16-B stores; otherwise byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxZ = 384;
constexpr int kMaxRows = 46;    // BG1
constexpr int kMaxEdges = 384;  // BG1: 67 + 3 x 18 core, 198 extension

// words per doubled block: 2Z bits and one word of slack for the funnel shift
__host__ __device__ __forceinline__ int doubled_words(int z) {
  return (2 * z + 31) / 32 + 1;
}

// lanes 32w..32w+31 of P^s x, from x's doubled block d
__device__ __forceinline__ uint32_t rotated_word(const uint32_t* d, int s,
                                                 int w) {
  const int pos = 32 * w + s;
  return __funnelshift_r(d[pos >> 5], d[(pos >> 5) + 1], pos & 31);
}

// OR word w (lanes 32w.., bits at and above Z zero) into both copies of a
// doubled block; the copy starts at bit Z, so it may straddle two words
__device__ __forceinline__ void put_doubled(uint32_t* d, int w, uint32_t v,
                                            int z) {
  atomicOr(d + w, v);
  const int pos = z + 32 * w;
  const int r = pos & 31;
  atomicOr(d + (pos >> 5), v << r);
  if (r) atomicOr(d + (pos >> 5) + 1, v >> (32 - r));
}

// 4 message bytes (0/1) → 4 bits
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t pack16(uint4 a) {
  return pack4(a.x) | pack4(a.y) << 4 | pack4(a.z) << 8 | pack4(a.w) << 12;
}

// 4 bits → 4 bytes (0/1)
__device__ __forceinline__ uint32_t unpack4(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads)
ldpc_encode_kernel(const int8_t* __restrict__ msg, int8_t* __restrict__ cw,
                   int batch, int vec_io, const int* __restrict__ row_off_g,
                   const uint32_t* __restrict__ edges_g, int nof_edges, int z,
                   int k, int m, int n, int per_cta) {
  __shared__ int row_off[kMaxRows + 1];
  __shared__ uint32_t edges[kMaxEdges];  // col << 16 | shift
  extern __shared__ uint32_t words[];    // [per_cta][n][doubled_words(z)]
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nw = (z + 31) / 32;          // words per block
  const int stride = doubled_words(z);
  const int blk = n * stride;
  const int cb0 = blockIdx.x * per_cta;
  const int cbs = min(per_cta, batch - cb0);
  const uint32_t last_mask = (z & 31) ? (1u << (z & 31)) - 1u : ~0u;

  for (int i = tid; i <= m; i += nt) row_off[i] = row_off_g[i];
  for (int i = tid; i < nof_edges; i += nt) edges[i] = edges_g[i];
  for (int i = tid; i < cbs * blk; i += nt) words[i] = 0;
  __syncthreads();

  // message → doubled bit blocks: item (codeblock, column, word)
  for (int it = tid; it < cbs * k * nw; it += nt) {
    const int g = it / (k * nw), c = it / nw % k, w = it % nw;
    const int8_t* src = msg + static_cast<size_t>(cb0 + g) * k * z + c * z +
                        32 * w;
    const int nbits = min(32, z - 32 * w);
    uint32_t v = 0;
    if (vec_io) {  // 16 divides z: 16 or 32 bytes, 16-B aligned
      v = pack16(*reinterpret_cast<const uint4*>(src));
      if (nbits > 16) v |= pack16(*reinterpret_cast<const uint4*>(src + 16)) << 16;
    } else {
      for (int b = 0; b < nbits; ++b)
        v |= static_cast<uint32_t>(src[b] & 1) << b;
    }
    put_doubled(words + g * blk + c * stride, w, v, z);
  }
  __syncthreads();

  // core parities p0..p3 (columns k..k+3), one dependent step each: item
  // (codeblock, word, quarter of the row's edges), quarters XORed in a quad
  const int core_items = cbs * nw * 4;
  for (int r = 0; r < 4; ++r) {
    const int e0 = row_off[r], len = row_off[r + 1] - e0;
    for (int base = 0; base < core_items; base += nt) {  // uniform per warp
      const int it = base + tid, part = it & 3;
      const int g = (it >> 2) / nw, w = (it >> 2) % nw;
      uint32_t v = 0;
      if (it < core_items) {
        const uint32_t* d = words + g * blk;
        for (int e = e0 + len * part / 4; e < e0 + len * (part + 1) / 4; ++e)
          v ^= rotated_word(d + (edges[e] >> 16) * stride, edges[e] & 0xFFFFu,
                            w);
      }
      v ^= __shfl_xor_sync(0xFFFFFFFFu, v, 1);
      v ^= __shfl_xor_sync(0xFFFFFFFFu, v, 2);
      if (it < core_items && part == 0)
        put_doubled(words + g * blk + (k + r) * stride, w,
                    w == nw - 1 ? v & last_mask : v, z);
    }
    __syncthreads();
  }

  // extension parities (columns k+4..n-1), all rows at once: item
  // (codeblock, row, word); they read columns < k+4 only
  const int ext_rows = m - 4;
  for (int it = tid; it < cbs * ext_rows * nw; it += nt) {
    const int g = it / (ext_rows * nw), r = 4 + it / nw % ext_rows,
              w = it % nw;
    const uint32_t* d = words + g * blk;
    uint32_t v = 0;
    for (int e = row_off[r]; e < row_off[r + 1]; ++e)
      v ^= rotated_word(d + (edges[e] >> 16) * stride, edges[e] & 0xFFFFu, w);
    words[g * blk + (k + r) * stride + w] = w == nw - 1 ? v & last_mask : v;
  }
  __syncthreads();

  // doubled bit blocks → codeword bytes
  const int nz = n * z;
  if (vec_io) {  // 16 bits per 16-B store
    for (int it = tid; it < cbs * (nz / 16); it += nt) {
      const int g = it / (nz / 16), pos = it % (nz / 16) * 16;
      const int c = pos / z, b = pos - c * z;
      const uint32_t h =
          words[g * blk + c * stride + (b >> 5)] >> (b & 31) & 0xFFFFu;
      reinterpret_cast<uint4*>(cw + static_cast<size_t>(cb0 + g) * nz)
          [pos / 16] = make_uint4(unpack4(h & 15u), unpack4(h >> 4 & 15u),
                                  unpack4(h >> 8 & 15u), unpack4(h >> 12));
    }
  } else {
    for (int it = tid; it < cbs * nz; it += nt) {
      const int g = it / nz, pos = it % nz;
      const int c = pos / z, b = pos - c * z;
      cw[static_cast<size_t>(cb0 + g) * nz + pos] = static_cast<int8_t>(
          words[g * blk + c * stride + (b >> 5)] >> (b & 31) & 1u);
    }
  }
}

}  // namespace

// msg [batch, k*z] int8, cw [batch, n*z] int8 (vec_io: 16 divides z and both
// are 16-B aligned); row_off [m+1] int32 and edges [nof_edges] (col << 16 |
// shift) on the device: rows 0..3 the core steps p0..p3 with their rolls
// folded into the shifts, rows 4..m-1 the extension rows over columns
// < k+4.  per_cta codeblocks per CTA.  Returns cudaGetLastError().
extern "C" int ldpc_encode(const void* msg, void* cw, int batch, int vec_io,
                           const void* row_off, const void* edges,
                           int nof_edges, int z, int k, int m, int n,
                           int per_cta, void* stream) {
  if (batch <= 0) return 0;
  if (z <= 0 || z > kMaxZ || m > kMaxRows || m < 4 ||
      nof_edges > kMaxEdges || per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      static_cast<size_t>(per_cta) * n * doubled_words(z) * sizeof(uint32_t);
  const int grid = (batch + per_cta - 1) / per_cta;
  ldpc_encode_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(msg), static_cast<int8_t*>(cw), batch,
      vec_io, static_cast<const int*>(row_off),
      static_cast<const uint32_t*>(edges), nof_edges, z, k, m, n, per_cta);
  return static_cast<int>(cudaGetLastError());
}
