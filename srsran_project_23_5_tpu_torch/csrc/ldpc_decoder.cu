// Layered normalised min-sum LDPC decoder kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decoder_pallas._make_kernel /
// _decode_tiles / decode (srsran_project_23_5_tpu/ops/ldpc/decoder_pallas.py)
// with its exact semantics: app and c2v stored in bfloat16 and computed in
// float32, scale 0.8 applied to the min magnitude, sign by `t < 0`, syndrome and
// hard bits by `<= 0`, ties `|t| == min1` take min2, the syndrome checked
// after every `check_period` sweeps, and per-codeblock freeze on convergence.
//
// What bounds it on the H100: not device memory.  A codeblock reads its LLRs
// once and writes K bits (at BG1 Z=384 x136 n_used 35 that is 8.5 MB, 2.5 us
// at 3.35 TB/s), but each sweep is a chain of dependent layers, one
// __syncthreads() apart, over state that lives on chip.  So the time is the
// latency of one CTA walking its layers, and how many CTAs share the card.
//
// The design, one CTA per codeblock and one thread per lane j < Z:
// - Compressed c2v.  A check row's messages are all made from min1, min2,
//   the argmin edge and one sign per edge, so per (row, lane) the kernel
//   keeps bf16(0.8 m1) and bf16(0.8 m2) in one word and the signs (bits
//   0..18) and the argmin (bits 27..31) in another: 8 B per row-lane
//   instead of 2 B per edge-lane.  Edge e's message is
//   ±(e == argmin ? M2 : M1).  This is exact: bf16 RNE is symmetric, so the
//   sign goes on after rounding; another edge with |t| == m1 exists only on
//   a tie, where m2 == m1; the zero state gives +0 as before; a -0 message
//   keeps its sign bit.  The whole state fits in shared memory for every
//   graph (full BG1 at Z=384: 46*384*8 + 68*384*2 = 193,536 B), so one
//   instance decodes every graph, and at the main path's truncated graphs
//   (~67 KB) two 384-thread CTAs share an SM: 136 codeblocks are one wave.
// - Exact degree.  Each layer runs an update unrolled for its own degree
//   (3..10 and 19 in 38.212's graphs), not for the largest one.
// - Schedule on chip.  Per edge one packed word (col*Z, shift, col) in
//   shared memory.
// - Bit-packed syndrome.  One __ballot_sync per (column, warp) packs the hard
//   decisions into words, stored twice back to back per column so that a
//   rotation of 32 lanes is one funnel shift; each (row, 32-lane word) item
//   XORs its edges' rotated words, and __syncthreads_and combines them.
// - Vectorised I/O.  LLRs arrive as float4 and go to shared memory as four
//   bf16 in one 8-B store; hard bits leave as 16-B stores.
// Within a layer lane j reads and writes app[c*Z + (j+s) mod Z], a bijection
// per edge, so no lane races another.  A CTA stops as soon as its syndrome
// passes: the Pallas per-codeblock freeze.  kDiag instances record clock64()
// per phase per CTA; only the measurement scripts launch them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 384;  // Z <= 384
constexpr int kMaxRows = 46;      // BG1
constexpr int kMaxEdges = 320;    // BG1 has 316
constexpr int kMaxDegree = 19;
constexpr int kDiagWords = 8;
constexpr float kBig = 3.0e38f;
constexpr int kMaxDynamicSmem = 232448 - 2048;  // static smem below 2 KB

// packed schedule word: col*z (bits 0..14) | shift << 16 | col << 25
__device__ __forceinline__ int app_index(uint32_t w, int j, int z) {
  int r = j + static_cast<int>((w >> 16) & 0x1FFu);
  r = r >= z ? r - z : r;
  return static_cast<int>(w & 0x7FFFu) + r;
}

__device__ __forceinline__ float bf16_to_float(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t hard(uint32_t h) {  // app <= 0
  return bf16_to_float(h) <= 0.0f ? 1u : 0u;
}

// hard bits of the four bf16 in (a, b) as four bytes
__device__ __forceinline__ uint32_t hard4(uint32_t a, uint32_t b) {
  return hard(a & 0xFFFFu) | hard(a >> 16) << 8 | hard(b & 0xFFFFu) << 16 |
         hard(b >> 16) << 24;
}

// words per doubled bit block: 2Z bits and one word of slack for the shift
__host__ __device__ __forceinline__ int doubled_words(int z) {
  return (2 * z + 31) / 32 + 1;
}

// lanes 32w..32w+31 of a bit block rotated by s, from its doubled block d
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

// One layer (check row) of the layered min-sum schedule for lane j; deg is
// D when the caller knows it, so the predicates fold away.  Rows of degree
// <= 10 keep their app indices in registers between the two passes.
template <int D>
__device__ __forceinline__ void update_layer(uint16_t* app, uint32_t* c2v_mag,
                                             uint32_t* c2v_sgn,
                                             const uint32_t* sched, int e0,
                                             int row, int deg, int z, int j,
                                             float scale) {
  const int slot = row * z + j;
  const uint32_t mag = c2v_mag[slot];
  const uint32_t sgn = c2v_sgn[slot];
  const uint32_t old_m1 = mag & 0xFFFFu, old_m2 = mag >> 16;
  const int old_arg = static_cast<int>(sgn >> 27);
  constexpr bool kKeep = D <= 10;
  float t[D];
  int idx[kKeep ? D : 1];
  float m1 = kBig, m2 = kBig;
  int arg = 0;
  uint32_t neg = 0;  // bit i: t_i < 0
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < deg) {
      const uint32_t old = (i == old_arg ? old_m2 : old_m1) |
                           ((sgn >> i) & 1u) << 15;
      const int ix = app_index(sched[e0 + i], j, z);
      if (kKeep) idx[i] = ix;
      const float v = __fsub_rn(bf16_to_float(app[ix]), bf16_to_float(old));
      t[i] = v;
      const float a = fabsf(v);
      if (a < m1) arg = i;
      m2 = (a < m1) ? m1 : fminf(m2, a);
      m1 = fminf(m1, a);
      neg |= static_cast<uint32_t>(v < 0.0f) << i;
    }
  }
  // message sign of edge i: the sign product (by t < 0) times sgn(t_i)
  const uint32_t flip = (__popc(neg) & 1) ? ~0u : 0u;
  const uint32_t signs = (neg ^ flip) & ((1u << deg) - 1u);
  const float s1 = __fmul_rn(scale, m1), s2 = __fmul_rn(scale, m2);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (i < deg) {
      const float v = t[i];
      float msg = (fabsf(v) == m1) ? s2 : s1;
      if ((signs >> i) & 1u) msg = -msg;
      app[kKeep ? idx[i] : app_index(sched[e0 + i], j, z)] =
          static_cast<uint16_t>(bf16_bits(__fadd_rn(v, msg)));
    }
  }
  c2v_mag[slot] = bf16_bits(s1) | bf16_bits(s2) << 16;
  c2v_sgn[slot] = signs | static_cast<uint32_t>(arg) << 27;
}

__device__ __forceinline__ void run_layer(uint16_t* app, uint32_t* c2v_mag,
                                          uint32_t* c2v_sgn,
                                          const uint32_t* sched,
                                          const int* layer_off, int l, int z,
                                          int j, float scale) {
  const int e0 = layer_off[l];
  const int deg = layer_off[l + 1] - e0;
#define LAYER(D) \
  update_layer<D>(app, c2v_mag, c2v_sgn, sched, e0, l, D, z, j, scale)
  switch (deg) {
    case 3: LAYER(3); break;
    case 4: LAYER(4); break;
    case 5: LAYER(5); break;
    case 6: LAYER(6); break;
    case 7: LAYER(7); break;
    case 8: LAYER(8); break;
    case 9: LAYER(9); break;
    case 10: LAYER(10); break;
    case 19: LAYER(19); break;
    default:
      update_layer<kMaxDegree>(app, c2v_mag, c2v_sgn, sched, e0, l, deg, z, j,
                               scale);
  }
#undef LAYER
}

// True (in every thread) iff every check row of the codeblock is satisfied.
// hw [n_used][doubled_words(z)] is scratch for the packed hard decisions.
__device__ __forceinline__ bool syndrome_ok(const uint16_t* app, uint32_t* hw,
                                            const uint32_t* sched,
                                            const int* layer_off,
                                            int nof_layers, int n_used, int z,
                                            int j) {
  const int nt = blockDim.x, nw = (z + 31) / 32, stride = doubled_words(z);
  for (int i = j; i < n_used * stride; i += nt) hw[i] = 0;
  __syncthreads();
  for (int c = 0; c < n_used; ++c) {  // warp w holds lanes 32w..32w+31
    const uint32_t b =
        __ballot_sync(0xFFFFFFFFu, j < z && hard(app[c * z + j]) != 0u);
    if ((j & 31) == 0) put_doubled(hw + c * stride, j >> 5, b, z);
  }
  __syncthreads();
  const uint32_t last_mask = (z & 31) ? (1u << (z & 31)) - 1u : ~0u;
  uint32_t bad = 0;
  for (int it = j; it < nof_layers * nw; it += nt) {  // item (row, word)
    const int r = it / nw, w = it - r * nw;
    uint32_t v = 0;
    for (int e = layer_off[r]; e < layer_off[r + 1]; ++e) {
      const uint32_t sw = sched[e];
      v ^= rotated_word(hw + (sw >> 25) * stride,
                        static_cast<int>((sw >> 16) & 0x1FFu), w);
    }
    bad |= w == nw - 1 ? v & last_mask : v;
  }
  return __syncthreads_and(bad == 0) != 0;
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__host__ __device__ __forceinline__ int app_offset(int nof_layers, int z) {
  return (8 * nof_layers * z + 15) / 16 * 16;  // bytes of compressed c2v
}

__host__ __device__ __forceinline__ int hard_offset(int nof_layers, int z,
                                                    int n_used) {
  return app_offset(nof_layers, z) + (2 * n_used * z + 15) / 16 * 16;
}

template <bool kDiag>
__global__ void __launch_bounds__(kMaxThreads, 2)
ldpc_decode_kernel(const float* __restrict__ llr, long long stride,
                   int vec_llr, int8_t* __restrict__ bits,
                   uint8_t* __restrict__ ok,
                   const int* __restrict__ layer_off_g,
                   const uint32_t* __restrict__ sched_g, int nof_layers,
                   int z, int n_used, int k, int n_edges, int nof_steps,
                   int sweeps_per_step, float scale,
                   long long* __restrict__ diag) {
  __shared__ int layer_off[kMaxRows + 1];
  __shared__ uint32_t sched[kMaxEdges];
  extern __shared__ __align__(16) unsigned char smem[];
  long long t0 = 0, t_a = 0, t_load = 0, t_sw = 0, t_syn = 0, g0 = 0;
  if (kDiag) {
    t0 = clock64();
    g0 = globaltimer();
  }
  const int rz = nof_layers * z;
  uint32_t* c2v_mag = reinterpret_cast<uint32_t*>(smem);  // [rows*z]
  uint32_t* c2v_sgn = c2v_mag + rz;                       // [rows*z]
  const int app_off = app_offset(nof_layers, z);
  uint16_t* app = reinterpret_cast<uint16_t*>(smem + app_off);  // [n_used*z]
  uint32_t* hw =  // [n_used][doubled_words(z)]
      reinterpret_cast<uint32_t*>(smem + hard_offset(nof_layers, z, n_used));
  const int j = threadIdx.x;
  const int nt = blockDim.x;
  const size_t cb = blockIdx.x;

  for (int i = j; i <= nof_layers; i += nt) layer_off[i] = layer_off_g[i];
  for (int i = j; i < n_edges; i += nt) sched[i] = sched_g[i];
  uint4* c2v4 = reinterpret_cast<uint4*>(smem);
  for (int i = j; i < app_off / 16; i += nt) c2v4[i] = make_uint4(0, 0, 0, 0);
  const float* in = llr + cb * static_cast<size_t>(stride);
  const int total = n_used * z;
  int head = 0;
  if (vec_llr) {  // 16-B aligned rows: four LLRs per load, four loads in flight
    const float4* in4 = reinterpret_cast<const float4*>(in);
    uint2* app4 = reinterpret_cast<uint2*>(app);
    const int n4 = total / 4;
    for (int base = j; base < n4; base += 4 * nt) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * nt < n4) v[u] = in4[base + u * nt];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (base + u * nt < n4)
          app4[base + u * nt] =
              make_uint2(bf16_bits(v[u].x) | bf16_bits(v[u].y) << 16,
                         bf16_bits(v[u].z) | bf16_bits(v[u].w) << 16);
    }
    head = n4 * 4;
  }
  for (int i = head + j; i < total; i += nt)
    app[i] = static_cast<uint16_t>(bf16_bits(in[i]));
  __syncthreads();
  if (kDiag) t_load = clock64() - t0;

  bool done = false;  // uniform across the CTA (from __syncthreads_and)
  int step = 0;
  for (; step < nof_steps && !done; ++step) {
    if (kDiag) t_a = clock64();
    for (int sweep = 0; sweep < sweeps_per_step; ++sweep) {
      for (int l = 0; l < nof_layers; ++l) {
        if (j < z) run_layer(app, c2v_mag, c2v_sgn, sched, layer_off, l, z, j,
                             scale);
        __syncthreads();
      }
    }
    if (kDiag) {
      const long long t_b = clock64();
      t_sw += t_b - t_a;
      t_a = t_b;
    }
    done = syndrome_ok(app, hw, sched, layer_off, nof_layers, n_used, z, j);
    if (kDiag) t_syn += clock64() - t_a;
  }
  if (kDiag) t_a = clock64();

  int8_t* out = bits + cb * static_cast<size_t>(k * z);
  const int kz = k * z;
  if ((kz & 15) == 0) {  // 16 hard bits per 16-B store
    const uint4* a16 = reinterpret_cast<const uint4*>(app);
    uint4* o16 = reinterpret_cast<uint4*>(out);
    for (int i = j; i < kz / 16; i += nt) {
      const uint4 lo = a16[2 * i], hi = a16[2 * i + 1];
      o16[i] = make_uint4(hard4(lo.x, lo.y), hard4(lo.z, lo.w),
                          hard4(hi.x, hi.y), hard4(hi.z, hi.w));
    }
  } else {
    for (int i = j; i < kz; i += nt) out[i] = static_cast<int8_t>(hard(app[i]));
  }
  if (j == 0) ok[cb] = done ? 1 : 0;
  if (kDiag) {
    __syncthreads();
    if (j == 0) {
      const long long t_end = clock64();
      long long* d = diag + cb * kDiagWords;
      d[0] = t_load;
      d[1] = t_sw;
      d[2] = t_syn;
      d[3] = t_end - t_a;
      d[4] = t_end - t0;
      d[5] = static_cast<long long>(step) * sweeps_per_step;
      d[6] = g0;
      d[7] = globaltimer();
    }
  }
}

size_t dynamic_smem(int nof_layers, int z, int n_used) {
  return static_cast<size_t>(hard_offset(nof_layers, z, n_used)) +
         static_cast<size_t>(n_used) * doubled_words(z) * sizeof(uint32_t);
}

// Function attributes, once per instance: the dynamic shared memory a CTA
// may take, and all of the SM's L1/shared split for shared memory.
template <bool kDiag>
cudaError_t prepare() {
  static cudaError_t state = cudaErrorNotReady;
  if (state == cudaErrorNotReady) {
    state = cudaFuncSetAttribute(ldpc_decode_kernel<kDiag>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxDynamicSmem);
    if (state == cudaSuccess)
      state = cudaFuncSetAttribute(
          ldpc_decode_kernel<kDiag>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
  }
  return state;
}

bool valid(int z, int nof_layers, int n_used, int n_edges, int d_max) {
  return z > 0 && z <= kMaxThreads && nof_layers > 0 &&
         nof_layers <= kMaxRows && n_edges <= kMaxEdges &&
         d_max <= kMaxDegree && n_used * z <= 0x8000 &&
         dynamic_smem(nof_layers, z, n_used) <= kMaxDynamicSmem;
}

template <bool kDiag>
int launch(const void* llr, long long stride, int vec_llr, void* bits,
           void* ok, int batch, const void* layer_off, const void* sched,
           int nof_layers, int z, int n_used, int k, int n_edges,
           int nof_steps, int sweeps_per_step, float scale, void* diag,
           cudaStream_t stream) {
  const cudaError_t err = prepare<kDiag>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = (z + 31) / 32 * 32;
  ldpc_decode_kernel<kDiag>
      <<<batch, threads, dynamic_smem(nof_layers, z, n_used), stream>>>(
          static_cast<const float*>(llr), stride, vec_llr,
          static_cast<int8_t*>(bits), static_cast<uint8_t*>(ok),
          static_cast<const int*>(layer_off),
          static_cast<const uint32_t*>(sched), nof_layers, z, n_used, k,
          n_edges, nof_steps, sweeps_per_step, scale,
          static_cast<long long*>(diag));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// llr [batch, >= n_used*z] float32 with row stride `stride` elements
// (vec_llr: rows 16-B aligned); bits [batch, k*z] int8; ok [batch] bool;
// layer_off [nof_layers+1] int32 and sched [n_edges] packed edge words on
// the device (compacted layer schedule).  diag: null, or [batch, 8] int64
// for the phase split of the diagnostic instance.  Runs up to nof_steps x
// (sweeps_per_step sweeps, then the syndrome check).  Returns
// cudaGetLastError().
extern "C" int ldpc_decode(const void* llr, long long stride, int vec_llr,
                           void* bits, void* ok, int batch,
                           const void* layer_off, const void* sched,
                           int nof_layers, int z, int n_used, int k,
                           int n_edges, int d_max, int nof_steps,
                           int sweeps_per_step, float scale, void* diag,
                           void* stream) {
  if (batch <= 0) return 0;
  if (!valid(z, nof_layers, n_used, n_edges, d_max))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (diag != nullptr)
    return launch<true>(llr, stride, vec_llr, bits, ok, batch, layer_off,
                        sched, nof_layers, z, n_used, k, n_edges, nof_steps,
                        sweeps_per_step, scale, diag, s);
  return launch<false>(llr, stride, vec_llr, bits, ok, batch, layer_off,
                       sched, nof_layers, z, n_used, k, n_edges, nof_steps,
                       sweeps_per_step, scale, nullptr, s);
}

// CTAs of the main instance that fit on one SM at this shape.
extern "C" int ldpc_decode_ctas_per_sm(int z, int nof_layers, int n_used,
                                       int* ctas) {
  const cudaError_t err = prepare<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, ldpc_decode_kernel<false>, (z + 31) / 32 * 32,
      dynamic_smem(nof_layers, z, n_used)));
}
