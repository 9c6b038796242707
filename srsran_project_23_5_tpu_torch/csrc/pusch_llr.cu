// PUSCH LLR stage for Hopper (sm_90a): equalised symbols → the clipped,
// descrambled codeword LLRs and each batch row's RMS EVM, in one pass
// (TS 38.211 §5.1, §6.3.1.1, §6.3.1.3).
//
// Replaces no Pallas TPU kernel: the JAX package demaps in plain XLA
// (srsran_project_23_5_tpu/ops/modulation.py demodulate_soft, and
// phy/upper/sch.py evm_calculate).  It was added because the plain chain
// (ops/modulation.pusch_llr_plain: a [..., S, 2^(qm/2)] distance tensor per
// axis, two masked fills and two amin reductions per bit, the stacks, the
// noise division, the layer-demap transpose, the sign product and the clip;
// ~35 launches) took about a fifth of the device time of the 273-PRB mixed
// slot at 64 slots a batch, and the plain EVM (ops/modulation.evm_plain: a
// second [..., S, 2^(qm/2)] distance tensor per axis, an argmin over it, a
// gather of the levels, the complex error, abs, square, mean and sqrt; ~14
// launches) then took its largest device op.
//
// What it computes, per codeword bit (L·i + l)·qm + q of a batch row, layer
// l's bit i·qm + q (the order of precoding.layer_demap_llr):
//   clamp(sign · ((min_{bit=1} d2 − min_{bit=0} d2) / nv), ±clip)
// with d2 = (y − level)² over the axis's 2^(qm/2) Gray PAM levels, bit
// q = 2k + axis, each min starting from the plain chain's masked fill 1e30
// and NaN winning as in amin; qm = 2 is the closed form gain·y / nv.  And per
// batch row, over its L·S REs:
//   evm = sqrt(sum |y − hard(y)|² / (L·S))
// with hard(y) the nearest level per axis by |y − level_j| over the levels
// in table order, the first index winning a tie and NaN winning as in
// torch.argmin (at qm = 2 the levels are ±1/√2).  |e| is hypotf(e.re, e.im):
// on the card PyTorch's abs of a complex64 is the jiterator's
// std::abs(complex<float>), which is hypot(real, imag), i.e. CUDA's hypotf;
// ** 2 is one rounded product.  The operations and their order are the plain
// chain's, each rounded once (-fmad=false and the _rn intrinsics), so the
// LLRs and each RE's |e|² are bit-identical to it; the row's sum runs in
// another order than torch's mean, so the EVM is within its rounding.
//
// What bounds it on the H100: bytes.  Per RE it reads 8 B of symbol and 4 B
// of noise variance and writes 4·qm B of LLR; the sign (4·qm B per RE) is the
// same for every row of a batch, so after the first row it comes from L2.
// At 64QAM that is 36 B per RE: the mixed slot's 3.3M data REs per 64-slot
// batch move ~0.12 GB, ~36 us at 3.35 TB/s.  The EVM reads nothing more: it
// works on the symbol already in registers, and writes 4 B per block and per
// row.  The arithmetic (2^(qm/2) subtractions and squares and
// qm/2 · 2^(qm/2) compares per axis for the LLRs, 2^(qm/2) compares per axis
// and one hypotf for the EVM) stays below the card's rate, but its registers
// cost occupancy: at the mixed slot's B=64 shapes the kernel runs at about
// half its bytes bound, where the LLRs alone ran at about two thirds.
//
// The design: threads take REs in codeword order, so neighbouring threads
// write neighbouring 4·qm-byte runs of the output (8-B stores) and read the
// sign the same way; with L > 1 the L threads of one symbol index read the L
// layers' rows, each a run of neighbouring 8-B symbol loads.  The level table
// is a kernel parameter (constant bank), the mins live in registers.  The
// grid is row × chunk: a block of 128 threads holds REs of one batch row
// only, sums their |e|² in a fixed tree (warp shuffles, then the four warps
// in order) and writes one partial.  The sum over a row needs every block of
// it, and blocks run in no order, so the last block of a row to finish sums
// the row's partials in index order: each block writes its partial, fences,
// and takes a ticket from the row's integer counter; the block that draws
// the last ticket fences again, adds the partials, writes the EVM and resets
// the counter to 0, so the next launch (a captured graph's replay too) finds
// it as the first found it.  No float atomics: a replay gives the same bits.
// That tail (sum, fence, ticket) holds the whole block, so where the grid is
// big (two blocks of 512 REs per SM or more: the mixed slot at B=64, a card
// of the flagship mesh) a thread takes 4 REs, 128 apart, and a block's tail
// is paid once per 512 REs: the mixed slot's B=64 pair of PUSCHs took 87 us
// at one RE a thread and 78 us at four (H100).  A smaller grid (a PUSCH of
// the FAPI carrier at B=1, the mixed slot's one-layer PUSCH at B=8) keeps
// one RE a thread, so that its blocks spread over the SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // REs a thread takes on a big grid
// blocks of kUnroll·128 REs that make a grid big: two per SM of the 132
constexpr long long kUnrollBlocks = 264;
constexpr float kMasked = 1e30f;  // demodulate_soft's masked_fill value

struct Levels {
  float v[16];  // the axis's PAM level of each label (pam_levels(qm))
};

// amin's minimum: NaN wins, otherwise the smaller
__device__ __forceinline__ float nan_min(float m, float d) {
  return (d != d || d < m) ? d : m;
}

// torch.clamp: NaN passes through
__device__ __forceinline__ float clip_llr(float x, float clip) {
  return x != x ? x : fminf(fmaxf(x, -clip), clip);
}

// the NB bit LLRs (before the noise division) of one axis value y
template <int NB>
__device__ __forceinline__ void axis_llr(float y, const Levels& lv,
                                         float (&diff)[NB]) {
  float m1[NB], m0[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) m1[k] = m0[k] = kMasked;
#pragma unroll
  for (int j = 0; j < (1 << NB); ++j) {
    const float t = __fsub_rn(y, lv.v[j]);
    const float d = __fmul_rn(t, t);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if ((j >> (NB - 1 - k)) & 1)
        m1[k] = nan_min(m1[k], d);
      else
        m0[k] = nan_min(m0[k], d);
    }
  }
#pragma unroll
  for (int k = 0; k < NB; ++k) diff[k] = __fsub_rn(m1[k], m0[k]);
}

// y minus its nearest of the M levels: argmin of |y − level_j| as
// torch.argmin takes it (NaN wins, then the smaller, the first index on a
// tie), so a NaN y takes level 0 as the plain chain's does
template <int M>
__device__ __forceinline__ float axis_error(float y, const Levels& lv) {
  float best = fabsf(__fsub_rn(y, lv.v[0]));
  float hard = lv.v[0];
#pragma unroll
  for (int j = 1; j < M; ++j) {
    const float d = fabsf(__fsub_rn(y, lv.v[j]));
    if (best == best && (d != d || d < best)) {
      best = d;
      hard = lv.v[j];
    }
  }
  return __fsub_rn(y, hard);
}

// the block's sum of v in a fixed order (lane tree, then warps in order),
// in thread 0; every thread of the block calls it
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, d));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    s = warp_sums[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, warp_sums[w]);
  }
  return s;
}

// One RE, index t = L·i + l of batch row b: writes its qm LLRs, returns
// its |y − hard(y)|².
template <int QM>
__device__ __forceinline__ float stage_re(
    const float2* __restrict__ x, const float* __restrict__ nv,
    const float* __restrict__ sign, float* __restrict__ out, long long b,
    int t, int layers, int nsym, const Levels& lv, float gain, float clip) {
  const int per_row = layers * nsym;
  const long long r = b * per_row + t;  // RE index in codeword order
  const int i = t / layers, l = t - i * layers;
  const long long src = b * per_row + static_cast<long long>(l) * nsym + i;
  const float2 y = x[src];
  const float w = nv[src];

  float v[QM];  // bit order per symbol: re0, im0, re1, im1, ...
  if constexpr (QM == 2) {
    v[0] = __fdiv_rn(__fmul_rn(gain, y.x), w);
    v[1] = __fdiv_rn(__fmul_rn(gain, y.y), w);
  } else {
    constexpr int NB = QM / 2;
    float re[NB], im[NB];
    axis_llr<NB>(y.x, lv, re);
    axis_llr<NB>(y.y, lv, im);
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      v[2 * k] = __fdiv_rn(re[k], w);
      v[2 * k + 1] = __fdiv_rn(im[k], w);
    }
  }

  const float2* s2 =
      reinterpret_cast<const float2*>(sign + static_cast<long long>(t) * QM);
  float2* o2 = reinterpret_cast<float2*>(out + r * QM);
#pragma unroll
  for (int p = 0; p < QM / 2; ++p) {
    const float2 s = s2[p];
    o2[p] = make_float2(clip_llr(__fmul_rn(v[2 * p], s.x), clip),
                        clip_llr(__fmul_rn(v[2 * p + 1], s.y), clip));
  }

  constexpr int M = 1 << (QM / 2);
  const float a = hypotf(axis_error<M>(y.x, lv), axis_error<M>(y.y, lv));
  return __fmul_rn(a, a);
}

// Block chunk of batch row b holds the row's REs [chunk·K·128,
// (chunk + 1)·K·128), K per thread, 128 apart.
template <int QM, int K>
__global__ void __launch_bounds__(kThreads)
pusch_llr_kernel(const float2* __restrict__ x, const float* __restrict__ nv,
                 const float* __restrict__ sign, float* __restrict__ out,
                 float* __restrict__ evm, float* __restrict__ partial,
                 unsigned* __restrict__ ticket, int layers, int nsym,
                 int chunks, Levels lv, float gain, float clip) {
  __shared__ float warp_sums[kWarps];
  __shared__ bool last;
  const int per_row = layers * nsym;
  const long long b = blockIdx.x / chunks;  // batch row
  const int chunk = static_cast<int>(blockIdx.x - b * chunks);
  float e2 = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int t = (chunk * K + k) * kThreads + threadIdx.x;
    if (t < per_row)
      e2 = __fadd_rn(e2, stage_re<QM>(x, nv, sign, out, b, t, layers, nsym,
                                      lv, gain, clip));
  }

  const float s = block_sum(e2, warp_sums);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();  // the partial is seen before the ticket is taken
    last = atomicAdd(ticket + b, 1u) == static_cast<unsigned>(chunks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // every block of the row has published its partial
  const float* row = partial + b * chunks;
  float acc = 0.0f;
  for (int c = threadIdx.x; c < chunks; c += kThreads)
    acc = __fadd_rn(acc, __ldcg(row + c));
  const float total = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) {
    evm[b] = __fsqrt_rn(__fdiv_rn(total, static_cast<float>(per_row)));
    ticket[b] = 0u;
  }
}

// REs a thread takes: kUnroll where the grid still has kUnrollBlocks
// blocks of kUnroll·128 REs, so that a block's tail (the sum, the fence,
// the ticket) is paid once per 512 REs; else 1, since a small grid needs
// every block it can get to spread over the SMs.
int per_thread(long long batch, long long per_row) {
  const long long span = static_cast<long long>(kThreads) * kUnroll;
  return batch * ((per_row + span - 1) / span) >= kUnrollBlocks ? kUnroll
                                                                 : 1;
}

template <int QM, int K>
void launch(const void* x, const void* nv, const void* sign, void* out,
            void* evm, void* partial, void* ticket, long long batch,
            int layers, int nsym, int chunks, const Levels& lv, float gain,
            float clip, cudaStream_t stream) {
  const long long grid = batch * chunks;
  pusch_llr_kernel<QM, K><<<static_cast<unsigned>(grid), kThreads, 0,
                            stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(nv),
      static_cast<const float*>(sign), static_cast<float*>(out),
      static_cast<float*>(evm), static_cast<float*>(partial),
      static_cast<unsigned*>(ticket), layers, nsym, chunks, lv, gain, clip);
}

template <int QM>
void launch_qm(const void* x, const void* nv, const void* sign, void* out,
               void* evm, void* partial, void* ticket, long long batch,
               int layers, int nsym, int chunks, int k, const Levels& lv,
               float gain, float clip, cudaStream_t stream) {
  if (k == kUnroll)
    launch<QM, kUnroll>(x, nv, sign, out, evm, partial, ticket, batch,
                        layers, nsym, chunks, lv, gain, clip, stream);
  else
    launch<QM, 1>(x, nv, sign, out, evm, partial, ticket, batch, layers,
                  nsym, chunks, lv, gain, clip, stream);
}

}  // namespace

// Blocks a batch row takes (the length of a row's run of partial sums).
extern "C" int pusch_llr_chunks(long long batch, int layers, int nsym) {
  const long long per_row = static_cast<long long>(layers) * nsym;
  const long long span =
      static_cast<long long>(kThreads) * per_thread(batch, per_row);
  return static_cast<int>((per_row + span - 1) / span);
}

// x [batch, layers, nsym] complex64 (interleaved float pairs), nv [batch,
// layers, nsym] float32, sign [layers·nsym·qm] float32 and out [batch,
// layers·nsym·qm] float32 on the device, contiguous, sign and out 8-B
// aligned; evm [batch] float32; partial [batch·pusch_llr_chunks] float32
// scratch; ticket [batch] uint32, zero before the launch and zero after it;
// levels: the 2^(qm/2) floats of the axis's levels, on the host.
// Returns cudaGetLastError().
extern "C" int pusch_llr(const void* x, const void* nv, const void* sign,
                         void* out, void* evm, void* partial, void* ticket,
                         long long batch, int layers, int nsym, int qm,
                         const float* levels, float gain, float clip,
                         void* stream) {
  if (batch < 0 || layers < 1 || nsym < 0 ||
      (qm != 2 && qm != 4 && qm != 6 && qm != 8) || levels == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_row = static_cast<long long>(layers) * nsym;
  if (batch == 0 || per_row == 0) return 0;
  const int k = per_thread(batch, per_row);
  const int chunks = pusch_llr_chunks(batch, layers, nsym);
  if (batch * chunks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  for (int j = 0; j < (1 << (qm / 2)); ++j) lv.v[j] = levels[j];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (qm) {
    case 2: launch_qm<2>(x, nv, sign, out, evm, partial, ticket, batch,
                         layers, nsym, chunks, k, lv, gain, clip, s);
      break;
    case 4: launch_qm<4>(x, nv, sign, out, evm, partial, ticket, batch,
                         layers, nsym, chunks, k, lv, gain, clip, s);
      break;
    case 6: launch_qm<6>(x, nv, sign, out, evm, partial, ticket, batch,
                         layers, nsym, chunks, k, lv, gain, clip, s);
      break;
    default: launch_qm<8>(x, nv, sign, out, evm, partial, ticket, batch,
                          layers, nsym, chunks, k, lv, gain, clip, s);
  }
  return static_cast<int>(cudaGetLastError());
}
