// PUSCH LLR stage for Hopper (sm_90a): equalised symbols → the clipped,
// descrambled codeword LLRs, in one pass (TS 38.211 §5.1, §6.3.1.1, §6.3.1.3).
//
// Replaces no Pallas TPU kernel: the JAX package demaps in plain XLA
// (srsran_project_23_5_tpu/ops/modulation.py demodulate_soft).  It was added
// because the plain chain (ops/modulation.pusch_llr_plain: a [..., S, 2^(qm/2)]
// distance tensor per axis, two masked fills and two amin reductions per bit,
// the stacks, the noise division, the layer-demap transpose, the sign product
// and the clip; ~35 launches) took about a fifth of the device time of the
// 273-PRB mixed slot at 64 slots a batch.
//
// What it computes, per codeword bit (L·i + l)·qm + q of a batch row, layer
// l's bit i·qm + q (the order of precoding.layer_demap_llr):
//   clamp(sign · ((min_{bit=1} d2 − min_{bit=0} d2) / nv), ±clip)
// with d2 = (y − level)² over the axis's 2^(qm/2) Gray PAM levels, bit
// q = 2k + axis, each min starting from the plain chain's masked fill 1e30
// and NaN winning as in amin; qm = 2 is the closed form gain·y / nv.  The
// operations and their order are the plain chain's, each rounded once
// (-fmad=false and the _rn intrinsics), so the output is bit-identical to it.
//
// What bounds it on the H100: bytes.  Per RE it reads 8 B of symbol and 4 B
// of noise variance and writes 4·qm B of LLR; the sign (4·qm B per RE) is the
// same for every row of a batch, so after the first row it comes from L2.
// At 64QAM that is 36 B per RE: the mixed slot's 3.3M data REs per 64-slot
// batch move ~0.12 GB, ~36 us at 3.35 TB/s.  The arithmetic (2^(qm/2)
// subtractions and squares and qm/2 · 2^(qm/2) compares per axis) is far
// below the card's rate.
//
// The design: one thread per RE in codeword order, so neighbouring threads
// write neighbouring 4·qm-byte runs of the output (8-B stores) and read the
// sign the same way; with L > 1 the L threads of one symbol index read the L
// layers' rows, each a run of neighbouring 8-B symbol loads.  The level table
// is a kernel parameter (constant bank), the mins live in registers, and
// nothing is staged in shared memory.  128 threads a block give 280 blocks for
// one slot's 2-layer PUSCH, enough for 132 SMs at a batch of one.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
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

template <int QM>
__global__ void __launch_bounds__(kThreads)
pusch_llr_kernel(const float2* __restrict__ x, const float* __restrict__ nv,
                 const float* __restrict__ sign, float* __restrict__ out,
                 long long n, int layers, int nsym, Levels lv, float gain,
                 float clip) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;  // RE index in codeword order
  if (r >= n) return;
  const int per_row = layers * nsym;
  const long long b = r / per_row;
  const int t = static_cast<int>(r - b * per_row);  // L·i + l
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
}

template <int QM>
void launch(const void* x, const void* nv, const void* sign, void* out,
            long long n, int layers, int nsym, const Levels& lv, float gain,
            float clip, cudaStream_t stream) {
  const long long grid = (n + kThreads - 1) / kThreads;
  pusch_llr_kernel<QM><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const float2*>(x), static_cast<const float*>(nv),
      static_cast<const float*>(sign), static_cast<float*>(out), n, layers,
      nsym, lv, gain, clip);
}

}  // namespace

// x [batch, layers, nsym] complex64 (interleaved float pairs), nv [batch,
// layers, nsym] float32, sign [layers·nsym·qm] float32 and out [batch,
// layers·nsym·qm] float32 on the device, contiguous, sign and out 8-B
// aligned; levels: 2^(qm/2) floats on the host (unused at qm = 2).
// Returns cudaGetLastError().
extern "C" int pusch_llr(const void* x, const void* nv, const void* sign,
                         void* out, long long batch, int layers, int nsym,
                         int qm, const float* levels, float gain, float clip,
                         void* stream) {
  if (batch < 0 || layers < 1 || nsym < 0 ||
      (qm != 2 && qm != 4 && qm != 6 && qm != 8) ||
      (qm != 2 && levels == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = batch * layers * nsym;
  if (n == 0) return 0;
  Levels lv = {};
  if (qm != 2)
    for (int j = 0; j < (1 << (qm / 2)); ++j) lv.v[j] = levels[j];
  const auto s = static_cast<cudaStream_t>(stream);
  switch (qm) {
    case 2: launch<2>(x, nv, sign, out, n, layers, nsym, lv, gain, clip, s);
      break;
    case 4: launch<4>(x, nv, sign, out, n, layers, nsym, lv, gain, clip, s);
      break;
    case 6: launch<6>(x, nv, sign, out, n, layers, nsym, lv, gain, clip, s);
      break;
    default: launch<8>(x, nv, sign, out, n, layers, nsym, lv, gain, clip, s);
  }
  return static_cast<int>(cudaGetLastError());
}
