// VCO-bank chunk scan for Hopper (sm_90a): T dt-steps of the k-oscillator
// LIF bank of the path integrator in one launch.
//
// Replaces sspslam_tpu/ops/pallas_kernels.py:_chunk_body_v2 (the default
// path, make_vco_scan_v2) and serves _chunk_body (make_vco_scan) as well:
// filtering and projection are linear and commute, so v1's filtered (T, d)
// SSP output is this kernel's filtered (T, 2k) decode rows times [ts0T; ts1T],
// which the wrapper applies with torch.matmul outside the kernel, as the
// JAX package applies it outside its pallas_call.
//
// Design.  Once the two input projections are hoisted out of the time loop,
// every oscillator evolves independently for the whole chunk, so the grid
// is one block per oscillator with no inter-block synchronisation.  A block:
//   1. prologue: projects the chunk's corrections (T, d) and velocities
//      (T, N) onto its own oscillator (columns j of tf0T, tf1T, velT_T) into
//      a per-oscillator scratch xs[j] = (xc0, xc1, xv), each (T,);
//   2. loads its neurons' voltage, refractory time and 9 parameters (3
//      encoders, bias, 5 decoders) into registers, NPT neurons per thread;
//   3. runs the rolled time loop: currents J, the LIF update (expm1f /
//      log1pf, the executor's formulas), five population decodes as a block
//      reduction (warp butterflies, one shared-memory exchange), and the
//      lowpass filters of the three recurrent rows and the two output rows.
//      Every thread ends the reduction holding the same sums, so every
//      thread keeps its own copy of the filter state and no broadcast is
//      needed; the partial sums are double-buffered, which leaves ONE
//      __syncthreads per step.  Thread 0 writes out[t, j] and out[t, k+j].
// The DC oscillator's pin (dc_mask, zeroed recurrent decoders) is data.
//
// What bounds it.  The state (~11 floats per neuron, 35 KB per oscillator at
// n = 800) stays in registers for the whole chunk and each step moves a few
// bytes, so bytes and FLOPs do not bound it.  Each step is a serial chain:
// the LIF update of the block's n neurons, issued by ONE SM (expm1f, log1pf
// and two IEEE divisions per neuron), then two shuffle trees and a barrier
// (per-step latency).  Only k of the card's 132 SMs are busy (49 at
// ssp_dim 97).  This first design accepts both; running several
// independent trials per launch, or splitting an oscillator across a
// thread-block cluster, is later work.

#include <cuda_runtime.h>

namespace {

// At most 512 threads per block: at n = 800 that is 2 neurons per thread,
// 13 warps per SM, which measured faster on an H100 than 4 per thread at
// 256 or 1 per thread at 1024 (PERF.md).
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// Neurons per thread: 1, 2 or 4, so at most 2,048 neurons per oscillator.
constexpr int kMaxNpt = 4;
constexpr unsigned kFull = 0xffffffffu;

struct Consts {
  float a_rec, b_rec, a_out, b_out, tau_rc, tau_ref, dt, spike_out;
};

// Butterfly sum over the warp: every lane ends with the same five sums
// (each level adds a pair in both orders, which IEEE addition makes equal).
__device__ __forceinline__ void warp_sum5(float (&p)[5]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 5; ++c) p[c] += __shfl_xor_sync(kFull, p[c], off);
  }
}

template <int NPT>
__global__ void __launch_bounds__(kMaxThreads) vco_scan_kernel(
    const float* __restrict__ enc0, const float* __restrict__ enc1,
    const float* __restrict__ enc2, const float* __restrict__ bias,
    const float* __restrict__ drec0, const float* __restrict__ drec1,
    const float* __restrict__ drec2, const float* __restrict__ dout0,
    const float* __restrict__ dout1, const float* __restrict__ dc_mask,
    const float* __restrict__ tf0T, const float* __restrict__ tf1T,
    const float* __restrict__ velT_T, const float* __restrict__ vel,
    const float* __restrict__ corr, const float* __restrict__ volt_in,
    const float* __restrict__ refr_in, const float* __restrict__ f0_in,
    const float* __restrict__ f1_in, const float* __restrict__ f2_in,
    const float* __restrict__ fo_in, float* __restrict__ out,
    float* __restrict__ volt_out, float* __restrict__ refr_out,
    float* __restrict__ f0_out, float* __restrict__ f1_out,
    float* __restrict__ f2_out, float* __restrict__ fo_out, float* xs,
    int n, int k, int d, int N, int T, Consts c) {
  extern __shared__ float cols[];  // (2d + N): this oscillator's columns
  __shared__ float red[2][kMaxWarps][5];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  // ---- 1. input projections for the whole chunk ------------------------
  for (int i = tid; i < d; i += nthreads) {
    cols[i] = tf0T[(size_t)i * k + j];
    cols[d + i] = tf1T[(size_t)i * k + j];
  }
  for (int i = tid; i < N; i += nthreads) {
    cols[2 * d + i] = velT_T[(size_t)i * k + j];
  }
  __syncthreads();
  float* xc0 = xs + (size_t)j * 3 * T;
  float* xc1 = xc0 + T;
  float* xv = xc1 + T;
  for (int t = tid; t < T; t += nthreads) {
    const float* cr = corr + (size_t)t * d;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < d; ++i) {
      const float x = cr[i];
      s0 = fmaf(x, cols[i], s0);
      s1 = fmaf(x, cols[d + i], s1);
    }
    const float* vr = vel + (size_t)t * N;
    for (int i = 0; i < N; ++i) s2 = fmaf(vr[i], cols[2 * d + i], s2);
    xc0[t] = s0;
    xc1[t] = s1;
    xv[t] = s2;
  }

  // ---- 2. neuron state and parameters into registers ---------------------
  float e0[NPT], e1[NPT], e2[NPT], bs[NPT];
  float r0[NPT], r1[NPT], r2[NPT], o0[NPT], o1[NPT];
  float v[NPT], rf[NPT];
#pragma unroll
  for (int s = 0; s < NPT; ++s) {
    const int i = tid + s * nthreads;
    const bool ok = i < n;
    const size_t at = (size_t)(ok ? i : 0) * k + j;
    e0[s] = ok ? enc0[at] : 0.f;
    e1[s] = ok ? enc1[at] : 0.f;
    e2[s] = ok ? enc2[at] : 0.f;
    bs[s] = ok ? bias[at] : 0.f;
    r0[s] = ok ? drec0[at] : 0.f;
    r1[s] = ok ? drec1[at] : 0.f;
    r2[s] = ok ? drec2[at] : 0.f;
    o0[s] = ok ? dout0[at] : 0.f;
    o1[s] = ok ? dout1[at] : 0.f;
    v[s] = ok ? volt_in[at] : 0.f;
    rf[s] = ok ? refr_in[at] : 0.f;
  }
  float f0 = f0_in[j], f1 = f1_in[j], f2 = f2_in[j];
  float g0 = fo_in[j], g1 = fo_in[k + j];
  const float dcm = dc_mask[j];
  __syncthreads();  // the block's scratch rows are written

  // ---- 3. the time loop ----------------------------------------------------
  float nc0 = xc0[0], nc1 = xc1[0], ncv = xv[0];
  int buf = 0;
  for (int t = 0; t < T; ++t) {
    const float c0 = nc0, c1 = nc1, cv = ncv;
    if (t + 1 < T) {  // prefetch the next step's inputs
      nc0 = xc0[t + 1];
      nc1 = xc1[t + 1];
      ncv = xv[t + 1];
    }
    const float x0 = (f0 + c0) + dcm;
    const float x1 = f1 + c1;
    const float x2 = f2 + cv;

    // Branch-free, as the Pallas kernel is: the NPT neurons of a thread are
    // independent chains the compiler can interleave.  A padding slot
    // (i >= n) has zero parameters, so J = 0, it never spikes and adds 0.
    float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
      const float J = e0[s] * x0 + e1[s] * x1 + e2[s] * x2 + bs[s];
      const float refr = rf[s] - c.dt;
      const float delta_t = fminf(fmaxf(c.dt - refr, 0.f), c.dt);
      const float volt = v[s] + (J - v[s]) * -expm1f(-delta_t / c.tau_rc);
      const bool spiked = volt > 1.f;
      const float denom = spiked ? fmaxf(J - 1.f, 1e-12f) : 1.f;
      const float over = fminf(fmaxf((volt - 1.f) / denom, 0.f), 1.f - 1e-6f);
      const float t_spike = c.dt + c.tau_rc * log1pf(-over);
      const float act = spiked ? c.spike_out : 0.f;
      v[s] = spiked ? 0.f : fmaxf(volt, 0.f);
      rf[s] = spiked ? c.tau_ref + t_spike : refr;
      p[0] += act * r0[s];
      p[1] += act * r1[s];
      p[2] += act * r2[s];
      p[3] += act * o0[s];
      p[4] += act * o1[s];
    }

    warp_sum5(p);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 5; ++q) red[buf][warp][q] = p[q];
    }
    __syncthreads();
    float r[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) r[q] = lane < nwarps ? red[buf][lane][q] : 0.f;
    warp_sum5(r);
    buf ^= 1;  // the next step writes the other buffer (see the header)

    f0 = c.a_rec * f0 + c.b_rec * r[0];
    f1 = c.a_rec * f1 + c.b_rec * r[1];
    f2 = c.a_rec * f2 + c.b_rec * r[2];
    g0 = c.a_out * g0 + c.b_out * r[3];
    g1 = c.a_out * g1 + c.b_out * r[4];
    if (tid == 0) {
      out[(size_t)t * 2 * k + j] = g0;
      out[(size_t)t * 2 * k + k + j] = g1;
    }
  }

#pragma unroll
  for (int s = 0; s < NPT; ++s) {
    const int i = tid + s * nthreads;
    if (i < n) {
      volt_out[(size_t)i * k + j] = v[s];
      refr_out[(size_t)i * k + j] = rf[s];
    }
  }
  if (tid == 0) {
    f0_out[j] = f0;
    f1_out[j] = f1;
    f2_out[j] = f2;
    fo_out[j] = g0;
    fo_out[k + j] = g1;
  }
}

template <int NPT>
cudaError_t launch(int threads, size_t smem, cudaStream_t stream,
                   const float* const* in, float* const* outp, int n, int k,
                   int d, int N, int T, Consts c) {
  vco_scan_kernel<NPT><<<k, threads, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9],
      in[10], in[11], in[12], in[13], in[14], in[15], in[16], in[17], in[18],
      in[19], in[20], outp[0], outp[1], outp[2], outp[3], outp[4], outp[5],
      outp[6], outp[7], n, k, d, N, T, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in:  enc0 enc1 enc2 bias drec0 drec1 drec2 dout0 dout1 (n, k), dc_mask
//      (k), tf0T tf1T (d, k), velT_T (N, k), vel (T, N), corr (T, d),
//      voltage refractory (n, k), f0 f1 f2 (k), fo (2k)        -- 21 pointers
// out: rows (T, 2k), voltage refractory (n, k), f0 f1 f2 (k), fo (2k),
//      scratch (k, 3, T)                                       --  8 pointers
// Returns 0 or the CUDA error of the launch.
int vco_scan_launch(const void* const* in, void* const* outp, int n, int k,
                    int d, int N, int T, float a_rec, float b_rec,
                    float a_out, float b_out, float tau_rc, float tau_ref,
                    float dt, float spike_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || k < 1 || T < 1 || d < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const Consts c{a_rec, b_rec, a_out, b_out, tau_rc, tau_ref, dt, spike_out};
  // the fewest neurons per thread that keep a block within kMaxThreads; at
  // most kMaxNpt, the variants that have run on the card (n <= 2,048)
  int npt = 1;
  while (npt < kMaxNpt && (n + npt - 1) / npt > kMaxThreads) npt *= 2;
  if ((n + npt - 1) / npt > kMaxThreads) return (int)cudaErrorInvalidValue;
  const int threads = ((n + npt - 1) / npt + 31) / 32 * 32;
  const size_t smem = (size_t)(2 * d + N) * sizeof(float);
  const float* const* fin = reinterpret_cast<const float* const*>(in);
  float* const* fout = reinterpret_cast<float* const*>(outp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (npt) {
    case 1: return (int)launch<1>(threads, smem, s, fin, fout, n, k, d, N, T, c);
    case 2: return (int)launch<2>(threads, smem, s, fin, fout, n, k, d, N, T, c);
    default: return (int)launch<4>(threads, smem, s, fin, fout, n, k, d, N, T, c);
  }
}

const char* vco_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
