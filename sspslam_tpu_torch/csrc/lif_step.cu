// One dt of a LIF ensemble group for Hopper (sm_90a): the spiking LIF
// update of sspslam_tpu_torch/ops/neurons.py (_lif_step_plain) in one
// launch, where the ATen chain it stands for launches 30 kernels.
//
// What bounds it.  It reads J, voltage and refractory time and writes the
// new voltage, refractory time and output: 24 bytes a neuron, 0.94 MB for
// the 39,200 LIF of the SLAM network's VCO bank (0.28 us at 3.35 TB/s).  At
// the SLAM network's group sizes (970 to 39,200 neurons) the launch's
// latency, not its bytes, sets its time.
//
// Design: one thread per neuron of the flat, contiguous group, so (n,),
// (k, n) and a rank's rows of either take the same launch.  The arithmetic
// is the chain's, op for op, in float32, so the results are bitwise those
// of the ATen kernels on the card:
//   - every add, subtract, multiply and divide is a round-to-nearest
//     intrinsic, which nvcc never contracts into an FMA (ATen's kernels each
//     do one operation, so nothing of the chain is fused);
//   - expm1f and log1pf are the functions ATen's expm1 and log1p kernels
//     call for float32 (the library is built with nvcc's default flags, as
//     ATen is: no fast math, denormals kept);
//   - a tensor divided by a Python scalar is, in ATen's CUDA kernel, a
//     multiply by the scalar's float32 reciprocal computed on the host:
//     inv_tau_rc is that reciprocal, computed by the caller;
//   - the other Python constants enter as ATen converts them: rounded to
//     float32 (dt, tau_rc, tau_ref, amplitude / dt, 1e-12, 1 - 1e-6,
//     min_voltage);
//   - torch.clamp returns a NaN input unchanged and is otherwise
//     min(max(v, lo), hi).
// The spike-time terms are computed for every neuron and selected, as the
// chain's torch.where does.

#include <cuda_runtime.h>

namespace {

struct Consts {
  float dt, inv_tau_rc, tau_rc, tau_ref, spike_out, min_voltage, min_jm1,
      max_overshoot;
};

__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__global__ void lif_step_kernel(const float* __restrict__ J,
                                const float* __restrict__ volt,
                                const float* __restrict__ refr,
                                float* __restrict__ volt_out,
                                float* __restrict__ refr_out,
                                float* __restrict__ out, long long n,
                                Consts c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float j = J[i];
  const float v0 = volt[i];
  // refractory = refractory - dt; delta_t = clip(dt - refractory, 0, dt)
  const float r = __fsub_rn(refr[i], c.dt);
  const float delta_t = clamp(__fsub_rn(c.dt, r), 0.f, c.dt);
  // voltage + (J - voltage) * -expm1(-delta_t / tau_rc)
  const float decay = -expm1f(__fmul_rn(-delta_t, c.inv_tau_rc));
  const float v = __fadd_rn(v0, __fmul_rn(__fsub_rn(j, v0), decay));
  const bool spiked = v > 1.f;
  // the spike time within the step
  const float denom = spiked ? clamp_lo(__fsub_rn(j, 1.f), c.min_jm1) : 1.f;
  const float over =
      clamp(__fdiv_rn(__fsub_rn(v, 1.f), denom), 0.f, c.max_overshoot);
  const float t_spike = __fadd_rn(__fmul_rn(log1pf(-over), c.tau_rc), c.dt);
  out[i] = spiked ? c.spike_out : 0.f;
  volt_out[i] = spiked ? 0.f : clamp_lo(v, c.min_voltage);
  refr_out[i] = spiked ? __fadd_rn(t_spike, c.tau_ref) : r;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" {

// in:  J, voltage, refractory (n floats each); out: voltage, refractory,
// output (n floats each, allocated by the caller); the constants as above.
// Returns 0 or the CUDA error of the launch.  Allocates nothing and does not
// synchronise, so a stream capture may record the launch.
int lif_step_launch(const float* J, const float* volt, const float* refr,
                    float* volt_out, float* refr_out, float* out,
                    long long n, float dt, float inv_tau_rc, float tau_rc,
                    float tau_ref, float spike_out, float min_voltage,
                    float min_jm1, float max_overshoot, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1) return (int)cudaErrorInvalidValue;
  const Consts c{dt,          inv_tau_rc, tau_rc,  tau_ref,
                 spike_out,   min_voltage, min_jm1, max_overshoot};
  const long long blocks = (n + kThreads - 1) / kThreads;
  lif_step_kernel<<<(unsigned)blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      J, volt, refr, volt_out, refr_out, out, n, c);
  return (int)cudaGetLastError();
}

const char* lif_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
