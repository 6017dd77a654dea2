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
// What bounds it.  Every neuron needs 10 float32 operations a step (the
// currents 6, an FMA counted as two; the voltage 3; the refractory clock
// 1), and each spike 15 more (the spike time: J - 1, volt - 1, a division,
// log1pf and its FMA, + tau_ref; the one step after it whose decay factor
// is not a constant: dt - refr, a division, expm1f; its five decoder
// values added to the decodes, which a silent neuron adds nothing to);
// compares, selects and min/max are not counted.
// At ssp_dim 97 (k = 49 oscillators of n = 800), with the 0.095 spikes
// per neuron and step of the main path's first chunk, that is about 4.9
// GFLOP per 10,000-step chunk with the projections, about 0.073 ms at the
// card's 67 TFLOP/s; it moves about 10 MB (0.003 ms at 3.35 TB/s), so
// operations set the bound (chip_smoke.py: bound_ms, from the spikes of
// its run).
// What holds the kernel far above it is that a step is a serial chain
// within each oscillator: the five population decodes must be complete
// before the next step's currents.  On one SM per oscillator the chain is
// the LIF instructions of all n neurons, then a block reduction, and only
// k of the card's 132 SMs work.
//
// Design: one oscillator per thread-block cluster of C CTAs (C = 1 or 4;
// one template).  The input projections are hoisted out of the time loop,
// so oscillators never interact inside a chunk and clusters need no
// synchronisation between them.  CTA rank r of cluster j owns neurons
// [r * ceil(n / C), ...) of oscillator j, so each SM runs 1/C of the
// oscillator's neuron instructions.  A CTA:
//   1. prologue: projects its share of the chunk's corrections (T, d) and
//      velocities (T, N) onto oscillator j (columns j of tf0T, tf1T,
//      velT_T) into the oscillator's scratch xs[j] = (xc0, xc1, xv), each
//      (T,); a cluster barrier then publishes all T rows to every rank;
//   2. loads its neurons' voltage, refractory time and 9 parameters into
//      registers, NPT neurons per thread;
//   3. runs the time loop.  The chain part of a step is the currents, the
//      new voltages, the spikes and the five decode sums: a warp butterfly,
//      then lanes 0..C-1 of every warp send the warp's five sums with
//      st.async through distributed shared memory into slot (rank, warp) of
//      every CTA of the cluster.  Each store completes on the receiving
//      CTA's mbarrier for that step (complete_tx), and thread 0 of each CTA
//      arrives on it once, announcing the C x nwarps x 20 bytes to come.
//      The sender neither waits nor fences: the same kernel with a split
//      cluster barrier (barrier.cluster.arrive.release / wait.acquire) in
//      place of the mbarrier measured 0.28-0.36 us slower per step at
//      n = 32 (PERF.md), presumably because a release waits for the step's
//      prefetch loads and output stores still in flight.  While the
//      exchange lands, each thread finishes its neurons' LIF update off the
//      chain (reset, refractory time, the next step's decay factor: both
//      divisions, expm1f and log1pf).  After the mbarrier's phase completes
//      (acquire), lane l of every warp of every CTA adds slots l, l+32, ...
//      and a warp butterfly sums the lanes: the same data in the same lanes,
//      so every thread of the cluster holds bit-identical sums and keeps an
//      identical copy of the filter state; no atomics, so a run is
//      deterministic.  Slots and mbarriers are double-buffered by step
//      parity.  A CTA sends step t+2's sums only after its step t+1 phase
//      completed, which needs every warp's step t+1 sums, computed from
//      that warp's step t reads: so no slot is overwritten before it is read.
//   Rank 0, thread 0 writes out[t, j], out[t, k+j] and the final filters;
//   every rank writes back its own neurons' voltage and refractory time.
// The DC oscillator's pin (dc_mask, zeroed recurrent decoders) is data.
// The host side picks C (ops/vco_scan.py: _cluster_size).  Clusters never
// wait on one another, so a grid of more clusters than fit at once runs in
// waves; the hardware co-schedules the C CTAs of each cluster.

#include <cuda_runtime.h>

namespace {

// At most 512 threads per CTA: at n = 800 on one CTA that is 2 neurons per
// thread, 13 warps, which measured faster on an H100 than 4 per thread at
// 256 or 1 per thread at 1024 (PERF.md).
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// Neurons per thread: 1, 2 or 4, so at most 2,048 neurons per CTA.
constexpr int kMaxNpt = 4;
// Floats per exchanged partial: the five sums, padded to two float4.
constexpr int kSlot = 8;
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

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The whole cluster, once, around the prologue (release / acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// This CTA's one arrival on `bar` for the current phase, announcing the
// bytes that the cluster's st.async stores will deliver to it.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Spins until the phase of `bar` with this parity has completed: the
// arrival is in and every announced byte has landed (acquire, cluster).
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n\t"
      ".reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT;\n\t"
      "}" :: "r"(bar), "r"(parity) : "memory");
}

// Five sums (20 bytes) into the slot at shared address `slot` of CTA `rank`
// of the cluster, completing on that CTA's mbarrier at address `bar`
// (st.async: the sender does not wait, and no fence orders it).
__device__ __forceinline__ void send_slot(unsigned slot, unsigned bar,
                                          unsigned rank,
                                          const float (&p)[5]) {
  unsigned rslot, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rslot) : "r"(slot), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rbar) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%6];\n\t"
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0+16], %5, [%6];"
      :: "r"(rslot), "f"(p[0]), "f"(p[1]), "f"(p[2]), "f"(p[3]), "f"(p[4]),
         "r"(rbar)
      : "memory");
}

// -expm1(-delta_t / tau_rc) for the refractory clock `refr` (= rf - dt): the
// voltage update's decay factor, a function of the state alone.
__device__ __forceinline__ float decay(float refr, const Consts& c) {
  const float delta_t = fminf(fmaxf(c.dt - refr, 0.f), c.dt);
  return -expm1f(-delta_t / c.tau_rc);
}

template <int NPT, int C>
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
  // [step parity][source rank * nwarps + source warp][five sums], and the
  // mbarrier that completes when a step's slots have all landed
  __shared__ __align__(16) float xch[2][C * kMaxWarps][kSlot];
  __shared__ __align__(8) unsigned long long full[2];

  const unsigned rank = C == 1 ? 0u : cluster_rank();
  const int j = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int per = (n + C - 1) / C;  // neurons per CTA; rank r owns r*per..
  const int lo = static_cast<int>(rank) * per;

  if (tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // ---- 1. input projections for the whole chunk, shared across ranks ----
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
  for (int t = static_cast<int>(rank) * nthreads + tid; t < T;
       t += C * nthreads) {
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
  float v[NPT], rf[NPT], refr[NPT], dec[NPT];
#pragma unroll
  for (int s = 0; s < NPT; ++s) {
    const int il = tid + s * nthreads;
    const int i = lo + il;
    const bool ok = il < per && i < n;
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
    refr[s] = rf[s] - c.dt;
    dec[s] = decay(refr[s], c);
  }
  float f0 = f0_in[j], f1 = f1_in[j], f2 = f2_in[j];
  float g0 = fo_in[j], g1 = fo_in[k + j];
  const float dcm = dc_mask[j];
  // every rank's scratch rows are written, and every CTA of the cluster has
  // started and initialised its mbarriers (its slots may be sent to now)
  cluster_sync();

  // ---- 3. the time loop ----------------------------------------------------
  const unsigned bytes = 5 * sizeof(float) * C * nwarps;  // per CTA and step
  float nc0 = xc0[0], nc1 = xc1[0], ncv = xv[0];
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    const unsigned bar = smem_addr(&full[buf]);
    const float c0 = nc0, c1 = nc1, cv = ncv;
    if (t + 1 < T) {  // prefetch the next step's inputs
      nc0 = xc0[t + 1];
      nc1 = xc1[t + 1];
      ncv = xv[t + 1];
    }
    const float x0 = (f0 + c0) + dcm;
    const float x1 = f1 + c1;
    const float x2 = f2 + cv;

    // The chain: currents, voltages, spikes, the five partial decodes.
    // Branch-free, as the Pallas kernel is: the NPT neurons of a thread are
    // independent chains the compiler can interleave.  A padding slot has
    // zero parameters, so J = 0, it never spikes and adds 0.
    float J[NPT], volt[NPT];
    float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
      J[s] = e0[s] * x0 + e1[s] * x1 + e2[s] * x2 + bs[s];
      volt[s] = v[s] + (J[s] - v[s]) * dec[s];
      const float act = volt[s] > 1.f ? c.spike_out : 0.f;
      p[0] += act * r0[s];
      p[1] += act * r1[s];
      p[2] += act * r2[s];
      p[3] += act * o0[s];
      p[4] += act * o1[s];
    }
    warp_sum5(p);
    if (tid == 0) mbar_expect(bar, bytes);
    if (lane < C) {
      send_slot(smem_addr(&xch[buf][static_cast<int>(rank) * nwarps + warp]),
                bar, lane, p);
    }

    // Off the chain, while the exchange completes: the rest of the LIF
    // update (the executor's formulas) and the next step's decay factor.
#pragma unroll
    for (int s = 0; s < NPT; ++s) {
      const bool spiked = volt[s] > 1.f;
      const float denom = spiked ? fmaxf(J[s] - 1.f, 1e-12f) : 1.f;
      const float over =
          fminf(fmaxf((volt[s] - 1.f) / denom, 0.f), 1.f - 1e-6f);
      const float t_spike = c.dt + c.tau_rc * log1pf(-over);
      v[s] = spiked ? 0.f : fmaxf(volt[s], 0.f);
      rf[s] = spiked ? c.tau_ref + t_spike : refr[s];
      refr[s] = rf[s] - c.dt;
      dec[s] = decay(refr[s], c);
    }

    mbar_wait(bar, (t >> 1) & 1);
    // Lane l of every warp of the cluster holds slots l, l + 32, ... and the
    // butterfly sums them: the same data in the same lanes, the same sums.
    float r[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int src = lane; src < C * nwarps; src += 32) {
      const float4 a = *reinterpret_cast<const float4*>(&xch[buf][src][0]);
      r[0] += a.x;
      r[1] += a.y;
      r[2] += a.z;
      r[3] += a.w;
      r[4] += xch[buf][src][4];
    }
    warp_sum5(r);

    f0 = c.a_rec * f0 + c.b_rec * r[0];
    f1 = c.a_rec * f1 + c.b_rec * r[1];
    f2 = c.a_rec * f2 + c.b_rec * r[2];
    g0 = c.a_out * g0 + c.b_out * r[3];
    g1 = c.a_out * g1 + c.b_out * r[4];
    if (rank == 0 && tid == 0) {
      out[(size_t)t * 2 * k + j] = g0;
      out[(size_t)t * 2 * k + k + j] = g1;
    }
  }
  // A CTA may exit now: every byte the cluster sends into its shared memory
  // belongs to a step whose phase it has waited for.

#pragma unroll
  for (int s = 0; s < NPT; ++s) {
    const int il = tid + s * nthreads;
    const int i = lo + il;
    if (il < per && i < n) {
      volt_out[(size_t)i * k + j] = v[s];
      refr_out[(size_t)i * k + j] = rf[s];
    }
  }
  if (rank == 0 && tid == 0) {
    f0_out[j] = f0;
    f1_out[j] = f1;
    f2_out[j] = f2;
    fo_out[j] = g0;
    fo_out[k + j] = g1;
  }
}

struct Launch {
  const float* const* in;
  float* const* out;
  int n, k, d, N, T;
  Consts c;
  int threads;
  size_t smem;
  cudaStream_t stream;
};

template <int NPT, int C>
cudaError_t go(const Launch& L) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(L.k * C);
  cfg.blockDim = dim3(L.threads);
  cfg.dynamicSmemBytes = L.smem;
  cfg.stream = L.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* const* in = L.in;
  float* const* o = L.out;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, vco_scan_kernel<NPT, C>, in[0], in[1], in[2], in[3], in[4],
      in[5], in[6], in[7], in[8], in[9], in[10], in[11], in[12], in[13],
      in[14], in[15], in[16], in[17], in[18], in[19], in[20], o[0], o[1],
      o[2], o[3], o[4], o[5], o[6], o[7], L.n, L.k, L.d, L.N, L.T, L.c);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int C>
cudaError_t go_npt(int npt, const Launch& L) {
  switch (npt) {
    case 1: return go<1, C>(L);
    case 2: return go<2, C>(L);
    default: return go<4, C>(L);
  }
}

// Fills the launch shape of (n, cluster); false if the kernel has no variant
// for it.  Neurons per thread: the fewest that keep a CTA of ceil(n / C)
// neurons within kMaxThreads, at most kMaxNpt (the variants that have run on
// the card).
bool shape(int n, int d, int N, int cluster, Launch* L, int* npt) {
  if (n < 1 || d < 1 || N < 1) return false;
  if (cluster != 1 && cluster != 4) return false;
  const int per = (n + cluster - 1) / cluster;
  int p = 1;
  while (p < kMaxNpt && (per + p - 1) / p > kMaxThreads) p *= 2;
  if ((per + p - 1) / p > kMaxThreads) return false;
  *npt = p;
  L->threads = ((per + p - 1) / p + 31) / 32 * 32;
  L->smem = (size_t)(2 * d + N) * sizeof(float);
  return true;
}

cudaError_t dispatch(int npt, int cluster, const Launch& L) {
  return cluster == 1 ? go_npt<1>(npt, L) : go_npt<4>(npt, L);
}

}  // namespace

extern "C" {

// in:  enc0 enc1 enc2 bias drec0 drec1 drec2 dout0 dout1 (n, k), dc_mask
//      (k), tf0T tf1T (d, k), velT_T (N, k), vel (T, N), corr (T, d),
//      voltage refractory (n, k), f0 f1 f2 (k), fo (2k)        -- 21 pointers
// out: rows (T, 2k), voltage refractory (n, k), f0 f1 f2 (k), fo (2k),
//      scratch (k, 3, T)                                       --  8 pointers
// cluster: CTAs per oscillator, 1 or 4.
// Returns 0 or the CUDA error of the launch.
int vco_scan_launch(const void* const* in, void* const* outp, int n, int k,
                    int d, int N, int T, float a_rec, float b_rec,
                    float a_out, float b_out, float tau_rc, float tau_ref,
                    float dt, float spike_out, int cluster, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Launch L{};
  int npt = 0;
  if (k < 1 || T < 1 || !shape(n, d, N, cluster, &L, &npt))
    return (int)cudaErrorInvalidValue;
  L.in = reinterpret_cast<const float* const*>(in);
  L.out = reinterpret_cast<float* const*>(outp);
  L.n = n;
  L.k = k;
  L.d = d;
  L.N = N;
  L.T = T;
  L.c = Consts{a_rec, b_rec, a_out, b_out, tau_rc, tau_ref, dt, spike_out};
  L.stream = static_cast<cudaStream_t>(stream);
  return (int)dispatch(npt, cluster, L);
}

const char* vco_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
