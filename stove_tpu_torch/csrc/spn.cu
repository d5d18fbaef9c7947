// Fused RAT-SPN forward for Hopper (sm_90a): x, w (B, V) f32 -> (B,) log p.
//
// Replaces: stove_tpu/ops/pallas_spn.py::spn_log_prob_fused (the Pallas
// kernel _make_kernel around spn_tile_body).  Same contract as
// models/spn.py::spn_log_prob with a per-variable weight: every activation
// from the Gaussian leaves to the root stays in shared memory; device
// memory sees x and w in and one float per sample out.
//
// Bound on this card.  At the training shapes (object SPN: 6144 patches of
// V=100; background SPN: 2048 frames of V=1024) the inputs are 4.9 MB and
// 16.8 MB, 1.5 us and 5.0 us at 3.35 TB/s, and the arithmetic (leaf terms,
// mixtures, exps) is a few hundred MFLOP, a few us at the f32 CUDA-core
// rate: the kernel is bound by latency, not by bytes or operations.
//
// Design.  One warp per sample, WPB warps per block: the warp stages the
// sample's x and w in shared memory (coalesced), then runs the shared
// device function Spn::log_prob (spn_tile.cuh): lanes over the (r, l, i)
// leaf sums and the (r, p, s) mixtures, parameters through L1.  No block-
// wide barrier, so a warp whose sample lies past B simply exits.  Shapes
// are compile-time (-DSPN_V, _R, _D, _I, _S): one library per SPN shape.

#include "spn_tile.cuh"

#ifndef SPN_V
#define SPN_V 100
#endif
#ifndef SPN_R
#define SPN_R 4
#endif
#ifndef SPN_D
#define SPN_D 2
#endif
#ifndef SPN_I
#define SPN_I 10
#endif
#ifndef SPN_S
#define SPN_S 10
#endif

namespace {

constexpr int WPB = 4;                                   // warps per block
using SpnT = Spn<SPN_V, SPN_R, SPN_D, SPN_I, SPN_S>;
constexpr int PER_WARP = (2 * SPN_V + SpnT::SCRATCH + 3) / 4 * 4;
constexpr size_t SMEM_BYTES = sizeof(float) * WPB * PER_WARP;
static_assert(SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

__global__ void __launch_bounds__(32 * WPB)
spn_kernel(const float* __restrict__ x, const float* __restrict__ w, int B,
           SpnParams p, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x * WPB + warp;
    if (b >= B) return;
    float* xs = reinterpret_cast<float*>(smem4) + warp * PER_WARP;
    float* ws = xs + SPN_V;
    float* scratch = ws + SPN_V;
    for (int v = lane; v < SPN_V; v += 32) {
        xs[v] = x[(size_t)b * SPN_V + v];
        ws[v] = w[(size_t)b * SPN_V + v];
    }
    __syncwarp();
    const float lp = SpnT::log_prob(xs, ws, p, scratch, lane);
    if (lane == 0) out[b] = lp;
}

}  // namespace

extern "C" {

int stove_spn_smem_bytes() { return (int)SMEM_BYTES; }

// Launches on `stream`; returns the CUDA error code (0 = ok).  Pointers are
// device pointers laid out by ops/fused_spn.py::prepare.
cudaError_t stove_spn_launch(const float* x, const float* w, int B,
                             const int* perm, const int* bounds,
                             const float* mu, const float* sd,
                             const float* logsd, const float* sumw,
                             const float* root, float* out, void* stream) {
    if (B <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        spn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const SpnParams p{perm, bounds, mu, sd, logsd, sumw, root};
    const int grid = (B + WPB - 1) / WPB;
    spn_kernel<<<grid, 32 * WPB, SMEM_BYTES, (cudaStream_t)stream>>>(x, w, B, p, out);
    return cudaGetLastError();
}

}  // extern "C"
