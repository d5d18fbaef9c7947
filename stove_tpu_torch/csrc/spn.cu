// Fused RAT-SPN forward for Hopper (sm_90a): x, w (B, V) f32 -> (B,) log p.
//
// Replaces: stove_tpu/ops/pallas_spn.py::spn_log_prob_fused (the Pallas
// kernel _make_kernel around spn_tile_body).  Same contract as
// models/spn.py::spn_log_prob with a per-variable weight: every activation
// from the Gaussian leaves to the root stays in shared memory; device
// memory sees x, w and the packed parameters in and one float per sample
// out.
//
// Bound on this card.  At the training shapes (object SPN: 6144 patches of
// V=100; background SPN: 2048 frames of V=1024) the inputs are 4.9 MB and
// 16.8 MB, 1.5 us and 5.0 us at 3.35 TB/s; the arithmetic (6 operations
// a leaf term, the mixtures, exps) is 0.48 GFLOP, 7.2 us at the f32
// CUDA-core rate: the pair is bound by its operations.  Read once a sample, the parameters alone would be 0.4 GB and 0.4
// GB through L2: the design reads them once a block (spn_tile.cuh).
//
// Design.  SPN_TB samples a block (ops/fused_spn.py::TILE), SPN_THREADS
// threads: the block starts loading the first slot of parameters, stages its
// samples' x and w with 16-byte cp.async copies (rows past B zeroed), and
// runs the shared evaluator SpnTile (spn_tile.cuh).  Shapes are
// compile-time (-DSPN_V, _R, _D, _I, _S, _TB): one library per SPN
// shape.  The library also exports the packing kernel that lays the
// parameters out for the evaluator (one launch).

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
#ifndef SPN_TB
#define SPN_TB 8
#endif

namespace {

using Tile = SpnTile<SPN_V, SPN_R, SPN_D, SPN_I, SPN_S, SPN_TB>;
constexpr int XROWS = Tile::NSP * Tile::XS;              // floats of x (and of w)
constexpr size_t SMEM_FLOATS = 2 * SPN_CHUNK + 2 * XROWS + Tile::SCRATCH + spn_r4(Tile::NSP);
constexpr size_t SMEM_BYTES = sizeof(float) * SMEM_FLOATS;
static_assert(SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

__global__ void __launch_bounds__(SPN_THREADS)
spn_kernel(const float* __restrict__ x, const float* __restrict__ w, int B,
           const float* __restrict__ gp, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    float* xs = ring + 2 * SPN_CHUNK;
    float* ws = xs + XROWS;
    float* scratch = ws + XROWS;
    float* res = scratch + Tile::SCRATCH;
    Tile::prefetch(gp, ring);
    const int b0 = blockIdx.x * SPN_TB, nb = min(SPN_TB, B - b0);
    if constexpr (SPN_V % 4 == 0) {
        constexpr int V4 = SPN_V / 4;
        for (int f = threadIdx.x; f < Tile::NSP * V4; f += SPN_THREADS) {
            const int n = f / V4, c = 4 * (f % V4);
            if (n < nb) {
                spn_cp16(xs + n * Tile::XS + c, x + (size_t)(b0 + n) * SPN_V + c);
                spn_cp16(ws + n * Tile::XS + c, w + (size_t)(b0 + n) * SPN_V + c);
            } else {
                *reinterpret_cast<float4*>(xs + n * Tile::XS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
                *reinterpret_cast<float4*>(ws + n * Tile::XS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
    } else {
        for (int f = threadIdx.x; f < Tile::NSP * SPN_V; f += SPN_THREADS) {
            const int n = f / SPN_V, v = f % SPN_V;
            xs[n * Tile::XS + v] = n < nb ? x[(size_t)(b0 + n) * SPN_V + v] : 0.f;
            ws[n * Tile::XS + v] = n < nb ? w[(size_t)(b0 + n) * SPN_V + v] : 0.f;
        }
    }
    spn_commit();
    Tile::run(xs, ws, gp, ring, scratch, res);
    if ((int)threadIdx.x < nb) out[b0 + threadIdx.x] = res[threadIdx.x];
}

__global__ void __launch_bounds__(256) spn_pack_kernel(SpnSrc src, float* __restrict__ out) {
    const int idx = blockIdx.x * 256 + threadIdx.x;
    if (idx < Tile::PACK_ITEMS) Tile::pack(idx, src, out);
}

}  // namespace

extern "C" {

int stove_spn_smem_bytes() { return (int)SMEM_BYTES; }
int stove_spn_floats() { return Tile::FLOATS; }

// Launches on `stream`; returns the CUDA error code (0 = ok).  Pointers are
// device pointers; `gp` is the packed buffer stove_spn_pack writes (16-byte
// aligned, as are x and w).
cudaError_t stove_spn_launch(const float* x, const float* w, int B, const float* gp, float* out,
                             void* stream) {
    if (B <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(spn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const int grid = (B + SPN_TB - 1) / SPN_TB;
    spn_kernel<<<grid, SPN_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(x, w, B, gp, out);
    return cudaGetLastError();
}

// The packed buffer (stove_spn_floats() floats) from the SPN's parameters:
// mu, raw std (R, V, I), perm (R, V) int32, the D sum-logit tensors for
// d = D-1 .. 0 (unused slots null), the root logits; sd = min_std + span *
// sigmoid(raw).
cudaError_t stove_spn_pack(const float* mu, const float* raw, const int* perm, const float* l0,
                           const float* l1, const float* l2, const float* l3, const float* root,
                           float min_std, float span, float* out, void* stream) {
    const SpnSrc src{mu, raw, perm, {l0, l1, l2, l3}, root, min_std, span};
    spn_pack_kernel<<<(Tile::PACK_ITEMS + 255) / 256, 256, 0, (cudaStream_t)stream>>>(src, out);
    return cudaGetLastError();
}

}  // extern "C"
