// Fused SuPAIR likelihood for Hopper (sm_90a):
// frames (B, H, W) f32, boxes (B, O, 4) f32 -> (B,) log p(x | z_where).
//
// Replaces: stove_tpu/ops/pallas_likelihood.py::likelihood_fused (the
// Pallas kernel _make_kernel with _edge and pallas_spn.spn_tile_body).
// Same contract as models/supair.py::likelihood on the patch-space overlap
// path: per frame, O bilinear PxP glimpses from hat weights on the
// linspace(-1, 1, P) grid (align_corners=True, border clamp), each object's
// claim weights 1 - max over earlier objects of their separable sigmoid box
// edges at its own sample points (clipped to [0, 1]), background visibility
// 1 - max over objects of their coverage on the pixel grid, then the object
// SPN on each patch and the background SPN on the frame, summed.  Nothing
// between the frame and its log-density touches device memory.
//
// Bound on this card.  At the training shape (2048 frames of 32x32, 3
// boxes) the inputs are 8.4 MB, 2.5 us at 3.35 TB/s; the arithmetic (three
// object SPNs of 4,000 leaf terms, one background SPN of 12,288, the
// glimpses and edges) is under 1 GFLOP, ~10 us at the f32 CUDA-core rate.
// The kernel is bound by latency.
//
// Design.  One warp per frame, WPB warps per block, no block-wide barrier.
// The warp stages the frame in shared memory, computes the background
// weights for all 1024 pixels, then per object the 100 patch values
// (bilinear: the two hat taps per axis that can be nonzero, with the same
// weights max(0, 1 - |c - src|) the dense matmuls use) and the claim
// weights, and calls the shared SPN device function (spn_tile.cuh) on the
// patch and on the frame.  The patch grid and the pixel grid come from the
// wrapper (torch.linspace), so both versions sample at the same points.
// Shapes are compile-time: -DLIK_O, -DLIK_P, -DLIK_IMG, the two SPN shapes
// -DOBJ_* and -DBG_*, and -DLIK_OVERLAP (overlap_correction and O > 1;
// without it the claim weights are 1 and the background weight is
// prod_o (1 - cover_o), as in glimpse.background_visibility).

#include "spn_tile.cuh"

#ifndef LIK_O
#define LIK_O 3
#endif
#ifndef LIK_P
#define LIK_P 10
#endif
#ifndef LIK_IMG
#define LIK_IMG 32
#endif
#ifndef LIK_OVERLAP
#define LIK_OVERLAP 1
#endif
#ifndef OBJ_R
#define OBJ_V 100
#define OBJ_R 4
#define OBJ_D 2
#define OBJ_I 10
#define OBJ_S 10
#endif
#ifndef BG_R
#define BG_V 1024
#define BG_R 2
#define BG_D 3
#define BG_I 6
#define BG_S 6
#endif

namespace {

constexpr int O = LIK_O;
constexpr int P = LIK_P;
constexpr int IMG = LIK_IMG;
constexpr int V = IMG * IMG;
constexpr int PP = P * P;
constexpr int WPB = 4;                                   // warps per block
using ObjSpn = Spn<OBJ_V, OBJ_R, OBJ_D, OBJ_I, OBJ_S>;
using BgSpn = Spn<BG_V, BG_R, BG_D, BG_I, BG_S>;
static_assert(OBJ_V == PP && BG_V == V, "SPN widths must match patch and frame");
static_assert(IMG >= 2 && P >= 2, "frames and patches need two samples a side");
constexpr int SCRATCH = ObjSpn::SCRATCH > BgSpn::SCRATCH ? ObjSpn::SCRATCH
                                                         : BgSpn::SCRATCH;
constexpr int PER_WARP = (2 * V + 2 * PP + 4 * O + SCRATCH + 3) / 4 * 4;
constexpr size_t SMEM_BYTES = sizeof(float) * WPB * PER_WARP;
static_assert(SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

// separable sigmoid box edge, sharpness 8 (supair.likelihood's `edge`)
__device__ __forceinline__ float edge(float t, float s, float c) {
    const float a = (8.f * (s - fabsf(c - t))) / fmaxf(s, 1e-3f);
    return 1.f / (1.f + expf(-a));
}

// the two bilinear taps along one axis: first index and both weights
__device__ __forceinline__ void taps(float coord, int& i0, float& w0, float& w1) {
    const float c = fminf(fmaxf(coord, 0.f), (float)(IMG - 1));
    i0 = min((int)floorf(c), IMG - 2);
    w0 = fmaxf(0.f, 1.f - fabsf(c - (float)i0));
    w1 = fmaxf(0.f, 1.f - fabsf(c - (float)(i0 + 1)));
}

__global__ void __launch_bounds__(32 * WPB)
likelihood_kernel(const float* __restrict__ frames, const float* __restrict__ boxes,
                  int B, const float* __restrict__ grid_p,
                  const float* __restrict__ grid_img, SpnParams obj,
                  SpnParams bg, float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int b = blockIdx.x * WPB + warp;
    if (b >= B) return;
    float* img = reinterpret_cast<float*>(smem4) + warp * PER_WARP;
    float* bgw = img + V;
    float* patch = bgw + V;
    float* pw = patch + PP;
    float* box = pw + PP;                 // (O, 4): sx, sy, tx, ty
    float* scratch = box + 4 * O;
    for (int v = lane; v < V; v += 32) img[v] = frames[(size_t)b * V + v];
    for (int k = lane; k < 4 * O; k += 32) box[k] = boxes[(size_t)b * 4 * O + k];
    __syncwarp();

    // background visibility on the pixel grid
    for (int v = lane; v < V; v += 32) {
        const float yc = __ldg(grid_img + v / IMG), xc = __ldg(grid_img + v % IMG);
#if LIK_OVERLAP
        float cover = 0.f;
        for (int o = 0; o < O; ++o) {
            const float* bx = box + 4 * o;
            const float cv = edge(bx[3], bx[1], yc) * edge(bx[2], bx[0], xc);
            cover = o == 0 ? cv : fmaxf(cover, cv);
        }
        bgw[v] = 1.f - cover;
#else
        float vis = 1.f;
        for (int o = 0; o < O; ++o) {
            const float* bx = box + 4 * o;
            vis *= 1.f - edge(bx[3], bx[1], yc) * edge(bx[2], bx[0], xc);
        }
        bgw[v] = vis;
#endif
    }

    const float half = (IMG - 1) / 2.0f;
    float total = 0.f;
    for (int o = 0; o < O; ++o) {
        const float sx = box[4 * o], sy = box[4 * o + 1];
        const float tx = box[4 * o + 2], ty = box[4 * o + 3];
        for (int idx = lane; idx < PP; idx += 32) {
            const int p = idx / P, q = idx % P;
            const float v = ty + sy * __ldg(grid_p + p);     // ST y of row p
            const float u = tx + sx * __ldg(grid_p + q);     // ST x of col q
            int h0, w0;
            float wy0, wy1, wx0, wx1;
            taps((v + 1.f) * half, h0, wy0, wy1);
            taps((u + 1.f) * half, w0, wx0, wx1);
            const float* r0 = img + h0 * IMG + w0;
            const float c0 = wy0 * r0[0] + wy1 * r0[IMG];          // column w0
            const float c1 = wy0 * r0[1] + wy1 * r0[IMG + 1];      // column w0 + 1
            patch[idx] = c0 * wx0 + c1 * wx1;
            float wt = 1.f;
#if LIK_OVERLAP
            if (o > 0) {
                float claimed = 0.f;
                for (int j = 0; j < o; ++j) {
                    const float* bj = box + 4 * j;
                    const float cj = edge(bj[3], bj[1], v) * edge(bj[2], bj[0], u);
                    claimed = j == 0 ? cj : fmaxf(claimed, cj);
                }
                wt = fminf(fmaxf(1.f - claimed, 0.f), 1.f);
            }
#endif
            pw[idx] = wt;
        }
        __syncwarp();
        total += ObjSpn::log_prob(patch, pw, obj, scratch, lane);
    }
    const float ll_bg = BgSpn::log_prob(img, bgw, bg, scratch, lane);
    if (lane == 0) out[b] = total + ll_bg;
}

}  // namespace

extern "C" {

int stove_lik_smem_bytes() { return (int)SMEM_BYTES; }

// Launches on `stream`; returns the CUDA error code (0 = ok).  Pointers are
// device pointers; the SPN buffers are laid out by ops/fused_spn.py::prepare.
cudaError_t stove_lik_launch(const float* frames, const float* boxes, int B,
                             const float* grid_p, const float* grid_img,
                             const int* o_perm, const int* o_bounds,
                             const float* o_mu, const float* o_sd,
                             const float* o_logsd, const float* o_sumw,
                             const float* o_root,
                             const int* b_perm, const int* b_bounds,
                             const float* b_mu, const float* b_sd,
                             const float* b_logsd, const float* b_sumw,
                             const float* b_root, float* out, void* stream) {
    if (B <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        likelihood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const SpnParams obj{o_perm, o_bounds, o_mu, o_sd, o_logsd, o_sumw, o_root};
    const SpnParams bg{b_perm, b_bounds, b_mu, b_sd, b_logsd, b_sumw, b_root};
    const int grid = (B + WPB - 1) / WPB;
    likelihood_kernel<<<grid, 32 * WPB, SMEM_BYTES, (cudaStream_t)stream>>>(
        frames, boxes, B, grid_p, grid_img, obj, bg, out);
    return cudaGetLastError();
}

}  // extern "C"
