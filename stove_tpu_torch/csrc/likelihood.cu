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
// object SPNs of 4,000 leaf terms and 12,000 mixture multiply-adds, one
// background SPN of 12,288 leaf terms, 6 operations a leaf term, the
// glimpses and the separable edges) is 0.52 GFLOP, 7.7 us at the f32
// CUDA-core rate: the kernel is bound by its operations, once the SPNs'
// parameters (321 KB packed) are read once a block rather than once a
// frame (spn_tile.cuh): 40 KB a frame through L2 at 8 frames a block.
//
// Design.  LIK_TB frames a block (ops/fused_spn.py::TILE), SPN_THREADS
// threads.  The block starts loading the object SPN's first parameter
// slot, stages its frames with 16-byte cp.async copies, then:
//   1. the box edges per axis, O (H + W) sigmoids a frame for the cover and
//      2P for each (object, earlier object) pair's claims, and the two
//      bilinear taps per sample point and axis (as the dense hat matmuls
//      weigh them);
//   2. the background weights, 1 - max_o ey*ex from the tables, into the
//      background SPN's w rows beside the frame;
//   3. the O patches and their claim weights into the object SPN's x and w
//      rows (sample o of frame s in row s*O + o);
//   4. the shared evaluator (spn_tile.cuh) on the TB*O patches, then on the
//      TB frames, and the sum of each frame's O + 1 log-densities.
// The patch grid and the pixel grid come from the wrapper (torch.linspace,
// cached), so both versions sample at the same points.  Shapes are
// compile-time: -DLIK_O, -DLIK_P, -DLIK_IMG, -DLIK_TB, the two SPN shapes
// -DOBJ_* and -DBG_*, and -DLIK_OVERLAP (overlap_correction and O > 1;
// without it the claim weights are 1 and the background weight is
// prod_o (1 - cover_o), as in glimpse.background_visibility).  The library
// also exports the packing kernel of both SPNs (one launch).

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
#ifndef LIK_TB
#define LIK_TB 8
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
constexpr int TB = LIK_TB;
constexpr int V = IMG * IMG;
constexpr int PP = P * P;
using ObjT = SpnTile<OBJ_V, OBJ_R, OBJ_D, OBJ_I, OBJ_S, TB * O>;
using BgT = SpnTile<BG_V, BG_R, BG_D, BG_I, BG_S, TB>;
static_assert(OBJ_V == PP && BG_V == V, "SPN widths must match patch and frame");
static_assert(IMG >= 2 && P >= 2 && IMG % 2 == 0, "an even frame side, two samples a side");

// shared memory, in floats
constexpr int RING = 2 * SPN_CHUNK;
constexpr int IMG_F = BgT::NSP * BgT::XS;              // frames (x of the bg SPN), and bg weights
constexpr int PATCH_F = ObjT::NSP * ObjT::XS;          // patches (x of the obj SPN), and claims
constexpr int SCRATCH = spn_imax(ObjT::SCRATCH, BgT::SCRATCH);
constexpr int BOX_F = spn_r4(TB * O * 4);
constexpr int EDGE_F = spn_r4(TB * O * 2 * IMG);       // (s, o, axis, pixel)
constexpr int CLAIM_F = spn_r4(TB * O * O * 2 * P);    // (s, o, j, axis, point)
constexpr int TAP_F = spn_r4(TB * O * 2 * P * 3);      // (s, o, axis, point): i0, w0, w1
constexpr int RES_F = spn_r4(ObjT::NSP) + spn_r4(BgT::NSP);
constexpr size_t SMEM_BYTES = sizeof(float) * (RING + 2 * IMG_F + 2 * PATCH_F + SCRATCH + BOX_F
                                               + EDGE_F + CLAIM_F + TAP_F + RES_F);
static_assert(SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

// separable sigmoid box edge, sharpness 8 (supair.likelihood's `edge`)
__device__ __forceinline__ float edge(float t, float s, float c) {
    const float a = (8.f * (s - fabsf(c - t))) / fmaxf(s, 1e-3f);
    return 1.f / (1.f + expf(-a));
}

__global__ void __launch_bounds__(SPN_THREADS)
likelihood_kernel(const float* __restrict__ frames, const float* __restrict__ boxes, int B,
                  const float* __restrict__ grid_p, const float* __restrict__ grid_img,
                  const float* __restrict__ gobj, const float* __restrict__ gbg,
                  float* __restrict__ out) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    float* img = ring + RING;            // (NSP_bg, XS_bg) frames
    float* bgw = img + IMG_F;            // background weights
    float* patch = bgw + IMG_F;          // (NSP_obj, XS_obj) patches
    float* pw = patch + PATCH_F;         // claim weights
    float* scratch = pw + PATCH_F;
    float* box = scratch + SCRATCH;      // (TB, O, 4): sx, sy, tx, ty
    float* eg = box + BOX_F;             // pixel-grid edges
    float* cl = eg + EDGE_F;             // claim edges at later objects' points
    float* tap = cl + CLAIM_F;
    float* res_o = tap + TAP_F;
    float* res_b = res_o + spn_r4(ObjT::NSP);
    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * TB, nb = min(TB, B - b0);

    ObjT::prefetch(gobj, ring);
    constexpr int V4 = V / 4;
    for (int f = tid; f < BgT::NSP * V4; f += SPN_THREADS) {
        const int s = f / V4, c = 4 * (f % V4);
        if (s < nb)
            spn_cp16(img + s * BgT::XS + c, frames + (size_t)(b0 + s) * V + c);
        else
            *reinterpret_cast<float4*>(img + s * BgT::XS + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    spn_commit();
    for (int f = tid; f < TB * O * 4; f += SPN_THREADS)
        box[f] = f < nb * O * 4 ? boxes[(size_t)b0 * O * 4 + f] : 0.f;
    for (int f = tid; f < (ObjT::NSP - TB * O) * PP; f += SPN_THREADS) {   // padding rows
        const int n = TB * O + f / PP, v = f % PP;
        patch[n * ObjT::XS + v] = 0.f;
        pw[n * ObjT::XS + v] = 0.f;
    }
    for (int f = tid; f < (BgT::NSP - TB) * V; f += SPN_THREADS)
        bgw[(TB + f / V) * BgT::XS + f % V] = 0.f;
    spn_wait_all();
    __syncthreads();

    // 1. edges per axis and bilinear taps
    const float half = (IMG - 1) / 2.0f;
    for (int f = tid; f < TB * O * 2 * IMG; f += SPN_THREADS) {
        const int t = f % IMG, ax = (f / IMG) % 2, so = f / (2 * IMG);
        const float* bx = box + 4 * so;
        const float c = __ldg(grid_img + t);
        eg[f] = ax == 0 ? edge(bx[3], bx[1], c) : edge(bx[2], bx[0], c);
    }
    for (int f = tid; f < TB * O * 2 * P; f += SPN_THREADS) {
        const int k = f % P, ax = (f / P) % 2, so = f / (2 * P);
        const int s = so / O, o = so % O;
        const float* bx = box + 4 * so;
        const float g = __ldg(grid_p + k);
        const float coord = ax == 0 ? bx[3] + bx[1] * g : bx[2] + bx[0] * g;   // ST y / x
        const float c = fminf(fmaxf((coord + 1.f) * half, 0.f), (float)(IMG - 1));
        const int i0 = min((int)floorf(c), IMG - 2);
        float* tp = tap + 3 * f;
        tp[0] = __int_as_float(i0);
        tp[1] = fmaxf(0.f, 1.f - fabsf(c - (float)i0));
        tp[2] = fmaxf(0.f, 1.f - fabsf(c - (float)(i0 + 1)));
#if LIK_OVERLAP
        for (int j = 0; j < o; ++j) {
            const float* bj = box + 4 * (s * O + j);
            cl[((so * O + j) * 2 + ax) * P + k] =
                ax == 0 ? edge(bj[3], bj[1], coord) : edge(bj[2], bj[0], coord);
        }
#endif
    }
    __syncthreads();

    // 2. background weights on the pixel grid
    for (int f = tid; f < TB * V; f += SPN_THREADS) {
        const int s = f / V, v = f % V, y = v / IMG, x = v % IMG;
        const float* e = eg + s * O * 2 * IMG;
#if LIK_OVERLAP
        float cover = e[y] * e[IMG + x];
        for (int o = 1; o < O; ++o) cover = fmaxf(cover, e[o * 2 * IMG + y] * e[o * 2 * IMG + IMG + x]);
        bgw[s * BgT::XS + v] = 1.f - cover;
#else
        float vis = 1.f - e[y] * e[IMG + x];
        for (int o = 1; o < O; ++o) vis *= 1.f - e[o * 2 * IMG + y] * e[o * 2 * IMG + IMG + x];
        bgw[s * BgT::XS + v] = vis;
#endif
    }
    // 3. patches and claim weights
    for (int f = tid; f < TB * O * PP; f += SPN_THREADS) {
        const int q = f % P, p = (f / P) % P, so = f / PP, s = so / O;
        const float* ty = tap + 3 * (so * 2 * P + p);
        const float* tx = tap + 3 * (so * 2 * P + P + q);
        const float* r0 = img + s * BgT::XS + __float_as_int(ty[0]) * IMG + __float_as_int(tx[0]);
        const float c0 = ty[1] * r0[0] + ty[2] * r0[IMG];          // column w0
        const float c1 = ty[1] * r0[1] + ty[2] * r0[IMG + 1];      // column w0 + 1
        patch[so * ObjT::XS + p * P + q] = c0 * tx[1] + c1 * tx[2];
        float wt = 1.f;
#if LIK_OVERLAP
        const int o = so % O;
        if (o > 0) {
            const float* c = cl + so * O * 2 * P;
            float claimed = c[p] * c[P + q];
            for (int j = 1; j < o; ++j) claimed = fmaxf(claimed, c[j * 2 * P + p] * c[j * 2 * P + P + q]);
            wt = fminf(fmaxf(1.f - claimed, 0.f), 1.f);
        }
#endif
        pw[so * ObjT::XS + p * P + q] = wt;
    }
    __syncthreads();

    // 4. the two SPNs and the sum
    ObjT::run(patch, pw, gobj, ring, scratch, res_o);
    BgT::prefetch(gbg, ring);
    BgT::run(img, bgw, gbg, ring, scratch, res_b);
    if (tid < nb) {
        float total = 0.f;
#pragma unroll
        for (int o = 0; o < O; ++o) total += res_o[tid * O + o];
        out[b0 + tid] = total + res_b[tid];
    }
}

template <class A, class Bk>
__global__ void __launch_bounds__(256)
pack_kernel(SpnSrc a, float* __restrict__ out_a, SpnSrc b, float* __restrict__ out_b) {
    const int idx = blockIdx.x * 256 + threadIdx.x;
    if (idx < A::PACK_ITEMS)
        A::pack(idx, a, out_a);
    else if (idx < A::PACK_ITEMS + Bk::PACK_ITEMS)
        Bk::pack(idx - A::PACK_ITEMS, b, out_b);
}

}  // namespace

extern "C" {

int stove_lik_smem_bytes() { return (int)SMEM_BYTES; }
// floats of the packed object (which = 0) and background (1) SPN buffers
int stove_lik_floats(int which) { return which == 0 ? ObjT::FLOATS : BgT::FLOATS; }

// Launches on `stream`; returns the CUDA error code (0 = ok).  Pointers are
// device pointers (frames and the packed buffers 16-byte aligned); gobj and
// gbg are the buffers stove_lik_pack writes.
cudaError_t stove_lik_launch(const float* frames, const float* boxes, int B, const float* grid_p,
                             const float* grid_img, const float* gobj, const float* gbg,
                             float* out, void* stream) {
    if (B <= 0) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        likelihood_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const int grid = (B + TB - 1) / TB;
    likelihood_kernel<<<grid, SPN_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        frames, boxes, B, grid_p, grid_img, gobj, gbg, out);
    return cudaGetLastError();
}

// Both SPNs' packed buffers in one launch; the arguments of each as
// stove_spn_pack takes them (spn.cu).
cudaError_t stove_lik_pack(const float* o_mu, const float* o_raw, const int* o_perm,
                           const float* o_l0, const float* o_l1, const float* o_l2,
                           const float* o_l3, const float* o_root, float o_min, float o_span,
                           float* o_out, const float* b_mu, const float* b_raw,
                           const int* b_perm, const float* b_l0, const float* b_l1,
                           const float* b_l2, const float* b_l3, const float* b_root,
                           float b_min, float b_span, float* b_out, void* stream) {
    const SpnSrc a{o_mu, o_raw, o_perm, {o_l0, o_l1, o_l2, o_l3}, o_root, o_min, o_span};
    const SpnSrc b{b_mu, b_raw, b_perm, {b_l0, b_l1, b_l2, b_l3}, b_root, b_min, b_span};
    const int items = ObjT::PACK_ITEMS + BgT::PACK_ITEMS;
    pack_kernel<ObjT, BgT><<<(items + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a, o_out, b, b_out);
    return cudaGetLastError();
}

}  // extern "C"
