// Fused posterior scan for Hopper (sm_90a): the T-2 steps of STOVE's
// posterior recursion (phase 2 of stove.infer) in one launch.
//
// Replaces: stove_tpu/ops/pallas_scan.py::scan_fused (the Pallas kernel of
// _make_kernel, on the graph-net core dyn_tile_core it shares with the
// rollout).  Same contract as ops/fused_scan.py::scan_reference: z1 (B, O,
// D), carried observation means/stds (B, O, 2), encoder box means/stds
// sup_mean/sup_std (B, T2, O, 4) and pre-drawn normals eps (B, T2, O, D),
// all f32, and for an action-conditioned model (STOVE_ACT=1) the actions
// a_{t-1} (B, T2) int32, in; z and z_mean (B, T2, O, D), the summed KL
// increments kl (B,) and, with the reward head (STOVE_REW=1, set apart
// from STOVE_ACT: the reference runs the head whenever its weights exist),
// the raw reward probabilities (B, T2) f32 out.  Each step, per sample: one
// dynamics step (dyn_core.cuh, with the action's row of embed layer 0),
// Euler integration to the prior mean, the prior std
// (size_std on the size rows, lo + (hi - lo) sigmoid(raw) elsewhere); slot
// alignment of the encoder's boxes to the predicted positions over all O!
// permutations in itertools order, keeping the first minimal one; products
// of Gaussians for size, position and (per STOVE_VEL_MODE) velocity; the
// sample z = q_mean + q_std * eps; the increment log p(z | prior) -
// log q(z); the carried observation for the next step; the reward head on
// the prior mean and the step's [s ; r] (pallas_scan.py:194), in the
// dynamics' buffers once the posterior has read them.
//
// Bound on this card.  The dynamics are 613,632 multiply-adds per sample
// and step at O=3, h=128, cl=16; at the training shape (B=256, T2=6) that is
// 1.9 GFLOP, 28 us at the f32 CUDA-core peak, against 1.8 MB of inputs and
// outputs (0.5 us at 3.35 TB/s): compute bound at full occupancy.  At
// B=256 occupancy is what limits it: the rollout's tile of 16 samples gives
// 16 blocks for 132 SMs.  This kernel takes TB=8 (STOVE_TB, set by the
// wrapper), the smallest tile the block-wide matmul's 2-D lane layout
// supports, for 32 blocks; each block still runs one sample group through
// all T2 steps, the TPU's sequential fori_loop as a loop in the block.
// The reward head adds 295,680 multiply-adds per sample and step (1.48x);
// the avoidance window (T2=10) is then 4.7 GFLOP, the gravity window
// (T2=14, no head) 4.4 GFLOP, both ~70 us at the f32 peak.
// The posterior algebra is a few hundred flops per (object, sample) column
// and runs one thread per column.
//
// STOVE_VEL_MODE: 0 no velocity posterior (prior velocity kept); 1 velocity
// evidence = encoder position - previous sample's position, encoder std;
// 2 = encoder position - previous encoder position, both stds
// (velocity_obs_full_std); 3 = filtered: this step's posterior position -
// the previous one, both stds.  The carried observation is the posterior
// position in mode 3 and the matched encoder position otherwise.

#include "dyn_core.cuh"

#ifndef STOVE_VEL_MODE
#define STOVE_VEL_MODE 2
#endif

namespace {

constexpr int VEL_MODE = STOVE_VEL_MODE;
constexpr float LOG2PI = 1.8378770664093453f;

constexpr int factorial(int n) { return n <= 1 ? 1 : n * factorial(n - 1); }
constexpr int NPERM = factorial(O);
static_assert(O <= 4, "the exact slot alignment enumerates O! permutations");

// scan-only shared memory after the dynamics core's buffers (floats)
constexpr int CM_SIZE = 2 * M;           // carried observation means (2, M)
constexpr int CS_SIZE = 2 * M;           // and stds
constexpr int LPQ_SIZE = 2 * M;          // per column: log p, log q sums
constexpr int SEL_SIZE = (TB * O + 3) / 4 * 4;   // ints: matched observation
constexpr int SCAN_SMEM_FLOATS = SMEM_FLOATS + CM_SIZE + CS_SIZE + LPQ_SIZE + SEL_SIZE;
constexpr size_t SCAN_SMEM_BYTES = sizeof(float) * SCAN_SMEM_FLOATS;
static_assert(SCAN_SMEM_BYTES <= 232448, "shared memory above the 227 KB a block can use");

__device__ __forceinline__ float log_normal(float x, float mean, float sd) {
    const float z = (x - mean) / sd;
    return -0.5f * (z * z + LOG2PI) - logf(sd);
}

// precision-weighted product of two Gaussians (ops/gaussians.product)
__device__ __forceinline__ void product(float ma, float sa, float mb, float sb,
                                        float& m, float& s) {
    const float va = sa * sa, vb = sb * sb;
    const float denom = va + vb;
    m = (ma * vb + mb * va) / denom;
    s = sqrtf(va * vb / denom);
}

__global__ void __launch_bounds__(NT, 1)
scan_kernel(const float* __restrict__ z1, const float* __restrict__ carry_m,
            const float* __restrict__ carry_s, const float* __restrict__ sup_mean,
            const float* __restrict__ sup_std, const float* __restrict__ eps,
            const int* __restrict__ actions, const float* __restrict__ P,
            float* __restrict__ z_out, float* __restrict__ zm_out,
            float* __restrict__ kl_out, float* __restrict__ rew_out, int B, int T2,
            float size_std, float std_lo, float std_hi, int latent_residual) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* zs = smem;                 // (D, LDO) state z_{t-1}
    float* AE = zs + ZS_SIZE;         // dynamics scratch; raw outputs after a step
    float* AEb = AE + HID * LDO;      // prior mean after integration
    float* SR = AE + AE_SIZE;
    float* P2 = SR + SR_SIZE;
    float* LG = P2 + P2_SIZE;
    float* WS = LG + LG_SIZE;
    float* RW = WS + WS_FLOATS;       // (4, LDO) reward head rows (STOVE_REW)
    int* ACTS = reinterpret_cast<int*>(RW + RW_SIZE);   // (TB) (STOVE_ACT)
    float* CM = WS + WS_FLOATS + RW_SIZE + ACT_SIZE;    // (2, M) carried observation mean
    float* CS = CM + CM_SIZE;         // (2, M) and std
    float* LPQ = CS + CS_SIZE;        // (2, M) per-column log p, log q
    int* SEL = reinterpret_cast<int*>(LPQ + LPQ_SIZE);   // (TB, O)

    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * TB;
    constexpr int SD = O * D;

    for (int i = tid; i < TB * SD; i += NT) {
        const int b = i / SD, r = i % SD, o = r / D, d = r % D;
        const int gb = b0 + b;
        zs[d * LDO + o * TB + b] = gb < B ? z1[(size_t)gb * SD + r] : 0.f;
    }
    for (int i = tid; i < 2 * M; i += NT) {
        const int k = i / M, m = i % M, o = m / TB, b = m % TB;
        const int gb = b0 + b;
        CM[i] = gb < B ? carry_m[((size_t)gb * O + o) * 2 + k] : 0.f;
        CS[i] = gb < B ? carry_s[((size_t)gb * O + o) * 2 + k] : 1.f;
    }
    float kl = 0.f;                   // thread b < TB: sample b's sum
    __syncthreads();

    for (int t = 0; t < T2; ++t) {
        if constexpr (ACT) {
            if (tid < TB) {
                const int gb = b0 + tid;
                ACTS[tid] = gb < B ? actions[(size_t)gb * T2 + t] : 0;
            }
        }
        dyn_forward(zs, P, AE, AEb, SR, P2, LG, WS, ACTS);
        integrate_mean(zs, AE, AEb, latent_residual);   // prior mean into AEb
        __syncthreads();

        // slot alignment, one thread per sample: cost[i][j] of matching
        // predicted slot i to encoder box j, permutations in itertools
        // (lexicographic) order, the first minimal total kept
        if (tid < TB) {
            const int b = tid, gb = b0 + b;
            float cost[O][O];
            for (int j = 0; j < O; ++j) {
                float ox = 0.f, oy = 0.f;
                if (gb < B) {
                    const float* sm = sup_mean + (((size_t)gb * T2 + t) * O + j) * 4;
                    ox = sm[2];
                    oy = sm[3];
                }
                for (int i = 0; i < O; ++i) {
                    const float dx = AEb[2 * LDO + i * TB + b] - ox;
                    const float dy = AEb[3 * LDO + i * TB + b] - oy;
                    cost[i][j] = dx * dx + dy * dy;
                }
            }
            int perm[O], best[O];
            for (int i = 0; i < O; ++i) perm[i] = best[i] = i;
            float best_cost = 0.f;
            for (int n = 0; n < NPERM; ++n) {
                float c = 0.f;
                for (int i = 0; i < O; ++i) c += cost[i][perm[i]];
                if (n == 0 || c < best_cost) {
                    best_cost = c;
                    for (int i = 0; i < O; ++i) best[i] = perm[i];
                }
                // next permutation in lexicographic order
                int k = O - 2;
                while (k >= 0 && perm[k] > perm[k + 1]) --k;
                if (k < 0) break;
                int l = O - 1;
                while (perm[l] < perm[k]) --l;
                int tmp = perm[k]; perm[k] = perm[l]; perm[l] = tmp;
                for (int a = k + 1, e = O - 1; a < e; ++a, --e) {
                    tmp = perm[a]; perm[a] = perm[e]; perm[e] = tmp;
                }
            }
            for (int i = 0; i < O; ++i) SEL[b * O + i] = best[i];
        }
        __syncthreads();

        // posterior, one thread per (object, sample) column
        for (int m = tid; m < M; m += NT) {
            const int o = m / TB, b = m % TB, gb = b0 + b;
            const int j = SEL[b * O + o];
            float om[4], os[4];
            for (int k = 0; k < 4; ++k) {
                om[k] = 0.f;
                os[k] = 1.f;
            }
            if (gb < B) {
                const size_t q = (((size_t)gb * T2 + t) * O + j) * 4;
                for (int k = 0; k < 4; ++k) {
                    om[k] = sup_mean[q + k];
                    os[k] = sup_std[q + k];
                }
            }
            const float* e = eps + (((size_t)gb * T2 + t) * O + o) * D;
            const float zprev[2] = {zs[2 * LDO + m], zs[3 * LDO + m]};
            float lp = 0.f, lq = 0.f;
            float qpm[2], qps[2];
            for (int d = 0; d < D; ++d) {
                const float dm = AEb[d * LDO + m];
                const float ds = d < 2 ? size_std
                    : std_lo + (std_hi - std_lo) * sigmoidf(AE[(CL + d) * LDO + m]);
                float qm = dm, qs = ds;
                if (d < 4) {                          // size, position
                    product(om[d], os[d], dm, ds, qm, qs);
                    if (d >= 2) {
                        qpm[d - 2] = qm;
                        qps[d - 2] = qs;
                    }
                } else if (d < 6 && VEL_MODE != 0) {  // velocity
                    const int k = d - 4;
                    float vo, vs;
                    if (VEL_MODE == 3) {
                        vo = qpm[k] - CM[k * M + m];
                        vs = sqrtf(qps[k] * qps[k] + CS[k * M + m] * CS[k * M + m]);
                    } else if (VEL_MODE == 2) {
                        vo = om[2 + k] - CM[k * M + m];
                        vs = sqrtf(os[2 + k] * os[2 + k] + CS[k * M + m] * CS[k * M + m]);
                    } else {
                        vo = om[2 + k] - zprev[k];
                        vs = os[2 + k];
                    }
                    product(vo, vs, dm, ds, qm, qs);
                }
                const float ev = gb < B ? e[d] : 0.f;
                const float z = qm + qs * ev;
                lp += log_normal(z, dm, ds);
                lq += log_normal(z, qm, qs);
                zs[d * LDO + m] = z;                  // own column only
                if (gb < B) {
                    const size_t q = (((size_t)gb * T2 + t) * O + o) * D + d;
                    z_out[q] = z;
                    zm_out[q] = qm;
                }
            }
            for (int k = 0; k < 2; ++k) {
                CM[k * M + m] = VEL_MODE == 3 ? qpm[k] : om[2 + k];
                CS[k * M + m] = VEL_MODE == 3 ? qps[k] : os[2 + k];
            }
            LPQ[m] = lp;
            LPQ[M + m] = lq;
        }
        __syncthreads();
        if constexpr (REW) {
            // on the prior mean (still in AEb) and this step's [s ; r]
            reward_head(AEb, SR, P, P2, AE, RW, WS);
            if (tid < TB && b0 + tid < B) {
                rew_out[(size_t)(b0 + tid) * T2 + t] = reward_pool(RW, tid);
            }
        }
        if (tid < TB) {
            float lp = 0.f, lq = 0.f;
            for (int o = 0; o < O; ++o) {
                lp += LPQ[o * TB + tid];
                lq += LPQ[M + o * TB + tid];
            }
            kl += lp - lq;
        }
        __syncthreads();
    }
    if (tid < TB && b0 + tid < B) kl_out[b0 + tid] = kl;
}

}  // namespace

extern "C" {

int stove_scan_param_count() { return N_PARAMS; }

int stove_scan_smem_bytes() { return (int)SCAN_SMEM_BYTES; }

int stove_scan_tile() { return TB; }

// Launches the scan on `stream`; returns the CUDA error code (0 = ok).
// Pointers are device pointers; the caller checks shapes and allocates the
// outputs.  params is the rollout's packed buffer (fused_rollout.pack_params).
// actions (B, T2) int32 is read only with STOVE_ACT, rew_out (B, T2)
// written only with STOVE_REW; each must be non-null there.
cudaError_t stove_scan_launch(const float* z1, const float* carry_m,
                              const float* carry_s, const float* sup_mean,
                              const float* sup_std, const float* eps,
                              const int* actions, const float* params,
                              float* z_out, float* zm_out, float* kl_out,
                              float* rew_out, int B, int T2, float size_std,
                              float std_lo, float std_hi, int latent_residual,
                              void* stream) {
    if (B <= 0 || T2 <= 0) return cudaErrorInvalidValue;
    if ((ACT && actions == nullptr) || (REW && rew_out == nullptr)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SCAN_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const int grid = (B + TB - 1) / TB;
    scan_kernel<<<grid, NT, SCAN_SMEM_BYTES, (cudaStream_t)stream>>>(
        z1, carry_m, carry_s, sup_mean, sup_std, eps, actions, params, z_out,
        zm_out, kl_out, rew_out, B, T2, size_std, std_lo, std_hi, latent_residual);
    return cudaGetLastError();
}

}  // extern "C"
