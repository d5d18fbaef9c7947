// Fused posterior scan for Hopper (sm_90a): the T-2 steps of STOVE's
// posterior recursion (phase 2 of stove.infer) in one launch, on the
// rollout's dynamics core: bf16 matmuls on the tensor cores, float32 ones
// on the CUDA cores.
//
// Replaces: stove_tpu/ops/pallas_scan.py::scan_fused (the Pallas kernel of
// _make_kernel, on the graph-net core dyn_tile_core it shares with the
// rollout), in both of the TPU kernel's precisions: STOVE_BF16=1 is its
// bfloat16 variant (make_mm: every matmul operand rounded to bf16, f32
// sums; the forward of scan_impl=pallas), STOVE_BF16=0 its float32 one.
// Same contract as ops/fused_scan.py::scan_reference: z1 (B, O, D),
// carried observation means/stds (B, O, 2), encoder box means/stds
// sup_mean/sup_std (B, T2, O, 4) and pre-drawn normals eps (B, T2, O, D),
// all f32, and for an action-conditioned model (STOVE_ACT=1) the actions
// a_{t-1} (B, T2) int32, in; z and z_mean (B, T2, O, D), the summed KL
// increments kl (B,) and, with the reward head (STOVE_REW=1, set apart
// from STOVE_ACT: the reference runs the head whenever its weights exist),
// the raw reward probabilities (B, T2) f32 out.  Each step, per sample: one
// dynamics step (dyn_core.cuh, with the action's row of embed layer 0),
// Euler integration to the prior mean, the prior std (size_std on the size
// columns, lo + (hi - lo) sigmoid(raw) elsewhere); slot alignment of the
// encoder's boxes to the predicted positions over all O! permutations in
// itertools order, keeping the first minimal one; products of Gaussians
// for size, position and (per STOVE_VEL_MODE) velocity; the sample z =
// q_mean + q_std * eps; the increment log p(z | prior) - log q(z); the
// carried observation for the next step; the reward head on the prior mean
// and the step's [s | r] (pallas_scan.py:194).
//
// Bound on this card.  The dynamics are 613,632 multiply-adds per sample
// and step at O=3, h=128, cl=16; at the training shape (B=256, T2=6) that
// is 1.9 GFLOP: 1.9 us at the bf16 tensor-core peak, 28 us at the f32
// CUDA-core peak, against 1.8 MB of inputs and outputs (0.5 us at 3.35
// TB/s).  The reward head adds 295,680 multiply-adds per sample and step
// (1.48x); the avoidance window (T2=10) is then 4.7 GFLOP, the gravity
// window (T2=14, no head) 4.4 GFLOP.  At the training batch neither bound
// is what limits it: a block runs its samples through all T2 steps in
// order (the TPU's sequential fori_loop as a loop in the block), so the
// time is T2 block-steps of the core, and a block-step costs the core's
// fixed cost a step -- a weight chunk behind each block barrier, the
// elementwise phases -- more than its matmuls (PERF.md).
//
// Design:
// 1. The dynamics are the rollout's core (dyn_core.cuh: dyn_step,
//    integrate_mean, reward_head, reward_pool): rows r = o * TB + b padded
//    to m-tiles of 16, bf16 mma.sync m16n8k16 with f32 accumulators (or
//    FMA in the float32 library), the weights of prepare_params, packed
//    once a call, streamed through the cp.async ring, whose stream runs on
//    across the posterior and the reward head into the next step.
// 2. Tile: STOVE_TB samples a block, chosen from B by the wrapper with
//    the rollout's rule (fused_scan.tile_for): 16, or 4 when 16 would launch
//    fewer blocks than the card has SMs, so the training batch B=256 runs
//    64 blocks.  A 4-sample block fits two an SM.  2 samples a block (128
//    blocks) ran as fast in bf16 at the three training windows
//    (tools/scan_probe.py, PERF.md).
// 3. The step's inputs (encoder boxes, eps) are loaded into registers
//    before the dynamics and stored to shared memory after them, so their
//    latency hides behind the matmuls.
// 4. The posterior runs one warp per (object, sample) row and one lane per
//    state column: the velocity lanes take the position lanes' posterior by
//    shuffle, the kl increment is a warp sum.  The slot alignment runs one
//    thread per sample.
// 5. No shared memory beyond the core's: the step's inputs, matches and kl
//    increments live in R2 between the dynamics and the reward head, the
//    carried observation in free columns of the predicted-mean rows.
// Rows of padding (a block's samples past B, an m-tile's rows past O * TB)
// stay in their own rows: every matmul row, posterior lane and reward pool
// reads its own sample only, and nothing past B is written out.
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
static_assert(D <= 32, "the posterior runs one lane per state column");

// The step's inputs, f32 in R2 from the end of the dynamics to the reward
// head: encoder box means and stds (TB, O, 4) and eps (TB, O, D), then the
// matched box of each slot (TB, O) int, then each row's log p - log q.
constexpr int NBOX = TB * O * 4;
constexpr int NIN = 2 * NBOX + TB * O * D;   // inputs a step
constexpr int NPF = (NIN + NT - 1) / NT;     // ... a thread
constexpr int I_SEL = NIN, I_LPQ = NIN + TB * O;
static_assert((size_t)(I_LPQ + MR) * 4 <= R2_BYTES, "the step's inputs fit R2");
// The carried observation -- means (2) then stds (2) -- in columns
// ZC..ZC+3 of the predicted-mean rows s.zn, which integrate_mean leaves.
constexpr int ZC = D;
static_assert(ZC + 4 <= LDZ, "the carried observation fits a mean row");

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

// Entry i < NIN of step t's inputs for the block's samples from b0: box
// means, box stds, eps; a sample past B gets means 0, stds 1, eps 0.
__device__ __forceinline__ float load_input(const float* __restrict__ sup_mean,
                                            const float* __restrict__ sup_std,
                                            const float* __restrict__ eps, int i,
                                            int b0, int B, int T2, int t) {
    if (i < 2 * NBOX) {
        const bool m = i < NBOX;
        const int k = m ? i : i - NBOX, b = k / (O * 4), r = k % (O * 4);
        if (b0 + b >= B) return m ? 0.f : 1.f;
        return __ldg((m ? sup_mean : sup_std) + ((size_t)(b0 + b) * T2 + t) * (O * 4) + r);
    }
    const int k = i - 2 * NBOX, b = k / (O * D), r = k % (O * D);
    return b0 + b < B ? __ldg(eps + ((size_t)(b0 + b) * T2 + t) * (O * D) + r) : 0.f;
}

__global__ void __launch_bounds__(NT, TB <= 4 ? 2 : 1)
scan_kernel(const float* __restrict__ z1, const float* __restrict__ carry_m,
            const float* __restrict__ carry_s, const float* __restrict__ sup_mean,
            const float* __restrict__ sup_std, const float* __restrict__ eps,
            const int* __restrict__ actions, const unsigned char* __restrict__ P,
            float* __restrict__ z_out, float* __restrict__ zm_out,
            float* __restrict__ kl_out, float* __restrict__ rew_out, int B, int T2,
            float size_std, float std_lo, float std_hi, int latent_residual) {
    extern __shared__ float4 smem4[];
    const Smem s = carve(reinterpret_cast<unsigned char*>(smem4));
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int b0 = blockIdx.x * TB;
    constexpr int SD = O * D;
    float* IN = reinterpret_cast<float*>(s.r2);
    const float* SUPM = IN;                          // (TB, O, 4)
    const float* SUPS = IN + NBOX;                   // (TB, O, 4)
    const float* EPS = IN + 2 * NBOX;                // (TB, O, D)
    int* SEL = reinterpret_cast<int*>(IN + I_SEL);   // (TB, O)
    float* LPQ = IN + I_LPQ;                         // (MR) log p - log q

    // padding rows and columns stay zero for the whole window
    for (int i = tid; i < (int)(SMEM_BYTES / 16); i += NT) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int i = tid; i < TB * SD; i += NT) {
        const int b = i / SD, r = i % SD, o = r / D, d = r % D;
        const int gb = b0 + b;
        s.zs[(o * TB + b) * LDZ + d] = gb < B ? z1[(size_t)gb * SD + r] : 0.f;
    }
    for (int i = tid; i < 2 * MR; i += NT) {
        const int m = i / 2, k = i % 2, o = m / TB, gb = b0 + m % TB;
        s.zn[m * LDZ + ZC + k] = gb < B ? carry_m[((size_t)gb * O + o) * 2 + k] : 0.f;
        s.zn[m * LDZ + ZC + 2 + k] = gb < B ? carry_s[((size_t)gb * O + o) * 2 + k] : 1.f;
    }
    int q = 0;                        // weight chunks used (ring slot parity)
    stream_start(s.ring, q, next_matrix<HID, DP>(P + O_WE0));
    float kl = 0.f;                   // thread b < TB: sample b's sum

    for (int t = 0; t < T2; ++t) {
        if constexpr (ACT) {
            if (tid < TB) {
                const int gb = b0 + tid;
                s.acts[tid] = gb < B ? actions[(size_t)gb * T2 + t] : 0;
            }
        }
        float pre[NPF];
#pragma unroll
        for (int k = 0; k < NPF; ++k) {
            const int i = tid + k * NT;
            pre[k] = i < NIN ? load_input(sup_mean, sup_std, eps, i, b0, B, T2, t) : 0.f;
        }
        // its first barrier orders zs, the carry and acts; the matrix after
        // the output MLP is the reward head's first or the next step's
        dyn_step(s, P, q, REW ? next_matrix<2 * HID, 2 * HID>(P + O_WH0)
                              : next_matrix<HID, DP>(P + O_WE0));
        integrate_mean(s, latent_residual);          // prior mean into s.zn
#pragma unroll
        for (int k = 0; k < NPF; ++k) {
            const int i = tid + k * NT;
            if (i < NIN) IN[i] = pre[k];
        }
        __syncthreads();

        // slot alignment, one thread per sample: cost[i][j] of matching
        // predicted slot i to encoder box j, permutations in itertools
        // (lexicographic) order, the first minimal total kept
        if (tid < TB) {
            const int b = tid;
            float cost[O][O];
#pragma unroll
            for (int i = 0; i < O; ++i) {
                const float* y = s.zn + (i * TB + b) * LDZ;
#pragma unroll
                for (int j = 0; j < O; ++j) {
                    const float dx = y[2] - SUPM[(b * O + j) * 4 + 2];
                    const float dy = y[3] - SUPM[(b * O + j) * 4 + 3];
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

        // posterior, one warp per (object, sample) row, lane d its column d
        const float* OUT = raw_out(s);
        for (int m = warp; m < MR; m += NW) {
            const int o = m / TB, b = m % TB, gb = b0 + b, d = lane;
            const int j = SEL[b * O + o];
            float* zn = s.zn + m * LDZ;
            const float* om = SUPM + (b * O + j) * 4;
            const float* os = SUPS + (b * O + j) * 4;
            float dm = 0.f, ds = 1.f, qm = 0.f, qs = 1.f;
            if (d < D) {
                dm = zn[d];
                ds = d < 2 ? size_std
                    : std_lo + (std_hi - std_lo) * sigmoidf(OUT[m * LDOUT + CL + d]);
                qm = dm;
                qs = ds;
                if (d < 4) product(om[d], os[d], dm, ds, qm, qs);   // size, position
            }
            // lanes 4, 5 (velocity) take lanes 2, 3's posterior position
            const float pm = __shfl_up_sync(0xffffffffu, qm, 2);
            const float ps = __shfl_up_sync(0xffffffffu, qs, 2);
            if (VEL_MODE != 0 && (d == 4 || d == 5)) {
                const int k = d - 4;
                const float cm = zn[ZC + k], cs = zn[ZC + 2 + k];
                float vo, vs;
                if (VEL_MODE == 3) {
                    vo = pm - cm;
                    vs = sqrtf(ps * ps + cs * cs);
                } else if (VEL_MODE == 2) {
                    vo = om[2 + k] - cm;
                    vs = sqrtf(os[2 + k] * os[2 + k] + cs * cs);
                } else {
                    vo = om[2 + k] - s.zs[m * LDZ + 2 + k];
                    vs = os[2 + k];
                }
                product(vo, vs, dm, ds, qm, qs);
            }
            // the increment log p(z | prior) - log q(z), entry by entry
            // before the row's sum (the row's log p and log q, each a sum of
            // D terms of a few units, would cancel to it)
            float z = 0.f, inc = 0.f;
            if (d < D) {
                z = qm + qs * EPS[(b * O + o) * D + d];
                inc = log_normal(z, dm, ds) - log_normal(z, qm, qs);
                if (gb < B) {
                    const size_t g = (((size_t)gb * T2 + t) * O + o) * D + d;
                    z_out[g] = z;
                    zm_out[g] = qm;
                }
            }
            inc = warp_sum(inc);
            __syncwarp();                 // the row's reads of zs and the carry are done
            if (d < D) s.zs[m * LDZ + d] = z;
            if (d == 2 || d == 3) {
                zn[ZC + d - 2] = VEL_MODE == 3 ? qm : om[d];
                zn[ZC + d] = VEL_MODE == 3 ? qs : os[d];
            }
            if (lane == 0) LPQ[m] = inc;
        }
        __syncthreads();
        if (tid < TB) {
            float inc = 0.f;
#pragma unroll
            for (int o = 0; o < O; ++o) inc += LPQ[o * TB + tid];
            kl += inc;
        }
        if constexpr (REW) {
            // on the prior mean (s.zn) and this step's [s | r]; its first
            // barrier orders the reads of LPQ before R2 is overwritten
            reward_head(s, P, q, next_matrix<HID, DP>(P + O_WE0));
            if (tid < TB && b0 + tid < B) {
                rew_out[(size_t)(b0 + tid) * T2 + t] = reward_pool(s.rw, tid);
            }
        }
    }
    cp_async_wait_all();              // the chunk the last step put in flight
    if (tid < TB && b0 + tid < B) kl_out[b0 + tid] = kl;
}

}  // namespace

extern "C" {

int stove_scan_param_bytes() { return (int)N_BYTES; }

int stove_scan_smem_bytes() { return (int)SMEM_BYTES; }

int stove_scan_tile() { return TB; }

int stove_scan_bf16() { return BF16 ? 1 : 0; }

// Launches the scan on `stream`; returns the CUDA error code (0 = ok).
// Pointers are device pointers; params is fused_scan.prepare_params'
// buffer for this library's precision (16-byte aligned); the caller checks
// shapes and allocates the outputs.  actions (B, T2) int32 is read only with
// STOVE_ACT, rew_out (B, T2) written only with STOVE_REW; each must be
// non-null there.
cudaError_t stove_scan_launch(const float* z1, const float* carry_m,
                              const float* carry_s, const float* sup_mean,
                              const float* sup_std, const float* eps,
                              const int* actions, const void* params,
                              float* z_out, float* zm_out, float* kl_out,
                              float* rew_out, int B, int T2, float size_std,
                              float std_lo, float std_hi, int latent_residual,
                              void* stream) {
    if (B <= 0 || T2 <= 0) return cudaErrorInvalidValue;
    if ((ACT && actions == nullptr) || (REW && rew_out == nullptr)) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(params) % 16) return cudaErrorMisalignedAddress;
    cudaError_t err = cudaFuncSetAttribute(
        scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(scan_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    const int grid = (B + TB - 1) / TB;
    scan_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        z1, carry_m, carry_s, sup_mean, sup_std, eps, actions,
        static_cast<const unsigned char*>(params), z_out, zm_out, kl_out, rew_out,
        B, T2, size_std, std_lo, std_hi, latent_residual);
    return cudaGetLastError();
}

}  // extern "C"
