// Fused whole-horizon STOVE dynamics rollout for Hopper (sm_90a): bf16
// matmuls on the tensor cores, float32 ones on the CUDA cores.
//
// Replaces: stove_tpu/ops/pallas_rollout.py::rollout_states and
// ::rollout_act (the Pallas kernel body _make_kernel, its graph-net core
// dyn_tile_core with the action term, Euler integration integrate_mean, the
// reward head reward_tile_pool, the open-loop std head of the sampled path
// (_make_kernel's open_head branch), and the in-kernel Box-Muller noise of
// _normals/_bits_to_normal_pairs), in both of the TPU kernel's precisions:
// STOVE_BF16=1 is its default bfloat16 variant (make_mm: every matmul
// operand rounded to bf16, f32 accumulation; biases, the attention column,
// the reward head's gap and distance rows and last columns, integration
// and noise in f32), STOVE_BF16=0 its float32 variant; and a third,
// STOVE_BF16=2, what stove_tpu/models/stove.py::rollout computes under
// compute_dtype=bfloat16: the bf16 core with the attention column and the
// reward head's geometry rows and last columns rounded too (dyn_core.cuh,
// dense_round), the same work as STOVE_BF16=1.  Same contract: z0
// (B, O, 6+cl) f32 and, for an action-conditioned model (STOVE_ACT=1),
// actions (B, H) int32 in; states (B, H, O, 6+cl) f32 and, with the reward
// head (STOVE_REW=1), the raw reward probabilities (B, H) f32 out; mean or
// sampled, all H steps in one launch; state and every activation stay on
// chip, device memory sees z0 and the actions in and the trajectory and
// rewards out.
//
// Bounds on this card.  One frame (one sample, one step, all O objects)
// costs 613,632 multiply-adds at O=3, h=128, cl=16 (6 ordered pairs); the
// reward head adds 295,680 (1.48x), the open-loop head 106,496.  The bytes
// are z0 + the trajectory (264 B per frame), so the work is bound by
// operations: at B=16384, H=92, 1.85 TFLOP is 1.87 ms at the bf16 tensor-
// core peak (989 TFLOP/s) and 27.6 ms at the f32 CUDA-core peak (67
// TFLOP/s) the float32 library runs at.  Below those sits the weight
// stream: each block reads every matrix once a step from L2 (345 KB bf16,
// 691 KB f32 without the reward head), at B=16384, H=92 and 16 samples a
// block ~32 GB (bf16) or ~65 GB (f32) from L2 into the SMs.
//
// Design, point by point against what held the earlier CUDA-core kernel
// back:
// 1. Matmuls: in the bf16 library on the tensor cores, warp-level
//    mma.sync m16n8k16 (dyn_core.cuh, mma_gemm).  mma.sync, not wgmma: a
//    block's rows are 48 (objects) or 96 (pairs), multiples of 16 but not
//    of wgmma's 64.  Rows are the m dimension, so one weight fragment
//    serves all of a block's rows.  The float32 library keeps FMA on the
//    CUDA cores, each thread summing over k in order a register tile of
//    6x4 (object rows) or 12x4 (pair rows, and the N = 2h layers) outputs,
//    a warp reading each weight row as 128 contiguous bytes: the
//    three-pass TF32 split (x = hi + lo, hi*hi + hi*lo + lo*hi on
//    m16n8k8) represents each operand only to 2^-22 of itself, and on an
//    H100 it drifted about 1e-4 from the float32 plain version over 8
//    steps at the avoidance planner's B=360, H=10, where chip_smoke.py
//    holds float32 to 1e-4 -- a build-time choice, not a fallback at run
//    time (PERF.md gives its error and time).
// 2. Weights packed once (fused_rollout.prepare_params), bf16 in the
//    order the mma fragments load, f32 row-major for the FMA loop, and
//    streamed through a two-slot ring in shared memory (16 KB slots; 32 KB
//    for the float32 library at 16 samples a block) filled by cp.async:
//    the next chunk is in flight while the current one is used, across
//    layers, heads and steps too, one barrier a chunk, no registers held
//    for the prefetch.
// 3. In the bf16 library the activations only matmuls read (embed and
//    self hidden rows, e, [s | r], the pair rows h1, the output MLP's hidden
//    rows, the heads' hidden rows) are stored bf16, rounded where make_mm
//    rounds them; rows that elementwise code reads stay f32.  The f32
//    feature and h2 rows of the 96 pair rows fill the room, so the tile
//    stays at 16 samples.
// 4. The attention logit and the reward head's last columns are warp-wide
//    f32 dot products (one warp a row, shuffle sum), not serial loops.
// 5. Small batches: the wrapper builds a second library with TB=4 samples a
//    block (12 object rows and 24 pair rows, padded to the mma's 16) and
//    launches it when ceil(B / 16) < 132 blocks, so the planner's B=576
//    runs 144 blocks; it fits two blocks an SM.
// A block owns TB samples for the whole horizon (a loop over H inside the
// block replaces the TPU's sequential fori_loop).  The action enters as its
// row of embed layer 0, added before that layer's ReLU; the reward head
// runs after the state update on the predicted mean; the open-loop std head
// (STOVE_OPEN, sampled rollouts of a model trained with open_loop_sigma) is
// a second two-layer MLP on [s ; r] whose stds, floored at the wrapper's
// lo = min_open_std, replace the output MLP's for the injected noise.
// Noise: Philox4x32-10 keyed by a seed the wrapper draws from the caller's
// torch.Generator, counter (chunk, step, sample, object), both Box-Muller
// branches.

#include "dyn_core.cuh"

namespace {

// Philox4x32-10 (Salmon et al., SC'11): counter-based, so every
// (chunk, step, sample, object) gets its own independent draw.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        const uint32_t lo0 = 0xD2511F53u * c.x;
        const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
        const uint32_t lo1 = 0xCD9E8D57u * c.z;
        const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
        c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
    return c;
}

// Both Box-Muller branches from one pair of 32-bit draws.  The top 24 bits
// make the uniforms; u1 lies in (0, 1], so log never sees 0.
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b, float& z0, float& z1) {
    const float u1 = (float)((a >> 8) + 1u) * (1.0f / 16777216.0f);
    const float u2 = (float)(b >> 8) * (1.0f / 16777216.0f);
    const float r = sqrtf(-2.0f * logf(u1));
    float s, c;
    sincospif(2.0f * u2, &s, &c);
    z0 = r * c;
    z1 = r * s;
}

// The matrix after the output MLP and the open-loop head: the reward
// head's first, or the next step's.
__device__ __forceinline__ Next after_heads(const unsigned char* P) {
    return REW ? next_matrix<2 * HID, 2 * HID>(P + O_WH0) : next_matrix<HID, DP>(P + O_WE0);
}

__global__ void __launch_bounds__(NT, TB <= 4 ? 2 : 1)
rollout_kernel(const float* __restrict__ z0, const unsigned char* __restrict__ P,
               const int* __restrict__ actions, float* __restrict__ out,
               float* __restrict__ rewards, int B, int H, int sample,
               unsigned long long seed, float size_std, float std_lo,
               float std_hi, float temp, int latent_residual) {
    extern __shared__ float4 smem4[];
    const Smem s = carve(reinterpret_cast<unsigned char*>(smem4));
    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * TB;
    constexpr int SD = O * D;
    const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
    const uint32_t k1 = (uint32_t)(seed >> 32);

    // padding rows and columns stay zero for the whole horizon
    for (int i = tid; i < (int)(SMEM_BYTES / 16); i += NT) smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    for (int i = tid; i < TB * SD; i += NT) {
        const int b = i / SD, r = i % SD, o = r / D, d = r % D;
        const int gb = b0 + b;
        s.zs[(o * TB + b) * LDZ + d] = gb < B ? z0[(size_t)gb * SD + r] : 0.f;
    }
    int q = 0;                        // weight chunks used (ring slot parity)
    // the weight stream: each gemm puts the next matrix's first chunk in
    // flight, across heads and steps
    stream_start(s.ring, q, next_matrix<HID, DP>(P + O_WE0));

    for (int t = 0; t < H; ++t) {
        if constexpr (ACT) {
            if (tid < TB) {
                const int gb = b0 + tid;
                s.acts[tid] = gb < B ? actions[(size_t)gb * H + t] : 0;
            }
        }
        // its first barrier orders zs and acts
        dyn_step(s, P, q, OPEN && sample ? next_matrix<HID, 2 * HID>(P + O_WOP0)
                                         : after_heads(P));
        integrate_mean(s, latent_residual);
        __syncthreads();
        if (sample) {
            // z = mean + temp * std * eps; std = size_std on the size columns,
            // lo + (hi - lo) * sigmoid(raw) on pos/vel/latent columns, raw
            // from the output MLP or, with STOVE_OPEN, from the open-loop head
            const float* RAW = nullptr;
            if constexpr (OPEN) RAW = open_head(s, P, q, after_heads(P));
            const float* OUT = raw_out(s);
            constexpr int NCH = (D + 3) / 4;
            for (int i = tid; i < NCH * MR; i += NT) {
                const int c = i / MR, m = i % MR;
                const int o = m / TB, b = m % TB;
                const uint4 bits = philox4x32_10(
                    make_uint4((uint32_t)c, (uint32_t)t, (uint32_t)(b0 + b), (uint32_t)o), k0, k1);
                float nz[4];
                box_muller(bits.x, bits.y, nz[0], nz[1]);
                box_muller(bits.z, bits.w, nz[2], nz[3]);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const int d = 4 * c + u;
                    if (d < D) {
                        const float sd = d < 2 ? size_std
                            : std_lo + (std_hi - std_lo) * sigmoidf(
                                  OPEN ? RAW[m * LDOP + d - 2] : OUT[m * LDOUT + CL + d]);
                        s.zs[m * LDZ + d] = s.zn[m * LDZ + d] + (temp * sd) * nz[u];
                    }
                }
            }
        } else {
            for (int i = tid; i < MR * D; i += NT) {
                const int m = i / D, d = i % D;
                s.zs[m * LDZ + d] = s.zn[m * LDZ + d];
            }
        }
        __syncthreads();
        for (int i = tid; i < TB * SD; i += NT) {
            const int b = i / SD, r = i % SD, o = r / D, d = r % D;
            const int gb = b0 + b;
            if (gb < B) out[((size_t)gb * H + t) * SD + r] = s.zs[(o * TB + b) * LDZ + d];
        }
        if constexpr (REW) {
            // on the predicted mean (s.zn) and this step's [s | r]
            reward_head(s, P, q, next_matrix<HID, DP>(P + O_WE0));
            if (tid < TB && b0 + tid < B) {
                rewards[(size_t)(b0 + tid) * H + t] = reward_pool(s.rw, tid);
            }
        }
    }
    cp_async_wait_all();              // the chunk the last step put in flight
}

}  // namespace

extern "C" {

int stove_rollout_param_bytes() { return (int)N_BYTES; }

int stove_rollout_smem_bytes() { return (int)SMEM_BYTES; }

int stove_rollout_tile() { return TB; }

int stove_rollout_bf16() { return STOVE_BF16; }

// Launches the rollout on `stream`; returns the CUDA error code (0 = ok).
// Pointers are device pointers; params is prepare_params' buffer for this
// library's precision (16-byte aligned); the caller checks shapes and
// allocates out and rewards.  actions (B, H) int32 is read only with
// STOVE_ACT, rewards (B, H) written only with STOVE_REW; each must be
// non-null there.
cudaError_t stove_rollout_launch(const float* z0, const void* params,
                                 const int* actions, float* out, float* rewards,
                                 int B, int H, int sample, unsigned long long seed,
                                 float size_std, float std_lo, float std_hi,
                                 float temp, int latent_residual, void* stream) {
    if (B <= 0 || H <= 0) return cudaErrorInvalidValue;
    if ((ACT && actions == nullptr) || (REW && rewards == nullptr)) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(params) % 16) return cudaErrorMisalignedAddress;
    cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(rollout_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    const int grid = (B + TB - 1) / TB;
    rollout_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        z0, static_cast<const unsigned char*>(params), actions, out, rewards, B, H,
        sample, seed, size_std, std_lo, std_hi, temp, latent_residual);
    return cudaGetLastError();
}

}  // extern "C"
