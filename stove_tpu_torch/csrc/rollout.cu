// Fused whole-horizon STOVE dynamics rollout for Hopper (sm_90a).
//
// Replaces: stove_tpu/ops/pallas_rollout.py::rollout_states and
// ::rollout_act (the Pallas kernel body _make_kernel, its graph-net core
// dyn_tile_core with the action term, Euler integration integrate_mean, the
// reward head reward_tile_pool, and the in-kernel Box-Muller noise of
// _normals/_bits_to_normal_pairs).  Same contract: z0 (B, O, 6+cl) f32 and,
// for an action-conditioned model (STOVE_ACT=1), actions (B, H) int32 in;
// states (B, H, O, 6+cl) f32 and, with the reward head (STOVE_REW=1), the
// raw reward probabilities (B, H) f32 out; mean or sampled, all H steps in
// one launch; state and every activation stay on chip, device memory sees
// z0 and the actions in and the trajectory and rewards out.
//
// Bound on this card.  One frame (one sample, one step, all O objects)
// costs ~613.6k multiply-adds at O=3, h=128, cl=16 (6 ordered pairs), and
// the bytes are only z0 + the trajectory (264 B per frame), so the work
// is compute bound: at B=16384, H=92 it is 1.85 TFLOP against ~0.4 GB of
// traffic.  The reward head adds 2 heads x O x (2h*h + h*h + h) = 295,680
// multiply-adds a frame (1.48x the action-free frame).  This kernel
// computes in f32 on the CUDA cores (67 TFLOP/s peak), which keeps the
// mean path within 1e-4 of the plain PyTorch version; the bf16
// tensor-core bound (989 TFLOP/s) is what a later wgmma version could
// approach.  At the planner's leaf shape (B = 360, H = 10) the launch is
// latency bound: 23 blocks on 132 SMs.
//
// Design.  The TPU kernel kept all weights resident in VMEM; here the f32
// weights (172,839 parameters, 691 KB, and 136,960 more for the reward
// head) are far above a block's 227 KB of
// shared memory, so they stay in global memory (L2 holds them all) and
// each layer streams through a 32 KB shared staging buffer one chunk of
// rows at a time, the next chunk in flight in registers while the current
// one is used.  Each block thus reads every weight once per step; letting
// the 8 warps read weights through L1 instead was 1.35x slower, and
// halving the tile (TB, samples per block) is 1.4x slower, since the
// weight traffic and the fixed costs per frame grow as 1/TB.  A block owns TB samples for the whole
// horizon (a loop over H inside the block replaces the TPU's sequential
// fori_loop).  Activations live in shared memory feature-major,
// X[k * ld + m], with m running over (object, sample) rows -- or over
// (ordered pair, sample) rows for the relational MLP -- which is the TPU's
// lane-stacked layout.  Every layer is one block-wide matmul
// Y = act(X @ W + b): each thread owns a TM x 4 register tile (4 adjacent
// output features, TM adjacent rows); a warp covers 32 features x 4 row
// groups, so per k it reads one 128 B wavefront of weights and four row
// slices of X; sums run in f32 in k order.  The receiver/sender split of
// the first relational layer is one N=2h matmul; pair activations
// relu(recv_o + send_j + b) are then formed for the O(O-1) ordered pairs
// (the diagonal skipped, as the mask in dynamics.py does) and the
// attention-gated pair sum is reduced per receiver.  The first output
// layer contracts [s | r] with K=2h, i.e. its self and relational halves
// stacked.  The action enters as its row of embed layer 0, added before
// that layer's ReLU; the reward head runs after the state update on the
// predicted mean, still in shared memory, in buffers the next step
// overwrites.  Noise: Philox4x32-10 keyed by a seed the wrapper draws from the
// caller's torch.Generator, counter (chunk, step, sample, object), both
// Box-Muller branches.
//
// The dynamics core (shapes, parameter layout, block-wide matmul, one
// dynamics step, Euler integration, the reward head) lives in
// dyn_core.cuh, shared with the posterior scan kernel (scan.cu).

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

__global__ void __launch_bounds__(NT, 1)
rollout_kernel(const float* __restrict__ z0, const float* __restrict__ P,
               const int* __restrict__ actions, float* __restrict__ out,
               float* __restrict__ rewards, int B, int H, int sample,
               unsigned long long seed, float size_std, float std_lo,
               float std_hi, float temp, int latent_residual) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    float* zs = smem;                 // (D, LDO) state
    float* AE = zs + ZS_SIZE;         // scratch: two (h, LDO) or one (h, LDP)
    float* AEb = AE + HID * LDO;
    float* SR = AE + AE_SIZE;         // (2h, LDO): rows [0,h) s, [h,2h) r
    float* P2 = SR + SR_SIZE;         // (2h, LDO) recv|send, then (h, LDP)
    float* LG = P2 + P2_SIZE;         // (MP) pair attention weights
    float* WS = LG + LG_SIZE;         // weight staging chunk
    float* RW = WS + WS_FLOATS;       // (4, LDO) reward head rows
    int* ACTS = reinterpret_cast<int*>(RW + RW_SIZE);   // (TB) the step's actions

    const int tid = threadIdx.x;
    const int b0 = blockIdx.x * TB;
    constexpr int SD = O * D;
    const uint32_t k0 = (uint32_t)(seed & 0xffffffffull);
    const uint32_t k1 = (uint32_t)(seed >> 32);

    for (int i = tid; i < TB * SD; i += NT) {
        const int b = i / SD, r = i % SD, o = r / D, d = r % D;
        const int gb = b0 + b;
        zs[d * LDO + o * TB + b] = gb < B ? z0[(size_t)gb * SD + r] : 0.f;
    }
    __syncthreads();

    for (int t = 0; t < H; ++t) {
        if constexpr (ACT) {
            if (tid < TB) {
                const int gb = b0 + tid;
                ACTS[tid] = gb < B ? actions[(size_t)gb * H + t] : 0;
            }
        }
        dyn_forward(zs, P, AE, AEb, SR, P2, LG, WS, ACTS);
        integrate_mean(zs, AE, AEb, latent_residual);   // mean into AEb
        __syncthreads();
        if (sample) {
            // z = mean + temp * std * eps; std = size_std on the size rows,
            // lo + (hi - lo) * sigmoid(raw) on pos/vel/latent rows
            constexpr int NCH = (D + 3) / 4;
            for (int i = tid; i < NCH * M; i += NT) {
                const int c = i / M, m = i % M;
                const int o = m / TB, b = m % TB;
                const uint4 bits = philox4x32_10(
                    make_uint4((uint32_t)c, (uint32_t)t, (uint32_t)(b0 + b), (uint32_t)o), k0, k1);
                float nz[4];
                box_muller(bits.x, bits.y, nz[0], nz[1]);
                box_muller(bits.z, bits.w, nz[2], nz[3]);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int d = 4 * c + q;
                    if (d < D) {
                        const float sd = d < 2 ? size_std
                            : std_lo + (std_hi - std_lo) * sigmoidf(AE[(CL + d) * LDO + m]);
                        zs[d * LDO + m] = AEb[d * LDO + m] + (temp * sd) * nz[q];
                    }
                }
            }
        } else {
            for (int i = tid; i < D * M; i += NT) {
                const int d = i / M, m = i % M;
                zs[d * LDO + m] = AEb[d * LDO + m];
            }
        }
        __syncthreads();
        for (int i = tid; i < TB * SD; i += NT) {
            const int b = i / SD, r = i % SD, o = r / D, d = r % D;
            const int gb = b0 + b;
            if (gb < B) out[((size_t)gb * H + t) * SD + r] = zs[d * LDO + o * TB + b];
        }
        if constexpr (REW) {
            // on the predicted mean (still in AEb) and this step's [s ; r]
            reward_head(AEb, SR, P, P2, AE, RW, WS);
            if (tid < TB && b0 + tid < B) {
                rewards[(size_t)(b0 + tid) * H + t] = reward_pool(RW, tid);
            }
        }
    }
}

}  // namespace

extern "C" {

int stove_rollout_param_count() { return N_PARAMS; }

int stove_rollout_smem_bytes() { return (int)SMEM_BYTES; }

int stove_rollout_tile() { return TB; }

// Launches the rollout on `stream`; returns the CUDA error code (0 = ok).
// Pointers are device pointers; the caller checks shapes and allocates out
// and rewards.  actions (B, H) int32 is read only with STOVE_ACT, rewards
// (B, H) written only with STOVE_REW; each must be non-null there.
cudaError_t stove_rollout_launch(const float* z0, const float* params,
                                 const int* actions, float* out, float* rewards,
                                 int B, int H, int sample, unsigned long long seed,
                                 float size_std, float std_lo, float std_hi,
                                 float temp, int latent_residual, void* stream) {
    if (B <= 0 || H <= 0) return cudaErrorInvalidValue;
    if ((ACT && actions == nullptr) || (REW && rewards == nullptr)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        rollout_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    const int grid = (B + TB - 1) / TB;
    rollout_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
        z0, params, actions, out, rewards, B, H, sample, seed, size_std, std_lo,
        std_hi, temp, latent_residual);
    return cudaGetLastError();
}

}  // extern "C"
