// One sample's RAT-SPN forward, evaluated by one warp from values in shared
// memory: the device function that the standalone SPN kernel (spn.cu) and
// the SuPAIR likelihood kernel (likelihood.cu) share.
//
// Counterpart of stove_tpu/ops/pallas_spn.py::spn_tile_body.  What it
// computes, for repetition r, leaf region l, leaf i, level d, region p and
// sum node s (models/spn.py::spn_log_prob):
//   leaf    A[r,l,i] = sum_{k in region l} w[v] * log N(x[v]; mu, sd), v = perm[r,k]
//   level   m = max_i left_i + max_j right_j,
//           mixed_s = sum_i e^{left_i - max left} * sum_j W[r,p,s,i,j] e^{right_j - max right},
//           next[r,p,s] = log(max(mixed_s, 1e-38)) + m
//   root    logsumexp_{r,s}(top[r,s] + root_logw[r,s])
// The TPU kernel contracts the leaf log-densities with the (V, L) 0/1 scope
// matrix on the MXU; here the scope is a partition of the permuted
// variables, so each leaf region is a contiguous run of the permutation and
// is summed directly: the wrapper hands in the leaf parameters already in
// permuted order ([r, k, i] = leaf (r, perm[r, k], i)), so a lane walks its
// region's k in order and gathers x and w through perm.
//
// Bound: the work is tiny (obj SPN 4,000 leaf terms, bg 12,288, a few
// thousand mixture MACs per sample), so a kernel around it is bound by
// latency, not by bytes or FLOPs.  Lanes split the (r, l, i) leaf sums and
// the (r, p, s) mixtures; the leaf parameters (obj 48 KB, bg 147 KB as
// mu/sd/log sd) are read through L1 (__ldg), where every warp of the SM
// shares them, rather than staged per block; the root reduction is serial
// in lane 0 (R*S <= 40 terms).  The caller's per-warp scratch holds
// SCRATCH floats.  The result is valid in lane 0; the function ends with
// __syncwarp() so the caller may reuse the scratch at once.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float SPN_LOG2PI = 1.8378770664093453f;   // log(2 pi)

struct SpnParams {
    const int* perm;      // (R, V) variable permutation per repetition
    const int* bounds;    // (L + 1) leaf region bounds along the permutation
    const float* mu;      // (R, V, I) leaf means, permuted order
    const float* sd;      // (R, V, I) leaf stds, permuted order
    const float* logsd;   // (R, V, I) their logs
    const float* sumw;    // levels d = D-1 .. 0, each (R, 2^d, S, c*c)
    const float* root;    // (R * S) root log-weights
};

template <int V, int R, int D, int I, int S>
struct Spn {
    static constexpr int L = 1 << D;
    static constexpr int C = I > S ? I : S;
    static constexpr int SCRATCH = (3 * C + 1) * R * L;   // floats per warp

    __device__ static float log_prob(const float* xs, const float* ws,
                                     const SpnParams& p, float* scratch,
                                     int lane) {
        float* A = scratch;               // activations (R, regions, c)
        float* Bn = A + R * L * C;        // next level's activations
        float* E = Bn + R * L * C;        // (R, P, 2c) exps of both children
        float* Mx = E + R * L * C;        // (R, P) summed child maxima

        // leaf regions: A[(r*L + l)*I + i]
        for (int idx = lane; idx < R * L * I; idx += 32) {
            const int i = idx % I, rl = idx / I, l = rl % L, r = rl / L;
            const int a = __ldg(p.bounds + l), b = __ldg(p.bounds + l + 1);
            float acc = 0.f;
            for (int k = a; k < b; ++k) {
                const int v = __ldg(p.perm + r * V + k);
                const int q = (r * V + k) * I + i;
                const float z = (xs[v] - __ldg(p.mu + q)) / __ldg(p.sd + q);
                const float ll = -0.5f * (z * z + SPN_LOG2PI) - __ldg(p.logsd + q);
                acc += ll * ws[v];
            }
            A[idx] = acc;
        }
        __syncwarp();

        const float* W = p.sumw;
        int c = I;
        for (int d = D - 1; d >= 0; --d) {
            const int P = 1 << d;
            // per (r, p): maxima of both children and their exps
            for (int idx = lane; idx < R * P; idx += 32) {
                const float* lf = A + (2 * idx) * c;     // region 2p of rep r
                const float* rt = lf + c;                // region 2p + 1
                float ml = lf[0], mr = rt[0];
                for (int i = 1; i < c; ++i) {
                    ml = fmaxf(ml, lf[i]);
                    mr = fmaxf(mr, rt[i]);
                }
                float* e = E + idx * 2 * c;
                for (int i = 0; i < c; ++i) {
                    e[i] = expf(lf[i] - ml);
                    e[c + i] = expf(rt[i] - mr);
                }
                Mx[idx] = ml + mr;
            }
            __syncwarp();
            // per (r, p, s): the factorised log-sum-product
            for (int idx = lane; idx < R * P * S; idx += 32) {
                const int rp = idx / S;
                const float* el = E + rp * 2 * c;
                const float* er = el + c;
                const float* w = W + idx * c * c;        // [s, i*c + j]
                float mixed = 0.f;
                for (int i = 0; i < c; ++i) {
                    float t = 0.f;
                    for (int j = 0; j < c; ++j) t += __ldg(w + i * c + j) * er[j];
                    mixed += el[i] * t;
                }
                Bn[idx] = logf(fmaxf(mixed, 1e-38f)) + Mx[rp];
            }
            __syncwarp();
            W += R * P * S * c * c;
            float* t = A; A = Bn; Bn = t;
            c = S;
        }

        // root: logsumexp over the R*S top sums plus their log-weights
        float out = 0.f;
        if (lane == 0) {
            float m = A[0] + __ldg(p.root);
            for (int k = 1; k < R * S; ++k) m = fmaxf(m, A[k] + __ldg(p.root + k));
            float s = 0.f;
            for (int k = 0; k < R * S; ++k) s += expf(A[k] + __ldg(p.root + k) - m);
            out = logf(s) + m;
        }
        __syncwarp();
        return out;
    }
};

}  // namespace
