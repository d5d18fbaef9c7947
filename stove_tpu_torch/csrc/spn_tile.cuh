// The RAT-SPN forward for a tile of samples a block: the evaluator that the
// standalone SPN kernel (spn.cu) and the SuPAIR likelihood kernel
// (likelihood.cu) share, and the packing kernel that lays the parameters
// out for it.
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
// variables, so a leaf region is a contiguous run of the permutation and is
// summed directly.
//
// Bound on this card.  The work a sample is small (object SPN: 4,000 leaf
// terms and 12,000 mixture multiply-adds; background SPN: 12,288 leaf terms
// and 3,024), and the parameters (packed: object SPN 112 KB, background
// 209 KB) are the same for every sample: read once per sample, as the
// warp-per-sample design before this one did, they were ~25x the bytes of
// the inputs through L2.  The evaluator reads them from device memory once a block and
// reuses each from shared memory for every sample of the tile, so the
// bound is the float32 CUDA-core arithmetic of the leaf terms and
// mixtures.
//
// Design.  SPN_THREADS threads, NS samples whose x and w the caller holds
// in shared memory (rows of XS floats, XS = 4 mod 32, so that the lanes of
// a warp, eight samples apart, gather from distinct banks).  The packed
// buffer (ops/fused_spn.py::layout) is streamed through a two-slot ring of
// SPN_CHUNK floats with cp.async, the next slot loading while the block
// computes on the current one:
//   1. leaf chunks, a few leaf regions each, as float4 (mu, sqrt(1/2)/sd,
//      -log sd - log(2 pi)/2, bits of v) in permuted order: a warp takes a
//      (region, eight samples, slice of the region) task; its lanes are
//      LS samples x QP parts of the slice, keep the I leaf sums in
//      registers (no division: a subtract, a multiply and two FMAs a term),
//      and add their parts with shuffles;
//   2. per level, the mixture weights of a few repetitions: a pass over
//      (sample, child region) takes maxima and exps in place, then each
//      thread takes a (sample, r, p, s) and runs the c x c weights from
//      shared memory (float4 broadcasts) against the child exps in
//      registers;
//   3. the root logsumexp, a warp per sample.
// Activations live in shared memory sample-fastest ([r][region][c][n]), so
// the passes over samples read and write without bank conflicts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float SPN_LOG2PI = 1.8378770664093453f;     // log(2 pi)
constexpr float SPN_SQRT_HALF = 0.70710678118654752f;
// threads a block (512 measured 4% faster for the likelihood at 8 frames
// a block, 10% slower for the SPN pair: tools/spn_probe.py, PERF.md)
constexpr int SPN_THREADS = 256;
constexpr int SPN_NW = SPN_THREADS / 32;              // warps a block
constexpr int SPN_CHUNK = 8192;                       // floats a ring slot
static_assert(SPN_THREADS % 32 == 0, "whole warps");

// ---- primitives (inline PTX) ------------------------------------------------
__device__ __forceinline__ void spn_cp16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void spn_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most one committed group is still in flight
__device__ __forceinline__ void spn_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void spn_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ float spn_xor(float v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
}
// ---- end of primitives ------------------------------------------------------

__host__ __device__ constexpr int spn_r4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int spn_imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int spn_imin(int a, int b) { return a < b ? a : b; }

// What the packing kernel reads: the SPN's parameters as models/spn.py holds
// them (natural variable order, logits), the permutation (R, V) int32.
struct SpnSrc {
    const float* mu;          // (R, V, I) leaf means
    const float* raw;         // (R, V, I) raw leaf stds
    const int* perm;          // (R, V)
    const float* logits[4];   // sum_logits_d for d = D-1 .. 0, (R, 2^d, S, c*c)
    const float* root;        // (R*S) root logits
    float min_std, span;      // sd = min_std + span * sigmoid(raw)
};

// Static structure and packed layout of one RAT-SPN shape.  The packed
// buffer (floats): the leaves, R*V*I float4 in permuted order; then per
// level d = D-1 .. 0 and repetition r a block of round4(P*S*c*c) softmaxed
// weights [p][s][i*c + j]; then the R*S root log-weights.  (Functions here,
// constants in SpnShape: a class's constants cannot call its own
// constexpr functions.)
template <int V, int R, int D, int I, int S>
struct SpnLayout {
    static constexpr int L = 1 << D;
    static_assert(D >= 1 && D <= 4 && L <= V, "depth 1-4, a variable a leaf region at least");
    static constexpr int LEAF = R * V * I * 4;

    // leaf region l's first index along the permutation:
    // numpy's linspace(0, V, L + 1).round() (half to even)
    __host__ __device__ static constexpr int bound(int l) {
        const int q = l * V / L, rem = l * V % L;
        return 2 * rem > L ? q + 1 : (2 * rem == L ? q + (q & 1) : q);
    }
    __host__ __device__ static constexpr int nmax() {
        int m = 0;
        for (int l = 0; l < L; ++l) m = spn_imax(m, bound(l + 1) - bound(l));
        return m;
    }
    __host__ __device__ static constexpr int chans(int d) { return d == D - 1 ? I : S; }
    __host__ __device__ static constexpr int wrep(int d) {
        return spn_r4((1 << d) * S * chans(d) * chans(d));
    }
    __host__ __device__ static constexpr int w_off(int d) {
        int off = LEAF;
        for (int e = D - 1; e > d; --e) off += R * wrep(e);
        return off;
    }
    __host__ __device__ static constexpr int rows() {
        int n = 0;
        for (int d = 0; d < D; ++d) n += R * (1 << d) * S;
        return n;
    }
    // level d's weights are staged RG(d) repetitions a ring slot
    __host__ __device__ static constexpr int rg(int d) {
        return spn_imin(R, SPN_CHUNK / wrep(d));
    }
    __host__ __device__ static constexpr int nchunks(int d) { return (R + rg(d) - 1) / rg(d); }
    __host__ __device__ static constexpr int level_chunks() {
        int n = 0;
        for (int d = 0; d < D; ++d) n += nchunks(d);
        return n;
    }
};

template <int V, int R, int D, int I, int S>
struct SpnShape : SpnLayout<V, R, D, I, S> {
    using F = SpnLayout<V, R, D, I, S>;
    using F::L;
    using F::LEAF;
    static constexpr int RL = R * L;
    static constexpr int ROOT = F::w_off(-1);
    static constexpr int FLOATS = ROOT + spn_r4(R * S);
    static constexpr int PACK_ITEMS = R * V * I + F::rows() + 1;

    // one item of the packing: a leaf entry, a softmax row or the root row
    __device__ static void pack(int idx, const SpnSrc& src, float* out) {
        if (idx < R * V * I) {
            const int i = idx % I, rk = idx / I, k = rk % V, r = rk / V;
            const int v = src.perm[r * V + k];
            const int q = (r * V + v) * I + i;
            const float sd = src.min_std + src.span * (1.f / (1.f + expf(-src.raw[q])));
            reinterpret_cast<float4*>(out)[idx] = make_float4(
                src.mu[q], SPN_SQRT_HALF / sd, -logf(sd) - 0.5f * SPN_LOG2PI, __int_as_float(v));
            return;
        }
        idx -= R * V * I;
        for (int d = D - 1; d >= 0; --d) {
            const int per_r = (1 << d) * S, cc = F::chans(d) * F::chans(d);
            if (idx < R * per_r) {
                const float* x = src.logits[D - 1 - d] + (size_t)idx * cc;
                float* y = out + F::w_off(d) + (idx / per_r) * F::wrep(d) + (idx % per_r) * cc;
                float m = x[0];
                for (int j = 1; j < cc; ++j) m = fmaxf(m, x[j]);
                float sum = 0.f;
                for (int j = 0; j < cc; ++j) sum += expf(x[j] - m);
                for (int j = 0; j < cc; ++j) y[j] = expf(x[j] - m) / sum;
                return;
            }
            idx -= R * per_r;
        }
        if (idx == 0) {                                 // root: log_softmax
            float m = src.root[0];
            for (int j = 1; j < R * S; ++j) m = fmaxf(m, src.root[j]);
            float sum = 0.f;
            for (int j = 0; j < R * S; ++j) sum += expf(src.root[j] - m);
            const float lse = logf(sum);
            for (int j = 0; j < R * S; ++j) out[ROOT + j] = src.root[j] - m - lse;
        }
    }
};

// The evaluator for NS samples a block (see the note at the top).
template <int V, int R, int D, int I, int S, int NS>
struct SpnTile : SpnShape<V, R, D, I, S> {
    using Sh = SpnShape<V, R, D, I, S>;
    static constexpr int L = Sh::L, RL = Sh::RL;
    static constexpr int LS = NS >= 8 ? 8 : NS >= 4 ? 4 : NS >= 2 ? 2 : 1;  // samples across lanes
    static constexpr int QP = 32 / LS;                  // parts of a region across lanes
    static constexpr int NO = (NS + LS - 1) / LS;       // lane groups of samples
    static constexpr int NSP = NO * LS;                 // rows of x and w the caller provides
    static constexpr int XS = V + (36 - V % 32) % 32;   // their stride, = 4 mod 32
    // leaf chunks: G regions of at most NMAX variables each
    static constexpr int RB = Sh::nmax() * I * 4;
    static_assert(RB <= SPN_CHUNK, "a leaf region's parameters exceed a ring slot");
    static constexpr int G = spn_imin(SPN_CHUNK / RB, RL);
    static constexpr int NLC = (RL + G - 1) / G;
    static constexpr int WPR = spn_imax(1, SPN_NW / (G * NO));   // warps a region
    static constexpr int PART = R * L * I * NSP;        // floats of one slice's partial sums
    static constexpr int NST = NLC + Sh::level_chunks();
    using Sh::rg;
    using Sh::nchunks;
    // shared scratch: X (leaf partials, then every other level's output),
    // Y (the other levels' outputs), M (child maxima)
    static constexpr int XF = spn_imax(WPR * PART, D > 1 ? R * (L / 4) * S * NSP : 0);
    static constexpr int YF = R * (L / 2) * S * NSP;
    static constexpr int MF = R * L * NSP;
    static constexpr int SCRATCH = spn_r4(XF) + spn_r4(YF) + spn_r4(MF);

    // the packed buffer's span (offset, floats) that stage st stages
    __device__ static void span(int st, int& off, int& n) {
        if (st < NLC) {
            const int g0 = st * G, g1 = spn_imin(g0 + G, RL);
            const int k0 = (g0 / L) * V + Sh::bound(g0 % L);
            const int k1 = ((g1 - 1) / L) * V + Sh::bound((g1 - 1) % L + 1);
            off = k0 * I * 4;
            n = (k1 - k0) * I * 4;
            return;
        }
        st -= NLC;
        for (int d = D - 1; d >= 0; --d) {
            if (st < nchunks(d)) {
                const int r0 = st * rg(d), r1 = spn_imin(R, r0 + rg(d));
                off = Sh::w_off(d) + r0 * Sh::wrep(d);
                n = (r1 - r0) * Sh::wrep(d);
                return;
            }
            st -= nchunks(d);
        }
        off = n = 0;
    }

    __device__ static void fetch(const float* gp, float* ring, int st) {
        int off, n;
        span(st, off, n);
        float* dst = ring + (st & 1) * SPN_CHUNK;
        for (int f = threadIdx.x * 4; f < n; f += SPN_THREADS * 4) spn_cp16(dst + f, gp + off + f);
    }

    // Stage 0 into the ring: the caller starts it before its own loads.
    __device__ static void prefetch(const float* gp, float* ring) {
        fetch(gp, ring, 0);
        spn_commit();
    }

    // start stage st: fetch the next one, wait for this one
    __device__ static const float* begin(const float* gp, float* ring, int st) {
        if (st + 1 < NST) fetch(gp, ring, st + 1);
        spn_commit();
        spn_wait_one();
        __syncthreads();
        return ring + (st & 1) * SPN_CHUNK;
    }

    __device__ static void leaf_chunk(int ch, const float* buf, const float* xs, const float* ws,
                                      float* X) {
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const int g0 = ch * G, gn = spn_imin(G, RL - g0);
        const int k0 = (g0 / L) * V + Sh::bound(g0 % L);
        const float4* b4 = reinterpret_cast<const float4*>(buf);
        const int q = lane / LS;
        for (int t = warp; t < gn * NO * WPR; t += SPN_NW) {
            const int h = t % WPR, o = (t / WPR) % NO, g = g0 + t / (WPR * NO);
            const int r = g / L, l = g % L;
            const int a = Sh::bound(l), b = Sh::bound(l + 1);
            const int ka = a + (b - a) * h / WPR, kb = a + (b - a) * (h + 1) / WPR;
            const int n = o * LS + lane % LS;
            const float* xn = xs + n * XS;
            const float* wn = ws + n * XS;
            float acc[I];
#pragma unroll
            for (int i = 0; i < I; ++i) acc[i] = 0.f;
#pragma unroll 2
            for (int k = ka + q; k < kb; k += QP) {
                const float4* pk = b4 + (r * V + k - k0) * I;
                const float4 p0 = pk[0];
                const int v = __float_as_int(p0.w);
                const float x = xn[v], w = wn[v];
#pragma unroll
                for (int i = 0; i < I; ++i) {
                    const float4 p = i == 0 ? p0 : pk[i];
                    const float zh = (x - p.x) * p.y;
                    acc[i] = fmaf(w, fmaf(-zh, zh, p.z), acc[i]);
                }
            }
#pragma unroll
            for (int m = LS; m < 32; m <<= 1) {
#pragma unroll
                for (int i = 0; i < I; ++i) acc[i] += spn_xor(acc[i], m);
            }
            float* dst = X + h * PART + (r * L + l) * I * NSP + n;
#pragma unroll
            for (int i = 0; i < I; ++i)
                if (i % QP == q) dst[i * NSP] = acc[i];
        }
    }

    // maxima and exps of level d's children, in place
    template <int d>
    __device__ static void exps(float* in, float* M) {
        constexpr int c = Sh::chans(d), NCH = 2 << d;
        constexpr int parts = d == D - 1 ? WPR : 1;
        for (int it = threadIdx.x; it < R * NCH * NSP; it += SPN_THREADS) {
            const int n = it % NSP, rl = it / NSP;
            float* a = in + rl * c * NSP + n;
            float v[c];
#pragma unroll
            for (int i = 0; i < c; ++i) {
                v[i] = a[i * NSP];
#pragma unroll
                for (int h = 1; h < parts; ++h) v[i] += a[h * PART + i * NSP];
            }
            float m = v[0];
#pragma unroll
            for (int i = 1; i < c; ++i) m = fmaxf(m, v[i]);
#pragma unroll
            for (int i = 0; i < c; ++i) a[i * NSP] = expf(v[i] - m);
            M[rl * NSP + n] = m;
        }
    }

    // level d's mixtures for the repetitions of chunk j
    template <int d>
    __device__ static void mix(int j, const float* buf, const float* in, const float* M,
                               float* out) {
        constexpr int c = Sh::chans(d), P = 1 << d, CC = c * c;
        const int r0 = j * rg(d), nr = spn_imin(rg(d), R - r0);
        for (int it = threadIdx.x; it < nr * P * S * NSP; it += SPN_THREADS) {
            const int n = it % NSP;
            int t = it / NSP;
            const int s = t % S;
            t /= S;
            const int p = t % P, r = r0 + t / P;
            const int lc = r * 2 * P + 2 * p;           // left child region
            const float* el = in + lc * c * NSP + n;
            const float* er = el + c * NSP;
            float e_l[c], e_r[c], acc[c];
#pragma unroll
            for (int i = 0; i < c; ++i) {
                e_l[i] = el[i * NSP];
                e_r[i] = er[i * NSP];
                acc[i] = 0.f;
            }
            const float* w = buf + (r - r0) * Sh::wrep(d) + (p * S + s) * CC;
            if constexpr (CC % 4 == 0) {
                const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
                for (int f = 0; f < CC / 4; ++f) {
                    const float4 q = w4[f];
                    acc[(4 * f) / c] = fmaf(q.x, e_r[(4 * f) % c], acc[(4 * f) / c]);
                    acc[(4 * f + 1) / c] = fmaf(q.y, e_r[(4 * f + 1) % c], acc[(4 * f + 1) / c]);
                    acc[(4 * f + 2) / c] = fmaf(q.z, e_r[(4 * f + 2) % c], acc[(4 * f + 2) / c]);
                    acc[(4 * f + 3) / c] = fmaf(q.w, e_r[(4 * f + 3) % c], acc[(4 * f + 3) / c]);
                }
            } else {
#pragma unroll
                for (int f = 0; f < CC; ++f) acc[f / c] = fmaf(w[f], e_r[f % c], acc[f / c]);
            }
            float mixed = 0.f;
#pragma unroll
            for (int i = 0; i < c; ++i) mixed = fmaf(e_l[i], acc[i], mixed);
            const float mx = M[lc * NSP + n] + M[(lc + 1) * NSP + n];
            out[((r * P + p) * S + s) * NSP + n] = logf(fmaxf(mixed, 1e-38f)) + mx;
        }
    }

    template <int d>
    __device__ static void levels(int& st, const float* gp, float* ring, float* X, float* Y,
                                  float* M) {
        float* in = (D - 1 - d) % 2 == 0 ? X : Y;
        float* out = (D - 1 - d) % 2 == 0 ? Y : X;
        for (int j = 0; j < nchunks(d); ++j, ++st) {
            const float* buf = begin(gp, ring, st);
            if (j == 0) {
                exps<d>(in, M);
                __syncthreads();
            }
            mix<d>(j, buf, in, M, out);
            __syncthreads();
        }
        if constexpr (d > 0) levels<d - 1>(st, gp, ring, X, Y, M);
    }

    // The log-densities of the NSP samples in xs/ws into res[NSP] (shared).
    // The caller has called prefetch(gp, ring) and committed its own loads of
    // xs and ws; ends with a block barrier.
    __device__ static void run(const float* xs, const float* ws, const float* gp, float* ring,
                               float* scratch, float* res) {
        float* X = scratch;
        float* Y = X + spn_r4(XF);
        float* M = Y + spn_r4(YF);
        int st = 0;
        for (int ch = 0; ch < NLC; ++ch, ++st) {
            const float* buf = begin(gp, ring, st);
            leaf_chunk(ch, buf, xs, ws, X);
            __syncthreads();
        }
        levels<D - 1>(st, gp, ring, X, Y, M);
        // root: logsumexp over the R*S top sums plus their log-weights
        const float* top = D % 2 == 1 ? Y : X;
        const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
        const float* rw = gp + Sh::ROOT;
        for (int n = warp; n < NSP; n += SPN_NW) {
            float m = __int_as_float((int)0xff800000);   // -inf
            for (int k = lane; k < R * S; k += 32) m = fmaxf(m, top[k * NSP + n] + __ldg(rw + k));
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, spn_xor(m, o));
            float sum = 0.f;
            for (int k = lane; k < R * S; k += 32) sum += expf(top[k * NSP + n] + __ldg(rw + k) - m);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) sum += spn_xor(sum, o);
            if (lane == 0) res[n] = logf(sum) + m;
        }
        __syncthreads();
    }
};

}  // namespace
