// The std-SPH pair ops shared by the streaming engine (pair_engine.cu) and
// the list walk (pair_lists.cu): the launch arguments, the kernel
// polynomial and one struct per op with its pair body and epilogue.
//
// Each op's pair body reads candidate k's j-fields from a shared-memory
// tile J[field][W]; W is the tile's row width (the streaming engine's 128,
// the list walk's 256-entry ring), so one body serves both engines.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

constexpr int TILE = 128;   // candidates per shared-memory tile = lanes of a chunk
constexpr int MAX_F = 24;   // field pointers an op may pass per side
constexpr int MAX_OUT = 8;
constexpr int NCOEF = 14;   // degree-13 kernel polynomial

// Mirror of sphexa_torch.sph.pair_engine.EngineArgs (same field order).
struct EngineArgs {
    const int32_t* starts;   // (NG, W3) run offsets in the sorted arrays
    const int32_t* lens;     // (NG, W3) run lengths
    const float* shift_x;    // (NG, W3) per-run periodic image offsets
    const float* shift_y;
    const float* shift_z;
    const int32_t* ncells;   // (NG,) live runs
    const float* ifields[MAX_F];
    const float* jfields[MAX_F];
    float* outs[MAX_OUT];
    int32_t* nc;             // (n,) neighbour counts, or null
    int32_t n;
    int32_t num_groups;
    int32_t w3;
    int32_t group;
    int32_t fold;
    int32_t sym_j;           // j-field index of 1/h_j^2, or -1
    const float* boxl;       // (3,) fold periods, read on the fold path only
    float K;
    float mhalf_K;           // -K/2 rounded once on the host
    float k_cour;
    float coeffs[NCOEF];
    const int32_t* bits;     // list walk: (NG, slot_cap, 4) marked-lane words
    int32_t slot_cap;        // list walk: slots per group
};

// W from u = d^2/h^2: Horner in s = clamp(u/2 - 1, -1, 1), floored at 0.
__device__ __forceinline__ float wpoly(float u, const float* c) {
    const float s = fminf(fmaxf(u * 0.5f - 1.0f, -1.0f), 1.0f);
    float acc = c[NCOEF - 1];
#pragma unroll
    for (int k = NCOEF - 2; k >= 0; --k) acc = acc * s + c[k];
    return fmaxf(acc, 0.0f);
}

// i-fields: x y z h 1/h^2 m; j-fields: x y z m.
struct DensityOp {
    static constexpr int NI = 6, NJ = 4, NACC = 1, NOUT = 1;
    static constexpr bool WANT_NC = true;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float, float, float, float d2, float* acc,
                                                const EngineArgs& p) {
        acc[0] += J[3][k] * wpoly(d2 * I[4], p.coeffs);
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3];
        out[0] = p.K * (I[5] + acc[0]) / (hi * hi * hi);
    }
};

// i-fields: x y z h 1/h^2; j-fields: x y z m/rho. Six moment sums, then the
// exponent-renormalised inverse (the power-of-two factor cancels exactly).
struct IadOp {
    static constexpr int NI = 5, NJ = 4, NACC = 6, NOUT = 6;
    static constexpr bool WANT_NC = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float vw = J[3][k] * wpoly(d2 * I[4], p.coeffs);
        acc[0] += rx * rx * vw;
        acc[1] += rx * ry * vw;
        acc[2] += rx * rz * vw;
        acc[3] += ry * ry * vw;
        acc[4] += ry * rz * vw;
        acc[5] += rz * rz * vw;
    }
    __device__ __forceinline__ static float exp_of(float v) {
        return v != 0.0f ? floorf(log2f(fabsf(v) + 1e-45f)) : 0.0f;
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3];
        const float esum = exp_of(acc[0]) + exp_of(acc[1]) + exp_of(acc[2]) +
                           exp_of(acc[3]) + exp_of(acc[4]) + exp_of(acc[5]);
        const float norm = exp2f(-floorf(esum / 6.0f));
        const float t11 = acc[0] * norm, t12 = acc[1] * norm, t13 = acc[2] * norm;
        const float t22 = acc[3] * norm, t23 = acc[4] * norm, t33 = acc[5] * norm;
        const float det = t11 * t22 * t33 + 2.0f * t12 * t23 * t13 -
                          t11 * t23 * t23 - t22 * t13 * t13 - t33 * t12 * t12;
        const float factor = norm * (hi * hi * hi) / (det * p.K);
        out[0] = (t22 * t33 - t23 * t23) * factor;
        out[1] = (t13 * t23 - t33 * t12) * factor;
        out[2] = (t12 * t23 - t22 * t13) * factor;
        out[3] = (t11 * t33 - t13 * t13) * factor;
        out[4] = (t13 * t12 - t11 * t23) * factor;
        out[5] = (t11 * t22 - t12 * t12) * factor;
    }
};

// i-fields: x y z h 1/h^2 1/h^3 vx vy vz c p/rho^2 m/rho c11 c12 c13 c22 c23 c33
// j-fields: x y z 1/h^2 vx vy vz c m m/(rho h^3) p/rho c11 c12 c13 c22 c23 c33
// Accumulators: momentum x/y/z, energy (sums) and the signal velocity (max).
struct MomentumEnergyStdOp {
    static constexpr int NI = 18, NJ = 17, NACC = 5, NOUT = 5;
    static constexpr bool WANT_NC = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float w_i = wpoly(d2 * I[4], p.coeffs) * I[5];
        const float mjw = J[9][k] * wpoly(d2 * J[3][k], p.coeffs);
        const float inv_dist = rsqrtf(d2);
        const float vx_ij = I[6] - J[4][k];
        const float vy_ij = I[7] - J[5][k];
        const float vz_ij = I[8] - J[6][k];
        const float rv = rx * vx_ij + ry * vy_ij + rz * vz_ij;
        const float w_ij = rv * inv_dist;
        // Monaghan constant-alpha AV, halved per pair (kernels.hpp:60-84)
        const float cij = I[9] + J[7][k];
        const float v_signal = 0.5f * cij - 2.0f * w_ij;
        const float visc = 0.5f * (w_ij < 0.0f ? -v_signal * w_ij : 0.0f);
        acc[4] = fmaxf(acc[4], cij - 3.0f * w_ij);

        const float tA1_i = I[12] * rx + I[13] * ry + I[14] * rz;
        const float tA2_i = I[13] * rx + I[15] * ry + I[16] * rz;
        const float tA3_i = I[14] * rx + I[16] * ry + I[17] * rz;
        const float tA1_j = J[11][k] * rx + J[12][k] * ry + J[13][k] * rz;
        const float tA2_j = J[12][k] * rx + J[14][k] * ry + J[15][k] * rz;
        const float tA3_j = J[13][k] * rx + J[15][k] * ry + J[16][k] * rz;

        const float mj_pro_i = J[8][k] * I[10];
        const float vmi = visc * I[11];
        const float a = w_i * (mj_pro_i + vmi);
        const float b = mjw * (J[10][k] + visc);
        acc[0] += a * tA1_i + b * tA1_j;
        acc[1] += a * tA2_i + b * tA2_j;
        acc[2] += a * tA3_i + b * tA3_j;
        const float a_e = w_i * (2.0f * mj_pro_i + vmi);
        const float b_e = visc * mjw;
        acc[3] += vx_ij * (a_e * tA1_i + b_e * tA1_j) +
                  vy_ij * (a_e * tA2_i + b_e * tA2_j) +
                  vz_ij * (a_e * tA3_i + b_e * tA3_j);
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3], ci = I[9];
        const float v = acc[4] > 0.0f ? acc[4] : ci;
        out[0] = p.K * acc[0];
        out[1] = p.K * acc[1];
        out[2] = p.K * acc[2];
        out[3] = p.mhalf_K * acc[3];
        out[4] = p.k_cour * hi / v;
    }
};
