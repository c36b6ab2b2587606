// The std-SPH and VE pair ops shared by the streaming engine
// (pair_engine.cu) and the list walk (pair_lists.cu): the launch
// arguments, the kernel polynomials and one struct per op with its pair
// body and epilogue. Each body is the JAX package's pair_body of the same
// op (sphexa_tpu/sph/pallas_pairs.py) with its field order and signs.
//
// Each op's pair body reads candidate k's j-fields from a shared-memory
// window J[field][W]; W is the window's row width (engine_window.cuh),
// so one body serves both engines.
//
// Every op's mask is the SPH support test d^2 < 4 h_i^2 (the gravity near
// field, which has no cutoff, is a kernel of its own: gravity_p2p.cu). SYM
// says whether its mask may add the symmetric cutoff d^2 < 4 h_j^2 (the
// momentum ops, when the launch names a sym_j field): the engines compile
// the mask with and without it.
//
// NC is the kernel polynomial's coefficient count, a template parameter of
// every op: 14 for the sinc family (degree 13) and 20 for wendland-c6
// (degree 19, sphexa_tpu/sph/kernels.py). The engines instantiate both and
// pick one at launch from EngineArgs.ncoef, so the sinc ops' code is the
// same as with one fixed count, and wendland-c6 pays for its own degree only.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

constexpr int TILE = 128;   // lanes of a chunk: one 128-aligned row of the sorted arrays
constexpr int MAX_F = 32;   // field pointers an op may pass per side
constexpr int MAX_OUT = 8;
constexpr int NCOEF_SINC = 14;      // degree-13 sinc-family polynomial
constexpr int NCOEF_WENDLAND = 20;  // degree-19 wendland-c6 polynomial
constexpr int MAX_NCOEF = 20;       // coefficient slots of EngineArgs
// layout version of EngineArgs, mirrored in sphexa_torch/kernels/build.py
// and sphexa_torch/sph/pair_engine.py
constexpr int ABI_VERSION = 9;

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
    float coeffs[MAX_NCOEF]; // the first ncoef used
    const int32_t* bits;     // list walk: (NG, slot_cap, 4) marked-lane words
    int32_t slot_cap;        // list walk: slots per group
    float dcoeffs[MAX_NCOEF];  // VE grad-h: dterh = -(3 W + v dW/dv) polynomial
    float alphamin;          // AV switches
    float alphamax;
    float decay_c;
    float at_min;            // VE momentum: Atwood ramp
    float at_max;
    float ramp;
    const float* dt;         // AV switches: () device scalar, the step's dt
    int32_t variant;         // template form: divv/curlv gradv, momentum av_clean
    // list walk: the mask phase's accepted-candidate words of every group,
    // (word_off[g] + j) * group + t for word j of target t (words of 32
    // candidates of the group's marked-lane sequence), or null; mode 1
    // writes them, mode 2 reads them instead of running the mask phase
    uint32_t* mask_words;
    const int32_t* word_off;
    int32_t mask_mode;
    int32_t ncoef;           // NCOEF_SINC or NCOEF_WENDLAND: the op form launched
    // rows of every j-field: n, or under a mesh the j-buffer [own slab |
    // halo rows] that the runs index (ABI 9; the wrapper checks the
    // fields' lengths and the runs stay inside it)
    int32_t nj;
};

// The kernel polynomial of NC coefficients by Horner in s. The sinc fits'
// terms are small (at most 0.22 against W's peak of 1), and their steps
// may contract into FMAs. wendland-c6's degree-19 terms reach 3 and cancel
// to W: there an FMA rounds apart from the plain version's product and sum
// by up to 8e-7 of the peak, and a lattice shell at the support's edge sums
// that difference coherently (past the momentum ops' tolerance against the
// plain version at an evolved Sedov 100^3 state). So the 20-coefficient
// form rounds each
// product and each sum as the plain version does (__fmul_rn, __fadd_rn),
// and its W and dterh are the plain version's bit for bit.
template <int NC>
__device__ __forceinline__ float horner(float s, const float* c) {
    float acc = c[NC - 1];
    if constexpr (NC == NCOEF_WENDLAND) {
#pragma unroll
        for (int k = NC - 2; k >= 0; --k) acc = __fadd_rn(__fmul_rn(acc, s), c[k]);
    } else {
#pragma unroll
        for (int k = NC - 2; k >= 0; --k) acc = acc * s + c[k];
    }
    return acc;
}

// W from u = d^2/h^2: the polynomial in s = clamp(u/2 - 1, -1, 1), floored
// at 0.
template <int NC>
__device__ __forceinline__ float wpoly(float u, const float* c) {
    return fmaxf(horner<NC>(fminf(fmaxf(u * 0.5f - 1.0f, -1.0f), 1.0f), c), 0.0f);
}

// dterh from u = d^2/h^2: the same polynomial form with no zero floor.
template <int NC>
__device__ __forceinline__ float dpoly(float u, const float* c) {
    return horner<NC>(fminf(fmaxf(u * 0.5f - 1.0f, -1.0f), 1.0f), c);
}

// t = (C r) w with the symmetric IAD tensor C = (c11 c12 c13 c22 c23 c33).
__device__ __forceinline__ void iad_project(float c11, float c12, float c13, float c22,
                                            float c23, float c33, float rx, float ry,
                                            float rz, float w, float* t) {
    t[0] = (c11 * rx + c12 * ry + c13 * rz) * w;
    t[1] = (c12 * rx + c22 * ry + c23 * rz) * w;
    t[2] = (c13 * rx + c23 * ry + c33 * rz) * w;
}

// i-fields: x y z h 1/h^2 m; j-fields: x y z m.
template <int NC>
struct DensityOp {
    static constexpr int NI = 6, NJ = 4, NACC = 1, NOUT = 1;
    static constexpr bool WANT_NC = true;
    static constexpr bool SYM = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float, float, float, float d2, float* acc,
                                                const EngineArgs& p) {
        acc[0] += J[3][k] * wpoly<NC>(d2 * I[4], p.coeffs);
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3];
        out[0] = p.K * (I[5] + acc[0]) / (hi * hi * hi);
    }
};

// i-fields: x y z h 1/h^2; j-fields: x y z m/rho. Six moment sums, then the
// exponent-renormalised inverse (the power-of-two factor cancels exactly).
template <int NC>
struct IadOp {
    static constexpr int NI = 5, NJ = 4, NACC = 6, NOUT = 6;
    static constexpr bool WANT_NC = false;
    static constexpr bool SYM = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float vw = J[3][k] * wpoly<NC>(d2 * I[4], p.coeffs);
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
template <int NC>
struct MomentumEnergyStdOp {
    static constexpr int NI = 18, NJ = 17, NACC = 5, NOUT = 5;
    static constexpr bool WANT_NC = false;
    static constexpr bool SYM = true;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float w_i = wpoly<NC>(d2 * I[4], p.coeffs) * I[5];
        const float mjw = J[9][k] * wpoly<NC>(d2 * J[3][k], p.coeffs);
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

// ---------------------------------------------------------------------------
// VE ops (pallas_pairs.py pallas_ve_def_gradh, pallas_iad_divv_curlv,
// pallas_av_switches, pallas_momentum_energy_ve). The VE projections carry
// the reference's sign: tA = -(C r) W, with the minus folded into w.
// ---------------------------------------------------------------------------

// i-fields: x y z h 1/h^2 m xm; j-fields: x y z m xm.
// Sums: kx (xm W), whomega (xm dterh), wrho0 (m dterh).
template <int NC>
struct VeDefGradhOp {
    static constexpr int NI = 7, NJ = 5, NACC = 3, NOUT = 2;
    static constexpr bool WANT_NC = false;
    static constexpr bool SYM = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float, float, float, float d2, float* acc,
                                                const EngineArgs& p) {
        const float u = d2 * I[4];
        const float w = wpoly<NC>(u, p.coeffs);
        const float dterh = dpoly<NC>(u, p.dcoeffs);
        acc[0] += J[4][k] * w;
        acc[1] += J[4][k] * dterh;
        acc[2] += J[3][k] * dterh;
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3], mi = I[5], xmi = I[6], K = p.K;
        const float h3inv = 1.0f / (hi * hi * hi);
        const float kx = (xmi + acc[0]) * K * h3inv;
        float whomega = (-3.0f * xmi + acc[1]) * K * h3inv / hi;
        const float wrho0 = (-3.0f * mi + acc[2]) * K * h3inv / hi;
        whomega = whomega * mi / xmi + (kx - K * xmi * h3inv) * wrho0;
        const float rho = kx * mi / xmi;
        const float dhdrho = -hi / (rho * 3.0f);
        out[0] = kx;
        out[1] = 1.0f - dhdrho * whomega;
    }
};

// i-fields: x y z h 1/h^2 c11 c12 c13 c22 c23 c33 knorm vx vy vz
// j-fields: x y z xm vx vy vz
// GRADV: the nine sums xm v_ji,a tA_b -> divv, curlv and the six
// symmetrised velocity-gradient components; else four sums -> divv, curlv.
template <bool GRADV, int NC>
struct DivvCurlvOp {
    static constexpr int NI = 15, NJ = 7, NACC = GRADV ? 9 : 4, NOUT = GRADV ? 8 : 2;
    static constexpr bool WANT_NC = false;
    static constexpr bool SYM = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float w = -wpoly<NC>(d2 * I[4], p.coeffs);
        float t[3];
        iad_project(I[5], I[6], I[7], I[8], I[9], I[10], rx, ry, rz, w, t);
        const float mw = J[3][k];
        const float v[3] = {J[4][k] - I[12], J[5][k] - I[13], J[6][k] - I[14]};
        if constexpr (GRADV) {
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b) acc[3 * a + b] += mw * v[a] * t[b];
        } else {
            acc[0] += mw * (v[0] * t[0] + v[1] * t[1] + v[2] * t[2]);
            acc[1] += mw * (v[2] * t[1] - v[1] * t[2]);
            acc[2] += mw * (v[0] * t[2] - v[2] * t[0]);
            acc[3] += mw * (v[1] * t[0] - v[0] * t[1]);
        }
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs&) {
        const float knorm = I[11];
        if constexpr (GRADV) {
            const float cx = acc[7] - acc[5], cy = acc[2] - acc[6], cz = acc[3] - acc[1];
            out[0] = knorm * (acc[0] + acc[4] + acc[8]);
            out[1] = knorm * sqrtf(cx * cx + cy * cy + cz * cz);
            out[2] = knorm * acc[0];
            out[3] = knorm * (acc[1] + acc[3]);
            out[4] = knorm * (acc[2] + acc[6]);
            out[5] = knorm * acc[4];
            out[6] = knorm * (acc[5] + acc[7]);
            out[7] = knorm * acc[8];
        } else {
            out[0] = knorm * acc[0];
            out[1] = knorm * sqrtf(acc[1] * acc[1] + acc[2] * acc[2] + acc[3] * acc[3]);
        }
    }
};

// i-fields: x y z h 1/h^2 K/h^3 c divv c11 c12 c13 c22 c23 c33 vx vy vz alpha
// j-fields: x y z c vx vy vz xm/kx divv
// Accumulators: the signal velocity (max from 0) and grad(divv) (sums).
// The step's dt is read from p.dt on the card.
template <int NC>
struct AvSwitchesOp {
    static constexpr int NI = 18, NJ = 9, NACC = 4, NOUT = 1;
    static constexpr bool WANT_NC = false;
    static constexpr bool SYM = false;
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float w = -wpoly<NC>(d2 * I[4], p.coeffs) * I[5];
        const float vx_ij = I[14] - J[4][k], vy_ij = I[15] - J[5][k], vz_ij = I[16] - J[6][k];
        const float rv = rx * vx_ij + ry * vy_ij + rz * vz_ij;
        const float inv_dist = rsqrtf(d2);
        const float vsig = rv < 0.0f ? I[6] + J[3][k] - 3.0f * rv * inv_dist : 0.0f;
        acc[0] = fmaxf(acc[0], vsig);
        float t[3];
        iad_project(I[8], I[9], I[10], I[11], I[12], I[13], rx, ry, rz, w, t);
        const float factor = J[7][k] * (I[7] - J[8][k]);
        acc[1] += factor * t[0];
        acc[2] += factor * t[1];
        acc[3] += factor * t[2];
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3], ci = I[6], divvi = I[7], alpha_i = I[17];
        // 1e-40 is a float32 denormal: the build keeps denormals (no
        // -ftz), so an isolated particle's decay stays finite
        const float vijsignal = fmaxf(acc[0], 1e-40f * ci);
        const float graddivv = sqrtf(acc[1] * acc[1] + acc[2] * acc[2] + acc[3] * acc[3]);
        const float a_const = hi * hi * graddivv;
        const float alphaloc =
            divvi < 0.0f ? p.alphamax * a_const / (a_const + hi * fabsf(divvi) + 0.05f * ci)
                         : 0.0f;
        const float decay = hi / (p.decay_c * vijsignal);
        const float target = fmaxf(alphaloc, p.alphamin);
        const float alphadot = (target - alpha_i) / decay;
        const float alpha_decayed = alpha_i + alphadot * (*p.dt);
        out[0] = alphaloc >= alpha_i ? alphaloc : alpha_decayed;
    }
};

// i-fields: x y z h 1/h^2 1/h^3 vx vy vz c alpha xm xm^2 ln(xm) rho 1/rho
//           p/(kx m^2 gradh) c11 c12 c13 c22 c23 c33 [eta_crit gv11..gv33]
// j-fields: x y z 1/h^2 1/h^3 vx vy vz c alpha m xm xm^2 ln(xm) rho 1/rho
//           p/(kx m^2 gradh) c11 c12 c13 c22 c23 c33 [gv11..gv33]
// Accumulators: momentum x/y/z, energy, viscous energy (sums), the signal
// velocity (max from 0).
template <bool AVCLEAN, int NC>
struct MomentumEnergyVeOp {
    static constexpr int NI = AVCLEAN ? 30 : 23, NJ = AVCLEAN ? 29 : 23, NACC = 6, NOUT = 5;
    static constexpr bool WANT_NC = false;
    static constexpr bool SYM = true;
    // r . G r with the symmetric velocity gradient G = (g11 g12 g13 g22 g23 g33)
    __device__ __forceinline__ static float sym_gv(float g11, float g12, float g13, float g22,
                                                   float g23, float g33, float rx, float ry,
                                                   float rz) {
        return rx * (g11 * rx + g12 * ry + g13 * rz) + ry * (g22 * ry + g23 * rz) +
               rz * (g33 * rz);
    }
    template <int W>
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[W], int k,
                                                float rx, float ry, float rz, float d2,
                                                float* acc, const EngineArgs& p) {
        const float u_i = d2 * I[4];
        const float u_j = d2 * J[3][k];
        const float w_i = -wpoly<NC>(u_i, p.coeffs) * I[5];
        const float w_j = -wpoly<NC>(u_j, p.coeffs) * J[4][k];
        const float vx_ij = I[6] - J[5][k], vy_ij = I[7] - J[6][k], vz_ij = I[8] - J[7][k];
        float rv = rx * vx_ij + ry * vy_ij + rz * vz_ij;
        const float inv_dist = rsqrtf(d2);
        if constexpr (AVCLEAN) {
            const float d1 = sym_gv(I[24], I[25], I[26], I[27], I[28], I[29], rx, ry, rz);
            const float d2_ = sym_gv(J[23][k], J[24][k], J[25][k], J[26][k], J[27][k],
                                     J[28][k], rx, ry, rz);
            const float eta_crit = I[23];
            const float eta_ab = fminf(sqrtf(u_i), sqrtf(u_j));
            const float eta_diff = 5.0f * (eta_ab - eta_crit);
            const float d3 = eta_ab < eta_crit ? expf(-(eta_diff * eta_diff)) : 1.0f;
            const float A = d2_ != 0.0f ? d1 / d2_ : 0.0f;
            const float Ap1 = 1.0f + A;
            const float phi = 0.5f * d3 * fminf(fmaxf(4.0f * A / (Ap1 * Ap1), 0.0f), 1.0f);
            rv = rv - phi * (d1 + d2_);
        }
        const float w_ij = rv * inv_dist;
        // per-particle-alpha Monaghan AV (kernels.hpp:60-84)
        const float cij = I[9] + J[8][k];
        const float v_sig = 0.25f * (I[10] + J[9][k]) * cij - 2.0f * w_ij;
        const float visc = w_ij < 0.0f ? -v_sig * w_ij : 0.0f;
        acc[5] = fmaxf(acc[5], 0.5f * cij - 2.0f * w_ij);

        float ti[3], tj[3];
        iad_project(I[17], I[18], I[19], I[20], I[21], I[22], rx, ry, rz, w_i, ti);
        iad_project(J[17][k], J[18][k], J[19][k], J[20][k], J[21][k], J[22][k], rx, ry, rz,
                    w_j, tj);

        // Atwood ramp between uncrossed (xm_i^2, xm_j^2) and crossed
        // (xm_i xm_j) volume elements; expf, not __expf
        const float rhoi = I[14], rhoj = J[14][k];
        const float atwood = fabsf(rhoi - rhoj) / (rhoi + rhoj);
        float a_mom, b_mom;
        if (atwood < p.at_min) {
            a_mom = I[12];
            b_mom = J[12][k];
        } else if (atwood > p.at_max) {
            a_mom = b_mom = I[11] * J[11][k];
        } else {
            const float sigma = p.ramp * (atwood - p.at_min);
            const float dl = J[13][k] - I[13];
            a_mom = I[12] * expf(sigma * dl);
            b_mom = J[12][k] * expf(-sigma * dl);
        }
        const float mj = J[10][k];
        const float a_visc = mj * I[15] * visc;
        const float b_visc = mj * J[15][k] * visc;
        const float avx = 0.5f * (a_visc * ti[0] + b_visc * tj[0]);
        const float avy = 0.5f * (a_visc * ti[1] + b_visc * tj[1]);
        const float avz = 0.5f * (a_visc * ti[2] + b_visc * tj[2]);
        acc[4] += avx * vx_ij + avy * vy_ij + avz * vz_ij;
        acc[3] += mj * a_mom * (vx_ij * ti[0] + vy_ij * ti[1] + vz_ij * ti[2]);
        const float mom_i = mj * I[16] * a_mom;
        const float mom_j = mj * J[16][k] * b_mom;
        acc[0] += mom_i * ti[0] + mom_j * tj[0] + avx;
        acc[1] += mom_i * ti[1] + mom_j * tj[1] + avy;
        acc[2] += mom_i * ti[2] + mom_j * tj[2] + avz;
    }
    __device__ __forceinline__ static void finalize(const float* I, const float* acc, float* out,
                                                    const EngineArgs& p) {
        const float hi = I[3], ci = I[9], prhoi = I[16];
        const float v = acc[5] > 0.0f ? acc[5] : ci;
        out[0] = -p.K * acc[0];
        out[1] = -p.K * acc[1];
        out[2] = -p.K * acc[2];
        out[3] = p.K * (prhoi * acc[3] + 0.5f * fmaxf(acc[4], 0.0f));
        out[4] = p.k_cour * hi / v;
    }
};
