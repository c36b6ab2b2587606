// Fused neighbour search + SPH pair op for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel group_pair_engine (sphexa_tpu/sph/pallas_pairs.py,
// its pallas_call in the streaming form) in the three std-SPH
// instantiations pallas_density, pallas_iad and pallas_momentum_energy_std.
// The contract is the TPU kernel's; its blocking is not: the 128-lane tiles,
// the (rows, nf_pad, 128) j-field packing, the VMEM double buffer and the
// scalar-prefetch tables exist because of the TPU and are dropped.
//
// Design. One CUDA block per target group of G SFC-consecutive particles
// (blockDim = G, one thread per target, target index g*G + t). The block
// walks the group's ncells[g] candidate runs [start, start + len) of the
// sorted arrays; for each run it stages TILE candidates' j-fields in shared
// memory (structure of arrays, coalesced loads), syncs, and every thread
// loops over the tile: periodic shift (or min-image fold), pair mask
// d^2 < 4 h_i^2 [and d^2 < 4 h_j^2] and not self, then Op::pair into
// register accumulators. Op::finalize writes each target's outputs; threads
// whose target index is >= n write nothing. No atomics, no cross-block
// reduction (min(dt_i) stays a torch reduction, as in the JAX package).
//
// What bounds it on this card: the FP32 operations of the candidate loop.
// Every thread tests every candidate of its group's runs (about 12
// operations for the mask), and only ~2% of candidates pass the mask at
// Sedov resolution, so the mask test, not the pair body, is most of the
// work; device-memory traffic is small (each j-field is read once per
// group that lists it, and the runs of neighbouring groups overlap in L2).
// The design keeps all candidate data in shared memory (broadcast reads,
// no bank conflicts: every thread of a warp reads the same candidate) and
// all accumulators in registers; the chunk-AABB skip of the TPU kernel's
// momentum op (_op_aabb / chunk_skip) is left out, since it changes no
// result (a culled chunk holds no pair within 2h).
//
// Exactness. Neighbour counts must match the plain version bit for bit, so
// the separation and d^2 of the mask use __fadd_rn/__fsub_rn/__fmul_rn
// (no FMA contraction can flip a pair at the d^2 < 4 h^2 boundary), in the
// plain version's order: rx = xi - (xj + shx), d2 = (rx*rx + ry*ry) + rz*rz.
// The fold rounds half to even (rintf) like jnp.round. The pair body runs
// only under the mask, so the d2 = 0 self pair's rsqrt(0) = inf never
// reaches an accumulator. The body's other arithmetic may contract.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (sphexa_torch/kernels/build.py); plain C entry
// points, loaded with ctypes.

#include <cuda_runtime.h>
#include <cstdint>

constexpr int TILE = 128;   // candidates staged per shared-memory tile
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
};

namespace {

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
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[TILE], int k,
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
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[TILE], int k,
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
    __device__ __forceinline__ static void pair(const float* I, const float (*J)[TILE], int k,
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

template <class Op, bool FOLD>
__global__ void __launch_bounds__(256) pair_engine(const EngineArgs p) {
    __shared__ float sj[Op::NJ][TILE];
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int G = blockDim.x;
    const int tgt = g * G + t;
    const int ii = min(tgt, p.n - 1);  // tail threads re-read the last particle

    float I[Op::NI];
#pragma unroll
    for (int f = 0; f < Op::NI; ++f) I[f] = p.ifields[f][ii];
    const float xi = I[0], yi = I[1], zi = I[2], hi = I[3];
    const float h4 = __fmul_rn(__fmul_rn(4.0f, hi), hi);
    const float lx = FOLD ? p.boxl[0] : 0.0f;
    const float ly = FOLD ? p.boxl[1] : 0.0f;
    const float lz = FOLD ? p.boxl[2] : 0.0f;
    const int sym = p.sym_j;

    float acc[Op::NACC];
#pragma unroll
    for (int a = 0; a < Op::NACC; ++a) acc[a] = 0.0f;
    int nc = 0;

    const int nrun = p.ncells[g];
    for (int w = 0; w < nrun; ++w) {
        const int slot = g * p.w3 + w;
        const int s = p.starts[slot];
        const int len = p.lens[slot];
        const float shx = p.shift_x[slot], shy = p.shift_y[slot], shz = p.shift_z[slot];
        for (int base = 0; base < len; base += TILE) {
            const int cnt = min(TILE, len - base);
            __syncthreads();  // the previous tile is consumed
            for (int k = t; k < cnt; k += G) {
#pragma unroll
                for (int f = 0; f < Op::NJ; ++f) sj[f][k] = p.jfields[f][s + base + k];
            }
            __syncthreads();
            for (int k = 0; k < cnt; ++k) {
                float rx, ry, rz;
                if (FOLD) {
                    rx = __fsub_rn(xi, sj[0][k]);
                    ry = __fsub_rn(yi, sj[1][k]);
                    rz = __fsub_rn(zi, sj[2][k]);
                    rx = __fsub_rn(rx, __fmul_rn(lx, rintf(__fdiv_rn(rx, lx))));
                    ry = __fsub_rn(ry, __fmul_rn(ly, rintf(__fdiv_rn(ry, ly))));
                    rz = __fsub_rn(rz, __fmul_rn(lz, rintf(__fdiv_rn(rz, lz))));
                } else {
                    rx = __fsub_rn(xi, __fadd_rn(sj[0][k], shx));
                    ry = __fsub_rn(yi, __fadd_rn(sj[1][k], shy));
                    rz = __fsub_rn(zi, __fadd_rn(sj[2][k], shz));
                }
                const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                                           __fmul_rn(rz, rz));
                bool mask = d2 < h4 && s + base + k != tgt;
                if (sym >= 0) mask = mask && __fmul_rn(d2, sj[sym][k]) < 4.0f;
                if (mask) {
                    Op::pair(I, sj, k, rx, ry, rz, d2, acc, p);
                    ++nc;
                }
            }
        }
    }
    if (tgt < p.n) {
        float out[Op::NOUT];
        Op::finalize(I, acc, out, p);
#pragma unroll
        for (int o = 0; o < Op::NOUT; ++o) p.outs[o][tgt] = out[o];
        if (Op::WANT_NC && p.nc != nullptr) p.nc[tgt] = nc;
    }
}

template <class Op>
int launch(const EngineArgs* a, void* stream) {
    if (a->num_groups <= 0) return 0;
    const dim3 grid(a->num_groups), block(a->group);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (a->fold)
        pair_engine<Op, true><<<grid, block, 0, st>>>(*a);
    else
        pair_engine<Op, false><<<grid, block, 0, st>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int launch_density(const EngineArgs* a, void* stream) {
    return launch<DensityOp>(a, stream);
}

int launch_iad(const EngineArgs* a, void* stream) {
    return launch<IadOp>(a, stream);
}

int launch_momentum_energy_std(const EngineArgs* a, void* stream) {
    return launch<MomentumEnergyStdOp>(a, stream);
}

const char* pair_engine_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pair_engine_abi_version() { return 2; }

}  // extern "C"
