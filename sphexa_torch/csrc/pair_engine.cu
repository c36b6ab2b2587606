// Fused neighbour search + SPH pair op for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel group_pair_engine (sphexa_tpu/sph/pallas_pairs.py,
// its pallas_call in the streaming form) in its std-SPH instantiations
// pallas_density, pallas_iad and pallas_momentum_energy_std, its VE
// instantiations pallas_ve_def_gradh, pallas_iad_divv_curlv,
// pallas_av_switches and pallas_momentum_energy_ve (pallas_xmass is
// m / rho0 over pallas_density), and the gravity near field
// (sphexa_tpu/gravity/traversal.py _pallas_p2p: no distance cutoff, groups
// of target_block targets over their block's near-leaf runs). In list
// mode density, IAD, grad-h and the
// plain divv/curlv run this kernel on the persistent lists' pruned runs
// (the TPU kernel's skip_slots form, whose per-chunk gate every pruned
// chunk passes); the momentum ops, the AV switches and divv/curlv with
// gradv run the list walk (pair_lists.cu), as the JAX dispatch does.
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
// The gravity near field (GravityP2POp, CUTOFF false) is the exception to
// the mask-bound picture: its body runs on every candidate of its runs, so
// the body and the j-field staging are its cost.
//
// Exactness. Neighbour counts must match the plain version bit for bit, so
// the separation and d^2 of the mask use __fadd_rn/__fsub_rn/__fmul_rn
// (no FMA contraction can flip a pair at the d^2 < 4 h^2 boundary), in the
// plain version's order: rx = xi - (xj + shx), d2 = (rx*rx + ry*ry) + rz*rz.
// The fold rounds half to even (rintf) like jnp.round. The pair body runs
// only under the mask, so the d2 = 0 self pair's rsqrt(0) = inf never
// reaches an accumulator. The body's other arithmetic may contract.
//
// The launch arguments and the ops' bodies are in pair_ops.cuh, shared
// with the list walk (pair_lists.cu). The VE bodies are heavier (VE
// momentum: 23 i-fields, 30 with av_clean, two expf and an rsqrt per
// pair), which raises the register count per thread; ptxas's report of
// each instantiation is kept in the build log.
//
// Build: sphexa_torch/kernels/build.py (nvcc for sm_90a, one object per
// source, linked into one library with plain C entry points, loaded with
// ctypes).

#include "pair_ops.cuh"

namespace {

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
    const bool self_ok = !Op::CUTOFF && p.allow_self != 0;

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
                bool mask;
                if constexpr (Op::CUTOFF) {
                    mask = d2 < h4 && s + base + k != tgt;
                    if (sym >= 0) mask = mask && __fmul_rn(d2, sj[sym][k]) < 4.0f;
                } else {
                    mask = self_ok || s + base + k != tgt;
                }
                if (mask) {
                    Op::template pair<TILE>(I, sj, k, rx, ry, rz, d2, acc, p);
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

int launch_ve_def_gradh(const EngineArgs* a, void* stream) {
    return launch<VeDefGradhOp>(a, stream);
}

int launch_iad_divv_curlv(const EngineArgs* a, void* stream) {
    return a->variant ? launch<DivvCurlvOp<true>>(a, stream)
                      : launch<DivvCurlvOp<false>>(a, stream);
}

int launch_av_switches(const EngineArgs* a, void* stream) {
    return launch<AvSwitchesOp>(a, stream);
}

int launch_momentum_energy_ve(const EngineArgs* a, void* stream) {
    return a->variant ? launch<MomentumEnergyVeOp<true>>(a, stream)
                      : launch<MomentumEnergyVeOp<false>>(a, stream);
}

int launch_gravity_p2p(const EngineArgs* a, void* stream) {
    return launch<GravityP2POp>(a, stream);
}

const char* pair_engine_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pair_engine_abi_version() { return ABI_VERSION; }

}  // extern "C"
