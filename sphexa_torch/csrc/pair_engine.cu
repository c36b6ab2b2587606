// Fused neighbour search + SPH pair op for NVIDIA Hopper (sm_90a): the
// streaming engine K1.
//
// Replaces the TPU kernel group_pair_engine (sphexa_tpu/sph/pallas_pairs.py,
// its pallas_call in the streaming form) in its std-SPH instantiations
// pallas_density, pallas_iad and pallas_momentum_energy_std, its VE
// instantiations pallas_ve_def_gradh, pallas_iad_divv_curlv,
// pallas_av_switches and pallas_momentum_energy_ve (pallas_xmass is
// m / rho0 over pallas_density). It serves the streaming steps
// (use_lists=False, fold-mode grids, steps under self-gravity); in list
// mode every SPH op runs the list walk (pair_lists.cu), which tests only
// the lanes the mark pass kept, and the gravity near field, which has no
// cutoff, is a kernel of its own (gravity_p2p.cu). The
// contract is the TPU kernel's; its blocking is not: the 128-lane tiles,
// the (rows, nf_pad, 128) j-field packing, the VMEM double buffer and the
// scalar-prefetch tables exist because of the TPU and are dropped.
//
// Design. One CUDA block per target group of G SFC-consecutive particles
// (blockDim = G, one thread per target, target index g*G + t). The block
// cuts the concatenation of the group's ncells[g] candidate runs
// [start, start + len) of the sorted arrays into windows of W consecutive
// candidates and runs them through engine_window.cuh's pipeline: each
// window's positions (a float4 per candidate: x, y, z, index) and j-field
// rows staged by cp.async while the previous window computes, a mask
// phase (every thread tests every candidate: periodic shift, or the
// min-image fold, and d^2 < 4 h_i^2, not self), a body phase (each thread
// runs the op's pair body over its own accepted candidates, ascending;
// the momentum ops add the symmetric cutoff d^2 < 4 h_j^2 there). Op::
// finalize writes each target's outputs; threads whose target index is
// >= n write nothing. No atomics, no cross-block reduction (min(dt_i)
// stays a torch reduction, as in the JAX package).
//
// What bounds it on this card. The mask test of every run lane by every
// target (about 12 FP32 operations each) is most of the work: only a few
// percent of the streamed candidates are neighbours. A body run inline,
// for the whole warp, on every candidate any of its 32 lanes accepts
// would hold a pair in a quarter of its lane-passes (0.24 at Sedov 100),
// so the momentum bodies (156-223 operations) would cost four times their
// share. The body phase instead passes as often as the warp's
// busiest lane has pairs in the window (at W = 256, 0.37 of the
// lane-passes hold a pair over K1's runs, 0.45 over the list walk's
// marked lanes); its reads are gathers (each lane at its own candidate),
// which cost shared-memory bank conflicts, and those, not the arithmetic,
// bound the momentum bodies. The mask phase reads one broadcast float4
// per candidate. Measured on the H100 at Sedov 100^3 (PERF.md,
// chip_smoke.py phase 8): density 3.45 ms against a bound of 0.77 ms,
// std momentum 5.11 against 0.94.
// Registers are capped (__launch_bounds__ minimum blocks) at 64 a thread
// for the light ops and 128 for the rest, and the window W = 256
// (engine_window.cuh says why) leaves 8 or more blocks of 64 threads (16
// warps) per SM for every SPH op but VE momentum (14 warps; 12 with
// av_clean: 23-29 j-fields of staged rows); chip_smoke.py's engines line
// reports each instantiation's registers, shared bytes, resident warps
// and times, and PERF.md the measured numbers.
//
// Exactness. Neighbour counts must match the plain version bit for bit, so
// the separation and d^2 of the mask use __fadd_rn/__fsub_rn/__fmul_rn
// (no FMA contraction can flip a pair at the d^2 < 4 h^2 boundary), in the
// plain version's order: rx = xi - (xj + shx), d2 = (rx*rx + ry*ry) + rz*rz;
// the body phase recomputes them the same way. The self test compares a
// candidate's row with the target's index g*G + t: the candidate's row
// rides the staged float4 as its int32 bits (__int_as_float, a copy, no
// arithmetic: exact for every row of an int32 table). Under a mesh the
// j-fields are the rank's j-buffer [own slab | halo rows] (EngineArgs.nj
// rows, the JAX package's jdata form): the own slab sits at offset 0, so
// a target meets itself at its own index (the JAX i_offset is 0), and a
// halo row, at nj > row >= n, never equals a target. The fold rounds half to
// even (rintf) like jnp.round. The pair body runs only under the mask, so
// the d2 = 0 self pair's rsqrt(0) = inf never reaches an accumulator. The
// body's other arithmetic may contract.
//
// The launch arguments and the ops' bodies are in pair_ops.cuh, shared
// with the list walk (pair_lists.cu); the window machinery in
// engine_window.cuh. ptxas's report of each instantiation is kept in the
// build log.
//
// Build: sphexa_torch/kernels/build.py (nvcc for sm_90a, one object per
// source, linked into one library with plain C entry points, loaded with
// ctypes).

#include <cstring>

#include "engine_window.cuh"

namespace {

template <class Op, bool FOLD, bool SYM>
__global__ void __launch_bounds__(MAX_BLOCK, min_blocks<Op>())
    pair_engine(const __grid_constant__ EngineArgs p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int g = blockIdx.x;
    const int t = threadIdx.x;
    const int G = blockDim.x;
    const int tgt = g * G + t;
    const int ii = min(tgt, p.n - 1);  // tail threads re-read the last particle

    float I[Op::NI];
#pragma unroll
    for (int f = 0; f < Op::NI; ++f) I[f] = p.ifields[f][ii];
    const float lx = FOLD ? p.boxl[0] : 0.0f;
    const float ly = FOLD ? p.boxl[1] : 0.0f;
    const float lz = FOLD ? p.boxl[2] : 0.0f;

    float acc[Op::NACC];
#pragma unroll
    for (int a = 0; a < Op::NACC; ++a) acc[a] = 0.0f;
    int nc = 0;

    const int nrun = p.ncells[g];
    const int64_t row = static_cast<int64_t>(g) * p.w3;
    // staging cursor (block-uniform): the next run and the offset in it
    int cw = 0, coff = 0;
    auto stage = [&](int b) {
        const WindowView v = window_view<Op::NJ>(smem, b);
        int fill = 0;
        while (fill < WINDOW && cw < nrun) {
            const int s = p.starts[row + cw], len = p.lens[row + cw];
            const int take = min(WINDOW - fill, len - coff);
            for (int pos = first_own(fill, t, G); pos < fill + take; pos += G)
                stage_position(v, pos, s + coff + (pos - fill), cw, p);
            fill += take;
            coff += take;
            if (coff >= len) {
                ++cw;
                coff = 0;
            }
        }
        return fill;
    };
    window_pipeline<Op, FOLD, SYM>(smem, stage, I, tgt, p.shift_x + row, p.shift_y + row,
                                      p.shift_z + row, lx, ly, lz, acc, nc, p);

    if (tgt < p.n) {
        float out[Op::NOUT];
        Op::finalize(I, acc, out, p);
#pragma unroll
        for (int o = 0; o < Op::NOUT; ++o) p.outs[o][tgt] = out[o];
        if (Op::WANT_NC && p.nc != nullptr) p.nc[tgt] = nc;
    }
}

template <class Op, bool FOLD, bool SYM>
int launch_k(const EngineArgs* a, cudaStream_t st, int32_t* info) {
    auto kern = pair_engine<Op, FOLD, SYM>;
    using L = WindowLayout<Op::NJ>;
    if (info) {
        const cudaError_t attr = set_window_attrs(kern, L::bytes(MAX_BLOCK));
        if (attr != cudaSuccess) return static_cast<int>(attr);
        return kernel_info(kern, L::bytes(a->group), a->group, info);
    }
    static const cudaError_t attr = set_window_attrs(kern, L::bytes(MAX_BLOCK));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    kern<<<a->num_groups, a->group, L::bytes(a->group), st>>>(*a);
    return static_cast<int>(cudaGetLastError());
}

// the symmetric cutoff (compiled in only for the ops that may take it)
template <class Op, bool FOLD>
int launch_sym(const EngineArgs* a, cudaStream_t st, int32_t* info) {
    if constexpr (Op::SYM) {
        if (a->sym_j >= 0) return launch_k<Op, FOLD, true>(a, st, info);
    } else if (a->sym_j >= 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_k<Op, FOLD, false>(a, st, info);
}

// one launch, or with `info` the instantiation's static facts instead
template <class Op>
int launch(const EngineArgs* a, void* stream, int32_t* info = nullptr) {
    if (!info && a->num_groups <= 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return a->fold ? launch_sym<Op, true>(a, st, info) : launch_sym<Op, false>(a, st, info);
}

// every entry point of this engine, by name, in the op form of NC
// polynomial coefficients: plain C dispatch shared by the launches and
// pair_engine_info
template <int NC>
int dispatch_nc(const char* name, const EngineArgs* a, void* stream, int32_t* info) {
    const bool v = a->variant != 0;
    if (!std::strcmp(name, "density")) return launch<DensityOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "iad")) return launch<IadOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "momentum_energy_std"))
        return launch<MomentumEnergyStdOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "ve_def_gradh")) return launch<VeDefGradhOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "iad_divv_curlv"))
        return v ? launch<DivvCurlvOp<true, NC>>(a, stream, info)
                 : launch<DivvCurlvOp<false, NC>>(a, stream, info);
    if (!std::strcmp(name, "av_switches")) return launch<AvSwitchesOp<NC>>(a, stream, info);
    if (!std::strcmp(name, "momentum_energy_ve"))
        return v ? launch<MomentumEnergyVeOp<true, NC>>(a, stream, info)
                 : launch<MomentumEnergyVeOp<false, NC>>(a, stream, info);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#ifdef PAIR_WENDLAND_TU
// pair_engine_wendland.cu: the wendland-c6 form's instantiations only
extern "C" int pair_engine_dispatch_wendland(const char* name, const EngineArgs* a,
                                             void* stream, int32_t* info) {
    return dispatch_nc<NCOEF_WENDLAND>(name, a, stream, info);
}
#else
// the wendland-c6 form lives in pair_engine_wendland.cu, built in an nvcc
// process of its own beside this one (the two forms' instantiations in one
// file doubled the build's longest compile)
extern "C" int pair_engine_dispatch_wendland(const char* name, const EngineArgs* a,
                                             void* stream, int32_t* info);

namespace {

int dispatch(const char* name, const EngineArgs* a, void* stream, int32_t* info) {
    if (a->ncoef == NCOEF_SINC) return dispatch_nc<NCOEF_SINC>(name, a, stream, info);
    if (a->ncoef == NCOEF_WENDLAND) return pair_engine_dispatch_wendland(name, a, stream, info);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int launch_density(const EngineArgs* a, void* stream) {
    return dispatch("density", a, stream, nullptr);
}

int launch_iad(const EngineArgs* a, void* stream) { return dispatch("iad", a, stream, nullptr); }

int launch_momentum_energy_std(const EngineArgs* a, void* stream) {
    return dispatch("momentum_energy_std", a, stream, nullptr);
}

int launch_ve_def_gradh(const EngineArgs* a, void* stream) {
    return dispatch("ve_def_gradh", a, stream, nullptr);
}

int launch_iad_divv_curlv(const EngineArgs* a, void* stream) {
    return dispatch("iad_divv_curlv", a, stream, nullptr);
}

int launch_av_switches(const EngineArgs* a, void* stream) {
    return dispatch("av_switches", a, stream, nullptr);
}

int launch_momentum_energy_ve(const EngineArgs* a, void* stream) {
    return dispatch("momentum_energy_ve", a, stream, nullptr);
}

// the static facts (kernel_info in engine_window.cuh) of the instantiation
// that launch_<name> would run with these arguments (variant, fold,
// group)
int pair_engine_info(const char* name, const EngineArgs* a, int32_t* out) {
    return dispatch(name, a, nullptr, out);
}

const char* pair_engine_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pair_engine_abi_version() { return ABI_VERSION; }

}  // extern "C"
#endif  // PAIR_WENDLAND_TU
