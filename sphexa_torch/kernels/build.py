"""Build the CUDA kernels of sphexa_torch/csrc at first use and load them.

nvcc compiles every ``csrc/*.cu`` into an object, one process per source,
all started together, and links them into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under
``sphexa_torch/_build/``, named by a hash of the sources and flags: an
unchanged tree reuses its library, a changed one builds anew. The library
is loaded with ctypes; the wrappers pass ``data_ptr()`` values and the
current stream.

    python -m sphexa_torch.kernels.build   # build now, print ptxas's report
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# no --use_fast_math and no -ftz=true: the AV switches' 1e-40 floor of the
# signal velocity is a float32 denormal, and expf must stay the accurate one
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: C entry points of the library and their argument types
_ENTRY_POINTS = {
    "launch_density": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_density_lists": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_iad": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_iad_lists": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_momentum_energy_std": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_momentum_energy_std_lists": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_mark": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_ve_def_gradh": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_ve_def_gradh_lists": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_iad_divv_curlv": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_iad_divv_curlv_lists": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_av_switches": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_av_switches_lists": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_momentum_energy_ve": [ctypes.c_void_p, ctypes.c_void_p],
    "launch_momentum_energy_ve_lists": [ctypes.c_void_p, ctypes.c_void_p],
    # x y z h, xj yj zj mj hj, nj, shift, allow_self, starts lens order,
    # n nb P blk r, ax ay az phi, stream
    "launch_gravity_p2p": [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5,
    "launch_compact_class_lists": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p],
    # due n, idx count tile_counts, stream: K13's one-row form
    "launch_compact_row": [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4,
    # () -> flags of one tile of the one-row form
    "compact_row_tile": [],
    # (op name, EngineArgs*, int32 out[7]): an instantiation's registers,
    # spills, shared memory and occupancy
    "pair_engine_info": [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p],
    "list_walk_info": [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p],
    # (target_block, targets a thread, int32 out[7]): K12's static facts
    "gravity_p2p_info": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    # (w3, slot_cap, int32 out[7]): the list build's static facts
    "list_build_info": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}

#: layout version of EngineArgs (csrc/pair_ops.cuh ABI_VERSION), checked
#: against the library's
ABI_VERSION = 9

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(SRC_DIR, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsphexa_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path. ptxas's register/spill report goes to a .log beside it."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out[:-3]}.{os.getpid()}"
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tag}.{os.path.basename(s)[:-3]}.o" for s in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, lg) for c, p, lg in zip(cmds, procs, logs) if p.returncode]
    link = [nvcc, "-shared", "-o", f"{tag}.tmp", *objs]
    if not failed:
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            failed.append((link, proc.returncode, proc.stdout))
    with open(out[:-3] + ".log", "w") as f:
        for c, lg in zip(cmds, logs):
            f.write(" ".join(c) + "\n" + lg)
        f.write(" ".join(link) + "\n")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        c, rc, lg = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{lg}")
    os.replace(f"{tag}.tmp", out)  # atomic: a concurrent loader never sees half a file
    return out


def build_log() -> str:
    """nvcc/ptxas output of the current library's build, if it was kept."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pair_engine_error_string.argtypes = [ctypes.c_int]
        lib.pair_engine_error_string.restype = ctypes.c_char_p
        lib.pair_engine_abi_version.restype = ctypes.c_int
        if lib.pair_engine_abi_version() != ABI_VERSION:
            raise RuntimeError("kernel library ABI mismatch")
        _lib = lib
    return _lib


if __name__ == "__main__":
    path = build()
    print(path)
    print(build_log())
