"""Build the package's CUDA kernels and bind them with ctypes.

The sources in ``localregneuralde_tpu_torch/csrc`` are compiled by ``nvcc``
for Hopper (``sm_90a``) into one shared library with a plain C interface, at
first use, into ``build/`` at the repository root: one ``nvcc -c`` per
source, all started together, then one link. The library's name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint

# C entry -> argument types; every entry returns cudaGetLastError() as int
_SIGNATURES = {
    "lrnde_tdmlp": [_P] * 7 + [_I] * 4 + [_P],
    "lrnde_tsit5_step": [_P] * 17 + [_I] * 4 + [_P, _P],
    "lrnde_persistent_tsit5": (
        [_P] * 4 + [_I] + [_P] * 11 + [_I] * 4 + [_F] * 3
        + [_P, _P, _I] + [_P] * 5 + [_I, _I] + [_P] * 2 + [_P]
    ),
    "lrnde_persistent_tsit5_timed": (
        [_P] * 4 + [_I] + [_P] * 11 + [_I] * 4 + [_F] * 3
        + [_P, _P, _I] + [_P] * 5 + [_I, _I] + [_P] * 2 + [_P, _P]
    ),
    "lrnde_tsit5_step_bwd": [_P] * 21 + [_I] * 3 + [_P],
    "lrnde_tsit5_step_bwd_tiered": [_I] + [_P] * 21 + [_I] * 3 + [_P],
    "lrnde_tdmlp_tf32": [_P] * 7 + [_I] * 4 + [_P],
    "lrnde_tsit5_step_tf32": [_P] * 17 + [_I] * 4 + [_P],
    "lrnde_persistent_tsit5_tf32": (
        [_P] * 4 + [_I] + [_P] * 11 + [_I] * 4 + [_F] * 3
        + [_P, _P, _I] + [_P] * 5 + [_I, _I] + [_P] * 2 + [_P]
    ),
    "lrnde_adjoint_sweep_tiered": (
        [_I, _I] + [_P] * 8 + [_I] + [_P] * 7 + [_F] * 3 + [_I] * 3
        + [_P] * 9 + [_I] * 3 + [_F] + [_P]
    ),
    "lrnde_adjoint_sweep": (
        [_I] + [_P] * 8 + [_I] + [_P] * 7 + [_F] * 3 + [_I] * 3 + [_P] * 9
        + [_I] * 3 + [_F] + [_P]
    ),
    "lrnde_adjoint_sweep_timed": (
        [_I] + [_P] * 8 + [_I] + [_P] * 7 + [_F] * 3 + [_I] * 3 + [_P] * 9
        + [_I] * 3 + [_F] + [_P, _P]
    ),
    "lrnde_sde_solve": (
        [_I] + [_P] * 3 + [_I] + [_P] * 7 + [_I] + [_P] * 15 + [_I] * 4
        + [_F] * 4 + [_P]
    ),
    "lrnde_sde_solve_timed": (
        [_I] + [_P] * 3 + [_I] + [_P] * 7 + [_I] + [_P] * 15 + [_I] * 4
        + [_F] * 4 + [_P, _P]
    ),
    "lrnde_sde_solve_tf32": (
        [_I] + [_P] * 3 + [_I] + [_P] * 7 + [_I] + [_P] * 15 + [_I] * 4
        + [_F] * 4 + [_P]
    ),
    "lrnde_sde_sweep": (
        [_I, _I] + [_P] * 12 + [_I] + [_P] * 5 + [_I] * 3 + [_P]
    ),
    "lrnde_sde_sweep_timed": (
        [_I] + [_P] * 12 + [_I] + [_P] * 5 + [_I] * 3 + [_P, _P]
    ),
    "lrnde_persistent_chain": (
        [_P] * 4 + [_I] + [_P] * 2 + [_I, _U, _I] + [_P] * 6 + [_I] * 2
        + [_F] * 3 + [_P] * 2 + [_I] + [_P] * 5 + [_I] * 2 + [_P] * 3
    ),
    "lrnde_persistent_chain_timed": (
        [_P] * 4 + [_I] + [_P] * 2 + [_I, _U, _I] + [_P] * 6 + [_I] * 2
        + [_F] * 3 + [_P] * 2 + [_I] + [_P] * 5 + [_I] * 2 + [_P] * 4
    ),
    "lrnde_chain_sweep": (
        [_I] + [_P] * 2 + [_I, _U, _I] + [_P] * 4 + [_I] + [_P] * 7
        + [_F] * 3 + [_I] * 3 + [_P] * 8 + [_I] + [_F] + [_P]
    ),
    "lrnde_chain_sweep_timed": (
        [_I] + [_P] * 2 + [_I, _U, _I] + [_P] * 4 + [_I] + [_P] * 7
        + [_F] * 3 + [_I] * 3 + [_P] * 8 + [_I] + [_F] + [_P] * 2
    ),
    "lrnde_chain_solve_grid": [_P, _I, _I, _P],
    "lrnde_chain_sweep_grid": [_P, _I, _I, _I, _P],
    "lrnde_chain_solve_grid_tf32": [_P, _I, _I, _P],
    "lrnde_chain_sweep_grid_tiered": [_I, _P, _I, _I, _I, _P],
    "lrnde_conv_step": [_P] * 22 + [_I] + [_F] * 3 + [_I] * 5 + [_P],
    "lrnde_conv_step_tf32": [_P] * 22 + [_I] + [_F] * 3 + [_I] * 5 + [_P],
    "lrnde_conv_step_bwd": [_I] + [_P] * 29 + [_F] + [_I] * 5 + [_P],
    "lrnde_vpsde_solve": (
        [_I] + [_P] * 3 + [_I, _P, _P, _I, _U] + [_F] * 3 + [_P, _I]
        + [_P] * 9 + [_I] * 2 + [_F] * 4 + [_P]
    ),
    "lrnde_vpsde_solve_timed": (
        [_I] + [_P] * 3 + [_I, _P, _P, _I, _U] + [_F] * 3 + [_P, _I]
        + [_P] * 9 + [_I] * 2 + [_F] * 4 + [_P, _P]
    ),
    "lrnde_conv_core": [_I, _I] + [_P] * 5 + [_I] * 5 + [_P],
    "lrnde_slot_sum": [_P, _I, _P, _P],
    "lrnde_persistent_pf": (
        [_P] * 4 + [_I, _P, _P, _I, _U] + [_F] * 3 + [_P] * 6 + [_I] * 2
        + [_F] * 3 + [_P]
    ),
    "lrnde_persistent_pf_timed": (
        [_P] * 4 + [_I, _P, _P, _I, _U] + [_F] * 3 + [_P] * 6 + [_I] * 2
        + [_F] * 3 + [_P, _P]
    ),
    "lrnde_pf_solve_probe": (
        [_I] + [_P] * 4 + [_I, _P, _P, _I, _U] + [_F] * 3 + [_P] * 6
        + [_I] * 2 + [_F] * 3 + [_P]
    ),
    "lrnde_pf_solve_grid": [_P, _I, _I, _P],
    "lrnde_pf_solve_grid_tf32": [_P, _I, _I, _P],
    "lrnde_sde_solve_grid": [_I, _I, _I, _P],
    "lrnde_conv_orient_tap": [_P] * 3 + [_I] * 5 + [_P],
    "lrnde_conv_orient_im2col": [_P] * 3 + [_I] * 5 + [_P],
    "lrnde_conv_orient_probe": [_I, _I] + [_P] * 3 + [_I] * 5 + [_P, _P],
    "lrnde_conv_orient_tile_test": [_P] * 3 + [_I, _I, _P],
}

# the TF32 instantiations take their FP32 entries' arguments
_SIGNATURES.update({
    "lrnde_persistent_chain_tf32": _SIGNATURES["lrnde_persistent_chain"],
    "lrnde_chain_sweep_tiered": [_I] + _SIGNATURES["lrnde_chain_sweep"],
    "lrnde_vpsde_solve_tf32": _SIGNATURES["lrnde_vpsde_solve"],
    "lrnde_persistent_pf_tf32": _SIGNATURES["lrnde_persistent_pf"],
})

# C entry -> argument types of the integer queries
_INTS = {
    "lrnde_sweep_clusters": [_I] * 3,
    "lrnde_solve_clusters": [_I] * 3,
    "lrnde_solve_rows": [_I] * 2,
    "lrnde_solve_weights_shared": [_I] * 2,
    "lrnde_eval_rows": [_I] * 2,
    "lrnde_eval_weights_shared": [_I] * 2,
    "lrnde_eval_grid": [_I] * 5 + [_P],
    "lrnde_sweep_replay_rows": [_I] * 2,
}

# C entry -> argument types of the size queries, which return long long
_SIZES = {
    "lrnde_sweep_scratch_floats": [_I] * 3,
    "lrnde_sweep_smem_floats": [_I] * 2,
    "lrnde_solve_smem_floats": [_I] * 2,
    "lrnde_solve_scratch_floats": [_I] * 3,
    "lrnde_eval_smem_floats": [_I] * 2,
    "lrnde_step_scratch_floats": [_I] * 2,
    "lrnde_sde_solve_smem_floats": [_I] * 2,
    "lrnde_sde_sweep_smem_floats": [_I] * 3,
    "lrnde_chain_solve_smem_floats_tf32": [_P, _I],
    "lrnde_chain_sweep_smem_floats_tiered": [_I, _P, _I],
    "lrnde_vpsde_solve_smem_floats_tf32": [_P, _I],
    "lrnde_pf_solve_smem_floats_tf32": [_P, _I],
    "lrnde_sde_solve_smem_floats_tf32": [_I] * 2,
    "lrnde_sde_grad_floats": [_I] * 2,
    "lrnde_chain_solve_smem_floats": [_P, _I],
    "lrnde_chain_sweep_smem_floats": [_P, _I],
    "lrnde_conv_step_scratch_floats": [_I] * 5,
    "lrnde_conv_step_offset": [_I] * 6,
    "lrnde_conv_step_bwd_scratch_floats": [_I] * 5,
    "lrnde_vpsde_solve_smem_floats": [_P, _I],
    "lrnde_pf_solve_smem_floats": [_P, _I],
    "lrnde_conv_core_scratch_floats": [_I] * 6,
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "CUDA kernels"
    )


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"liblrnde_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The sources compile in parallel, one ``nvcc`` each; the ptxas reports
    (registers, shared memory, spills) and each source's compile seconds
    are kept beside the library as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    nvcc = _nvcc()
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(cu, objs)]
    start = time.monotonic()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]

    def finish(p):
        out = p.communicate()[0]
        return out, time.monotonic() - start

    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    outs = [o for o, _ in done]
    log = [f"{' '.join(c)}\n[{src.name} compiled in {sec:.1f} s]\n{o}"
           for c, src, (o, sec) in zip(cmds, cu, done)]
    failed = [o for p, o in zip(procs, outs) if p.returncode != 0]
    tmp = lib.with_name(f"{tag}.tmp")
    if not failed:
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True,
                              check=False)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = log[-1:]
    lib.with_suffix(".log").write_text("\n".join(log))
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its argument
    types declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _INTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in _SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    for name in ("lrnde_rows_per_block", "lrnde_sde_rows_per_block",
                 "lrnde_chain_error_rows", "lrnde_score_rows_per_block",
                 "lrnde_sde_phases", "lrnde_sweep_phases", "lrnde_solve_phases",
                 "lrnde_step_phases",
                 "lrnde_sweep_cluster", "lrnde_sweep_rows",
                 "lrnde_sde_sweep_threads", "lrnde_sde_sweep_hid_threads",
                 "lrnde_sde_solve_threads", "lrnde_pf_error_rows",
                 "lrnde_pf_solve_threads", "lrnde_pf_warp_rows"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    for name in ("lrnde_chain_solve_phase_names",
                 "lrnde_chain_sweep_phase_names",
                 "lrnde_pf_solve_phase_names",
                 "lrnde_sde_sweep_phase_names",
                 "lrnde_conv_orient_phase_names"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_char_p
    lib.lrnde_error_string.argtypes = [ctypes.c_int]
    lib.lrnde_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.lrnde_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
