"""Build the CUDA kernels under ``csrc/`` with nvcc and load them with ctypes.

All ``csrc/*.cu`` sources (and the ``csrc/*.cuh`` headers they include)
compile into ONE shared library with a plain C interface (no PyTorch
headers, so a build takes seconds): one nvcc per source, all started
together, each into an object file, then one link. The library is built at
first use into ``kernels/_build/`` (listed in .gitignore), named by a hash
of the sources and the flags, so an edited source rebuilds and an unchanged
one loads the existing file. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double

# C entry points: name -> argtypes (every pointer and the stream as
# c_void_p, or ctypes would cut them to 32-bit ints). All return the
# cudaError_t of the launch as an int. The _bf16 entries store bfloat16 and
# compute in float32 (csrc/storage.cuh); _f32_bf16 is K1's BF16C gsrb.
_SIGNATURES = {
    # (x, out, mi, mj, mk, stream): x is (2mi, 2mj, 2mk), out (mi, mj, mk)
    "hpgmg_restrict_cell_f32": (_P, _P, _I, _I, _I, _P),
    "hpgmg_restrict_cell_f64": (_P, _P, _I, _I, _I, _P),
    "hpgmg_restrict_cell_bf16": (_P, _P, _I, _I, _I, _P),
    # (x, beta_i, beta_j, beta_k, alpha, rhs, kdinv, out, n, mode, periodic,
    #  parity, chunk, scale, a_coef, stream); x is the n^3 cell field
    "hpgmg_fv4_stream_f32": (_P,) * 8 + (_I,) * 5 + (_D, _D, _P),
    "hpgmg_fv4_stream_f64": (_P,) * 8 + (_I,) * 5 + (_D, _D, _P),
    "hpgmg_fv4_stream_bf16": (_P,) * 8 + (_I,) * 5 + (_D, _D, _P),
    # float x, alpha, rhs and out; bf16 face coefficients and kdinv; gsrb
    "hpgmg_fv4_stream_f32_bf16": (_P,) * 8 + (_I,) * 5 + (_D, _D, _P),
    # (x, beta_i, beta_j, beta_k, alpha, rhs, kdinv, out, n, mode, parity,
    #  ti, scale, a_coef, stream); x is the n^3 cell field, mode
    #  apply/residual/gsrb, ti the tile length along i (0: the rule)
    "hpgmg_fv4_subtile_f32": (_P,) * 8 + (_I,) * 4 + (_D, _D, _P),
    "hpgmg_fv4_subtile_f64": (_P,) * 8 + (_I,) * 4 + (_D, _D, _P),
    "hpgmg_fv4_subtile_bf16": (_P,) * 8 + (_I,) * 4 + (_D, _D, _P),
    # (x, beta_i, beta_j, beta_k, alpha, rhs, kd0, kd1, out, n, chunk, scale,
    #  a_coef, stream); kd0 read at red cells, kd1 at black ones
    "hpgmg_fv4_gsrb2_f32": (_P,) * 9 + (_I, _I, _D, _D, _P),
    "hpgmg_fv4_gsrb2_f64": (_P,) * 9 + (_I, _I, _D, _D, _P),
    # (x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0, kdinv1, out, n, scale,
    #  a_coef, stream)
    "hpgmg_fv4_gsrb2_cluster_f32": (_P,) * 9 + (_I, _D, _D, _P),
    "hpgmg_fv4_gsrb2_cluster_f64": (_P,) * 9 + (_I, _D, _D, _P),
    "hpgmg_fv4_gsrb2_cluster_bf16": (_P,) * 9 + (_I, _D, _D, _P),
    # (ptrs, dims, scales, nlev, nsweeps, a_coef, x_in | u_bot, stream); ptrs
    # is a host array of 9 device pointers per level
    "hpgmg_tail_down_f32": (_P, _P, _P, _I, _I, _D, _P, _P),
    "hpgmg_tail_down_f64": (_P, _P, _P, _I, _I, _D, _P, _P),
    "hpgmg_tail_up_f32": (_P, _P, _P, _I, _I, _D, _P, _P),
    "hpgmg_tail_up_f64": (_P, _P, _P, _I, _I, _D, _P, _P),
    "hpgmg_tail_down_bf16": (_P, _P, _P, _I, _I, _D, _P, _P),
    "hpgmg_tail_up_bf16": (_P, _P, _P, _I, _I, _D, _P, _P),
    # (ptrs, dims, scales, nlev, nsweeps, a_coef, x_in, ainv, u_bot, stream)
    "hpgmg_tail_v_f32": (_P, _P, _P, _I, _I, _D, _P, _P, _P, _P),
    "hpgmg_tail_v_f64": (_P, _P, _P, _I, _I, _D, _P, _P, _P, _P),
    # (x, beta_i, beta_j, beta_k, alpha, rhs, kdinv, out, n, mode, periodic,
    #  parity, chunk, b_h2inv, a_coef, t1, t2, stream): the var7 body
    "hpgmg_r1_var7_f32": (_P,) * 8 + (_I,) * 5 + (_D,) * 4 + (_P,),
    "hpgmg_r1_var7_f64": (_P,) * 8 + (_I,) * 5 + (_D,) * 4 + (_P,),
    "hpgmg_r1_var7_bf16": (_P,) * 8 + (_I,) * 5 + (_D,) * 4 + (_P,),
    # (x, rhs, kdinv, out, n, mode, periodic, parity, chunk, b_h2inv, a_coef,
    #  t1, t2, stream): the 27pt body
    "hpgmg_r1_stream_f32": (_P,) * 4 + (_I,) * 5 + (_D,) * 4 + (_P,),
    "hpgmg_r1_stream_f64": (_P,) * 4 + (_I,) * 5 + (_D,) * 4 + (_P,),
    "hpgmg_r1_stream_bf16": (_P,) * 4 + (_I,) * 5 + (_D,) * 4 + (_P,),
    # (x, beta_i, beta_j, beta_k, alpha, rhs, kdinv0, kdinv1, out, n, var7,
    #  b_h2inv, a_coef, t1, t2, stream); the _chunk entries take the chunk
    #  of i-planes after var7
    "hpgmg_r1_gsrb2_f32": (_P,) * 9 + (_I, _I, _D, _D, _D, _D, _P),
    "hpgmg_r1_gsrb2_f64": (_P,) * 9 + (_I, _I, _D, _D, _D, _D, _P),
    "hpgmg_r1_gsrb2_bf16": (_P,) * 9 + (_I, _I, _D, _D, _D, _D, _P),
    "hpgmg_r1_gsrb2_chunk_f32": (_P,) * 9 + (_I, _I, _I, _D, _D, _D, _D, _P),
    "hpgmg_r1_gsrb2_chunk_f64": (_P,) * 9 + (_I, _I, _I, _D, _D, _D, _D, _P),
    "hpgmg_r1_gsrb2_chunk_bf16": (_P,) * 9 + (_I, _I, _I, _D, _D, _D, _D, _P),
    # (x, ilo, ihi, jlo, jhi, klo, khi, beta_i, beta_j, beta_k, alpha, rhs,
    #  kdinv, out, ni, nj, nk, mode, periodic, ksplit, parity, chunk, scale,
    #  a_coef, pass, stream)
    "hpgmg_fv4_slab_f32": (_P,) * 14 + (_I,) * 8 + (_D, _D, _I, _P),
    "hpgmg_fv4_slab_f64": (_P,) * 14 + (_I,) * 8 + (_D, _D, _I, _P),
    # (x, ilo, ihi, jlo, jhi, klo, khi, beta_i, beta_j, beta_k, alpha, rhs,
    #  kdinv, out, ni, nj, nk, mode, var7, periodic, parity, chunk, b_h2inv,
    #  a_coef, t1, t2, stream); klo, khi null on a block whole along k
    "hpgmg_r1_slab_f32": (_P,) * 14 + (_I,) * 8 + (_D,) * 4 + (_P,),
    "hpgmg_r1_slab_f64": (_P,) * 14 + (_I,) * 8 + (_D,) * 4 + (_P,),
    # (x, ilo, ihi, jlo, jhi, klo, khi, ring beta_i, beta_j, beta_k, alpha,
    #  rhs, kdinv0, kdinv1, out, ni, nj, nk, edges, var7, b_h2inv, a_coef, t1,
    #  t2, stream); the _chunk entries take the chunk of i-planes after var7
    "hpgmg_r1_gsrb2_slab_f32": (_P,) * 15 + (_I,) * 5 + (_D,) * 4 + (_P,),
    "hpgmg_r1_gsrb2_slab_f64": (_P,) * 15 + (_I,) * 5 + (_D,) * 4 + (_P,),
    "hpgmg_r1_gsrb2_slab_chunk_f32": (_P,) * 15 + (_I,) * 6 + (_D,) * 4 + (_P,),
    "hpgmg_r1_gsrb2_slab_chunk_f64": (_P,) * 15 + (_I,) * 6 + (_D,) * 4 + (_P,),
}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"hpgmg_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists:
    the sources in parallel (one nvcc each), then one link. The compilers'
    output (with ptxas register/spill counts) is kept beside the library as
    ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    out.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call), with every entry
    point's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
