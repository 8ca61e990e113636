"""Build and load the port's CUDA kernels (``csrc/*.cu``: the ETAP decode
kernels over bf16 rows and over int8 / e4m3 code rows (paged, fused and
over separate K and V pools, and dense; one wgmma / TMA kernel), the
chunked paged prefill over bf16 and code pools, the untransposed baseline
over bf16 and code rows (one wgmma / TMA kernel), the split combine, the
causal prefill and the selective scan) on first use.

Each source compiles to an object with its own ``nvcc`` process, all started
together; the objects link into one shared library with a plain C interface,
loaded with ``ctypes``.  The library is cached under ``_build/`` beside this
file, keyed by a hash of the sources and flags, so a checkout builds once.
Nothing here runs at import time: :func:`library` is called by the kernel
wrappers the first time they see a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# no -use_fast_math: exp2f, expf and the division must stay IEEE-accurate
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# the dense kernels' operand block: q, k, kb, ldk, v, vb, ldv, S, lengths,
# kvh, kh, vh, dk, dv
_DENSE = [_P, _P, _L, _I, _P, _L, _I, _I, _P, _I, _L, _L, _I, _I]
# the quantized dense kernels' pairs and code type after it: kz, zb, zh,
# ldz, vz, vzb, vzh, ldvz, code, qf32
_PAIRS = [_P, _L, _L, _I, _P, _L, _L, _I, _I, _I]
_SINGLE = [_P, _I, _I, _F, _I, _P]           # out, B, H, scale, amla, stream
_SPLIT = [_P, _P, _P, _I, _I, _I, _I, _F, _I, _P]   # m, l, acc, B, H, n, tps
SIGNATURES = {
    "etap_dk": [],
    "etap_dv": [],
    "etap_page": [],
    "etap_dense_widths": [_P, _I],
    "etap_dense_quant_widths": [_P, _I],
    "flash_decode_widths": [_P, _I],
    "flash_decode_quant_widths": [_P, _I],
    "etap_decode_mla_paged": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    "etap_paged_partial": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                           _I, _P],
    "etap_prefill_mla_paged": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                               _I, _P],
    "etap_decode_mla_paged_quant": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                                    _I, _I, _I, _P],
    "etap_paged_partial_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _F, _I, _I, _I, _P],
    "etap_prefill_mla_paged_quant": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _F, _I, _I, _I, _P],
    "etap_decode_dense": _DENSE + _SINGLE,
    "etap_partial_dense": _DENSE + _SPLIT,
    "etap_decode_dense_quant": _DENSE + _PAIRS + _SINGLE,
    "etap_partial_dense_quant": _DENSE + _PAIRS + _SPLIT,
    "flash_decode": _DENSE + _SINGLE,
    "flash_decode_partial": _DENSE + _SPLIT,
    "flash_decode_quant": _DENSE + _PAIRS + _SINGLE,
    "flash_decode_partial_quant": _DENSE + _PAIRS + _SPLIT,
    # (dk, dv, stats[, code, qf32], out[3]): registers, shared memory and
    # local memory of one dense instance
    "etap_dense_attrs": [_I, _I, _I, _P],
    "etap_dense_quant_attrs": [_I, _I, _I, _I, _I, _P],
    "flash_decode_attrs": [_I, _I, _I, _P],
    # (dk, dv, sepv, stats, out[3]): K7 / K8 fused (sepv 0, the latent) or
    # with V rows of their own (flash_decode_wgmma.cu)
    "flash_decode_sepv_attrs": [_I, _I, _I, _I, _P],
    "flash_decode_quant_attrs": [_I, _I, _I, _I, _I, _P],
    # (dk, dv, sepv, stats, code, qf32, out[3]): K7q / K8q fused (sepv 0,
    # the latent) or with V code rows of their own
    "flash_decode_quant_sepv_attrs": [_I, _I, _I, _I, _I, _I, _P],
    "etap_combine_splits": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "etap_combine_splits_rows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _P],
    # (rows, vec, nb, out_f32, out[3]): K2's instance in the [n, H, Dv]
    # (rows 1) or transposed orientation, 1, 4 or 2 x 4 (vec 8) floats a
    # thread, nb splits loaded at once
    "etap_combine_attrs": [_I, _I, _I, _I, _P],
    # dA, dBx, c, y, h, B, L, D, N, stream
    "selective_scan": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # the separate-V paged kernels: widths, (dk, dv, stats, code, qf32,
    # out[3]) attrs, then pointers, shapes (.., dk, dv), scale, amla[,
    # code, qf32], stream
    "etap_paged_sepv_widths": [_P, _I],
    "etap_paged_sepv_attrs": [_I, _I, _I, _I, _I, _P],
    "etap_decode_paged": [_P] * 6 + [_I] * 5 + [_F, _I, _P],
    "etap_paged_partial_sepv": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    "etap_prefill_paged": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
    "etap_decode_paged_quant": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _I, _P],
    "etap_paged_partial_sepv_quant": [_P] * 10 + [_I] * 6 + [_F, _I, _I, _I,
                                                             _P],
    "etap_prefill_paged_quant": [_P] * 9 + [_I] * 6 + [_F, _I, _I, _I, _P],
    # the decode kernels K1 / K3 / K5 / K6 and their twins over codes
    # (etap_decode.cuh): (dense, dk, dv, sepv, stats, cols, q, out[3])
    # attrs at units of 16, 32 or 64 columns (q -1: bf16 rows; 0 / 1:
    # codes with bf16 / fp32 q), and the unit width for (dk, B n_splits, C)
    "etap_decode_attrs": [_I, _I, _I, _I, _I, _I, _I, _P],
    "etap_decode_unit_cols": [_I, _L, _I],
    # K4 over bf16 pools (etap_prefill.cu): (dk, dv, sepv, cols, out[3])
    # attrs at units of 64 or 32 columns; K4q's with qf32 before out
    "etap_prefill_attrs": [_I, _I, _I, _I, _P],
    "etap_prefill_quant_attrs": [_I, _I, _I, _I, _I, _P],
    "flash_prefill_widths": [_P, _I],
    "flash_prefill_attrs": [_I, _I, _P],
    # q, qb, qs, qh, k, kb, ks, kh, v, vb, vs, vh, out, B, S, H, K, d, dv,
    # scale, amla, stream
    "flash_prefill": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L, _L, _P, _I,
                      _I, _I, _I, _I, _I, _F, _I, _P],
}

_LIB: list = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built from "
                       "source on first use and need the CUDA toolkit")


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the sources (in parallel) and link the shared library if it
    is not cached yet.  Returns (library path, compiler log); the log holds
    each source's compile time and ptxas' register and shared-memory lines,
    and is kept beside the library."""
    key = _key()
    lib = BUILD_DIR / f"libetap_{key}.so"
    log = BUILD_DIR / f"libetap_{key}.log"
    if lib.exists() and log.exists():
        return lib, log.read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        t0 = time.perf_counter()
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        text = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            text.append(f"== {src.name} (done {time.perf_counter() - t0:.1f} s "
                        f"after the start)\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(text))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    log.write_text("\n".join(text))
    return lib, log.read_text()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    if not _LIB:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB.append(lib)
    return _LIB[0]


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
