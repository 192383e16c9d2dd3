"""Build of the port's hand-written kernels into plain-C shared libraries.

``nvcc`` compiles each kernel source of ``KERNELS`` for ``sm_90a``, once
per variant (field form and threads per point), into a ``.so``
with a plain C interface, loaded with ``ctypes``: no PyTorch headers, so
the build takes seconds rather than the minutes of
``torch.utils.cpp_extension``.  The same headers also build with ``g++``
into a CPU library (``host_check.cpp``) that the tests run here.  Builds
happen at first use, land in the git-ignored ``zecale_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, and are renamed
into place so that parallel processes never load a half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC",
             "-Wno-unknown-pragmas"]

#: seconds and compiler log of the last build done by this process
last_build: dict = {}


def _sources(pattern: str) -> list:
    return sorted(glob.glob(os.path.join(CSRC, pattern)))


def _key(files: list, flags: list) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files + _sources("*.cuh"):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    return h.hexdigest()[:16]


class _Job:
    """One compiler run into a content-keyed library; starts at once."""

    def __init__(self, cmd: list, srcs: list, flags: list, stem: str):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.stem = stem
        self.out = os.path.join(BUILD_DIR, f"{stem}-{_key(srcs, flags)}.so")
        self.proc = None
        self.t0 = time.time()
        if not os.path.exists(self.out):
            self.tmp = f"{self.out}.{os.getpid()}.tmp"
            self.proc = subprocess.Popen(
                cmd + flags + ["-I", CSRC, "-o", self.tmp] + srcs,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )

    def wait(self) -> str:
        log = "cached"
        if self.proc is not None:
            log, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(
                    f"build of {self.stem} failed ({self.proc.returncode}):"
                    f"\n{log[-4000:]}"
                )
            os.replace(self.tmp, self.out)
        last_build[self.stem] = {
            "seconds": time.time() - self.t0, "log": log, "path": self.out,
        }
        return self.out


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the toolkit")
    return path


_VP, _CI = ctypes.c_void_p, ctypes.c_int

#: -D flags of each field form: BLS12-377 Fq and BW6-761 Fr have 12 limbs,
#: BW6-761 Fq 24, and BLS12-377 Fq2 is 2 x 12
FORMS = {
    "fq12": ["-DZT_LIMBS=12"],
    "fq24": ["-DZT_LIMBS=24"],
    "fq2": ["-DZT_FQ2=1"],
}

#: Threads per point of K2 (proj_add) and K4 (jac_add), fast_kernels.cu,
#: by kernel and form: rows (largest batch, TPI), the last row's bound
#: None (any batch).  A wrapper takes the first row whose bound holds its
#: batch.  The build makes every TPI a form names, for both kernels: at
#: most two a form.  From a sweep of every TPI on the H100 (PERF.md
#: section 6): at Fq 24 and Fq2 lanes beat one thread a point
#: (its registers spill), eight a point on small batches; at Fq 12 one
#: thread wins from a few thousand points up.
ADD_TPI = {
    "proj_add": {
        "fq12": ((None, 1),),
        "fq24": ((16384, 8), (None, 4)),
        "fq2": ((None, 4),),
    },
    "jac_add": {
        "fq12": ((4096, 4), (None, 1)),
        "fq24": ((16384, 8), (None, 4)),
        "fq2": ((4096, 4), (None, 1)),
    },
}


def _row(table: dict, kernel: str, form: str, n: int) -> tuple:
    """The first row of table[kernel][form] whose bound holds n, without
    its bound."""
    for bound, *pick in table[kernel][form]:
        if bound is None or n <= bound:
            return tuple(pick)
    raise ValueError(f"no row of {kernel} {form} for n = {n}")


def add_tpi(kernel: str, form: str, n: int) -> int:
    """Threads per point of ``kernel`` (K2 "proj_add" or K4 "jac_add") for
    a batch of n points in ``form``."""
    return _row(ADD_TPI, kernel, form, n)[0]


#: the TPIs built for each form: every one that ADD_TPI names
ADD_TPIS = {form: sorted({t for table in ADD_TPI.values()
                          for _, t in table[form]})
            for form in FORMS}

#: Threads per point-group of K3 (proj_dbl_chain) and K5 (jac_dbl_chain),
#: fast_kernels.cu, by kernel and form: rows (largest batch, TPI), looked
#: up as ADD_TPI's.  Both kernels run one warp a point with the products of
#: each step side by side, in 32 / TPI groups of TPI lanes; every
#: fast_kernels variant (ADD_TPIS) builds them.  From a sweep of every
#: built TPI at the paths' batches (1, 35 and 48 points) on the H100
#: (PERF.md section 6): eight lanes at Fq 24, four at Fq 12, one thread
#: over Fq2 (four lanes tie there within 5%).  No path sends more than 48
#: points; at 16,384 a warp a point costs 32 / TPI times the threads.
DBL_TPI = {
    "proj_dbl_chain": {
        "fq12": ((None, 4),),
        "fq24": ((None, 8),),
        "fq2": ((None, 1),),
    },
    "jac_dbl_chain": {
        "fq12": ((None, 4),),
        "fq24": ((None, 8),),
        "fq2": ((None, 1),),
    },
}


def dbl_tpi(kernel: str, form: str, n: int) -> int:
    """Threads per point-group of ``kernel`` (K3 "proj_dbl_chain" or K5
    "jac_dbl_chain") for a batch of n points in ``form``."""
    return _row(DBL_TPI, kernel, form, n)[0]


#: Threads per segment of K1 (bucket_reduce, keyed by the launch's
#: entries: its adds) and per point of K6 (aff_add, keyed by the batch),
#: fast_kernels.cu, by kernel and form: rows (largest count, TPI), looked
#: up as ADD_TPI's, each TPI one that ADD_TPIS builds.  From the sweep of
#: every built TPI in chip_smoke.py on the H100 (PERF.md section 6).  K1
#: at the launches of an MSM at n = 2^16 and the first 4,096-65,536
#: segments of its first one: up to 131,072 entries (subset sums, second
#: levels of short segments, 4,096 full segments) the more lanes won in
#: every form, from 524,288 (16,384 full segments and up) the fewer; at
#: equal segment counts the pick flips with the segments' length, so the
#: entries, not the segments, key the rows.  K6 at the jac engine's tiled
#: round and the setup's 16,384-lane chunks, as K4's rows where the two
#: TPIs were within the runs' noise.
SUM_TPI = {
    "bucket_reduce": {
        "fq12": ((262144, 4), (None, 1)),
        "fq24": ((262144, 8), (None, 4)),
        "fq2": ((262144, 4), (None, 1)),
    },
    "aff_add": {
        "fq12": ((16384, 4), (None, 1)),
        "fq24": ((16384, 8), (None, 4)),
        "fq2": ((4096, 4), (None, 1)),
    },
}


def sum_tpi(kernel: str, form: str, n: int) -> int:
    """Threads per segment of K1 ("bucket_reduce", a launch of n entries)
    or per point of K6 ("aff_add", n points) in ``form``."""
    return _row(SUM_TPI, kernel, form, n)[0]


#: One entry per kernel source: its variants (key -> -D flags, one nvcc and
#: one library each) and the C functions every variant exports, with their
#: ctypes argtypes.  Every launcher returns the CUDA error code (int).
KERNELS = {
    "fast_kernels.cu": {
        "variants": {(form, t): FORMS[form] + [f"-DZT_TPI={t}"]
                     for form, ts in ADD_TPIS.items() for t in ts},
        "symbols": {
            # pts, ent, seg, nseg, out, affine, b3, stream
            "zt_bucket_reduce": [_VP, _VP, _VP, _CI, _VP, _CI, _VP, _VP],
            # p, q, out, n, b3, stream
            "zt_proj_add": [_VP, _VP, _VP, _CI, _VP, _VP],
            # p, q, out, n, stream
            "zt_jac_add": [_VP, _VP, _VP, _CI, _VP],
            # p, out, n, k, b3, stream
            "zt_proj_dbl_chain": [_VP, _VP, _CI, _CI, _VP, _VP],
            # p, out, n, k, stream
            "zt_jac_dbl_chain": [_VP, _VP, _CI, _CI, _VP],
            # a, ainf, b, binf, out, n, stream
            "zt_aff_add": [_VP, _VP, _VP, _VP, _VP, _CI, _VP],
        },
    },
}

@functools.lru_cache(maxsize=None)
def cuda_kernels() -> dict:
    """{(symbol, variant key): ctypes function} of every kernel in
    ``KERNELS``, built on first use: one nvcc per (source, variant), all
    started together before the first one is waited for."""
    nvcc = nvcc_path()
    jobs = []
    for src, spec in KERNELS.items():
        stem = src.rsplit(".", 1)[0]
        for key, flags in spec["variants"].items():
            name = "-".join([stem, *map(str, key)])
            job = _Job([nvcc], [os.path.join(CSRC, src)], NVCC_FLAGS + flags,
                       name)
            jobs.append((spec["symbols"], key, job))
    fns, failed = {}, []
    for symbols, key, job in jobs:
        try:
            path = job.wait()
        except RuntimeError as e:  # wait for the others, then report all
            failed.append(str(e))
            continue
        lib = ctypes.CDLL(path)
        for sym, argtypes in symbols.items():
            # attribute access caches the function object on the library,
            # so the argtypes set here stay with it
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = _CI
            fns[(sym, key)] = fn
    if failed:
        raise RuntimeError("\n".join(failed))
    return fns


def kernel_label(mangled: str):
    """The kernel function of a mangled name, K1's with its input form (its
    last template argument, the bool before the return type); None for
    another symbol."""
    kernel = re.search(r"([a-z][a-z_]*_kernel)I", mangled)
    if not kernel:
        return None
    if kernel.group(1) == "bucket_reduce_kernel":
        affine = re.search(r"Lb([01])E+v", mangled)
        if affine:
            return kernel.group(1) + ("_affine" if affine.group(1) == "1"
                                      else "_projective")
    return kernel.group(1)


def build_report() -> list:
    """One line per job of this process: seconds, and the ptxas register
    and spill lines of its log."""
    out = []
    for stem, info in sorted(last_build.items()):
        if info["log"] == "cached":
            out.append(f"{stem}: cached ({info['path']})")
            continue
        regs = []
        for ln in info["log"].splitlines():
            kernel = kernel_label(ln)
            if "entry function" in ln and kernel:
                regs.append(kernel)
            elif "registers" in ln or "spill" in ln:
                regs.append(ln.split(":", 1)[-1].strip())
        out.append(f"{stem}: {info['seconds']:.1f}s {regs}")
    return out


@functools.lru_cache(maxsize=None)
def host_check_lib() -> ctypes.CDLL:
    """CPU build of the kernels' device math, for the tests."""
    gxx = shutil.which("g++") or "g++"
    so = _Job([gxx], _sources("host_check.cpp"), GXX_FLAGS,
              "host_check").wait()
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.zt_cpu_fp_mul.argtypes = [ci, vp, vp, vp, ctypes.c_long, vp, vp,
                                  ctypes.c_uint]
    lib.zt_cpu_fp_mul.restype = ci
    lib.zt_cpu_jac.argtypes = [ci, ci, vp, vp, vp, ctypes.c_long, ci, vp, vp,
                               ctypes.c_uint]
    lib.zt_cpu_jac.restype = ci
    lib.zt_cpu_fast_field.argtypes = [ci, ci, ci, vp, vp, vp, ctypes.c_long]
    lib.zt_cpu_fast_field.restype = ci
    lib.zt_cpu_fast_add.argtypes = [ci, ci, ci, vp, vp, vp, ctypes.c_long,
                                    vp]
    lib.zt_cpu_fast_add.restype = ci
    lib.zt_cpu_fast_dbl.argtypes = [ci, ci, ci, vp, vp, ctypes.c_long, ci,
                                    vp]
    lib.zt_cpu_fast_dbl.restype = ci
    lib.zt_cpu_fast_reduce.argtypes = [ci, ci, ci, vp, vp, vp, ci, vp, vp]
    lib.zt_cpu_fast_reduce.restype = ci
    lib.zt_cpu_fast_aff_add.argtypes = [ci, ci, vp, vp, vp, vp, vp,
                                        ctypes.c_long]
    lib.zt_cpu_fast_aff_add.restype = ci
    lib.zt_cpu_fast_consts.argtypes = [ci, vp, vp]
    lib.zt_cpu_fast_consts.restype = ctypes.c_uint
    return lib
