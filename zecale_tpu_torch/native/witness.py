# Copied from zecale_tpu/native/witness.py (JAX-free); imports, build paths, the grouping of Python hooks and the replay's span changed.
"""ctypes bindings for the native witness/constraint engine
(csrc/witness_engine.c).  Compiled on demand with gcc; every entry point has
a pure-Python fallback, so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np

from ..utils import profiling

_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "csrc", "witness_engine.c"
)
_SO = os.path.join(tempfile.gettempdir(), "zecale_torch_witness_engine.so")

LIMB64 = 64


def _so_and_flags():
    """Sanitized-build variant selection (ZECALE_NATIVE_SANITIZE; see
    native/ec.py — the reference-sanitizers analog,
    cmake/sanitizers.cmake:17-91)."""
    from .ec import _SAN_FLAGS, sanitize_mode

    mode = sanitize_mode()
    suffix = f".{mode}" if mode else ""
    so = os.path.join(
        tempfile.gettempdir(), "zecale_torch_witness_engine" + suffix + ".so"
    )
    return so, _SAN_FLAGS.get(mode, [])


def _limbs64(x: int, nl: int) -> np.ndarray:
    out = np.empty(nl, dtype=np.uint64)
    for i in range(nl):
        out[i] = (x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
    return out


def _from_limbs64(a: np.ndarray) -> int:
    acc = 0
    for i, v in enumerate(a.tolist()):
        acc |= int(v) << (64 * i)
    return acc


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    try:
        so, san = _so_and_flags()
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(
            _SRC
        ):
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(
                ["gcc", "-O3", "-shared", "-fPIC", "-o", tmp] + san + [_SRC],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.fp_ctx_size.restype = ctypes.c_long
        return lib
    except Exception:
        return None


class NativeField:
    """Per-modulus native context (None if the engine is unavailable)."""

    def __init__(self, p: int):
        self.p = p
        self.nl = -(-p.bit_length() // LIMB64)
        assert self.nl <= 12
        self.lib = _lib()
        if self.lib is None:
            self.ctx = None
            return
        R = 1 << (64 * self.nl)
        self.ctx = ctypes.create_string_buffer(self.lib.fp_ctx_size())
        self.lib.fp_init(
            self.ctx,
            self.nl,
            _limbs64(p, self.nl).ctypes.data_as(ctypes.c_void_p),
            _limbs64(R * R % p, self.nl).ctypes.data_as(ctypes.c_void_p),
            ctypes.c_uint64((-pow(p, -1, 1 << 64)) % (1 << 64)),
        )

    @property
    def available(self) -> bool:
        return self.ctx is not None

    # -- packing ------------------------------------------------------------
    def pack(self, ints: Sequence[int]) -> np.ndarray:
        out = np.empty((len(ints), self.nl), dtype=np.uint64)
        for i, x in enumerate(ints):
            out[i] = _limbs64(x % self.p, self.nl)
        return out

    def unpack(self, arr: np.ndarray) -> List[int]:
        return [_from_limbs64(row) for row in arr]

    def to_mont(self, arr: np.ndarray) -> np.ndarray:
        out = np.empty_like(arr)
        self.lib.fp_to_mont_batch(
            self.ctx,
            out.ctypes.data_as(ctypes.c_void_p),
            arr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(arr.shape[0]),
        )
        return out

    def from_mont(self, arr: np.ndarray) -> np.ndarray:
        out = np.empty_like(arr)
        self.lib.fp_from_mont_batch(
            self.ctx,
            out.ctypes.data_as(ctypes.c_void_p),
            arr.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_long(arr.shape[0]),
        )
        return out


@functools.lru_cache(maxsize=None)
def native_field(p: int) -> NativeField:
    return NativeField(p)


class NativeR1CS:
    """Pre-packed sparse R1CS bound to the native engine for fast
    repeated evaluation (the hot host-side step of every prove call)."""

    def __init__(self, r1cs):
        self.r1cs = r1cs
        self.F = native_field(r1cs.r)
        if not self.F.available:
            return
        mats = r1cs.to_sparse_tensors()
        self.packed = []
        for rows, cols, vals in mats:
            self.packed.append(
                (
                    np.asarray(rows, dtype=np.int32),
                    np.asarray(cols, dtype=np.int32),
                    self.F.to_mont(self.F.pack(vals)),
                )
            )

    @property
    def available(self) -> bool:
        return self.F.available

    def abc_evaluations(self, assignment: Sequence[int]):
        """Az, Bz, Cz over the padded QAP domain (standard form ints),
        bit-identical to R1CS.abc_evaluations."""
        r1cs = self.r1cs
        n = r1cs.qap_degree
        asg_m = self.F.to_mont(self.F.pack(list(assignment)))
        outs = []
        for rows, cols, coeffs_m in self.packed:
            acc = np.zeros((n, self.F.nl), dtype=np.uint64)
            self.F.lib.lc_matvec(
                self.F.ctx,
                acc.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_long(n),
                rows.ctypes.data_as(ctypes.c_void_p),
                cols.ctypes.data_as(ctypes.c_void_p),
                coeffs_m.ctypes.data_as(ctypes.c_void_p),
                asg_m.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_long(len(rows)),
            )
            outs.append(self.F.unpack(self.F.from_mont(acc)))
        az, bz, cz = outs
        # hardening rows: az[m + i] = assignment[i]
        m = r1cs.num_constraints
        for i in range(r1cs.num_primary + 1):
            az[m + i] = assignment[i] % r1cs.r
        return az, bz, cz

    def first_failing_constraint(self, assignment: Sequence[int]):
        az, bz, cz = self.abc_evaluations(assignment)
        r = self.r1cs.r
        for i in range(self.r1cs.num_constraints):
            if az[i] * bz[i] % r != cz[i]:
                return i
        return None


# ---------------------------------------------------------------------------
# witness hook-program replay (round 4 — VERDICT r3 item 4)
# ---------------------------------------------------------------------------


def _pack_fast(vals: Sequence[int], nl: int) -> np.ndarray:
    """Batch int -> u64-limb pack via one bytes buffer (the per-element
    _limbs64 path costs ~2.5 us/element in Python — a wall at 250k vars)."""
    w = nl * 8
    buf = b"".join(int(v).to_bytes(w, "little") for v in vals)
    return (
        np.frombuffer(buf, dtype=np.uint64).reshape(len(vals), nl).copy()
    )


def _unpack_fast(arr: np.ndarray) -> List[int]:
    nl = arr.shape[1]
    w = nl * 8
    buf = arr.astype(np.uint64).tobytes()
    return [
        int.from_bytes(buf[i * w : (i + 1) * w], "little")
        for i in range(arr.shape[0])
    ]


class _MontView:
    """List-like adapter over the Montgomery u64 assignment array, so
    unstructured Python hooks (tower inversions etc.) read and write
    plain ints transparently between native segments."""

    def __init__(self, F: NativeField, arr: np.ndarray):
        self.F = F
        self.arr = arr
        self.r = F.p
        self.R = 1 << (64 * F.nl)
        self.rinv = pow(self.R, F.p - 2, F.p)

    def __getitem__(self, i: int) -> int:
        return _from_limbs64(self.arr[i]) * self.rinv % self.r

    def __setitem__(self, i: int, v: int) -> None:
        self.arr[i] = _limbs64(v % self.r * self.R % self.r, self.F.nl)

    def __len__(self) -> int:
        return self.arr.shape[0]


class HookProgram:
    """Compiled witness program: structured hooks flattened to the C
    bytecode (csrc/witness_engine.c hook_replay); unstructured hooks run
    as Python closures against a _MontView between native segments.

    Build once per protoboard, replay per prove.  Replaces the Python
    closure loop (and the abandoned fork-replay experiment) as the
    witness engine behind Protoboard.generate_witness."""

    #: op tags -> C opcodes.  Precondition for "xor": BOTH operand LCs must
    #: evaluate to bits — the C opcode computes nonzero(a) XOR nonzero(b),
    #: which matches the Python hooks' integer '^' only on {0, 1} (the one
    #: current emitter, gadgets/blake2s.py, xors boolean-constrained bit
    #: wires; ADVICE r4 low).
    KINDS = {"mul": 0, "div": 1, "invz": 2, "assign": 3, "unpack": 4,
             "xor": 5}

    def __init__(self, pb):
        self.pb = pb
        self.F = native_field(pb.r)
        #: ("c", ops array) | ("py", indices of consecutive Python hooks)
        self.segments = []
        if not self.F.available:
            return
        F = self.F
        nl = F.nl
        r = pb.r
        R = 1 << (64 * nl)
        tvar: List[int] = []
        tcoef: List[int] = []  # Montgomery-form coefficients

        def flat_lc(lc) -> tuple:
            off = len(tvar)
            terms = lc.as_list() if hasattr(lc, "as_list") else lc
            for idx, coeff in terms:
                tvar.append(idx)
                tcoef.append(coeff % r * R % r)
            return off, len(terms)

        cur: List[List[int]] = []
        for hi, op in enumerate(pb.hook_ops):
            if op is None:
                if cur:
                    self.segments.append(("c", cur))
                    cur = []
                if self.segments and self.segments[-1][0] == "py":
                    self.segments[-1][1].append(hi)
                else:
                    self.segments.append(("py", [hi]))
                continue
            kind = self.KINDS[op[0]]
            if op[0] in ("mul", "div", "xor"):
                _, out, a, b = op
                ao, al = flat_lc(a)
                bo, bl = flat_lc(b)
                cur.append([kind, out, ao, al, bo, bl, 0, 0])
            elif op[0] == "invz":
                _, ainv, nz, a = op
                ao, al = flat_lc(a)
                cur.append([kind, ainv, ao, al, 0, 0, nz, 0])
            elif op[0] == "assign":
                _, out, lc = op
                ao, al = flat_lc(lc)
                cur.append([kind, out, ao, al, 0, 0, 0, 0])
            elif op[0] == "unpack":
                _, out0, nbits, lc = op
                ao, al = flat_lc(lc)
                cur.append([kind, out0, ao, al, 0, 0, nbits, 0])
        if cur:
            self.segments.append(("c", cur))
        self.segments = [
            (k, np.asarray(v, dtype=np.int32) if k == "c" else v)
            for k, v in self.segments
        ]
        self.tvar = np.asarray(tvar, dtype=np.int32)
        self.tcoef = _pack_fast(tcoef, nl)
        self.pm2 = _limbs64(r - 2, nl)
        self.one_m = _limbs64(R % r, nl)

    @property
    def available(self) -> bool:
        return self.F.available

    def run(self, w: List[int]) -> List[int]:
        """Replay over a plain-int assignment list (primary + seeded
        free inputs filled, the rest 0); returns the completed list.

        The replay is the span ``witness.replay``; its attributes
        ``c_segments``, ``py_hooks`` and ``py_ns`` count the C segments
        run, the Python hooks run and the nanoseconds of the runs of
        consecutive Python hooks."""
        F = self.F
        hooks = self.pb.witness_hooks
        c_segments = py_hooks = py_ns = 0
        with profiling.span("witness.replay") as sp:
            arr = _pack_fast([v % F.p for v in w], F.nl)
            arr_m = F.to_mont(arr)
            view = None
            for kind, payload in self.segments:
                if kind == "c":
                    F.lib.hook_replay(
                        F.ctx,
                        arr_m.ctypes.data_as(ctypes.c_void_p),
                        payload.ctypes.data_as(ctypes.c_void_p),
                        ctypes.c_long(payload.shape[0]),
                        self.tvar.ctypes.data_as(ctypes.c_void_p),
                        self.tcoef.ctypes.data_as(ctypes.c_void_p),
                        self.pm2.ctypes.data_as(ctypes.c_void_p),
                        self.one_m.ctypes.data_as(ctypes.c_void_p),
                    )
                    c_segments += 1
                else:
                    if view is None:
                        view = _MontView(F, arr_m)
                    t0 = time.perf_counter_ns()
                    for hi in payload:
                        hooks[hi](view)
                    py_ns += time.perf_counter_ns() - t0
                    py_hooks += len(payload)
            out = _unpack_fast(F.from_mont(arr_m))
            sp.attrs.update(c_segments=c_segments, py_hooks=py_hooks,
                            py_ns=py_ns)
        return out
