# Copied from zecale_tpu/gadgets/protoboard.py (JAX-free); imports, build paths and the span of the hook program's build changed.
"""Constraint-system builder ("protoboard") and linear-combination algebra.

Equivalent role to libsnark's ``protoboard``/``pb_variable``/``gadget``
machinery in the reference stack (SURVEY.md section 2b, "libsnark —
relations/protoboard"), redesigned for this framework:

  * Constraints accumulate into the flat sparse R1CS of
    ``zecale_tpu.snark.r1cs`` (directly exportable as index/coefficient
    tensors for the TPU prover kernels).
  * Witness generation is a recorded program: every gadget that allocates
    intermediate variables appends a *hook* (a Python closure) at build time;
    proving replays the hooks in order against a fresh assignment.  This
    mirrors the reference's two-phase generate_r1cs_constraints /
    generate_r1cs_witness flow (aggregator_circuit.tcc:60-97,119-170) while
    keeping the circuit reusable across proofs.

Variable numbering follows libsnark: 0 is the constant ONE; primary (public)
variables must be allocated before any auxiliary variable.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

from ..snark.r1cs import R1CS
from ..utils import profiling


class LC:
    """Sparse linear combination  sum_i coeff_i * var_i  over F_r.

    Immutable; supports +, -, scalar *.  ``LC.const(pb, c)`` is c * ONE.
    """

    __slots__ = ("terms",)

    def __init__(self, terms: Iterable[Tuple[int, int]] = ()):
        # normalize: merge duplicate variable indices
        merged: Dict[int, int] = {}
        for idx, coeff in terms:
            merged[idx] = merged.get(idx, 0) + coeff
        self.terms: Tuple[Tuple[int, int], ...] = tuple(
            (i, c) for i, c in merged.items() if c != 0
        )

    @staticmethod
    def of_var(idx: int, coeff: int = 1) -> "LC":
        return LC([(idx, coeff)])

    @staticmethod
    def const(c: int) -> "LC":
        return LC([(0, c)])

    def __add__(self, other: "LC") -> "LC":
        return LC(self.terms + other.terms)

    def __sub__(self, other: "LC") -> "LC":
        return LC(self.terms + tuple((i, -c) for i, c in other.terms))

    def __neg__(self) -> "LC":
        return LC(tuple((i, -c) for i, c in self.terms))

    def scale(self, k: int) -> "LC":
        return LC(tuple((i, c * k) for i, c in self.terms))

    def is_zero(self) -> bool:
        return not self.terms

    def as_list(self) -> List[Tuple[int, int]]:
        return list(self.terms)


class Protoboard:
    """Accumulates variables, constraints and the witness program."""

    def __init__(self, r: int):
        self.r = r
        self._num_vars = 1  # var 0 == ONE
        self.num_primary = 0
        self._primary_sealed = False
        self.constraints: List[Tuple[LC, LC, LC]] = []
        self.witness_hooks: List[Callable[[List[int]], None]] = []
        self.hook_ops: List = []  # structured descriptors (or None)
        self._hook_prog = None  # compiled native program cache
        self.ONE = LC.const(1)

    # -- allocation ---------------------------------------------------------
    def allocate(self) -> int:
        idx = self._num_vars
        self._num_vars += 1
        return idx

    def allocate_array(self, n: int) -> List[int]:
        return [self.allocate() for _ in range(n)]

    def allocate_primary(self) -> int:
        assert not self._primary_sealed, (
            "primary inputs must be allocated before auxiliary variables"
        )
        self.num_primary += 1
        return self.allocate()

    def allocate_primary_array(self, n: int) -> List[int]:
        return [self.allocate_primary() for _ in range(n)]

    def seal_primary(self) -> None:
        self._primary_sealed = True

    @property
    def num_variables(self) -> int:
        return self._num_vars

    # -- constraints --------------------------------------------------------
    def add_r1cs(self, a: LC, b: LC, c: LC) -> None:
        """Constrain <a, w> * <b, w> == <c, w>."""
        if not self._primary_sealed:
            self._primary_sealed = True
        self.constraints.append((a, b, c))

    def enforce_equal(self, a: LC, b: LC) -> None:
        self.add_r1cs(a - b, self.ONE, LC())

    def enforce_boolean(self, x: LC) -> None:
        """x * (x - 1) == 0."""
        self.add_r1cs(x, x - self.ONE, LC())

    # -- witness program ----------------------------------------------------
    def add_hook(self, fn: Callable[[List[int]], None], op=None) -> None:
        """Register a witness hook.  ``op``: optional structured bytecode
        descriptor for the native replay engine (csrc/witness_engine.c
        hook_replay); hooks without one run as Python closures against a
        Montgomery-array view between native segments."""
        self.witness_hooks.append(fn)
        self.hook_ops.append(op)
        self._hook_prog = None

    def lc_val(self, assignment: List[int], lc: LC) -> int:
        acc = 0
        for idx, coeff in lc.terms:
            acc += coeff * assignment[idx]
        return acc % self.r

    def mul_hook(self, out_idx: int, a: LC, b: LC) -> None:
        """Hook computing out = <a,w> * <b,w>."""

        def fn(w: List[int], _a=a, _b=b, _o=out_idx, _pb=self):
            w[_o] = _pb.lc_val(w, _a) * _pb.lc_val(w, _b) % _pb.r

        self.add_hook(fn, op=("mul", out_idx, a, b))

    # -- common gadget primitives ------------------------------------------
    def mul(self, a: LC, b: LC) -> LC:
        """Allocate v with constraint a * b == v; returns v as an LC."""
        v = self.allocate()
        self.add_r1cs(a, b, LC.of_var(v))
        self.mul_hook(v, a, b)
        return LC.of_var(v)

    def square(self, a: LC) -> LC:
        return self.mul(a, a)

    def div(self, a: LC, b: LC) -> LC:
        """Allocate v with constraint v * b == a (i.e. v = a / b).

        Witness-total: if b evaluates to 0 the hook assigns v = 0 and the
        constraint only holds if a == 0 as well; division gadget callers on
        the *result-bit* paths must guard accordingly.
        """
        v = self.allocate()

        def fn(w: List[int], _a=a, _b=b, _v=v, _pb=self):
            bv = _pb.lc_val(w, _b)
            av = _pb.lc_val(w, _a)
            w[_v] = 0 if bv == 0 else av * pow(bv, _pb.r - 2, _pb.r) % _pb.r

        self.add_hook(fn, op=("div", v, a, b))
        self.add_r1cs(LC.of_var(v), b, a)
        return LC.of_var(v)

    def inv_or_zero(self, a: LC) -> Tuple[LC, LC]:
        """Return (a_inv, is_nonzero_bit) with total witness semantics.

        Constraints: a * a_inv == nz;  a * (1 - nz) == 0;  nz boolean.
        """
        ainv = self.allocate()
        nz = self.allocate()

        def fn(w: List[int], _a=a, _ai=ainv, _nz=nz, _pb=self):
            av = _pb.lc_val(w, _a)
            if av == 0:
                w[_ai] = 0
                w[_nz] = 0
            else:
                w[_ai] = pow(av, _pb.r - 2, _pb.r)
                w[_nz] = 1

        self.add_hook(fn, op=("invz", ainv, nz, a))
        nz_lc = LC.of_var(nz)
        self.add_r1cs(a, LC.of_var(ainv), nz_lc)
        self.add_r1cs(a, self.ONE - nz_lc, LC())
        self.enforce_boolean(nz_lc)
        return LC.of_var(ainv), nz_lc

    def is_equal_bit(self, a: LC, b: LC) -> LC:
        """Bit that is 1 iff <a,w> == <b,w> (total)."""
        _, nz = self.inv_or_zero(a - b)
        return self.ONE - nz

    def bit_and(self, a: LC, b: LC) -> LC:
        return self.mul(a, b)

    def select(self, bit: LC, if_one: LC, if_zero: LC) -> LC:
        """bit ? if_one : if_zero  (bit must be boolean)."""
        return self.mul(bit, if_one - if_zero) + if_zero

    # -- finalize -----------------------------------------------------------
    def to_r1cs(self) -> R1CS:
        r1cs = R1CS(
            r=self.r,
            num_primary=self.num_primary,
            num_aux=self._num_vars - 1 - self.num_primary,
        )
        for a, b, c in self.constraints:
            r1cs.add_constraint(a.as_list(), b.as_list(), c.as_list())
        return r1cs

    def generate_witness(
        self, primary: Sequence[int], extra_setter=None,
        parallel_ranges=None,
    ) -> List[int]:
        """Replay the witness program.

        ``primary``: values for the primary inputs (in allocation order).
        ``extra_setter(assignment)``: optional callback run before hooks to
        seed non-primary free inputs (e.g. the nested proofs being verified).

        ``parallel_ranges``: optional list of disjoint, contiguous,
        ascending (start, end) hook index ranges whose hooks are mutually
        independent (e.g. the per-proof verifier witnesses of the
        aggregator batch).  Each range is replayed in a forked child
        process; hooks before the first range run first, hooks after the
        last range run after the merge.  Requires os.fork (Linux).

        MEASURED (batch-N dummy-app wrapper, 64-core host): fork-based
        replay is value-exact but wins only modestly at batch 4 (~1.2x)
        and LOSES at batch 8 (~0.4x) — copy-on-write refcount storms on
        the multi-GB parent heap dominate the pure-Python bigint work.
        It therefore stays opt-in (ZECALE_PARALLEL_WITNESS=1); the real
        scaling fix is pushing hook replay into the C witness engine
        (csrc/witness_engine.c), tracked in KNOWN_GAPS."""
        w = [0] * self._num_vars
        w[0] = 1
        assert len(primary) == self.num_primary
        for i, v in enumerate(primary):
            w[1 + i] = v % self.r
        if extra_setter is not None:
            extra_setter(w)

        # round-4 default: the native C hook-replay engine
        # (csrc/witness_engine.c hook_replay) executes the structured
        # bytecode of the witness program; unstructured hooks run as
        # Python closures between native segments.  ZECALE_PY_WITNESS=1
        # forces the pure-Python loop (differential testing).
        if not os.environ.get("ZECALE_PY_WITNESS"):
            prog = self._hook_prog
            if prog is None:
                try:
                    from ..native.witness import HookProgram

                    with profiling.span("setup.hook_program"):
                        prog = HookProgram(self)
                except Exception:
                    prog = False
                self._hook_prog = prog
            if prog and prog.available:
                return prog.run(w)

        if not parallel_ranges or len(parallel_ranges) < 2:
            for hook in self.witness_hooks:
                hook(w)
            return w

        import multiprocessing as mp

        for (a_lo, a_hi), (b_lo, b_hi) in zip(
            parallel_ranges, parallel_ranges[1:]
        ):
            assert a_hi == b_lo, (
                "parallel_ranges must be contiguous (hooks between ranges "
                "would be skipped)"
            )
        # cap the fork count: each child COW-faults the parent heap while
        # copying the assignment, so many small children thrash (measured:
        # 8 forks on the 246k-var batch-8 wrapper ran 4x SLOWER than
        # sequential; 4 forks were 2.4x faster).  Merge adjacent ranges.
        max_procs = int(os.environ.get("ZECALE_WITNESS_PROCS", "4"))
        if len(parallel_ranges) > max_procs:
            per = -(-len(parallel_ranges) // max_procs)
            merged = []
            for i in range(0, len(parallel_ranges), per):
                group = parallel_ranges[i : i + per]
                merged.append((group[0][0], group[-1][1]))
            parallel_ranges = merged

        ctx = mp.get_context("fork")
        lo0 = parallel_ranges[0][0]
        hi_last = parallel_ranges[-1][1]
        for hook in self.witness_hooks[:lo0]:
            hook(w)

        def run_range(lo, hi, conn):
            wc = list(w)
            for hook in self.witness_hooks[lo:hi]:
                hook(wc)
            diff = [
                (i, v) for i, (v, v0) in enumerate(zip(wc, w)) if v != v0
            ]
            conn.send(diff)
            conn.close()

        procs = []
        for lo, hi in parallel_ranges:
            parent, child = ctx.Pipe(duplex=False)
            p = ctx.Process(target=run_range, args=(lo, hi, child))
            p.start()
            child.close()
            procs.append((p, parent))
        for p, parent in procs:
            for i, v in parent.recv():
                w[i] = v
            p.join()
        for hook in self.witness_hooks[hi_last:]:
            hook(w)
        return w
