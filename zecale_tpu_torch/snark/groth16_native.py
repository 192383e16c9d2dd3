# Copied from zecale_tpu/snark/groth16_native.py (JAX-free but for line 211); generate_setup calls snark/setup_native.py, and the QAP evaluations come from groth16_torch.abc_evaluations.
"""Groth16 prover/setup on the native C runtime (csrc/ec_engine.c).

The zero-hardware production path: same algebra as the device prover
(snark/groth16_torch.py) with the QAP division and all five MSMs running in
the native engine — this is what makes full recursion (setup -> prove ->
verify) feasible inside the CPU test suite (VERDICT round-1 item 4) and
gives serving hosts without an accelerator a real prover, mirroring the
reference's CPU-only operation (libsnark r1cs_gg_ppzksnark under
aggregator_circuit.tcc:168).
"""

from __future__ import annotations

import functools
import random
from typing import Optional, Sequence

import numpy as np

from ..ec import host_curve as hc
from ..ff import params as P
from ..native import ec as nec
from ..poly.domain_host import domain
from . import setup_native
from .groth16 import Groth16KeyPair, Groth16Proof, Groth16ProvingKey
from .r1cs import R1CS


def available() -> bool:
    return nec.available()


@functools.lru_cache(maxsize=None)
def _coset_tables(d):
    """(fwd, inv) coset scale arrays in Montgomery u64 form, keyed by the
    domain object (domain() caches one instance per (size, r))."""
    r = d.r
    F = nec.NativeScalarField(r)
    g = d.coset_shift
    ginv = pow(g, r - 2, r)
    fwd, inv = [], []
    cf = ci = 1
    for _ in range(d.size):
        fwd.append(cf)
        inv.append(ci)
        cf = cf * g % r
        ci = ci * ginv % r
    return F.to_mont(fwd), F.to_mont(inv)


@functools.lru_cache(maxsize=None)
def _ext_tables(d):
    """Per-block (shift^j)^i scale arrays (fwd, inv) for the extended-domain
    native FFT, Montgomery u64 form, keyed by the domain object."""
    r = d.r
    F = nec.NativeScalarField(r)
    fwd_blocks, inv_blocks = [], []
    for j in range(d.C):
        sj = pow(d.shift, j, r)
        sji = pow(sj, r - 2, r)
        fwd, inv = [], []
        cf = ci = 1
        for _ in range(d.m):
            fwd.append(cf)
            inv.append(ci)
            cf = cf * sj % r
            ci = ci * sji % r
        fwd_blocks.append(F.to_mont(fwd))
        inv_blocks.append(F.to_mont(inv))
    return tuple(fwd_blocks), tuple(inv_blocks)


def _native_fft(F: "nec.NativeScalarField", d, arr: np.ndarray,
                inverse: bool) -> np.ndarray:
    """In-place-style FFT/iFFT over domain `d` via the C engine: plain
    radix-2 for basic domains; fold-scale + per-coset radix-2 for extended
    domains (same composition as ExtendedRadix2Domain.fft/ifft)."""
    r = d.r
    if getattr(d, "C", 1) == 1:
        if inverse:
            F.fft_inplace(arr, d.omega_inv, sinv=pow(d.size, r - 2, r))
        else:
            F.fft_inplace(arr, d.omega)
        return arr
    m, C = d.m, d.C
    sj_pows, sj_inv_pows = _ext_tables(d)
    if not inverse:
        blocks = []
        for j in range(C):
            acc = arr[:m].copy()
            tju = 1
            for u in range(1, C):
                tju = tju * d.t[j] % r
                acc = F.add_arrays(
                    acc, F.mul_const(arr[u * m : (u + 1) * m], tju)
                )
            acc = F.mul_arrays(acc, sj_pows[j])
            F.fft_inplace(acc, d.omega)
            blocks.append(acc)
    else:
        minv = pow(m, r - 2, r)
        ys = []
        for j in range(C):
            b = arr[j * m : (j + 1) * m].copy()
            F.fft_inplace(b, d.omega_inv, sinv=minv)
            ys.append(F.mul_arrays(b, sj_inv_pows[j]))
        blocks = []
        for u in range(C):
            acc = F.mul_const(ys[0], d._vinv[u][0])
            for j in range(1, C):
                acc = F.add_arrays(acc, F.mul_const(ys[j], d._vinv[u][j]))
            blocks.append(acc)
    arr[:] = np.concatenate(blocks, axis=0)
    return arr


class Groth16Native:
    """Native-engine Groth16 over the named curve (same trait surface as
    Groth16 / Groth16TPU: name, generate_setup, prove, verify)."""

    name = "GROTH16"

    def __init__(self, curve_name: str):
        assert nec.available(), "native engine unavailable"
        self.curve_name = curve_name
        self.params = P.CURVES[curve_name]
        self.r = self.params.r
        self.Fr = nec.NativeScalarField(self.r)
        self.g1 = nec.NativeCurve(curve_name, g2=False)
        self.g2 = nec.NativeCurve(curve_name, g2=True)
        self.g1_host = hc.g1_curve(curve_name)
        self.g2_host = hc.g2_curve(curve_name)

    # ------------------------------------------------------------------
    def generate_setup(
        self, r1cs: R1CS, rng: Optional[random.Random] = None
    ) -> Groth16KeyPair:
        return setup_native.generate_setup(self.curve_name, r1cs, rng)

    # ------------------------------------------------------------------
    def h_coefficients(self, r1cs: R1CS, assignment: Sequence[int]):
        """QAP division entirely in the native engine -> H coeff ints."""
        from .groth16_torch import abc_evaluations

        r = self.r
        F = self.Fr
        az, bz, cz = abc_evaluations(r1cs, assignment)
        n = r1cs.qap_degree
        d = domain(n, r)
        fsc, isc = _coset_tables(d)
        arrs = []
        for v in (az, bz, cz):
            a = F.to_mont(v)
            _native_fft(F, d, a, inverse=True)
            a = F.mul_arrays(a, fsc)
            _native_fft(F, d, a, inverse=False)
            arrs.append(a)
        # divide by Z on the coset: constant per coset block (one block for
        # basic domains, C blocks for extended domains)
        zinvs = d.vanishing_on_coset_blocks_inverse()
        bs = d.block_size
        h_e = np.concatenate(
            [
                F.h_from_evals(
                    arrs[0][j * bs : (j + 1) * bs],
                    arrs[1][j * bs : (j + 1) * bs],
                    arrs[2][j * bs : (j + 1) * bs],
                    zi,
                )
                for j, zi in enumerate(zinvs)
            ],
            axis=0,
        )
        _native_fft(F, d, h_e, inverse=True)
        h_c = F.mul_arrays(h_e, isc)
        return F.from_mont(h_c)[: n - 1]

    def prove(
        self,
        r1cs: R1CS,
        pk: Groth16ProvingKey,
        assignment: Sequence[int],
        rng: Optional[random.Random] = None,
        device_pk=None,
        timings: Optional[dict] = None,
    ) -> Groth16Proof:
        import time as _time

        rng = rng or random.Random()
        r = self.r
        num_pub = r1cs.num_primary + 1
        t0 = _time.time()

        def mark(name):
            nonlocal t0
            if timings is not None:
                timings[name] = timings.get(name, 0.0) + _time.time() - t0
            t0 = _time.time()

        h_scalars = self.h_coefficients(r1cs, assignment)
        mark("fft")
        asg = [a % r for a in assignment]
        ev_a = self.g1.msm(asg, pk.a_query)
        ev_b1 = self.g1.msm(asg, pk.b_g1_query)
        ev_b2 = self.g2.msm(asg, pk.b_g2_query)
        ev_l = self.g1.msm(asg[num_pub:], pk.l_query)
        ev_h = self.g1.msm(h_scalars, pk.h_query[: len(h_scalars)])
        mark("msm")

        rr = rng.randrange(r)
        ss = rng.randrange(r)
        g1, g2 = self.g1_host, self.g2_host
        A = g1.add(g1.add(pk.alpha_g1, ev_a), g1.mul(rr, pk.delta_g1))
        B = g2.add(g2.add(pk.beta_g2, ev_b2), g2.mul(ss, pk.delta_g2))
        B1 = g1.add(g1.add(pk.beta_g1, ev_b1), g1.mul(ss, pk.delta_g1))
        C = g1.add(
            g1.add(ev_l, ev_h),
            g1.add(
                g1.add(g1.mul(ss, A), g1.mul(rr, B1)),
                g1.neg(g1.mul(rr * ss % r, pk.delta_g1)),
            ),
        )
        mark("assembly")
        return Groth16Proof(a=A, b=B, c=C)

    # ------------------------------------------------------------------
    def verify(self, inputs, proof, vk) -> bool:
        from .groth16 import Groth16

        return Groth16(self.curve_name).verify(inputs, proof, vk)
