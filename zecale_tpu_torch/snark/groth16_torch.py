"""Groth16 prover and trusted setup on the card.

Ports ``snark/groth16_tpu.py`` (``DevicePk8`` 201, ``pack_pk8`` 227,
``_prove8`` 422, the ``use_msm8=False`` branch of ``prove`` 582-647 and
``generate_setup`` 283; ``TpuSnarkBase`` 116-197 is ``TorchSnarkBase``,
which ``snark/pghr13_torch.py`` shares).
``Groth16Torch.prove`` has the reference's signature, so
``AggregatorCircuit.prove(prover=...)`` calls it unchanged.  The steps:

  * witness: Az, Bz, Cz from the native C engine (``native/witness.py``);
    no Python fallback -- a missing engine raises;
  * fft: the QAP division ``poly/fft_torch.h_pipeline`` on the device;
  * digitize: H to standard form on the device, the assignment packed as
    32-bit scalar limbs;
  * msm: A, B1, L, H in G1 and B2 in G2 through one of the three engines
    of the reference: ``"msm4"`` (``ec/msm.py``, bucket sums in the CUDA
    kernel ``bucket_reduce``), ``"msm8"`` (``ec/msm8.py``, in the window
    chunks of ``msm8_chunks``, as ``groth16_tpu.py:536-545``) or ``"jac"``
    (the reference's ``use_msm8=False`` branch: ``ec/msm_jac.py``); every
    kernel is in ``csrc/fast_kernels.cu``.
    With no engine given, it is
    chosen as ``groth16_tpu.py:510-513`` chooses: ``ZECALE_USE_MSM8`` set
    selects msm8, else msm4.  The coordinates of BW6-761 G1 and G2 lie in
    Fq; BLS12-377 G2 lies in Fq2 (``ff/fp2_torch.py``);
  * with a mesh (``prove(mesh=...)``, the reference's mesh route), the
    QAP division and the H MSM run sharded over ``parallel/``;
  * assembly: on the host exactly as ``groth16_tpu.py:566-580``, drawing
    rr then ss from ``rng``, so one ``random.Random`` state gives the same
    proof as the reference's provers.

``generate_setup`` is the reference's device setup: the fixed-base
products of ``setup_native.setup_from_products`` as windowed Jacobian
scans on the card (``msm_jac.fixed_base_mul_batch``), so one rng state
gives the native engine's keypair.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..ec import curve_torch as ct
from ..ec import host_curve as hc
from ..ec import msm, msm8, msm_jac
from ..ff import params as P
from ..ff.fp_torch import field
from ..native.witness import NativeR1CS
from ..parallel import fft_dist, sharded
from ..poly import fft_torch
from ..utils.device import resolve
from . import setup_native
from .groth16 import Groth16KeyPair, Groth16Proof, Groth16ProvingKey
from .r1cs import R1CS

QUERIES = ("a_query", "b_g1_query", "b_g2_query", "l_query", "h_query")


@dataclasses.dataclass
class DevicePk:
    """Proving key resident on the device: each query is
    {"xy": (n, 2, L) int32 affine Montgomery limbs, "inf": (n,) bool},
    the G1 queries padded to one power-of-two length with points at
    infinity, as ``pack_pk8`` pads them."""

    curve_name: str
    num_pub: int
    n_g1: int
    n_g2: int
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_query: dict
    b_g1_query: dict
    b_g2_query: dict
    l_query: dict
    h_query: dict
    #: (qap_degree, the H query's first qap_degree rows permuted by
    #: ``fft_dist.bitrev_permutation``): the mesh route's cache
    #: (``_h_query_rev``, ``groth16_tpu.py:402-406``)
    h_query_rev: Optional[tuple] = None


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _query_lengths(pk: Groth16ProvingKey):
    n_g1 = _next_pow2(
        max(len(pk.a_query), len(pk.b_g1_query), max(1, len(pk.l_query)),
            max(1, len(pk.h_query)))
    )
    return n_g1, _next_pow2(len(pk.b_g2_query))


def pack_pk(curve_name: str, pk: Groth16ProvingKey, num_pub: int,
            device=None) -> DevicePk:
    """Host proving key -> DevicePk on ``device`` (``pack_pk8``)."""
    device = resolve(device)
    n_g1, n_g2 = _query_lengths(pk)

    def q(pts, n, g2=False):
        F = ct.coord_field(curve_name, g2)
        xy, inf = ct.pack_affine(F, list(pts) + [None] * (n - len(pts)),
                                 device)
        return {"xy": xy, "inf": inf}

    return DevicePk(
        curve_name=curve_name, num_pub=num_pub, n_g1=n_g1, n_g2=n_g2,
        alpha_g1=pk.alpha_g1, beta_g1=pk.beta_g1, beta_g2=pk.beta_g2,
        delta_g1=pk.delta_g1, delta_g2=pk.delta_g2,
        a_query=q(pk.a_query, n_g1),
        b_g1_query=q(pk.b_g1_query, n_g1),
        b_g2_query=q(pk.b_g2_query, n_g2, g2=True),
        l_query=q(pk.l_query, n_g1),
        h_query=q(pk.h_query, n_g1),
    )


def from_reference_pk8(arrays: dict, curve_name: str, num_pub: int,
                       points: dict, device=None) -> DevicePk:
    """The JAX package's DevicePk8 as numpy -> the port's DevicePk.

    ``arrays[name]`` for each query name holds ``x`` and ``y`` ((n, L8)
    arrays of 8-bit Montgomery limbs, R = 2^(8 L8); (n, 2, L8) for the
    BLS12-377 G2 query, whose coordinates lie in Fq2) and ``inf`` ((n,)
    bool); ``points`` holds the host affine alpha_g1, beta_g1, beta_g2,
    delta_g1 and delta_g2.  Both representations share R, so the bytes
    regroup into 32-bit limbs unchanged."""
    device = resolve(device)
    F = ct.base_field(curve_name)

    def limbs32(a8):
        a8 = np.asarray(a8)
        if a8.shape[-1] != 4 * F.n:
            raise ValueError(
                f"8-bit planes of {a8.shape[-1]} limbs do not share "
                f"R = 2^{32 * F.n}"
            )
        u8 = np.ascontiguousarray(a8.astype(np.uint8))
        return torch.from_numpy(u8.view("<u4").view(np.int32).copy())

    qs = {}
    for name in QUERIES:
        a = arrays[name]
        xy = torch.stack([limbs32(a["x"]), limbs32(a["y"])], dim=1)
        inf = torch.from_numpy(np.asarray(a["inf"], dtype=bool).copy())
        qs[name] = {"xy": xy.to(device), "inf": inf.to(device)}
    return DevicePk(
        curve_name=curve_name, num_pub=num_pub,
        n_g1=qs["a_query"]["xy"].shape[0], n_g2=qs["b_g2_query"]["xy"].shape[0],
        **{k: points[k] for k in
           ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")},
        **qs,
    )


def abc_evaluations(r1cs: R1CS, assignment: Sequence[int]) -> tuple:
    """Az, Bz, Cz on the QAP domain from the native C witness engine
    (built once a circuit); no Python fallback -- a missing engine
    raises."""
    nat = getattr(r1cs, "_native", None)
    if nat is None:
        nat = NativeR1CS(r1cs)
        r1cs._native = nat
    if not nat.available:
        raise RuntimeError(
            "native witness engine did not build (gcc of "
            "zecale_tpu_torch/native/csrc/witness_engine.c)"
        )
    return nat.abc_evaluations(assignment)


ENGINES = ("msm4", "msm8", "jac")


def msm8_chunks(curve_name: str, n: int) -> int:
    """Window chunks of an msm8 MSM over n points, by the reference's rule
    (``groth16_tpu.py:504-507, 536``): a unit of 2^16 points when the
    curve's base field q takes 96 bytes (BW6-761), else 2^18, and
    max(1, n // unit) chunks.  The rule reads the base field for G2 too,
    so BLS12-377 G2 over Fq2 takes the 2^18 unit."""
    unit = 1 << 16 if -(-P.CURVES[curve_name].q.bit_length() // 8) >= 96 \
        else 1 << 18
    return max(1, n // unit)


def mesh_route(engine: str, qap_degree: int, mesh) -> bool:
    """Whether ``prove`` takes the mesh route (``groth16_tpu.py:465-469``):
    a mesh of more than one shard that the QAP degree divides into, and an
    engine with a sharded H MSM (msm4 or msm8; the reference's jac branch
    ignores the mesh)."""
    return (mesh is not None and mesh.size > 1
            and qap_degree % mesh.size == 0 and engine != "jac")


def default_engine() -> str:
    """The reference's choice (``groth16_tpu.py:510-513``): msm8 when
    ``ZECALE_USE_MSM8`` is set to anything non-empty, else msm4."""
    return "msm8" if os.environ.get("ZECALE_USE_MSM8") else "msm4"


class TorchSnarkBase:
    """What the device provers share (``TpuSnarkBase``,
    ``groth16_tpu.py:116-197``): the device, the curve, its scalar field,
    the host curves, and the device's fixed-base products (the trusted
    setups) and Jacobian MSMs against a padded query.  The curve must have
    a = 0: the device group law refuses the others."""

    def __init__(self, curve_name: str, device=None):
        self.curve_name = curve_name
        self.device = resolve(device)
        self.r = P.CURVES[curve_name].r
        self.Fr = field(self.r)
        ct.b3_of(curve_name, True)  # refuses curves the law does not serve
        self.g1_host = hc.g1_curve(curve_name)
        self.g2_host = hc.g2_curve(curve_name)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _scalars(self, vals: Sequence[int], n: int) -> torch.Tensor:
        return self.Fr.pack(list(vals) + [0] * (n - len(vals)), self.device)

    # -- trusted setup (``TpuSnarkBase`` 122-197) ---------------------------
    def _batch_scalar_mul(self, g2: bool, scalars: Sequence[int], base,
                          timings: Optional[dict] = None) -> list:
        """[k_i] base for host ints -> host affine points (None for 0):
        windowed fixed-base scans on the device in chunks of
        ``msm_jac.BATCH_MUL_CHUNK`` lanes, then one batched conversion.
        ``timings`` gains the seconds of the two steps: "device" (the
        products, with the scalars' packing and the window tables) and
        "affine"."""
        t = {} if timings is None else timings
        t0 = time.time()
        chunk = msm_jac.BATCH_MUL_CHUNK
        parts = [
            msm_jac.fixed_base_mul_batch(
                self.curve_name, g2,
                self.Fr.pack(list(scalars[off: off + chunk]), self.device),
                base)
            for off in range(0, len(scalars), chunk)
        ]
        if not parts:
            return []
        self._sync()
        t1 = time.time()
        # one transfer and one batched inversion (``_jac_to_affine_batch``)
        out = msm_jac.curve(self.curve_name, g2).to_affine_host(
            torch.cat(parts))
        t["device"] = t.get("device", 0.0) + t1 - t0
        t["affine"] = t.get("affine", 0.0) + time.time() - t1
        return out

    def batch_mul_g1(self, scalars, base=None) -> list:
        return self._batch_scalar_mul(
            False, scalars, base or hc.generators(self.curve_name)[0])

    def batch_mul_g2(self, scalars, base=None) -> list:
        return self._batch_scalar_mul(
            True, scalars, base or hc.generators(self.curve_name)[1])

    def msm_device(self, g2: bool, query: dict, scalars):
        """MSM against a padded device query (DevicePk layout) -> one
        Jacobian point on the device (``msm_device`` 189).  ``scalars``
        are (n, L) standard-form limbs on the device, padded to the
        query's n (``_scalars``; packed once for several MSMs)."""
        n = query["xy"].shape[0]
        if len(scalars) != n:
            raise ValueError(f"msm_device: {len(scalars)} packed scalars "
                             f"for a query of {n}")
        crv = msm_jac.curve(self.curve_name, g2)
        digits = msm_jac.scalar_digit_planes(
            scalars, self.r.bit_length(), msm_jac.MSM_WINDOW_C)
        return msm_jac.msm_pippenger(crv, digits, query["xy"], query["inf"],
                                     msm_jac.MSM_WINDOW_C)


class Groth16Torch(TorchSnarkBase):
    """Device Groth16 prover over an a = 0 curve: BW6-761 (the wrapper) or
    BLS12-377 (the nested application proofs, G2 over Fq2).  ``engine``
    is "msm4", "msm8" or "jac"; None reads ``ZECALE_USE_MSM8``."""

    name = "GROTH16"

    def __init__(self, curve_name: str, device=None, engine=None):
        self.engine = engine or default_engine()
        if self.engine not in ENGINES:
            raise ValueError(f"engine {self.engine!r} not in {ENGINES}")
        super().__init__(curve_name, device)

    def pack_pk(self, pk: Groth16ProvingKey, num_pub: int) -> DevicePk:
        return pack_pk(self.curve_name, pk, num_pub, self.device)

    def generate_setup(self, r1cs: R1CS,
                       rng: Optional[random.Random] = None,
                       timings: Optional[dict] = None) -> Groth16KeyPair:
        """The trusted setup with its fixed-base products on the device
        (``Groth16TPU.generate_setup`` 283): the native setup's keypair
        from the same rng state.  ``timings`` gains the seconds of the
        host scalars ("scalars"), the device products ("device") and their
        conversion to affine points ("affine")."""
        t = {} if timings is None else timings
        g1, g2 = hc.generators(self.curve_name)
        t0 = time.time()
        kp = setup_native.setup_from_products(
            self.curve_name, r1cs, rng,
            lambda ks: self._batch_scalar_mul(False, ks, g1, t),
            lambda ks: self._batch_scalar_mul(True, ks, g2, t))
        t["scalars"] = (time.time() - t0 - t.get("device", 0.0)
                        - t.get("affine", 0.0))
        return kp

    def prove(
        self,
        r1cs: R1CS,
        pk,
        assignment: Sequence[int],
        rng: Optional[random.Random] = None,
        device_pk: Optional[DevicePk] = None,
        timings: Optional[dict] = None,
        mesh=None,
    ) -> Groth16Proof:
        """``mesh``: a ``parallel.mesh.Mesh``.  With more than one shard
        and a QAP degree that divides into them, the QAP division and the
        H MSM run sharded (``groth16_tpu.py:465-469``): the distributed
        FFT leaves H in bit-reversed order, taken against the H query
        permuted to match, by ``msm4_sharded`` or ``msm8_sharded`` as the
        engine is.  The jac engine takes the single-device path with the
        mesh unused, as the reference's jac branch (602-647) ignores it;
        so does any other mesh.  The "fft" phase holds the sharded
        division, the "msm" phase the sharded H MSM."""
        rng = rng or random.Random()
        r, Fr, dev = self.r, self.Fr, self.device
        num_pub = r1cs.num_primary + 1
        deg = r1cs.qap_degree
        use_mesh = mesh_route(self.engine, deg, mesh)
        t0 = time.time()

        def mark(name):
            self._sync()
            if use_mesh:  # the shards may lie on other cards
                for d in {d for d in mesh.devices if d.type == "cuda"}:
                    torch.cuda.synchronize(d)
            now = time.time()
            if timings is not None:
                timings[name] = timings.get(name, 0.0) + now - t0
            return now

        dpk = device_pk or self.pack_pk(pk, num_pub)
        az, bz, cz = abc_evaluations(r1cs, assignment)
        t0 = mark("witness")

        evals = [Fr.to_mont(Fr.pack(v, dev)) for v in (az, bz, cz)]
        if use_mesh:
            h_rev = fft_dist.h_pipeline_sharded(mesh, r, *evals)
        else:
            h = fft_torch.h_pipeline(*evals, r)
        t0 = mark("fft")

        if use_mesh:
            h_rev = [Fr.from_mont(x) for x in h_rev]
        else:
            h_std = Fr.from_mont(h[: deg - 1])
            h_scal = torch.nn.functional.pad(h_std,
                                             (0, 0, 0, dpk.n_g1 - deg + 1))
        asg = [a % r for a in assignment]
        asg_g1 = self._scalars(asg, dpk.n_g1)
        asg_g2 = self._scalars(asg, dpk.n_g2)
        l_scal = self._scalars(asg[num_pub:], dpk.n_g1)
        t0 = mark("digitize")

        def run(g2, scal, query):
            xy, inf = query["xy"], query["inf"]
            if self.engine == "msm8":
                return msm8.msm8(
                    self.curve_name, g2, scal, xy, inf,
                    chunks=msm8_chunks(self.curve_name, xy.shape[0]))
            engine = msm.msm if self.engine == "msm4" else msm_jac.msm
            return engine(self.curve_name, g2, scal, xy, inf)

        ev_a_h = run(False, asg_g1, dpk.a_query)
        ev_b1_h = run(False, asg_g1, dpk.b_g1_query)
        ev_b2_h = run(True, asg_g2, dpk.b_g2_query)
        ev_l_h = run(False, l_scal, dpk.l_query)
        if use_mesh:
            ev_h_h = self._sharded_h_msm(deg, dpk, h_rev, mesh)
        else:
            ev_h_h = run(False, h_scal, dpk.h_query)
        t0 = mark("msm")

        rr = rng.randrange(r)
        ss = rng.randrange(r)
        g1, g2 = self.g1_host, self.g2_host
        A = g1.add(g1.add(dpk.alpha_g1, ev_a_h), g1.mul(rr, dpk.delta_g1))
        B = g2.add(g2.add(dpk.beta_g2, ev_b2_h), g2.mul(ss, dpk.delta_g2))
        B1 = g1.add(g1.add(dpk.beta_g1, ev_b1_h), g1.mul(ss, dpk.delta_g1))
        C = g1.add(
            g1.add(ev_l_h, ev_h_h),
            g1.add(
                g1.add(g1.mul(ss, A), g1.mul(rr, B1)),
                g1.neg(g1.mul(rr * ss % r, dpk.delta_g1)),
            ),
        )
        mark("assembly")
        return Groth16Proof(a=A, b=B, c=C)

    def _sharded_h_msm(self, deg: int, dpk: DevicePk, h_rev: list, mesh):
        """The H MSM over the mesh (``_sharded_h_msm``,
        ``groth16_tpu.py:365-424``): H's coefficients in bit-reversed
        order (standard form, this process's shards) against the H query
        permuted to match -- position i holds coefficient rev[i], and the
        one with rev[i] = deg - 1 meets the query's padding at infinity --
        by ``msm4_sharded``, or ``msm8_sharded`` at
        ``msm8.default_window(deg)`` (557).  -> host affine point."""
        if dpk.h_query_rev is None or dpk.h_query_rev[0] != deg:
            rev = torch.from_numpy(fft_dist.bitrev_permutation(deg).astype(
                np.int64)).to(dpk.h_query["xy"].device)
            dpk.h_query_rev = (deg, {k: v[:deg][rev].contiguous()
                                     for k, v in dpk.h_query.items()})
        q = dpk.h_query_rev[1]
        if self.engine == "msm8":
            pt = sharded.msm8_sharded(self.curve_name, mesh, h_rev, q["xy"],
                                      q["inf"], msm8.default_window(deg))
        else:
            pt = sharded.msm4_sharded(self.curve_name, mesh, h_rev, q["xy"],
                                      q["inf"])
        return sharded.point_to_host(self.curve_name, False, pt)
