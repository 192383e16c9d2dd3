"""PGHR13 prover and trusted setup on the card.

Ports ``snark/pghr13_tpu.py`` (``DevicePkPghr13`` 38, ``pack_pk_pghr13``
52, ``Pghr13TPU`` 77: ``generate_setup`` 85, ``prove`` 161) on
``TorchSnarkBase`` (``snark/groth16_torch.py``).  The same algebra as the
host ``snark/pghr13.py``, with the bulk work on the device:

  * witness: Az, Bz, Cz from the native C engine, as ``Groth16Torch``;
  * fft: ``poly/fft_torch.qap_polys_pipeline``, the QAP division that also
    returns the coefficients of A(x) and B(x), then the zero-knowledge
    shift H' = H + d2 A + d1 B + d1 d2 Z - d3 with the port's Fr ops;
  * digitize: H' to standard form on the device, the coefficients (the
    assignment and d1, d2, d3) packed once as 32-bit scalar limbs;
  * msm: the eight proof MSMs (A, A', B in G2, B', C, C', K, H) through
    ``msm_device``: the Jacobian engine, K4 ``jac_add``, K5
    ``jac_dbl_chain`` and K6 ``aff_add``;
  * assembly: the eight Jacobian sums to host affine points, one batched
    conversion a group.

``generate_setup`` is the host ``Pghr13.generate_setup`` with its
``_g1_many`` / ``_g2_many`` hooks on the device
(``TorchSnarkBase._batch_scalar_mul``, what ``batch_mul_g1/g2`` run: K4,
K6), as ``Pghr13Native`` puts them on the C engine, so one rng state
gives the host ``Pghr13``'s and ``Pghr13Native``'s keypair.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..ec import curve_torch as ct
from ..ec import host_curve as hc
from ..ec import msm_jac
from ..poly import fft_torch
from ..utils.device import resolve
from .groth16_torch import TorchSnarkBase, _next_pow2, abc_evaluations
from .pghr13 import (
    Pghr13,
    Pghr13KeyPair,
    Pghr13Proof,
    Pghr13ProvingKey,
)
from .r1cs import R1CS

#: the device key's queries: (name, in G2) in ``DevicePkPghr13``'s order
QUERIES = (("a0", False), ("a1", False), ("b0", True), ("b1", False),
           ("c0", False), ("c1", False), ("k", False), ("h", False))


@dataclasses.dataclass
class DevicePkPghr13:
    """PGHR13 proving key resident on the device.  Each query is
    {"xy": (n, 2, *F.shape) int32 affine Montgomery limbs, "inf": (n,)
    bool}; every G1 query is padded to one power-of-two length ``n_g1``
    with points at infinity, as ``pack_pk_pghr13`` pads them."""

    curve_name: str
    n_g1: int
    n_g2: int
    a0: dict  # [rhoA At_priv]1
    a1: dict  # [alphaA rhoA At_priv]1
    b0: dict  # [rhoB Bt]2
    b1: dict  # [alphaB rhoB Bt]1
    c0: dict  # [rhoC Ct]1
    c1: dict  # [alphaC rhoC Ct]1
    k: dict  # [beta(...)]1
    h: dict  # [t^i]1


def pack_pk_pghr13(curve_name: str, pk: Pghr13ProvingKey,
                   device=None) -> DevicePkPghr13:
    """Host proving key -> DevicePkPghr13 on ``device``
    (``pack_pk_pghr13`` 52): every G1 query padded to
    next_pow2(max(|A|, |H|)), the G2 query to next_pow2(|B|)."""
    device = resolve(device)
    n_g1 = _next_pow2(max(len(pk.a_query), len(pk.h_query)))
    n_g2 = _next_pow2(len(pk.b_query))
    pts = {
        "a0": [q[0] for q in pk.a_query], "a1": [q[1] for q in pk.a_query],
        "b0": [q[0] for q in pk.b_query], "b1": [q[1] for q in pk.b_query],
        "c0": [q[0] for q in pk.c_query], "c1": [q[1] for q in pk.c_query],
        "k": pk.k_query, "h": pk.h_query,
    }
    qs = {}
    for name, g2 in QUERIES:
        pad = [None] * ((n_g2 if g2 else n_g1) - len(pts[name]))
        xy, inf = ct.pack_affine(ct.coord_field(curve_name, g2),
                                 list(pts[name]) + pad, device)
        qs[name] = {"xy": xy, "inf": inf}
    return DevicePkPghr13(curve_name=curve_name, n_g1=n_g1, n_g2=n_g2, **qs)


def from_reference_pk_pghr13(arrays: dict, curve_name: str,
                             device=None) -> DevicePkPghr13:
    """The JAX package's DevicePkPghr13 as numpy -> the port's.

    ``arrays[name]`` for each query name holds ``x``, ``y`` and ``z``:
    Jacobian coordinates as (n, L16) arrays of 16-bit Montgomery limbs
    ((n, 2, L16) for the BLS12-377 G2 query, whose coordinates lie in
    Fq2), z = 0 at infinity and Montgomery 1 elsewhere
    (``msm_tpu.pack_g1_points`` / ``pack_g2_points``).  Both
    representations share R, so limb pairs regroup into 32-bit limbs
    unchanged.  A z that is neither is refused: the point would not be
    the affine (x, y)."""
    device = resolve(device)
    Fq = ct.base_field(curve_name)

    def limbs32(a16):
        a16 = np.asarray(a16)
        if a16.shape[-1] != 2 * Fq.n:
            raise ValueError(
                f"16-bit planes of {a16.shape[-1]} limbs do not share "
                f"R = 2^{32 * Fq.n}"
            )
        u = a16.astype(np.uint32)
        return torch.from_numpy(
            (u[..., 0::2] | (u[..., 1::2] << 16)).view(np.int32).copy())

    qs = {}
    for name, g2 in QUERIES:
        F = ct.coord_field(curve_name, g2)
        a = arrays[name]
        z = limbs32(a["z"]).reshape(-1, *F.shape)
        one = F.consts("cpu")["one"]
        inf = (z == 0).flatten(1).all(1)
        if not bool((inf | (z == one).flatten(1).all(1)).all()):
            raise ValueError(f"query {name}: z neither 0 nor Montgomery 1")
        xy = torch.stack([limbs32(a["x"]), limbs32(a["y"])], dim=1)
        qs[name] = {"xy": xy.reshape(-1, 2, *F.shape).to(device),
                    "inf": inf.to(device)}
    return DevicePkPghr13(curve_name=curve_name,
                          n_g1=qs["a0"]["xy"].shape[0],
                          n_g2=qs["b0"]["xy"].shape[0], **qs)


class Pghr13Torch(TorchSnarkBase, Pghr13):
    """Device PGHR13 prover over an a = 0 curve: BW6-761 (the wrapper) or
    BLS12-377 (G2 over Fq2).  The host ``Pghr13`` with its batched
    fixed-base products and its proof on the device; ``verify`` is the
    host's (five pairing checks, on the native pairing engine)."""

    name = "PGHR13"

    def pack_pk(self, pk: Pghr13ProvingKey) -> DevicePkPghr13:
        return pack_pk_pghr13(self.curve_name, pk, self.device)

    def __init__(self, curve_name: str, device=None):
        TorchSnarkBase.__init__(self, curve_name, device)
        Pghr13.__init__(self, curve_name)
        self._setup_timings = None

    # -- trusted setup (``Pghr13TPU.generate_setup`` 85-159) -----------------
    def _g1_many(self, scalars: Sequence[int]) -> list:
        return self._batch_scalar_mul(
            False, [k % self.r for k in scalars],
            hc.generators(self.curve_name)[0], self._setup_timings)

    def _g2_many(self, scalars: Sequence[int]) -> list:
        return self._batch_scalar_mul(
            True, [k % self.r for k in scalars],
            hc.generators(self.curve_name)[1], self._setup_timings)

    def generate_setup(self, r1cs: R1CS,
                       rng: Optional[random.Random] = None,
                       timings: Optional[dict] = None) -> Pghr13KeyPair:
        """The host ``Pghr13.generate_setup`` with its key queries'
        fixed-base products on the device.  ``timings`` gains the seconds
        of the host scalars and vk points ("scalars"), the device products
        ("device") and their conversion to affine points ("affine")."""
        t = {} if timings is None else timings
        t0 = time.time()
        self._setup_timings = t
        try:
            kp = Pghr13.generate_setup(self, r1cs, rng)
        finally:
            self._setup_timings = None
        t["scalars"] = (time.time() - t0 - t.get("device", 0.0)
                        - t.get("affine", 0.0))
        return kp

    # -- proving (``Pghr13TPU.prove`` 161-210) ------------------------------
    def prove(
        self,
        r1cs: R1CS,
        pk: Pghr13ProvingKey,
        assignment: Sequence[int],
        rng: Optional[random.Random] = None,
        device_pk: Optional[DevicePkPghr13] = None,
        timings: Optional[dict] = None,
    ) -> Pghr13Proof:
        rng = rng or random.Random()
        r, Fr, dev = self.r, self.Fr, self.device
        t0 = time.time()

        def mark(name):
            self._sync()
            now = time.time()
            if timings is not None:
                timings[name] = timings.get(name, 0.0) + now - t0
            return now

        dpk = (device_pk if device_pk is not None
               else self.resident_pk(pk)[0])
        d1, d2, d3 = (rng.randrange(r) for _ in range(3))
        az, bz, cz = abc_evaluations(r1cs, assignment)
        t0 = mark("witness")

        evals = [Fr.to_mont(Fr.pack(v, dev)) for v in (az, bz, cz)]
        h, a_c, b_c = fft_torch.qap_polys_pipeline(*evals, r)
        # H'(x) = H + d2 A + d1 B + d1 d2 Z - d3, Z = x^n - 1
        n = r1cs.qap_degree
        dd = d1 * d2 % r
        c2, c1, c0 = Fr.pack_mont([d2, d1, (dd + d3) % r], dev)
        hp = Fr.add(h, Fr.add(Fr.mul(a_c, c2), Fr.mul(b_c, c1)))
        hp[0] = Fr.sub(hp[:1], c0.unsqueeze(0))[0]
        hp = torch.cat([hp, Fr.pack_mont([dd], dev)])
        t0 = mark("fft")

        h_scal = torch.nn.functional.pad(Fr.from_mont(hp),
                                         (0, 0, 0, dpk.n_g1 - n - 1))
        coeffs = [a % r for a in assignment] + [d1, d2, d3]
        scal = self._scalars(coeffs, dpk.n_g1)  # n_g2 <= n_g1
        t0 = mark("digitize")

        sums = {name: self.msm_device(g2, getattr(dpk, name),
                                      scal[:dpk.n_g2] if g2 else scal)
                for name, g2 in QUERIES if name != "h"}
        sums["h"] = self.msm_device(False, dpk.h, h_scal)
        t0 = mark("msm")

        g1_names = [name for name, g2 in QUERIES if not g2]
        aff = dict(zip(g1_names, msm_jac.curve(self.curve_name, False)
                       .to_affine_host(torch.cat([sums[k]
                                                  for k in g1_names]))))
        aff["b0"] = msm_jac.curve(self.curve_name, True).to_affine_host(
            sums["b0"])[0]
        proof = Pghr13Proof(a=aff["a0"], a_p=aff["a1"], b=aff["b0"],
                            b_p=aff["b1"], c=aff["c0"], c_p=aff["c1"],
                            h=aff["h"], k=aff["k"])
        mark("assembly")
        return proof
