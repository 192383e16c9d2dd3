# Ported from __graft_entry__.py (_example_data 20-49, entry 52-106): the same function and example data on tensors; the multi-device dry runs are not ported yet.
"""Single-device entry point of the port.

``entry()`` returns ``(fn, example_args)``: ``fn`` is the single-card core
of the flagship workload -- the BW6-761 wrapper prover's QAP division
(``poly/fft_torch.h_pipeline``) at n = 16 plus the H-query MSM of the msm8
engine (device-side signed digits and sort-based bucket combining,
``ec/msm8.msm8_core``, K2 and K3) at c = 6.  ``fn(*example_args)`` gives
``(h, acc)``: H's coefficients as (16, 12) Montgomery limbs and the MSM as
one (1, 3, 24) projective point, both on the device.  The example data are
drawn from ``random.Random(7)`` in the reference's order.
"""

from __future__ import annotations

import random

CURVE = "bw6-761"
N_DOMAIN = 16
N_POINTS = 16
WINDOW_C = 6


def example_data(device=None, curve_name=CURVE, n_domain=N_DOMAIN,
                 n_points=N_POINTS) -> dict:
    """The host values and their device tensors: Az, Bz, Cz on the
    domain (Montgomery limbs), standard-form scalar limbs and affine
    points with their infinity mask."""
    from .ec import curve_torch as ct
    from .ec import host_curve as hc
    from .ff import params as P
    from .ff.fp_torch import field
    from .utils.device import resolve

    dev = resolve(device)
    r = P.CURVES[curve_name].r
    F = field(r)
    rng = random.Random(7)
    az = [rng.randrange(r) for _ in range(n_domain)]
    bz = [rng.randrange(r) for _ in range(n_domain)]
    cz = [rng.randrange(r) for _ in range(n_domain)]
    gen = hc.generators(curve_name)[0]
    crv_h = hc.g1_curve(curve_name)
    pts = [crv_h.mul(rng.randrange(1, r), gen) for _ in range(n_points)]
    scalars = [rng.randrange(r) for _ in range(n_points)]
    xy, inf = ct.pack_affine(ct.coord_field(curve_name, False), pts, dev)
    return {
        "r": r, "az": az, "bz": bz, "cz": cz, "pts": pts,
        "scalars": scalars,
        "args": (F.pack_mont(az, dev), F.pack_mont(bz, dev),
                 F.pack_mont(cz, dev), F.pack(scalars, dev), xy, inf),
    }


def entry(device=None):
    """(fn, example_args) on ``device`` (the card unless the CPU is asked
    for)."""
    from .ec import msm, msm8
    from .ec.proj_curve import ProjCurve
    from .poly import fft_torch

    data = example_data(device)
    r = data["r"]
    crv = ProjCurve(CURVE, False)
    nbits = r.bit_length()

    def forward(az, bz, cz, scal, xy, inf):
        h = fft_torch.h_pipeline(az, bz, cz, r)
        buckets, signs = msm.signed_digits(scal, nbits, WINDOW_C)
        acc = msm8.msm8_core(crv, buckets, signs, xy, inf, WINDOW_C)
        return h, acc

    return forward, data["args"]
