# Ported from __graft_entry__.py (_example_data 20-49, entry 52-106, dryrun_multichip 149 / 175, dryrun_multihost 276): the same functions and example data on tensors, the dry runs in process on the card.
"""Entry points of the port: ``entry`` and the multi-device dry runs.

``entry()`` returns ``(fn, example_args)``: ``fn`` is the single-card core
of the flagship workload -- the BW6-761 wrapper prover's QAP division
(``poly/fft_torch.h_pipeline``) at n = 16 plus the H-query MSM of the msm8
engine (device-side signed digits and sort-based bucket combining,
``ec/msm8.msm8_core``, K2 and K3) at c = 6.  ``fn(*example_args)`` gives
``(h, acc)``: H's coefficients as (16, 12) Montgomery limbs and the MSM as
one (1, 3, 24) projective point, both on the device.  The example data are
drawn from ``random.Random(7)`` in the reference's order.

``dryrun_multichip(n)`` runs the sharded prover step on an n-shard mesh
and checks its values against the host oracle; ``dryrun_multihost()``
runs ``multihost_dryrun.py``'s launcher (2 processes joined by gloo).
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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded prover step on an ``n_devices``-shard mesh, value-checked
    against the host oracle (``_dryrun_multichip_impl`` 175): BLS12-377,
    n = max(256, 32 n_devices) and c = 5; ``prove_core_sharded8`` (the
    distributed QAP division and the msm8 H MSM against the bit-reversed
    points) and ``msm4_sharded``, each equal to ``domain_host`` and
    ``host_curve.msm``; then the per-shard evidence: n_devices shards, each
    holding a distinct, full-size slice of H.  It runs in this process.

    ``device``: None takes one card a shard (``make_mesh``: a
    RuntimeError where there are too few); given, every shard lies on it
    (e.g. "cuda:0", or "cpu" for the plain versions)."""
    import time

    import torch

    from .ec import host_curve as hc
    from .ff.fp_torch import field
    from .parallel import fft_dist, sharded
    from .parallel.mesh import make_mesh
    from .poly import domain_host

    t0 = time.time()
    mesh = make_mesh(n_devices, devices=None if device is None
                     else [device] * n_devices)
    curve = "bls12-377"
    n = max(256, 32 * n_devices)
    data = example_data(mesh.devices[0], curve, n, n)
    r = data["r"]
    az_d, bz_d, cz_d, scal, xy, inf = data["args"]
    print(f"[dryrun] {mesh.describe()}; curve {curve}, n={n}", flush=True)

    rev = fft_dist.bitrev_permutation(n)
    idx = torch.from_numpy(rev.astype("int64")).to(xy.device)
    h_sh, msm_out = sharded.prove_core_sharded8(
        curve, mesh, az_d, bz_d, cz_d, None,
        {"xy": xy[idx].contiguous(), "inf": inf[idx].contiguous()}, c=5)
    print(f"[dryrun] sharded step ran in {time.time() - t0:.1f}s",
          flush=True)

    d = domain_host.domain(n, r)
    a_e, b_e, c_e = (d.coset_fft(d.ifft(v))
                     for v in (data["az"], data["bz"], data["cz"]))
    zi = d.vanishing_on_coset_inverse()
    h_vals = d.coset_ifft([(a * b - c) % r * zi % r
                           for a, b, c in zip(a_e, b_e, c_e)])
    F = field(r)
    if F.unpack_mont(mesh.gather(h_sh)) != [h_vals[i] for i in rev]:
        raise RuntimeError("sharded H pipeline diverges from the host oracle")
    crv = hc.g1_curve(curve)
    if sharded.point_to_host(curve, False, msm_out) != crv.msm(
            h_vals, data["pts"]):
        raise RuntimeError("sharded H-MSM diverges from the host oracle")

    t4 = time.time()
    out4 = sharded.msm4_sharded(curve, mesh, scal, xy, inf)
    if sharded.point_to_host(curve, False, out4) != crv.msm(
            data["scalars"], data["pts"]):
        raise RuntimeError("sharded msm4 diverges from the host oracle")
    print(f"[dryrun] sharded msm4 ran in {time.time() - t4:.1f}s",
          flush=True)

    # per-shard evidence: every shard holds a distinct, full-size slice of
    # H (not a replicated or degenerate layout)
    per = n // n_devices
    if len(h_sh) != n_devices or any(h.shape[0] != per for h in h_sh):
        raise RuntimeError(f"H not in {n_devices} shards of {per} rows")
    if len({h.cpu().numpy().tobytes() for h in h_sh}) != n_devices:
        raise RuntimeError("shard contents degenerate or replicated")
    print(f"dryrun_multichip({n_devices}): sharded prover step ok in "
          f"{time.time() - t0:.1f}s; H in {n_devices} shards of {per}; H "
          "pipeline and H-MSM value-match the host oracle", flush=True)


def dryrun_multihost() -> None:
    """Two processes of four shards each on the card, joined by a gloo
    group into one 8-shard mesh, run the distributed iFFT value-checked
    against the host oracle (``dryrun_multihost`` 276):
    ``multihost_dryrun.py``'s launcher, refused without a card."""
    from . import multihost_dryrun

    rc = multihost_dryrun.launcher()
    if rc != 0:
        raise RuntimeError(f"dryrun_multihost failed rc={rc}")
