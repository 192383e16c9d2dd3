"""Share (%) of the msm phase's seconds that the least time of its five
MSMs takes on the card (``roofline.py``: each MSM's points, the scalars
of the request's witness that are neither 0 nor 1, field limbs and group,
as Pippenger needs at its best window), over the window's requests."""

from .. import roofline
from .common import ok


def read(record):
    least = msm = 0.0
    for r in ok(record):
        if "msm" not in r["phases"] or not r.get("msms"):
            continue
        msm += r["phases"]["msm"]
        for call in r["msms"]:
            for g, n, ones in roofline.groth16_msms(*call):
                bits, q, ext = record.msm_groups[g]
                least += roofline.msm_least_s(n, bits, q, ext, ones)
    if not msm:
        return None
    return 100.0 * least / msm
