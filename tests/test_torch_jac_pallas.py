"""The Jacobian engine's kernels K4 jac_add, K5 jac_dbl_chain and K6 aff_add
(zecale_tpu_torch/ec/jac_curve.py) on the CPU, where the wrappers take
their plain versions, against the Pallas kernels they replace:
ec/ec_pallas.py:PallasG1Curve(bt=8) in interpret mode, as
tests/test_ec_pallas.py runs them, in the three field forms (BLS12-377 Fq,
BW6-761 Fq, BLS12-377 Fq2).  The interpreter takes minutes over the Fq2
form, so this comparison has a file of its own; one block of eight cases
per kernel (the first eight of tests/test_torch_jac.py's: O+O, O+P, P+O
with nonzero X and Y at infinity, P+P with equal and with different Z,
P+(-P) and distinct points; for K6 each infinity flag, P = Q, P = -Q).
Tolerance: exact, as field values of the Jacobian triples."""

import pytest
import torch

from zecale_tpu.ec import ec_pallas
from zecale_tpu_torch.ec import jac_curve as jc

from .test_torch_jac import (FORMS, _aff_pairs, _aff_to_torch, _from_ref,
                             _from_torch, _jac_pairs, _ref_aff, _ref_pt,
                             _to_torch)

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

#: cases per kernel: one block of the interpreted kernel
B = 8


@pytest.mark.parametrize("curve,g2", FORMS)
def test_plain_jac_law_matches_pallas_kernels(curve, g2):
    """K4, K5 and K6 against the Pallas kernels they replace, run by the
    Pallas interpreter on the CPU."""
    pcrv = ec_pallas.PallasG1Curve(curve, bt=8, g2=g2)
    F8 = pcrv.F
    crv = jc.JacCurve(curve, g2)
    F = crv.F
    lhs, rhs = (v[:B] for v in _jac_pairs(curve, g2, 11))
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    a8, b8 = _ref_pt(F8, lhs), _ref_pt(F8, rhs)
    assert _from_torch(F, crv.add(a, b)) == _from_ref(F8, pcrv.add(a8, b8))
    assert (_from_torch(F, crv.dbl_chain(a, 2))
            == _from_ref(F8, pcrv.dbl_chain(a8, 2)))
    l_ops, r_ops = (v[:B] for v in _aff_pairs(curve, g2, 13))
    xy_a, inf_a = _aff_to_torch(F, l_ops)
    xy_b, inf_b = _aff_to_torch(F, r_ops)
    got = crv.add_affine_affine(xy_a, inf_a, xy_b, inf_b)
    want = pcrv.add_affine_affine(_ref_aff(F8, l_ops), _ref_aff(F8, r_ops))
    assert _from_torch(F, got) == _from_ref(F8, want)
