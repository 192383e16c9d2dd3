# Copied from zecale_tpu/snark/groth16_native.py (Groth16Native.generate_setup, 139-208); imports changed, and the body split so that the device setup (groth16_torch.Groth16Torch.generate_setup) shares it.
"""Groth16 trusted setup on the native C engine (native/csrc/ec_engine.c).

The wrapper circuit's setup is tens of thousands of fixed-base scalar
multiplications; the pure-Python host setup takes about an hour at batch 1,
so this module raises where the native engine cannot be built instead of
falling back to it.  ``setup_from_products`` is the setup's scalar side,
shared with the device setup: it draws tau, alpha, beta and delta from
``rng`` in this order and hands the fixed-base products to the caller's
multipliers, so one rng state gives one keypair whichever engine multiplies.
"""

from __future__ import annotations

import random
from typing import Callable, Optional

from ..ec import host_curve as hc
from ..ff import params as P
from ..native import ec as nec
from .groth16 import (
    Groth16KeyPair,
    Groth16ProvingKey,
    Groth16VerificationKey,
)
from .r1cs import R1CS


def generate_setup(
    curve_name: str, r1cs: R1CS, rng: Optional[random.Random] = None
) -> Groth16KeyPair:
    if not nec.available():
        raise RuntimeError(
            "native EC engine did not build (gcc -fopenmp of "
            "zecale_tpu_torch/native/csrc); refusing the Python setup"
        )
    g1_gen, g2_gen = hc.generators(curve_name)
    return setup_from_products(
        curve_name, r1cs, rng,
        lambda s: nec.NativeCurve(curve_name, g2=False).fixed_base_mul_batch(
            s, g1_gen),
        lambda s: nec.NativeCurve(curve_name, g2=True).fixed_base_mul_batch(
            s, g2_gen),
    )


def setup_from_products(
    curve_name: str,
    r1cs: R1CS,
    rng: Optional[random.Random],
    mul_g1: Callable[[list], list],
    mul_g2: Callable[[list], list],
) -> Groth16KeyPair:
    """The keypair from the products [k_i] G1 = mul_g1(ks) and
    [k_i] G2 = mul_g2(ks) (host affine points, None for 0)."""
    rng = rng or random.Random()
    r = P.CURVES[curve_name].r
    tau = rng.randrange(1, r)
    alpha = rng.randrange(1, r)
    beta = rng.randrange(1, r)
    delta = rng.randrange(1, r)
    delta_inv = pow(delta, r - 2, r)

    num_vars = r1cs.num_variables
    num_pub = r1cs.num_primary + 1
    a_at, b_at, c_at = r1cs.qap_evaluations(tau, r)
    d_size, z_tau = r1cs.domain_vanishing(tau, r)

    abc_scalars = [
        (beta * a_at[i] + alpha * b_at[i] + c_at[i]) % r
        for i in range(num_pub)
    ]
    l_scalars = [
        (beta * a_at[i] + alpha * b_at[i] + c_at[i]) * delta_inv % r
        for i in range(num_pub, num_vars)
    ]
    h_scalars = []
    t_pow = 1
    for _ in range(d_size - 1):
        h_scalars.append(t_pow * z_tau % r * delta_inv % r)
        t_pow = t_pow * tau % r

    g1 = mul_g1(
        [alpha, beta, delta] + a_at + b_at + abc_scalars + l_scalars
        + h_scalars
    )
    alpha_g1, beta_g1, delta_g1 = g1[0], g1[1], g1[2]
    o = 3
    a_query = g1[o : o + num_vars]
    o += num_vars
    b_g1 = g1[o : o + num_vars]
    o += num_vars
    abc = g1[o : o + num_pub]
    o += num_pub
    l_query = g1[o : o + len(l_scalars)]
    o += len(l_scalars)
    h_query = g1[o:]

    g2v = mul_g2([beta, delta] + b_at)
    beta_g2, delta_g2 = g2v[0], g2v[1]
    b_g2 = g2v[2:]

    pk = Groth16ProvingKey(
        alpha_g1=alpha_g1,
        beta_g1=beta_g1,
        beta_g2=beta_g2,
        delta_g1=delta_g1,
        delta_g2=delta_g2,
        a_query=a_query,
        b_g1_query=b_g1,
        b_g2_query=b_g2,
        l_query=l_query,
        h_query=h_query,
    )
    vk = Groth16VerificationKey(
        alpha=alpha_g1, beta=beta_g2, delta=delta_g2, abc=abc
    )
    return Groth16KeyPair(pk=pk, vk=vk)
