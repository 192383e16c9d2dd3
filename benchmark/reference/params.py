# Frozen copy of zecale_tpu_torch/ff/params.py for the benchmark's reference; only imports changed.
"""Field and curve parameters for the pairing-friendly curves used by the
aggregation framework.

The framework supports the same curve pairs as the reference aggregator
(reference: libzecale CMakeLists.txt ZECALE_CURVE options {BW6_761, MNT6}):

  * nested  BLS12-377  /  wrapper BW6-761   (default, "one-layer composition")
  * nested  MNT4-298   /  wrapper MNT6-298  (legacy 2-cycle)

The defining property (reference: libzecale/circuits/aggregator_gadget.hpp:20-30)
is that the *base* field Fq of the nested curve equals the *scalar* field Fr of
the wrapper curve, so nested group coordinates are native wrapper-circuit
scalars.

All big constants here are plain Python ints.  The BW6-761 modulus and
generators are taken from the reference's own client test
(client/test_commands/test_bw6_761_groth16_contract.py:23-40).  BLS12-377
parameters are derived from the public BLS seed x = 0x8508c00000000001 via the
BLS12 polynomial parameterisation (r = x^4 - x^2 + 1, q = ((x-1)^2 r)/3 + x);
the derivation is cross-checked against the literal modulus that the reference
records for BW6-761's scalar field (the two must be identical).

Nothing in this module is copied from libff; the constants are standard,
published curve parameters.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# BLS12-377 (nested curve "npp" of the default configuration)
# ---------------------------------------------------------------------------

#: BLS family seed (a.k.a. "x" / "t" parameter) for BLS12-377.
BLS12_377_X = 0x8508C00000000001

#: Scalar field modulus r = x^4 - x^2 + 1  (253 bits, 2-adicity 47).
BLS12_377_R = BLS12_377_X**4 - BLS12_377_X**2 + 1

#: Base field modulus q = ((x - 1)^2 * r) / 3 + x  (377 bits, 2-adicity 46).
BLS12_377_Q = ((BLS12_377_X - 1) ** 2 * BLS12_377_R) // 3 + BLS12_377_X

# Literal recorded by the reference client (r of BW6-761 == q of BLS12-377):
# client/test_commands/test_bw6_761_groth16_contract.py:26
_BLS12_377_Q_LITERAL = int(
    "0x01ae3a4617c510eac63b05c06ca1493b1a22d9f300f5138f1ef3622fba0948001"
    "70b5d44300000008508c00000000001",
    16,
)
assert BLS12_377_Q == _BLS12_377_Q_LITERAL, "BLS12-377 modulus derivation broke"
assert BLS12_377_R.bit_length() == 253
assert BLS12_377_Q.bit_length() == 377

#: G1 curve: y^2 = x^3 + 1 over Fq.
BLS12_377_B = 1

#: Fq2 = Fq[u] / (u^2 - QNR) with QNR = -5.
BLS12_377_FQ2_QNR = BLS12_377_Q - 5

#: G1 cofactor = (x - 1)^2 / 3.
BLS12_377_G1_COFACTOR = (BLS12_377_X - 1) ** 2 // 3

#: G2 cofactor = (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13) / 9.
BLS12_377_G2_COFACTOR = (
    BLS12_377_X**8
    - 4 * BLS12_377_X**7
    + 5 * BLS12_377_X**6
    - 4 * BLS12_377_X**4
    + 6 * BLS12_377_X**3
    - 4 * BLS12_377_X**2
    - 4 * BLS12_377_X
    + 13
) // 9

# Standard (Zexe/arkworks/libff) generators.  These are only needed when *we*
# run a trusted setup or must interop with reference-produced keys; proof
# verification of golden vectors validates them empirically
# (tests/test_golden_vectors.py).
BLS12_377_G1_GENERATOR = (
    81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
)

#: G2 generator coordinates, each Fq2 element as (c0, c1).
BLS12_377_G2_GENERATOR = (
    (
        233578398248691099356572568220835526895379068987715365179118596935057653620464273615301663571204657964920925606294,
        140913150380207355837477652521042157274541796891053068589147167627541651775299824604154852141315666357241556069118,
    ),
    (
        63160294768292073209381361943935198908131692476676907196754037919244929611450776219210369229519898517858833747423,
        149157405641012693445398062341192467754805999074082136895788947234480009303640899064710353187729182149407503257491,
    ),
)

# ---------------------------------------------------------------------------
# BW6-761 (wrapper curve "wpp" of the default configuration)
# ---------------------------------------------------------------------------

#: Scalar field of BW6-761 *is* the base field of BLS12-377 (the chain
#: property that makes one-layer recursion native).
BW6_761_R = BLS12_377_Q

#: Base field modulus (761 bits), literal from the reference client test
#: (client/test_commands/test_bw6_761_groth16_contract.py:27).
BW6_761_Q = int(
    "0x0122e824fb83ce0ad187c94004faff3eb926186a81d14688528275ef8087be417"
    "07ba638e584e91903cebaff25b423048689c8ed12f9fd9071dcd3dc73ebff2e98a"
    "116c25667a8f8160cf8aeeaf0a437e6913e6870000082f49d00000000008b",
    16,
)
assert BW6_761_Q.bit_length() == 761

#: G1 curve: y^2 = x^3 - 1 over Fq.
BW6_761_B = BW6_761_Q - 1

#: G2 curve (sextic M-twist): y^2 = x^3 + 4 over Fq.
BW6_761_TWIST_B = 4

#: Fq6 = Fq3[w]/(w^2 - v), Fq3 = Fq[v]/(v^3 - XI) with XI = -4
#: (so w^6 = -4; M-type twist with b' = b * xi = (-1)*(-4) = 4).
BW6_761_XI = BW6_761_Q - 4

#: Generators, literals from the reference client test (:28-37).
BW6_761_G1_GENERATOR = (
    int(
        "0x01075b020ea190c8b277ce98a477beaee6a0cfb7551b27f0ee05c54b85f56fc7"
        "79017ffac15520ac11dbfcd294c2e746a17a54ce47729b905bd71fa0c9ea0971"
        "03758f9a280ca27f6750dd0356133e82055928aca6af603f4088f3af66e5b43d",
        16,
    ),
    int(
        "0x0058b84e0a6fc574e6fd637b45cc2a420f952589884c9ec61a7348d2a2e573a3"
        "265909f1af7e0dbac5b8fa1771b5b806cc685d31717a4c55be3fb90b6fc2cdd4"
        "9f9df141b3053253b2b08119cad0fb93ad1cb2be0b20d2a1bafc8f2db4e95363",
        16,
    ),
)

BW6_761_G2_GENERATOR = (
    int(
        "0x0110133241d9b816c852a82e69d660f9d61053aac5a7115f4c06201013890f6d"
        "26b41c5dab3da268734ec3f1f09feb58c5bbcae9ac70e7c7963317a300e1b6ba"
        "ce6948cb3cd208d700e96efbc2ad54b06410cf4fe1bf995ba830c194cd025f1c",
        16,
    ),
    int(
        "0x0017c3357761369f8179eb10e4b6d2dc26b7cf9acec2181c81a78e2753ffe316"
        "0a1d86c80b95a59c94c97eb733293fef64f293dbd2c712b88906c170ffa82300"
        "3ea96fcd504affc758aa2d3a3c5a02a591ec0594f9eac689eb70a16728c73b61",
        16,
    ),
)

# ---------------------------------------------------------------------------
# MNT4-298 / MNT6-298 (legacy 2-cycle, alternate ZECALE_CURVE=MNT6 config)
# ---------------------------------------------------------------------------
# Standard published parameters (Coda/libff MNT cycle).  q of MNT4 == r of
# MNT6 and vice versa.

MNT4_298_Q = 475922286169261325753349249653048451545124879242694725395555128576210262817955800483758081
MNT4_298_R = 475922286169261325753349249653048451545124878552823515553267735739164647307408490559963137
MNT4_298_A = 2
MNT4_298_B = 423894536526684178289416011533888240029318103673896002803341544124054745019340795360841685
#: Fq2 non-residue for MNT4-298.
MNT4_298_QNR = 17

MNT6_298_Q = MNT4_298_R
MNT6_298_R = MNT4_298_Q
MNT6_298_A = 11
MNT6_298_B = 106700080510851735677967319632585352256454251201367587890185989362936000262606668469523074
#: Fq3 non-residue for MNT6-298.
MNT6_298_QNR = 5

# Embedding-degree sanity: r | Phi_4(q) for MNT4, r | Phi_6(q) for MNT6.
assert (MNT4_298_Q**2 + 1) % MNT4_298_R == 0
assert (MNT6_298_Q**2 - MNT6_298_Q + 1) % MNT6_298_R == 0

# MNT generators are derived deterministically at first use (smallest valid
# x-coordinate, lexicographically smaller y, cofactor-cleared); see
# zecale_tpu.ec.host_curve.derived_generators.  There are no reference golden
# vectors for the MNT pair, so no external generator constants need matching.
MNT4_298_G1_GENERATOR = None
MNT4_298_G2_GENERATOR = None
MNT6_298_G1_GENERATOR = None
MNT6_298_G2_GENERATOR = None

# MNT traces (t = q + 1 - #E(Fq), #E(Fq) = r since both cycle curves have
# cofactor 1).  Used to derive G2 twist cofactors.
MNT4_298_T = MNT4_298_Q + 1 - MNT4_298_R
MNT6_298_T = MNT6_298_Q + 1 - MNT6_298_R

#: G2 cofactor candidates: G2 lives on a quadratic twist of E over Fq^{k/2},
#: whose order is q^e + 1 +- t_e (t_e = trace of Frobenius over Fq^e); both
#: signs can be divisible by r, so the correct one is resolved empirically by
#: a subgroup point test at generator-derivation time
#: (zecale_tpu.ec.host_curve.generators).
def _twist_cofactor_candidates(q: int, t: int, e: int, r: int):
    # trace over Fq^e via the recurrence t_n = t * t_{n-1} - q * t_{n-2}
    t_prev, t_cur = 2, t  # t_0 = 2, t_1 = t
    for _ in range(e - 1):
        t_prev, t_cur = t_cur, t * t_cur - q * t_prev
    cands = []
    for order in (q**e + 1 + t_cur, q**e + 1 - t_cur):
        if order % r == 0:
            cands.append(order // r)
    assert cands, "no twist order candidate divisible by r"
    return tuple(cands)


MNT4_298_G2_COFACTORS = _twist_cofactor_candidates(
    MNT4_298_Q, MNT4_298_T, 2, MNT4_298_R
)
MNT6_298_G2_COFACTORS = _twist_cofactor_candidates(
    MNT6_298_Q, MNT6_298_T, 3, MNT6_298_R
)


# ---------------------------------------------------------------------------
# Curve descriptor bundles
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """Static description of one pairing-friendly curve.

    ``name`` follows the reference naming exposed over the RPC configuration
    (e.g. "bls12-377", "bw6-761"; see aggregator.proto PairingParameters use).

    ``g1_generator``/``g2_generator`` may be ``None``, in which case
    deterministic generators are derived at first use
    (zecale_tpu.ec.host_curve.generators).
    """

    name: str
    q: int  # base field modulus
    r: int  # scalar (subgroup) order
    a: int  # short-Weierstrass a coefficient of G1
    b: int  # short-Weierstrass b coefficient of G1
    g2_degree: int  # extension degree of the field G2 coords live in
    embedding_degree: int
    g1_generator: tuple | None
    g2_generator: tuple | None
    coord_bytes: int  # serialized byte length of one Fq element
    scalar_bytes: int  # serialized byte length of one Fr element
    g1_cofactor: int | None = None
    g2_cofactor: int | None = None
    #: unresolved candidate cofactors (resolved empirically at first use)
    g2_cofactor_candidates: tuple = ()


BLS12_377 = CurveParams(
    name="bls12-377",
    q=BLS12_377_Q,
    r=BLS12_377_R,
    a=0,
    b=BLS12_377_B,
    g2_degree=2,
    embedding_degree=12,
    g1_generator=BLS12_377_G1_GENERATOR,
    g2_generator=BLS12_377_G2_GENERATOR,
    coord_bytes=48,
    scalar_bytes=32,
    g1_cofactor=BLS12_377_G1_COFACTOR,
    g2_cofactor=BLS12_377_G2_COFACTOR,
)

BW6_761 = CurveParams(
    name="bw6-761",
    q=BW6_761_Q,
    r=BW6_761_R,
    a=0,
    b=BW6_761_B,
    g2_degree=1,
    embedding_degree=6,
    g1_generator=BW6_761_G1_GENERATOR,
    g2_generator=BW6_761_G2_GENERATOR,
    coord_bytes=96,
    scalar_bytes=48,
)

MNT4_298 = CurveParams(
    name="mnt4-298",
    q=MNT4_298_Q,
    r=MNT4_298_R,
    a=MNT4_298_A,
    b=MNT4_298_B,
    g2_degree=2,
    embedding_degree=4,
    g1_generator=MNT4_298_G1_GENERATOR,
    g2_generator=MNT4_298_G2_GENERATOR,
    coord_bytes=38,
    scalar_bytes=38,
    g1_cofactor=1,
    g2_cofactor=None,
    g2_cofactor_candidates=MNT4_298_G2_COFACTORS,
)

MNT6_298 = CurveParams(
    name="mnt6-298",
    q=MNT6_298_Q,
    r=MNT6_298_R,
    a=MNT6_298_A,
    b=MNT6_298_B,
    g2_degree=3,
    embedding_degree=6,
    g1_generator=MNT6_298_G1_GENERATOR,
    g2_generator=MNT6_298_G2_GENERATOR,
    coord_bytes=38,
    scalar_bytes=38,
    g1_cofactor=1,
    g2_cofactor=None,
    g2_cofactor_candidates=MNT6_298_G2_COFACTORS,
)

CURVES = {c.name: c for c in (BLS12_377, BW6_761, MNT4_298, MNT6_298)}

#: The nested->wrapper pairs supported, mirroring the reference's
#: ZECALE_CURVE compile-time option (CMakeLists.txt:31-57) but runtime
#: selectable here.
CURVE_PAIRS = {
    "bw6-761": ("bls12-377", "bw6-761"),
    "mnt6-298": ("mnt4-298", "mnt6-298"),
}


# ---------------------------------------------------------------------------
# Gamma-slot G2 points
# ---------------------------------------------------------------------------
# The reference's libzeth Groth16 fixes gamma = 1, so verification pairs the
# input accumulator with the *G2 generator constant baked into libff*.  For
# BW6-761 that constant is recorded in the reference tree (and validated by
# golden batch verification).  libff's BLS12-377 G2 generator is NOT present
# anywhere in the reference snapshot; we default to the standard Zexe/arkworks
# generator (a valid subgroup point) and allow an override, so a
# reference-interop deployment can inject libff's constant without code
# changes.  See KNOWN_GAPS.md.
_GAMMA_G2_OVERRIDES: dict = {}


def set_gamma_g2(curve_name: str, point) -> None:
    """Override the [gamma]_2 constant used in Groth16 verification."""
    _GAMMA_G2_OVERRIDES[curve_name] = point


def gamma_g2(curve_name: str):
    if curve_name in _GAMMA_G2_OVERRIDES:
        return _GAMMA_G2_OVERRIDES[curve_name]
    from .host_curve import generators

    return generators(curve_name)[1]
