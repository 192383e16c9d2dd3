# Copied from zecale_tpu/zeth/dev_vectors.py (JAX-free); only imports and build paths changed.
"""Deterministic joinsplit test scenario — the same shape as the
reference's generate_valid_zeth_proof (aggregator_test.cpp:100-190):
one funded note at tree address 1, one dummy input, one funded output,
one dummy output, vpub_out > 0."""

from __future__ import annotations

import random

from ..ff import params as P
from . import merkle, notes


def _rand32(rng: random.Random) -> bytes:
    return bytes(rng.randrange(256) for _ in range(32))


def make_test_joinsplit(
    rng: random.Random, tree_depth: int = 4, curve_name: str = "bls12-377"
) -> dict:
    """kwargs for JoinsplitCircuit.generate_witness / prove."""
    r = P.CURVES[curve_name].r
    a_sk = _rand32(rng)
    a_pk = notes.prf_addr(a_sk)
    trap_r = _rand32(rng)
    note_in = notes.ZethNote(
        a_pk=a_pk, value=0x2F0000000000000F, rho=_rand32(rng), trap_r=trap_r
    )
    note_dummy = notes.ZethNote(
        a_pk=a_pk, value=0, rho=_rand32(rng), trap_r=trap_r
    )

    tree = merkle.MerkleTreeField(tree_depth, r)
    addr = 1
    tree.set_value(addr, note_in.commitment_field(r))
    root = tree.get_root()
    path = tree.get_path(addr)

    inputs = [
        notes.JoinsplitInput(path=path, address=addr, note=note_in, a_sk=a_sk),
        notes.JoinsplitInput(
            path=path, address=addr, note=note_dummy, a_sk=a_sk
        ),
    ]

    h_sig = _rand32(rng)
    phi = _rand32(rng)
    a_pk_out = _rand32(rng)
    vpub_out = 0x1700000000000007
    v_out = note_in.value - vpub_out
    out_note = notes.ZethNote(
        a_pk=a_pk_out,
        value=v_out,
        rho=notes.prf_rho(phi, 0, h_sig),
        trap_r=_rand32(rng),
    )
    out_dummy = notes.ZethNote(
        a_pk=a_pk_out,
        value=0,
        rho=notes.prf_rho(phi, 1, h_sig),
        trap_r=_rand32(rng),
    )
    return dict(
        root=root,
        inputs=inputs,
        outputs=[out_note, out_dummy],
        vpub_in=0,
        vpub_out=vpub_out,
        h_sig=h_sig,
        phi=phi,
    )
