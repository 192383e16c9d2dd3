"""The port's joinsplit application (zecale_tpu_torch/zeth/ and
gadgets/blake2s.py, copies of the JAX package's JAX-free modules) against
the JAX package: the BLAKE2s host hash and compression gadget, the MiMC
Merkle tree and its gadget, the notes' PRFs and commitments, the test
vectors, and the whole 2-in/2-out joinsplit circuit (its constraint rows,
and its witnesses through the port's native engine, whose "xor" opcode no
other circuit of the port emits).  Tolerance: exact (integers mod r)."""

import hashlib
import random

import pytest
import torch

from zecale_tpu.gadgets import blake2s as ref_b2
from zecale_tpu.gadgets.protoboard import LC as RefLC
from zecale_tpu.gadgets.protoboard import Protoboard as RefProtoboard
from zecale_tpu.zeth import dev_vectors as ref_dv
from zecale_tpu.zeth import joinsplit as ref_joinsplit
from zecale_tpu.zeth import merkle as ref_merkle
from zecale_tpu.zeth import notes as ref_notes
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.gadgets import blake2s as b2
from zecale_tpu_torch.gadgets import mimc
from zecale_tpu_torch.gadgets.protoboard import LC, Protoboard
from zecale_tpu_torch.zeth import dev_vectors as dv
from zecale_tpu_torch.zeth import joinsplit, merkle, notes

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

R = P.BLS12_377_R


def _rows_digest(r1cs) -> str:
    """A digest of every A, B, C row of a constraint system, row by row."""
    h = hashlib.sha256()
    for row in r1cs.constraints:
        h.update(repr(row).encode())
    return h.hexdigest()


def _rand_bytes(rng: random.Random, n: int) -> bytes:
    return bytes(rng.randrange(256) for _ in range(n))


def test_blake2s_host_matches_hashlib_and_reference():
    rng = random.Random(60)
    lengths = [0, 1, 31, 32, 55, 63, 64, 65, 104, 127, 128, 129, 200]
    lengths += [rng.randrange(201) for _ in range(12)]
    for n in lengths:
        data = _rand_bytes(rng, n)
        got = b2.blake2s_host(data)
        assert got == hashlib.blake2s(data).digest(), n
        assert got == ref_b2.blake2s_host(data), n
        bits = b2.bytes_to_bits_be(data)
        assert bits == ref_b2.bytes_to_bits_be(data)
        assert b2.bits_be_to_bytes(bits) == data


def _compress_circuit(b2mod, pbcls, lccls, data: bytes):
    """One last-block compression of the 64-byte ``data`` over free bit
    variables -> (r1cs, witness, digest words as ints)."""
    pb = pbcls(R)
    pb.seal_primary()
    vs = pb.allocate_array(512)
    lcs = [lccls.of_var(v) for v in vs]
    for x in lcs:
        pb.enforce_boolean(x)
    m = b2mod._bits_be_to_words(lcs)
    h = [b2mod._Word.constant(b2mod.IV[0] ^ b2mod._PARAM_W0)] + [
        b2mod._Word.constant(b2mod.IV[i]) for i in range(1, 8)]
    out = b2mod.blake2s_compress_gadget(pb, h, m, len(data), True)
    bits = b2mod.bytes_to_bits_be(data)

    def extra(w):
        for v, bit in zip(vs, bits):
            w[v] = bit

    w = pb.generate_witness([], extra_setter=extra)
    words = [sum(pb.lc_val(w, b) << i for i, b in enumerate(wd.bits))
             for wd in out]
    return pb.to_r1cs(), w, words


def test_blake2s_compression_gadget_matches_reference():
    data = _rand_bytes(random.Random(61), 64)
    r1cs, w, words = _compress_circuit(b2, Protoboard, LC, data)
    ref_r1cs, ref_w, ref_words = _compress_circuit(ref_b2, RefProtoboard,
                                                   RefLC, data)
    assert r1cs.num_constraints == ref_r1cs.num_constraints
    assert r1cs.num_variables == ref_r1cs.num_variables
    assert _rows_digest(r1cs) == _rows_digest(ref_r1cs)
    assert w == ref_w
    assert r1cs.is_satisfied(w)
    digest = b"".join(x.to_bytes(4, "little") for x in words)
    assert words == ref_words
    assert digest == hashlib.blake2s(data).digest()


def test_merkle_tree_host_and_gadget_match_reference():
    depth = 4
    t = merkle.MerkleTreeField(depth, R)
    ref_t = ref_merkle.MerkleTreeField(depth, R)
    rng = random.Random(50)
    vals = {a: rng.randrange(R) for a in (0, 1, 5, 15)}
    for a, v in vals.items():
        t.set_value(a, v)
        ref_t.set_value(a, v)
    assert t.get_root() == ref_t.get_root()
    for a, v in vals.items():
        assert t.get_path(a) == ref_t.get_path(a)
        cur = v
        for lvl, sib in enumerate(t.get_path(a)):
            left, right = (sib, cur) if (a >> lvl) & 1 else (cur, sib)
            cur = merkle.node_hash(left, right, R)
            assert cur == ref_merkle.node_hash(left, right, R)
        assert cur == t.get_root()

    # the gadget recomputes the root along the path
    a = 5
    pb = Protoboard(R)
    addr_bits = [LC.const((a >> i) & 1) for i in range(depth)]
    path = [LC.const(s) for s in t.get_path(a)]
    root_lc = merkle.merkle_root_gadget(pb, LC.const(vals[a]), addr_bits,
                                        path)
    w = pb.generate_witness([0] * pb.num_primary)
    r1cs = pb.to_r1cs()
    assert r1cs.is_satisfied(w)
    assert pb.lc_val(w, root_lc) == t.get_root()

    ref_pb = RefProtoboard(R)
    ref_merkle.merkle_root_gadget(
        ref_pb, RefLC.const(vals[a]),
        [RefLC.const((a >> i) & 1) for i in range(depth)],
        [RefLC.const(s) for s in t.get_path(a)])
    ref_w = ref_pb.generate_witness([0] * ref_pb.num_primary)
    assert _rows_digest(r1cs) == _rows_digest(ref_pb.to_r1cs())
    assert w == ref_w


def test_note_prfs_and_commitments_match_reference():
    rng = random.Random(62)
    for _ in range(4):
        a_sk, rho, trap_r, h_sig, phi, a_pk = (_rand_bytes(rng, 32)
                                               for _ in range(6))
        value = rng.randrange(1 << 64)
        assert notes.prf_addr(a_sk) == ref_notes.prf_addr(a_sk)
        assert notes.prf_nf(a_sk, rho) == ref_notes.prf_nf(a_sk, rho)
        for i in (0, 1):
            assert (notes.prf_pk(a_sk, i, h_sig)
                    == ref_notes.prf_pk(a_sk, i, h_sig))
            assert (notes.prf_rho(phi, i, h_sig)
                    == ref_notes.prf_rho(phi, i, h_sig))
        note = notes.ZethNote(a_pk=a_pk, value=value, rho=rho, trap_r=trap_r)
        ref_note = ref_notes.ZethNote(a_pk=a_pk, value=value, rho=rho,
                                      trap_r=trap_r)
        assert note.commitment() == ref_note.commitment()
        assert note.commitment_field(R) == ref_note.commitment_field(R)
        inp = notes.JoinsplitInput(path=[1, 2, 3, 4], address=3, note=note,
                                   a_sk=a_sk)
        ref_inp = ref_notes.JoinsplitInput(path=[1, 2, 3, 4], address=3,
                                           note=ref_note, a_sk=a_sk)
        assert inp.nullifier() == ref_inp.nullifier()


def _plain(js: dict) -> dict:
    """A joinsplit's kwargs with the notes as tuples of their fields."""
    def note(n):
        return (n.a_pk, n.value, n.rho, n.trap_r)

    out = dict(js)
    out["inputs"] = [(i.path, i.address, note(i.note), i.a_sk)
                     for i in js["inputs"]]
    out["outputs"] = [note(n) for n in js["outputs"]]
    return out


@pytest.mark.parametrize("seed", [100, 101, 102])
def test_make_test_joinsplit_matches_reference(seed):
    got = dv.make_test_joinsplit(random.Random(seed))
    want = ref_dv.make_test_joinsplit(random.Random(seed))
    assert _plain(got) == _plain(want)


# -- the whole joinsplit circuit ---------------------------------------------


@pytest.fixture(scope="module")
def circuits():
    """(port, reference) JoinsplitCircuit(), each built once (~12 s)."""
    return joinsplit.JoinsplitCircuit(), ref_joinsplit.JoinsplitCircuit()


def test_joinsplit_circuit_rows_match_reference(circuits):
    port, ref = circuits
    got, want = port.r1cs, ref.r1cs
    assert (got.num_constraints, got.num_variables, got.num_primary) == (
        350_776, 345_661, 1)
    assert (want.num_constraints, want.num_variables, want.num_primary) == (
        350_776, 345_661, 1)
    assert got.qap_degree == want.qap_degree == 1 << 19
    assert port.num_public_data == ref.num_public_data == 9
    assert _rows_digest(got) == _rows_digest(want)


@pytest.mark.parametrize("seed", [100, 101])
def test_joinsplit_witness_matches_reference(circuits, seed):
    port, ref = circuits
    w = port.generate_witness(**dv.make_test_joinsplit(random.Random(seed)))
    want = ref.generate_witness(
        **ref_dv.make_test_joinsplit(random.Random(seed)))
    assert len(w) == port.r1cs.num_variables
    assert w == want
    # the port's witness went through the native engine and its "xor"
    ops = {op[0] for op in port.pb.hook_ops if op is not None}
    assert {"xor", "unpack"} <= ops
    assert port.pb._hook_prog and port.pb._hook_prog.available


def test_joinsplit_witness_satisfiable_and_hashes_public_data(circuits):
    port, _ = circuits
    js = dv.make_test_joinsplit(random.Random(51))
    w = port.generate_witness(**js)
    assert port.r1cs.first_failing_constraint(w) is None

    # the single primary input is the MiMC hash of the public data
    cap = port.capacity
    mask = (1 << cap) - 1

    def fpart(d: bytes) -> int:
        return int.from_bytes(d, "big") & mask

    def rpart(d: bytes) -> int:
        return int.from_bytes(d, "big") >> cap

    nf = [inp.nullifier() for inp in js["inputs"]]
    h = [notes.prf_pk(inp.a_sk, i, js["h_sig"])
         for i, inp in enumerate(js["inputs"])]
    cm_out = [n.commitment_field(R) for n in js["outputs"]]
    residual = ((js["vpub_in"] << 84) | (js["vpub_out"] << 20)
                | (rpart(js["h_sig"]) << 16) | (rpart(nf[0]) << 12)
                | (rpart(nf[1]) << 8) | (rpart(h[0]) << 4) | rpart(h[1]))
    public_data = ([js["root"]] + [fpart(x) for x in nf] + cm_out
                   + [fpart(js["h_sig"])] + [fpart(x) for x in h]
                   + [residual])
    assert w[1] == mimc.mimc_hash_inputs(public_data, R)


@pytest.mark.parametrize("fault", ["bad balance", "wrong root"])
def test_joinsplit_rejects_a_bad_statement(circuits, fault):
    port, _ = circuits
    js = dv.make_test_joinsplit(random.Random(52))
    if fault == "bad balance":
        js["vpub_out"] += 1  # steal one wei
    else:
        js["root"] = (js["root"] + 1) % R  # the funded input's root binds
    w = port.generate_witness(**js)
    assert port.r1cs.first_failing_constraint(w) is not None
