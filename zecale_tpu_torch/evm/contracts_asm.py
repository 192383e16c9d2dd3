# Copied from zecale_tpu/evm/contracts_asm.py (JAX-free); unchanged but for this line.
"""Hand-assembled EVM bytecode for the Zecale on-chain path.

No solc exists in this image, so these programs are assembled by hand
(evm/asm.py) from the reference contracts' documented word layouts and
ABIs, and executed as REAL BYTECODE on the interpreter in evm/vm.py with
the BW6-761 precompiles at 0xc1/0xc2/0xc3:

  * groth16_verifier_test_code(): the Groth16BW6_761 verifier behind the
    `test_verify(uint256[],uint256[18],uint256[])` ABI of the reference's
    Groth16BW6_761_test.sol:13-23 — vk stored to contract storage, input
    accumulation via ecmul/ecadd on a memory pad, one ecpairing call over
    the 4 pairs laid out exactly as Groth16BW6_761.sol:166-262.

Storage layout divergence (documented): the reference's Solidity dynamic
array lives at keccak(slot); these hand-written programs use flat slots
(length at slot 0, data from slot 1).  The ABI surface — calldata word
layout, the precompile pad layout, and accept/reject behavior — matches
the reference bit-for-bit and is exercised against the golden vectors in
tests/test_evm.py.
"""

from __future__ import annotations

import functools

from .asm import Asm, Label, selector

# the negated BW6-761 G2 generator, encoded as 6 EVM words
# (reference Groth16BW6_761.sol:17-36)
_MINUS_G2 = [
    0x0110133241D9B816C852A82E69D660F9D61053AAC5A7115F4C06201013890F6D,
    0x26B41C5DAB3DA268734EC3F1F09FEB58C5BBCAE9AC70E7C7963317A300E1B6BA,
    0xCE6948CB3CD208D700E96EFBC2AD54B06410CF4FE1BF995BA830C194CD025F1C,
    0x010B24EF8422976B500DDE2F20442C62926E48CFB30F2E6BD0DAE7C82C87DB2B,
    0x665E1F70D9EF437C6F053C47F28AE315219735114032EAD7E8D6126B7443DC2E,
    0x59F7A6F5061CA930BD62CB74AE96A19254A538D3761539F9092C5E98D738C52A,
]

TEST_VERIFY_SELECTOR = selector(
    "test_verify(uint256[],uint256[18],uint256[])"
)

# memory variable slots
_VK_PTR = 0x00
_VK_LEN = 0x20
_I = 0x40
_ABC_SLOT = 0x60
_IN_PTR = 0x80
_IN_END = 0xA0
_PB = 0x100  # pairing/mul pad base: 0x100 .. 0x700


def _var(a: Asm, slot: int):
    a.emit(slot, "MLOAD")


def _setvar(a: Asm, slot: int):
    a.emit(slot, "MSTORE")


def _revert(a: Asm):
    a.emit(0, 0, "REVERT")


def _emit_verify_body(a: Asm, proof_cd: int, fail: Label):
    """Assemble the verify() body.  Preconditions (set by the caller):
    vk stored flat (len at slot 0, words at 1..); mem vars _IN_PTR /
    _IN_END / _ABC_SLOT initialised; num_inputs validated.
    ``proof_cd``: calldata offset of the 18 inline proof words.
    Leaves the boolean result word at memory _PB."""
    # accum = abc[0]: copy 6 words from storage slots abc0.. to pad+0
    for w in range(6):
        a.emit(_I, "MLOAD", w, "ADD", "SLOAD", _PB + 0x20 * w, "MSTORE")
    # abc_slot starts past abc[0]
    _var(a, _I)
    a.emit(6, "ADD")
    _setvar(a, _ABC_SLOT)

    # --- input accumulation loop (Groth16BW6_761.sol:131-161) ----------
    loop = Label("accum_loop")
    done = Label("accum_done")
    a.label(str(loop))
    # continue while in_ptr < in_end (LT takes its left operand on top)
    _var(a, _IN_END)
    _var(a, _IN_PTR)
    a.emit("LT", "ISZERO", done, "JUMPI")
    # copy abc_i (6 words) from storage into pad+0xc0 (mul_in)
    for w in range(6):
        _var(a, _ABC_SLOT)
        a.emit(w, "ADD", "SLOAD", _PB + 0xC0 + 0x20 * w, "MSTORE")
    _var(a, _ABC_SLOT)
    a.emit(6, "ADD")
    _setvar(a, _ABC_SLOT)
    # copy input_i (2 words) from calldata into pad+0x180
    a.emit(0x40)  # size
    _var(a, _IN_PTR)
    a.emit(_PB + 0x180, "CALLDATACOPY")
    _var(a, _IN_PTR)
    a.emit(0x40, "ADD")
    _setvar(a, _IN_PTR)
    # s1 = call(gas, 0xc2 ecmul, 0, mul_in, 0x100, mul_in, 0xc0)
    a.emit(0xC0, _PB + 0xC0, 0x100, _PB + 0xC0, 0, 0xC2, "GAS", "CALL")
    a.emit("ISZERO", fail, "JUMPI")
    # s2 = call(gas, 0xc1 ecadd, 0, pad, 0x180, pad, 0xc0)
    a.emit(0xC0, _PB, 0x180, _PB, 0, 0xC1, "GAS", "CALL")
    a.emit("ISZERO", fail, "JUMPI")
    a.emit(loop, "JUMP")
    a.label(str(done))

    # --- pairing pad (Groth16BW6_761.sol:166-262) ----------------------
    # accum already at pad+0x000; -g2 at 0x0c0
    for w, word in enumerate(_MINUS_G2):
        a.emit(word, _PB + 0x0C0 + 0x20 * w, "MSTORE")
    # vk.alpha (slots 1..6) at 0x180, vk.minus_beta (7..12) at 0x240
    for w in range(12):
        a.emit(1 + w, "SLOAD", _PB + 0x180 + 0x20 * w, "MSTORE")
    # proof a|b (12 words) at 0x300, proof c (6 words) at 0x480 —
    # contiguous in calldata and in the pad: one CALLDATACOPY
    a.emit(0x240, proof_cd, _PB + 0x300, "CALLDATACOPY")
    # vk.minus_delta (slots 13..18) at 0x540
    for w in range(6):
        a.emit(13 + w, "SLOAD", _PB + 0x540 + 0x20 * w, "MSTORE")
    # result := call(gas, 0xc3 ecpairing, 0, pad, 0x600, pad, 0x20)
    a.emit(0x20, _PB, 0x600, _PB, 0, 0xC3, "GAS", "CALL")
    a.emit("ISZERO", fail, "JUMPI")


@functools.lru_cache(maxsize=None)
def groth16_verifier_test_code() -> bytes:
    """Runtime bytecode for the Groth16BW6_761_test contract."""
    a = Asm()
    fail = Label("fail")

    # selector dispatch
    a.emit(0, "CALLDATALOAD", 0xE0, "SHR", TEST_VERIFY_SELECTOR, "EQ",
           "ISZERO", fail, "JUMPI")

    # vk_ptr = 4 + calldataload(4); vk_len = calldataload(vk_ptr)
    a.emit(0x04, "CALLDATALOAD", 0x04, "ADD")
    a.emit("DUP1")
    _setvar(a, _VK_PTR)
    a.emit("CALLDATALOAD")
    a.emit("DUP1")
    _setvar(a, _VK_LEN)
    a.emit(0, "SSTORE")  # slot 0 = vk length

    # store vk words to slots 1..len
    a.emit(0)
    _setvar(a, _I)
    vkl = Label("vk_loop")
    vkd = Label("vk_done")
    a.label(str(vkl))
    _var(a, _I)
    _var(a, _VK_LEN)
    a.emit("GT", "ISZERO")  # len > i ? continue : done  (stack: len>i)
    a.emit(vkd, "JUMPI")
    # sstore(1+i, calldataload(vk_ptr + 0x20 + 0x20*i))
    _var(a, _I)
    a.emit(0x20, "MUL", 0x20, "ADD")
    _var(a, _VK_PTR)
    a.emit("ADD", "CALLDATALOAD")
    _var(a, _I)
    a.emit(1, "ADD", "SSTORE")
    _var(a, _I)
    a.emit(1, "ADD")
    _setvar(a, _I)
    a.emit(vkl, "JUMP")
    a.label(str(vkd))

    # num_inputs = (vk_len - 0x12)/6 - 1   (Groth16BW6_761.sol:64-68)
    _var(a, _VK_LEN)
    a.emit(0x12, "SWAP1", "SUB", 6, "SWAP1", "DIV", 1, "SWAP1", "SUB")

    # inputs_ptr = 4 + calldataload(0x264); require(len/2 == num_inputs)
    a.emit(0x264, "CALLDATALOAD", 0x04, "ADD")  # [num_inputs, inputs_ptr]
    a.emit("DUP1", "CALLDATALOAD", 2, "SWAP1", "DIV")
    # stack: [num_inputs, inputs_ptr, inputs_len/2]
    a.emit("DUP3", "EQ", "ISZERO", fail, "JUMPI")
    # in_ptr = inputs_ptr + 0x20 ; in_end = in_ptr + num_inputs*0x40
    a.emit(0x20, "ADD", "DUP1")
    _setvar(a, _IN_PTR)
    # stack: [num_inputs, in_ptr]
    a.emit("SWAP1", 0x40, "MUL", "ADD")
    _setvar(a, _IN_END)

    # abc starts at slot 1 + 0x12
    a.emit(1 + 0x12)
    _setvar(a, _I)

    _emit_verify_body(a, proof_cd=0x24, fail=fail)

    # return (pad[0] == 1) as a bool word
    a.emit(_PB, "MLOAD", 1, "EQ", 0x00, "MSTORE", 0x20, 0x00, "RETURN")

    a.label(str(fail))
    _revert(a)
    return a.assemble()


def encode_test_verify(vk_words, proof_words, input_words) -> bytes:
    """ABI-encode a test_verify(uint256[],uint256[18],uint256[]) call."""
    assert len(proof_words) == 18
    head = [0] * 20
    tail = b""
    head_bytes = 20 * 32
    head[0] = head_bytes + len(tail)
    tail += len(vk_words).to_bytes(32, "big") + b"".join(
        w.to_bytes(32, "big") for w in vk_words
    )
    for i, w in enumerate(proof_words):
        head[1 + i] = w
    head[19] = head_bytes + len(tail)
    tail += len(input_words).to_bytes(32, "big") + b"".join(
        w.to_bytes(32, "big") for w in input_words
    )
    return (
        TEST_VERIFY_SELECTOR.to_bytes(4, "big")
        + b"".join(h.to_bytes(32, "big") for h in head)
        + tail
    )


# ---------------------------------------------------------------------------
# ZecaleDispatcher (reference ZecaleDispatcher.sol:25-170, batch size made a
# runtime init parameter instead of the reference's compile-time constant 2)
# ---------------------------------------------------------------------------

INIT_DISPATCHER_SELECTOR = selector("init(uint256[],uint256)")
PROCESS_BATCH_SELECTOR = selector(
    "process_batch(uint256[18],uint256[],bytes[],address)"
)

# dispatcher storage: slot 0 = vk length, slots 1.. = vk words (flat),
_SLOT_TOTAL_INPUTS = 1000
_SLOT_INPUTS_PER_TX = 1001
_SLOT_BATCH_SIZE = 1002
_SLOT_INITED = 1003

# dispatcher memory vars
_D_IN_PTR = 0x00  # calldata offset of inputs length word
_D_PAR_PTR = 0x20  # calldata offset of nested_parameters length word
_D_TX = 0x40  # (verify: abc slot cursor) then tx index
_D_RESULTS = 0xC0
_D_CALLB = 0x800  # dispatch-call construction area


@functools.lru_cache(maxsize=None)
def dispatcher_code() -> bytes:
    a = Asm()
    fail = Label("fail")
    pb = Label("process_batch")

    a.emit(0, "CALLDATALOAD", 0xE0, "SHR")
    a.emit("DUP1", PROCESS_BATCH_SELECTOR, "EQ", pb, "JUMPI")
    a.emit(INIT_DISPATCHER_SELECTOR, "EQ", "ISZERO", fail, "JUMPI")

    # ---- init(uint256[] vk, uint256 batch_size) -----------------------
    a.emit(_SLOT_INITED, "SLOAD", fail, "JUMPI")  # only once
    a.emit(1, _SLOT_INITED, "SSTORE")
    # vk_ptr = 4 + cd(4); store flat
    a.emit(0x04, "CALLDATALOAD", 0x04, "ADD", "DUP1", "CALLDATALOAD")
    # stack: [vk_ptr, vk_len]
    a.emit("DUP1", 0, "SSTORE")
    a.emit(0)  # i
    ivl = Label("init_vk_loop")
    ivd = Label("init_vk_done")
    a.label(str(ivl))
    # stack: [vk_ptr, vk_len, i]
    a.emit("DUP1", "DUP3", "GT", "ISZERO", ivd, "JUMPI")  # while len > i
    a.emit("DUP1", 0x20, "MUL", 0x20, "ADD", "DUP4", "ADD",
           "CALLDATALOAD")  # [.., i, word]
    a.emit("DUP2", 1, "ADD", "SSTORE")  # slot 1+i
    a.emit(1, "ADD", ivl, "JUMP")
    a.label(str(ivd))
    # total_inputs = (vk_len - 0x18)/6  (num_inputs_from_vk_length,
    # Groth16BW6_761.sol:267-272)
    a.emit("POP")  # drop i -> [vk_ptr, vk_len]
    a.emit(0x18, "SWAP1", "SUB", 6, "SWAP1", "DIV")
    a.emit("DUP1", _SLOT_TOTAL_INPUTS, "SSTORE")
    # inputs_per_nested_tx = (total_inputs - 2) / batch_size
    a.emit(2, "SWAP1", "SUB", 0x24, "CALLDATALOAD", "SWAP1", "DIV")
    a.emit(_SLOT_INPUTS_PER_TX, "SSTORE")
    a.emit(0x24, "CALLDATALOAD", _SLOT_BATCH_SIZE, "SSTORE", "STOP")

    # ---- process_batch ------------------------------------------------
    a.label(str(pb))
    a.emit("POP")  # drop selector copy
    # inputs_ptr / params_ptr
    a.emit(0x244, "CALLDATALOAD", 0x04, "ADD", "DUP1", _D_IN_PTR,
           "MSTORE")
    # require(inputs.length == total_inputs * 2)
    a.emit("CALLDATALOAD", _SLOT_TOTAL_INPUTS, "SLOAD", 2, "MUL", "EQ",
           "ISZERO", fail, "JUMPI")
    a.emit(0x264, "CALLDATALOAD", 0x04, "ADD", "DUP1", _D_PAR_PTR,
           "MSTORE")
    # require(nested_parameters.length == batch_size)
    a.emit("CALLDATALOAD", _SLOT_BATCH_SIZE, "SLOAD", "EQ", "ISZERO",
           fail, "JUMPI")

    # verify(vk, proof@0x04, inputs): set up _IN_PTR/_IN_END/abc cursor
    a.emit(_D_IN_PTR, "MLOAD", 0x20, "ADD", "DUP1", _IN_PTR, "MSTORE")
    a.emit(0, "SLOAD", 0x12, "SWAP1", "SUB", 6, "SWAP1", "DIV", 1,
           "SWAP1", "SUB")  # num_inputs from vk length
    a.emit(0x40, "MUL", "ADD", _IN_END, "MSTORE")
    a.emit(1 + 0x12, _I, "MSTORE")
    _emit_verify_body(a, proof_cd=0x04, fail=fail)
    # require pairing result == 1 ("invalid wrapper proof")
    a.emit(_PB, "MLOAD", 1, "EQ", "ISZERO", fail, "JUMPI")

    # results = inputs[3] (LO word of packed results)
    a.emit(_D_IN_PTR, "MLOAD", 0x20 + 3 * 0x20, "ADD", "CALLDATALOAD",
           _D_RESULTS, "MSTORE")

    # per-tx dispatch loop
    a.emit(0, _D_TX, "MSTORE")
    txl = Label("tx_loop")
    txn = Label("tx_next")
    txd = Label("tx_done")
    a.label(str(txl))
    a.emit(_SLOT_BATCH_SIZE, "SLOAD", _D_TX, "MLOAD", "LT", "ISZERO",
           txd, "JUMPI")  # while tx < batch_size
    # result bit (SHR takes the shift amount on top of the stack)
    a.emit(_D_RESULTS, "MLOAD", "DUP1", 1, "SHR", _D_RESULTS,
           "MSTORE", 1, "AND", "ISZERO", txn, "JUMPI")

    # build dispatch(uint256[2],uint256[],bytes) calldata at _D_CALLB:
    #   0x00: selector (4 bytes, via MSTORE of selector<<224 at 0x00)
    #   0x04: vk_hash[0]; 0x24: vk_hash[1]
    #   0x44: inputs offset (= 0x80); 0x64: bytes offset
    #   0x84: inputs tail [len][words]; then bytes tail [len][data]
    a.emit(DISPATCH_SELECTOR << 224, _D_CALLB, "MSTORE")
    a.emit(_D_IN_PTR, "MLOAD", 0x20, "ADD", "CALLDATALOAD",
           _D_CALLB + 0x04, "MSTORE")
    a.emit(_D_IN_PTR, "MLOAD", 0x40, "ADD", "CALLDATALOAD",
           _D_CALLB + 0x24, "MSTORE")
    a.emit(0x80, _D_CALLB + 0x44, "MSTORE")
    # inputs tail: len = inputs_per_nested_tx
    a.emit(_SLOT_INPUTS_PER_TX, "SLOAD", _D_CALLB + 0x84, "MSTORE")
    # batch_start_word_idx = 2*(2 + ipn*tx) + 1   (calldata word offset)
    a.emit(_SLOT_INPUTS_PER_TX, "SLOAD", _D_TX, "MLOAD", "MUL", 2,
           "ADD", 2, "MUL", 1, "ADD")
    # -> calldata byte addr: in_ptr + 0x20 + 0x20*idx
    a.emit(0x20, "MUL", 0x20, "ADD", _D_IN_PTR, "MLOAD", "ADD")
    # copy ipn LO words (stride 2 words) into the tail
    a.emit(0)  # i ; stack: [src_base, i]
    cpl = Label("copy_loop")
    cpd = Label("copy_done")
    a.label(str(cpl))
    a.emit("DUP1", _SLOT_INPUTS_PER_TX, "SLOAD", "GT", "ISZERO", cpd,
           "JUMPI")  # while ipn > i
    a.emit("DUP1", 0x40, "MUL", "DUP3", "ADD", "CALLDATALOAD")
    # dst = _D_CALLB+0xa4 + 0x20*i
    a.emit("DUP2", 0x20, "MUL", _D_CALLB + 0xA4, "ADD", "MSTORE")
    a.emit(1, "ADD", cpl, "JUMP")
    a.label(str(cpd))
    a.emit("POP", "POP")  # drop i, src_base

    # bytes tail: nested_parameters[tx]; src: par_ptr+0x20+off_tx
    a.emit(_D_TX, "MLOAD", 0x20, "MUL", 0x20, "ADD", _D_PAR_PTR,
           "MLOAD", "ADD", "CALLDATALOAD")  # off_tx (rel to array data)
    a.emit(_D_PAR_PTR, "MLOAD", 0x20, "ADD", "ADD")  # byte_ptr -> [bp]
    # blen = cd(bp); bytes_off_word = 0x80 + 0x20 + ipn*0x20
    a.emit("DUP1", "CALLDATALOAD")  # [bp, blen]
    a.emit(_SLOT_INPUTS_PER_TX, "SLOAD", 0x20, "MUL", 0xA0, "ADD")
    # [bp, blen, boff] ; store bytes offset into head word 0x64
    a.emit("DUP1", _D_CALLB + 0x64, "MSTORE")
    # dst = _D_CALLB + 4 + boff
    a.emit(_D_CALLB + 4, "ADD")  # [bp, blen, dst]
    # copy_size = 0x20 + ceil32(blen) = 0x20 * ((blen + 0x3f) / 0x20)
    a.emit("DUP2", 0x3F, "ADD", 0x20, "SWAP1", "DIV", 0x20, "MUL")
    # [bp, blen, dst, csize]
    a.emit("DUP1", "DUP5", "DUP4", "CALLDATACOPY")
    # (popped dst, src=bp, size=csize) -> [bp, blen, dst, csize]
    # total calldata = 4 + 0x80 (head) + 0x20 + 0x20*ipn (inputs) + csize
    a.emit(_SLOT_INPUTS_PER_TX, "SLOAD", 0x20, "MUL", "ADD", 0xA4,
           "ADD")  # [bp, blen, dst, total]
    # call app.dispatch (app address at calldata 0x284):
    # push retSize, retOffset, argsSize, argsOffset, value, addr, gas
    a.emit(0, 0, "DUP3", _D_CALLB, 0, 0x284, "CALLDATALOAD", "GAS",
           "CALL")
    a.emit("ISZERO", fail, "JUMPI")
    a.emit("POP", "POP", "POP", "POP")  # drop total, dst, blen, bp

    a.label(str(txn))
    a.emit(_D_TX, "MLOAD", 1, "ADD", _D_TX, "MSTORE", txl, "JUMP")
    a.label(str(txd))
    # return true
    a.emit(1, 0, "MSTORE", 0x20, 0, "RETURN")

    a.label(str(fail))
    _revert(a)
    return a.assemble()


# ---------------------------------------------------------------------------
# DummyApplication (reference DummyApplication.sol:14-67)
# ---------------------------------------------------------------------------

DISPATCH_SELECTOR = selector("dispatch(uint256[2],uint256[],bytes)")
INIT_APP_SELECTOR = selector("init(address,uint256[2])")
GET_SELECTOR = selector("get(uint256)")

# app storage: 0 = permitted dispatcher, 1/2 = vk_hash, 3 = init flag;
# scalar map entries at keccak(scalar || 100)
_MAP_SALT = 100


@functools.lru_cache(maxsize=None)
def dummy_application_code() -> bytes:
    a = Asm()
    fail = Label("fail")
    disp = Label("do_dispatch")
    getl = Label("do_get")

    a.emit(0, "CALLDATALOAD", 0xE0, "SHR")
    a.emit("DUP1", DISPATCH_SELECTOR, "EQ", disp, "JUMPI")
    a.emit("DUP1", GET_SELECTOR, "EQ", getl, "JUMPI")
    a.emit(INIT_APP_SELECTOR, "EQ", "ISZERO", fail, "JUMPI")

    # init(address dispatcher, uint256[2] vk_hash)
    a.emit(3, "SLOAD", fail, "JUMPI")
    a.emit(1, 3, "SSTORE")
    a.emit(0x04, "CALLDATALOAD", 0, "SSTORE")
    a.emit(0x24, "CALLDATALOAD", 1, "SSTORE")
    a.emit(0x44, "CALLDATALOAD", 2, "SSTORE")
    a.emit("STOP")

    # get(uint256 scalar)
    a.label(str(getl))
    a.emit("POP")
    a.emit(0x04, "CALLDATALOAD", 0, "MSTORE", _MAP_SALT, 0x20, "MSTORE")
    a.emit(0x40, 0, "KECCAK256", "SLOAD", 0, "MSTORE", 0x20, 0,
           "RETURN")

    # dispatch(uint256[2] vk_hash, uint256[] inputs, bytes parameters)
    a.label(str(disp))
    a.emit("POP")
    # require caller == permitted dispatcher
    a.emit("CALLER", 0, "SLOAD", "EQ", "ISZERO", fail, "JUMPI")
    # require vk_hash matches
    a.emit(0x04, "CALLDATALOAD", 1, "SLOAD", "EQ", "ISZERO", fail,
           "JUMPI")
    a.emit(0x24, "CALLDATALOAD", 2, "SLOAD", "EQ", "ISZERO", fail,
           "JUMPI")
    # inputs_ptr = 4 + cd(0x44); require len == 1
    a.emit(0x44, "CALLDATALOAD", 0x04, "ADD", "DUP1", "CALLDATALOAD", 1,
           "EQ", "ISZERO", fail, "JUMPI")
    # scalar = cd(inputs_ptr + 0x20)
    a.emit(0x20, "ADD", "CALLDATALOAD")  # [scalar]
    # parameters bytes: bp = 4 + cd(0x64); content = abi.encode(uint256[])
    #   require cd(bp) (byte len) == 0x60; inner offset word == 0x20;
    #   inner len == 1; param = cd(bp + 0x60)
    a.emit(0x64, "CALLDATALOAD", 0x04, "ADD")  # [scalar, bp]
    a.emit("DUP1", "CALLDATALOAD", 0x60, "EQ", "ISZERO", fail, "JUMPI")
    a.emit("DUP1", 0x20, "ADD", "CALLDATALOAD", 0x20, "EQ", "ISZERO",
           fail, "JUMPI")
    a.emit("DUP1", 0x40, "ADD", "CALLDATALOAD", 1, "EQ", "ISZERO", fail,
           "JUMPI")
    a.emit(0x60, "ADD", "CALLDATALOAD")  # [scalar, param]
    # require param != 0
    a.emit("DUP1", "ISZERO", fail, "JUMPI")
    # slot = keccak(scalar || SALT); require unseen; store param
    a.emit("DUP2", 0, "MSTORE", _MAP_SALT, 0x20, "MSTORE")
    a.emit(0x40, 0, "KECCAK256")  # [scalar, param, slot]
    a.emit("DUP1", "SLOAD", fail, "JUMPI")  # scalar already seen
    a.emit("SSTORE", "POP", "STOP")

    a.label(str(fail))
    _revert(a)
    return a.assemble()


def encode_init_dispatcher(vk_words, batch_size: int) -> bytes:
    head = [0x40, batch_size]
    tail = len(vk_words).to_bytes(32, "big") + b"".join(
        w.to_bytes(32, "big") for w in vk_words
    )
    return (
        INIT_DISPATCHER_SELECTOR.to_bytes(4, "big")
        + b"".join(h.to_bytes(32, "big") for h in head)
        + tail
    )


def encode_process_batch(proof_words, input_words, nested_parameters,
                         app_addr: int) -> bytes:
    """ABI-encode process_batch(uint256[18],uint256[],bytes[],address).
    ``nested_parameters``: list of bytes payloads."""
    assert len(proof_words) == 18
    head = [0] * 21
    for i, w in enumerate(proof_words):
        head[i] = w
    head_bytes = 21 * 32
    tail = b""
    head[18] = head_bytes + len(tail)
    tail += len(input_words).to_bytes(32, "big") + b"".join(
        w.to_bytes(32, "big") for w in input_words
    )
    head[19] = head_bytes + len(tail)
    # bytes[] encoding: len, offsets (relative to array data), payloads
    n = len(nested_parameters)
    inner_head = []
    inner_tail = b""
    for p in nested_parameters:
        inner_head.append(n * 32 + len(inner_tail))
        padded = p + b"\x00" * ((32 - len(p) % 32) % 32)
        inner_tail += len(p).to_bytes(32, "big") + padded
    tail += (
        n.to_bytes(32, "big")
        + b"".join(o.to_bytes(32, "big") for o in inner_head)
        + inner_tail
    )
    head[20] = app_addr
    return (
        PROCESS_BATCH_SELECTOR.to_bytes(4, "big")
        + b"".join(h.to_bytes(32, "big") for h in head)
        + tail
    )


def encode_init_app(dispatcher_addr: int, vk_hash) -> bytes:
    return (
        INIT_APP_SELECTOR.to_bytes(4, "big")
        + dispatcher_addr.to_bytes(32, "big")
        + vk_hash[0].to_bytes(32, "big")
        + vk_hash[1].to_bytes(32, "big")
    )


def encode_get(scalar: int) -> bytes:
    return GET_SELECTOR.to_bytes(4, "big") + scalar.to_bytes(32, "big")


def encode_app_parameters(value: int) -> bytes:
    """abi.encode(uint256[] with one element) — the dummy app's expected
    `parameters` payload (DummyApplication.sol:45-49)."""
    return (
        (0x20).to_bytes(32, "big")
        + (1).to_bytes(32, "big")
        + value.to_bytes(32, "big")
    )
