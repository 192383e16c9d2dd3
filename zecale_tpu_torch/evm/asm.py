# Copied from zecale_tpu/evm/asm.py (JAX-free); unchanged but for this line.
"""A small EVM assembler (mnemonics + labels -> bytecode).

There is no solc in this environment (KNOWN_GAPS.md #6), so the on-chain
contracts are hand-assembled against the reference's documented word
layouts (contracts_asm.py) and executed on the interpreter in evm/vm.py.
"""

from __future__ import annotations

from typing import List, Tuple, Union

OPCODES = {
    "STOP": 0x00, "ADD": 0x01, "MUL": 0x02, "SUB": 0x03, "DIV": 0x04,
    "SDIV": 0x05, "MOD": 0x06, "ADDMOD": 0x08, "MULMOD": 0x09,
    "EXP": 0x0A, "LT": 0x10, "GT": 0x11, "SLT": 0x12, "SGT": 0x13,
    "EQ": 0x14, "ISZERO": 0x15, "AND": 0x16, "OR": 0x17, "XOR": 0x18,
    "NOT": 0x19, "BYTE": 0x1A, "SHL": 0x1B, "SHR": 0x1C,
    "KECCAK256": 0x20, "ADDRESS": 0x30, "CALLER": 0x33,
    "CALLVALUE": 0x34, "CALLDATALOAD": 0x35, "CALLDATASIZE": 0x36,
    "CALLDATACOPY": 0x37, "RETURNDATASIZE": 0x3D, "RETURNDATACOPY": 0x3E,
    "SELFBALANCE": 0x47, "POP": 0x50, "MLOAD": 0x51, "MSTORE": 0x52,
    "MSTORE8": 0x53, "SLOAD": 0x54, "SSTORE": 0x55, "JUMP": 0x56,
    "JUMPI": 0x57, "PC": 0x58, "MSIZE": 0x59, "GAS": 0x5A,
    "JUMPDEST": 0x5B, "LOG0": 0xA0, "LOG1": 0xA1, "LOG2": 0xA2,
    "LOG3": 0xA3, "LOG4": 0xA4, "CALL": 0xF1, "STATICCALL": 0xFA,
    "RETURN": 0xF3, "REVERT": 0xFD, "INVALID": 0xFE,
}
for _i in range(1, 17):
    OPCODES[f"DUP{_i}"] = 0x7F + _i
    OPCODES[f"SWAP{_i}"] = 0x8F + _i


class Label(str):
    pass


class Asm:
    """Two-pass assembler.  ``emit`` takes mnemonics, ints (auto-sized
    PUSH) and Label references (PUSH2, fixed width for the fixup pass)."""

    def __init__(self):
        self.items: List[Tuple[str, Union[int, str, None]]] = []

    def emit(self, *parts):
        for p in parts:
            if isinstance(p, Label):
                self.items.append(("pushlabel", str(p)))
            elif isinstance(p, int):
                self.items.append(("push", p))
            elif isinstance(p, str):
                assert p in OPCODES, f"unknown mnemonic {p}"
                self.items.append(("op", p))
            else:
                raise TypeError(p)
        return self

    def label(self, name: str):
        self.items.append(("label", name))
        self.items.append(("op", "JUMPDEST"))
        return self

    def assemble(self) -> bytes:
        # pass 1: layout
        offsets = {}
        pc = 0
        for kind, val in self.items:
            if kind == "label":
                offsets[val] = pc
            elif kind == "op":
                pc += 1
            elif kind == "push":
                n = max(1, (int(val).bit_length() + 7) // 8)
                pc += 1 + n
            elif kind == "pushlabel":
                pc += 3  # PUSH2 xx xx
        # pass 2: emit
        out = bytearray()
        for kind, val in self.items:
            if kind == "label":
                continue
            if kind == "op":
                out.append(OPCODES[val])
            elif kind == "push":
                v = int(val)
                n = max(1, (v.bit_length() + 7) // 8)
                out.append(0x5F + n)
                out.extend(v.to_bytes(n, "big"))
            elif kind == "pushlabel":
                dst = offsets[val]
                out.append(0x61)  # PUSH2
                out.extend(dst.to_bytes(2, "big"))
        return bytes(out)


def selector(signature: str) -> int:
    from .keccak import keccak256

    return int.from_bytes(keccak256(signature.encode())[:4], "big")
