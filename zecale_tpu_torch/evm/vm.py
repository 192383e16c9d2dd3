# Copied from zecale_tpu/evm/vm.py (JAX-free); unchanged but for this line.
"""Minimal EVM interpreter with BW6-761 precompiles (0xc1/0xc2/0xc3).

The reference settles batches on a Clearmatics ganache fork whose EVM adds
BW6-761 ecadd/ecmul/ecpairing precompiles (reference
contracts/Groth16BW6_761.sol:158-159,259; client/README.md:66-70).  This
image has no solc, no py-evm and no ganache, so the on-chain path is
executed here by (a) this interpreter — the opcode subset the Zecale
contracts need — and (b) hand-assembled bytecode for the contracts
(evm/contracts_asm.py) matching the reference word layouts.  The
precompiles are backed by the host curve oracle (ec/host_curve.py).

Semantics follow the Yellow Paper for the implemented subset: 256-bit
wrapping arithmetic, big-endian memory words, keccak-256 for storage slot
derivation, value-transferring CALL between accounts, LOG records, REVERT
with reason propagation.  Gas is metered approximately (a fixed cost per
opcode class + precompile costs) so `process_batch` gas reports exist; it
is NOT consensus-accurate.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from ..ec import host_curve as hc
from ..ff import params as P
from .keccak import keccak256

U256 = 1 << 256
MASK256 = U256 - 1
SIGN_BIT = 1 << 255


def _sx(v: int) -> int:
    """uint256 -> signed."""
    return v - U256 if v & SIGN_BIT else v


class EvmRevert(Exception):
    def __init__(self, data: bytes):
        self.data = data
        super().__init__(self.reason() or "revert")

    def reason(self) -> Optional[str]:
        # Error(string) selector 0x08c379a0
        d = self.data
        if len(d) >= 4 + 32 + 32 and d[:4] == bytes.fromhex("08c379a0"):
            slen = int.from_bytes(d[36:68], "big")
            return d[68 : 68 + slen].decode("utf-8", "replace")
        return None


@dataclasses.dataclass
class LogRecord:
    address: int
    topics: List[int]
    data: bytes


@dataclasses.dataclass
class Account:
    code: bytes = b""
    storage: Dict[int, int] = dataclasses.field(default_factory=dict)
    balance: int = 0
    nonce: int = 0


class Memory:
    def __init__(self):
        self.data = bytearray()

    def _ensure(self, off: int, size: int):
        end = off + size
        if end > len(self.data):
            # word-align growth like the EVM
            grow = ((end + 31) // 32) * 32
            self.data.extend(b"\x00" * (grow - len(self.data)))

    def read(self, off: int, size: int) -> bytes:
        if size == 0:
            return b""
        self._ensure(off, size)
        return bytes(self.data[off : off + size])

    def write(self, off: int, value: bytes):
        if not value:
            return
        self._ensure(off, len(value))
        self.data[off : off + len(value)] = value

    def load_word(self, off: int) -> int:
        return int.from_bytes(self.read(off, 32), "big")

    def store_word(self, off: int, v: int):
        self.write(off, (v & MASK256).to_bytes(32, "big"))


# ---------------------------------------------------------------------------
# BW6-761 precompiles (addresses 0xc1 ecadd, 0xc2 ecmul, 0xc3 ecpairing)
# ---------------------------------------------------------------------------

_FQ_WORDS = 3  # 761-bit Fq in 3 words
_G1_BYTES = 2 * _FQ_WORDS * 32  # 192


def _read_fq(data: bytes, off: int) -> int:
    return int.from_bytes(data[off : off + _FQ_WORDS * 32], "big")


def _write_g1(pt) -> bytes:
    if pt is None:
        return b"\x00" * _G1_BYTES
    x, y = pt
    return x.to_bytes(_FQ_WORDS * 32, "big") + y.to_bytes(
        _FQ_WORDS * 32, "big"
    )


def _read_g1(data: bytes, off: int):
    x = _read_fq(data, off)
    y = _read_fq(data, off + _FQ_WORDS * 32)
    if x == 0 and y == 0:
        return None
    return (x, y)


def _bw6_ecadd(data: bytes) -> bytes:
    crv = hc.g1_curve("bw6-761")
    a = _read_g1(data, 0)
    b = _read_g1(data, _G1_BYTES)
    for pt in (a, b):
        if pt is not None and not crv.is_on_curve(pt):
            raise EvmRevert(b"")
    return _write_g1(crv.add(a, b) if (a and b) else (a or b))


def _bw6_ecmul(data: bytes) -> bytes:
    crv = hc.g1_curve("bw6-761")
    p = _read_g1(data, 0)
    s = int.from_bytes(data[_G1_BYTES : _G1_BYTES + 64], "big")
    if p is not None and not crv.is_on_curve(p):
        raise EvmRevert(b"")
    if p is None or s % P.CURVES["bw6-761"].r == 0:
        return _write_g1(None)
    return _write_g1(crv.mul(s % P.CURVES["bw6-761"].r, p))


def _pairing_product_is_one(pairs) -> bool:
    from ..native import pairing as npair

    eng = npair.bw6()
    if eng is not None:
        return eng.pairing_product_is_one(pairs)
    from ..pairing import host_pairing

    return host_pairing.ctx("bw6-761").pairing_product_is_one(pairs)


def _bw6_ecpairing(data: bytes) -> bytes:
    pair_bytes = 2 * _G1_BYTES  # G1 (192) + G2 (192, Fq coords)
    if len(data) % pair_bytes:
        raise EvmRevert(b"")
    pairs = []
    crv1 = hc.g1_curve("bw6-761")
    crv2 = hc.g2_curve("bw6-761")
    for off in range(0, len(data), pair_bytes):
        p = _read_g1(data, off)
        q = _read_g1(data, off + _G1_BYTES)
        if p is None or q is None:
            continue  # pair with infinity contributes 1
        if not crv1.is_on_curve(p) or not crv2.is_on_curve(q):
            raise EvmRevert(b"")
        pairs.append((p, q))
    ok = _pairing_product_is_one(pairs)
    return (1 if ok else 0).to_bytes(32, "big")


PRECOMPILES: Dict[int, Callable[[bytes], bytes]] = {
    0xC1: _bw6_ecadd,
    0xC2: _bw6_ecmul,
    0xC3: _bw6_ecpairing,
}

_PRECOMPILE_GAS = {0xC1: 600, 0xC2: 4_500, 0xC3: 120_000}


def _precompile_gas(addr: int, data: bytes) -> int:
    g = _PRECOMPILE_GAS[addr]
    if addr == 0xC3:
        g += 35_000 * (len(data) // (2 * _G1_BYTES))
    return g


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------


class Chain:
    """A single-block in-memory chain: accounts, deploy, call, logs.

    Serializable to JSON so CLI invocations in separate processes share
    one chain state file (the analog of the reference's --eth-network
    node endpoint)."""

    def __init__(self):
        self.accounts: Dict[int, Account] = {}
        self.logs: List[LogRecord] = []
        self._next_addr = 0x1000

    # -- persistence ------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "next_addr": self._next_addr,
            "accounts": {
                hex(a): {
                    "code": acct.code.hex(),
                    "storage": {hex(k): hex(v) for k, v in acct.storage.items()},
                    "balance": acct.balance,
                    "nonce": acct.nonce,
                }
                for a, acct in self.accounts.items()
            },
            "logs": [
                {
                    "address": hex(l.address),
                    "topics": [hex(t) for t in l.topics],
                    "data": l.data.hex(),
                }
                for l in self.logs
            ],
        }

    @classmethod
    def from_json(cls, j: dict) -> "Chain":
        c = cls()
        c._next_addr = j["next_addr"]
        for a, acct in j["accounts"].items():
            c.accounts[int(a, 16)] = Account(
                code=bytes.fromhex(acct["code"]),
                storage={
                    int(k, 16): int(v, 16)
                    for k, v in acct["storage"].items()
                },
                balance=acct["balance"],
                nonce=acct["nonce"],
            )
        c.logs = [
            LogRecord(
                int(l["address"], 16),
                [int(t, 16) for t in l["topics"]],
                bytes.fromhex(l["data"]),
            )
            for l in j["logs"]
        ]
        return c

    def save(self, path: str):
        import json

        with open(path, "w") as f:
            json.dump(self.to_json(), f)

    @classmethod
    def load(cls, path: str) -> "Chain":
        import json
        import os

        if not os.path.exists(path):
            return cls()
        with open(path) as f:
            return cls.from_json(json.load(f))

    def account(self, addr: int) -> Account:
        return self.accounts.setdefault(addr, Account())

    def deploy(self, code: bytes, sender: int = 0xCAFE,
               value: int = 0) -> int:
        """Install runtime bytecode directly (no constructor execution —
        the hand-assembled contracts take their init args via a setup
        call instead, documented per contract)."""
        addr = self._next_addr
        self._next_addr += 1
        acct = self.account(addr)
        acct.code = code
        acct.balance += value
        return addr

    def call(
        self,
        to: int,
        data: bytes,
        sender: int = 0xCAFE,
        value: int = 0,
        gas: int = 1 << 32,
    ) -> Tuple[bytes, int]:
        """Top-level transaction call.  Returns (returndata, gas_used).
        Raises EvmRevert on revert (state changes in the frame are rolled
        back)."""
        snapshot = {
            a: (acct.code, dict(acct.storage), acct.balance, acct.nonce)
            for a, acct in self.accounts.items()
        }
        log_mark = len(self.logs)
        frame = Frame(self, to, sender, value, data, gas)
        try:
            ret = frame.run()
        except EvmRevert:
            self.accounts = {
                a: Account(code=c, storage=s, balance=b, nonce=n)
                for a, (c, s, b, n) in snapshot.items()
            }
            del self.logs[log_mark:]
            raise
        return ret, frame.gas_used


class Frame:
    """One call frame executing an account's code."""

    def __init__(self, chain: Chain, address: int, caller: int,
                 value: int, calldata: bytes, gas: int,
                 static: bool = False):
        self.chain = chain
        self.address = address
        self.caller = caller
        self.value = value
        self.calldata = calldata
        self.gas = gas
        self.gas_used = 0
        self.static = static
        self.stack: List[int] = []
        self.mem = Memory()
        self.returndata = b""

    # -- helpers ----------------------------------------------------------
    def push(self, v: int):
        if len(self.stack) >= 1024:
            raise EvmRevert(b"")
        self.stack.append(v & MASK256)

    def pop(self) -> int:
        return self.stack.pop()

    def use_gas(self, g: int):
        self.gas_used += g
        if self.gas_used > self.gas:
            raise EvmRevert(b"")

    # -- the interpreter --------------------------------------------------
    def run(self) -> bytes:
        code = self.chain.account(self.address).code
        # precompute valid JUMPDESTs (skip PUSH immediates)
        jumpdests = set()
        i = 0
        while i < len(code):
            op = code[i]
            if op == 0x5B:
                jumpdests.add(i)
            i += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)

        pc = 0
        push = self.push
        pop = self.pop
        mem = self.mem
        storage = self.chain.account(self.address).storage
        while pc < len(code):
            op = code[pc]
            pc += 1
            self.use_gas(3)
            if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
                n = op - 0x5F
                push(int.from_bytes(code[pc : pc + n], "big"))
                pc += n
            elif 0x80 <= op <= 0x8F:  # DUP1..DUP16
                push(self.stack[-(op - 0x7F)])
            elif 0x90 <= op <= 0x9F:  # SWAP1..SWAP16
                n = op - 0x8F
                s = self.stack
                s[-1], s[-n - 1] = s[-n - 1], s[-1]
            elif op == 0x00:  # STOP
                return b""
            elif op == 0x01:  # ADD
                push(pop() + pop())
            elif op == 0x02:  # MUL
                push(pop() * pop())
            elif op == 0x03:  # SUB
                a = pop(); push(a - pop())
            elif op == 0x04:  # DIV
                a, b = pop(), pop()
                push(a // b if b else 0)
            elif op == 0x05:  # SDIV
                a, b = _sx(pop()), _sx(pop())
                push(0 if b == 0 else abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1))
            elif op == 0x06:  # MOD
                a, b = pop(), pop()
                push(a % b if b else 0)
            elif op == 0x08:  # ADDMOD
                a, b, m = pop(), pop(), pop()
                push((a + b) % m if m else 0)
            elif op == 0x09:  # MULMOD
                a, b, m = pop(), pop(), pop()
                push((a * b) % m if m else 0)
            elif op == 0x0A:  # EXP
                a, b = pop(), pop()
                push(pow(a, b, U256))
            elif op == 0x10:  # LT
                a = pop(); push(1 if a < pop() else 0)
            elif op == 0x11:  # GT
                a = pop(); push(1 if a > pop() else 0)
            elif op == 0x12:  # SLT
                a = _sx(pop()); push(1 if a < _sx(pop()) else 0)
            elif op == 0x13:  # SGT
                a = _sx(pop()); push(1 if a > _sx(pop()) else 0)
            elif op == 0x14:  # EQ
                push(1 if pop() == pop() else 0)
            elif op == 0x15:  # ISZERO
                push(1 if pop() == 0 else 0)
            elif op == 0x16:  # AND
                push(pop() & pop())
            elif op == 0x17:  # OR
                push(pop() | pop())
            elif op == 0x18:  # XOR
                push(pop() ^ pop())
            elif op == 0x19:  # NOT
                push(~pop())
            elif op == 0x1A:  # BYTE
                i_, x = pop(), pop()
                push((x >> (8 * (31 - i_))) & 0xFF if i_ < 32 else 0)
            elif op == 0x1B:  # SHL
                s, v = pop(), pop()
                push(v << s if s < 256 else 0)
            elif op == 0x1C:  # SHR
                s, v = pop(), pop()
                push(v >> s if s < 256 else 0)
            elif op == 0x20:  # KECCAK256
                off, size = pop(), pop()
                self.use_gas(30 + 6 * ((size + 31) // 32))
                push(int.from_bytes(keccak256(mem.read(off, size)), "big"))
            elif op == 0x30:  # ADDRESS
                push(self.address)
            elif op == 0x33:  # CALLER
                push(self.caller)
            elif op == 0x34:  # CALLVALUE
                push(self.value)
            elif op == 0x35:  # CALLDATALOAD
                off = pop()
                d = self.calldata[off : off + 32]
                push(int.from_bytes(d.ljust(32, b"\x00"), "big"))
            elif op == 0x36:  # CALLDATASIZE
                push(len(self.calldata))
            elif op == 0x37:  # CALLDATACOPY
                dst, src, size = pop(), pop(), pop()
                d = self.calldata[src : src + size]
                mem.write(dst, d.ljust(size, b"\x00"))
            elif op == 0x3D:  # RETURNDATASIZE
                push(len(self.returndata))
            elif op == 0x3E:  # RETURNDATACOPY
                dst, src, size = pop(), pop(), pop()
                if src + size > len(self.returndata):
                    raise EvmRevert(b"")
                mem.write(dst, self.returndata[src : src + size])
            elif op == 0x47:  # SELFBALANCE
                push(self.chain.account(self.address).balance)
            elif op == 0x50:  # POP
                pop()
            elif op == 0x51:  # MLOAD
                push(mem.load_word(pop()))
            elif op == 0x52:  # MSTORE
                off = pop()
                mem.store_word(off, pop())
            elif op == 0x53:  # MSTORE8
                off = pop()
                mem.write(off, bytes([pop() & 0xFF]))
            elif op == 0x54:  # SLOAD
                self.use_gas(200)
                push(storage.get(pop(), 0))
            elif op == 0x55:  # SSTORE
                if self.static:
                    raise EvmRevert(b"")
                self.use_gas(5000)
                k = pop()
                storage[k] = pop()
            elif op == 0x56:  # JUMP
                pc = pop()
                if pc not in jumpdests:
                    raise EvmRevert(b"")
            elif op == 0x57:  # JUMPI
                dst, cond = pop(), pop()
                if cond:
                    pc = dst
                    if pc not in jumpdests:
                        raise EvmRevert(b"")
            elif op == 0x58:  # PC
                push(pc - 1)
            elif op == 0x59:  # MSIZE
                push(len(mem.data))
            elif op == 0x5A:  # GAS
                push(self.gas - self.gas_used)
            elif op == 0x5B:  # JUMPDEST
                pass
            elif 0xA0 <= op <= 0xA4:  # LOG0..LOG4
                if self.static:
                    raise EvmRevert(b"")
                off, size = pop(), pop()
                topics = [pop() for _ in range(op - 0xA0)]
                self.use_gas(375 * (1 + op - 0xA0) + 8 * size)
                self.chain.logs.append(
                    LogRecord(self.address, topics, mem.read(off, size))
                )
            elif op in (0xF1, 0xFA):  # CALL / STATICCALL
                if op == 0xF1:
                    g, to, val, in_off, in_size, out_off, out_size = (
                        pop(), pop(), pop(), pop(), pop(), pop(), pop()
                    )
                else:
                    g, to, in_off, in_size, out_off, out_size = (
                        pop(), pop(), pop(), pop(), pop(), pop()
                    )
                    val = 0
                data = mem.read(in_off, in_size)
                if to in PRECOMPILES:
                    self.use_gas(_precompile_gas(to, data))
                    try:
                        self.returndata = PRECOMPILES[to](data)
                        ok = 1
                    except EvmRevert:
                        self.returndata = b""
                        ok = 0
                else:
                    self.use_gas(700)
                    if val:
                        me = self.chain.account(self.address)
                        if me.balance < val:
                            raise EvmRevert(b"")
                        me.balance -= val
                        self.chain.account(to).balance += val
                    sub = Frame(
                        self.chain, to, self.address, val, data,
                        self.gas - self.gas_used,
                        static=self.static or op == 0xFA,
                    )
                    try:
                        self.returndata = sub.run()
                        ok = 1
                    except EvmRevert as e:
                        self.returndata = e.data
                        ok = 0
                    self.use_gas(sub.gas_used)
                mem.write(out_off, self.returndata[:out_size])
                push(ok)
            elif op == 0xF3:  # RETURN
                off, size = pop(), pop()
                return mem.read(off, size)
            elif op == 0xFD:  # REVERT
                off, size = pop(), pop()
                raise EvmRevert(mem.read(off, size))
            elif op == 0xFE:  # INVALID
                raise EvmRevert(b"")
            else:
                raise NotImplementedError(
                    f"opcode 0x{op:02x} at pc={pc - 1}"
                )
        return b""
