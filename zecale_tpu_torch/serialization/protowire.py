# Copied from zecale_tpu/serialization/protowire.py (JAX-free); unchanged but for this line.
"""Hand-rolled proto3 wire-format codec for the Aggregator API messages.

grpcio-tools (protobuf codegen) is not in the image, but the proto3 wire
format itself is tiny: varints + length-delimited fields.  This module
encodes/decodes exactly the messages of proto/zecale/api/aggregator.proto
(mirroring the reference service contract, reference
proto/zecale/api/aggregator.proto:9-79), giving the service a real
protobuf-wire transport; the canonical-JSON transport remains available as
a fallback (proto/README.md).

Messages are represented as plain dicts keyed by field name.  Scalar kinds:
``string``, ``bytes``, ``int64``; ``(MSG, schema)`` nests; a kind wrapped in
``repeated(...)`` accepts/produces lists.  Unknown fields are skipped on
decode (proto3 semantics); default values are omitted on encode.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5


class repeated:
    def __init__(self, kind):
        self.kind = kind


MSG = "msg"


# ---------------------------------------------------------------------------
# varint primitives
# ---------------------------------------------------------------------------


def write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 10 bytes (proto3 int64)
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    result = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _int64_from_u64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


# ---------------------------------------------------------------------------
# message encode/decode
# ---------------------------------------------------------------------------


def _encode_field(out: bytearray, num: int, kind, value,
                  in_repeated: bool = False) -> None:
    if isinstance(kind, repeated):
        for v in value:
            _encode_field(out, num, kind.kind, v, in_repeated=True)
        return
    if kind == "int64":
        if value == 0 and not in_repeated:
            return
        write_varint(out, (num << 3) | _WT_VARINT)
        write_varint(out, int(value))
        return
    if kind == "string":
        data = value.encode("utf-8")
    elif kind == "bytes":
        data = bytes(value)
    elif isinstance(kind, tuple) and kind[0] == MSG:
        data = encode(kind[1], value)
    else:
        raise TypeError(f"unsupported kind {kind!r}")
    if (
        not data
        and not in_repeated
        and not (isinstance(kind, tuple) and kind[0] == MSG)
    ):
        return  # proto3 default: empty singular string/bytes omitted
    write_varint(out, (num << 3) | _WT_LEN)
    write_varint(out, len(data))
    out.extend(data)


def encode(schema: Dict[int, Tuple[str, object]], msg: dict) -> bytes:
    out = bytearray()
    for num in sorted(schema):
        name, kind = schema[num]
        if name in msg and msg[name] is not None:
            _encode_field(out, num, kind, msg[name])
    return bytes(out)


def _skip(buf: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = read_varint(buf, pos)
    elif wt == _WT_LEN:
        ln, pos = read_varint(buf, pos)
        pos += ln
    elif wt == _WT_I64:
        pos += 8
    elif wt == _WT_I32:
        pos += 4
    else:
        raise ValueError(f"unknown wire type {wt}")
    return pos


def decode(schema: Dict[int, Tuple[str, object]], buf: bytes) -> dict:
    msg: dict = {}
    # proto3 defaults
    for num, (name, kind) in schema.items():
        if isinstance(kind, repeated):
            msg[name] = []
        elif kind == "int64":
            msg[name] = 0
        elif kind in ("string",):
            msg[name] = ""
        elif kind == "bytes":
            msg[name] = b""
        else:
            msg[name] = None
    pos = 0
    while pos < len(buf):
        tag, pos = read_varint(buf, pos)
        num, wt = tag >> 3, tag & 7
        if num not in schema:
            pos = _skip(buf, pos, wt)
            continue
        name, kind = schema[num]
        base = kind.kind if isinstance(kind, repeated) else kind
        if base == "int64":
            u, pos = read_varint(buf, pos)
            val = _int64_from_u64(u)
        else:
            ln, pos = read_varint(buf, pos)
            data = buf[pos : pos + ln]
            if len(data) != ln:
                raise ValueError("truncated field")
            pos += ln
            if base == "string":
                val = data.decode("utf-8")
            elif base == "bytes":
                val = bytes(data)
            elif isinstance(base, tuple) and base[0] == MSG:
                val = decode(base[1], data)
            else:
                raise TypeError(f"unsupported kind {base!r}")
        if isinstance(kind, repeated):
            msg[name].append(val)
        else:
            msg[name] = val
    return msg


# ---------------------------------------------------------------------------
# aggregator.proto schemas (field numbers from proto/zecale/api/aggregator.proto)
# ---------------------------------------------------------------------------

EMPTY: Dict[int, Tuple[str, object]] = {}

PAIRING_PARAMETERS = {
    1: ("name", "string"),
    2: ("r", "string"),
    3: ("q", "string"),
    4: ("generator_g1", repeated("string")),
    5: ("generator_g2", repeated("string")),
}

AGGREGATOR_CONFIGURATION = {
    1: ("nested_snark_name", "string"),
    2: ("wrapper_snark_name", "string"),
    3: ("nested_pairing_parameters", (MSG, PAIRING_PARAMETERS)),
    4: ("wrapper_pairing_parameters", (MSG, PAIRING_PARAMETERS)),
}

# Structured group-element messages (round 3).  The reference imports
# zeth's snark_messages.proto / ec_group_messages.proto for these; the
# zeth submodule is absent from the snapshot, so exact zeth field
# numbering is unverifiable — these carry the same information at the
# message level (hex coordinate strings; G2 coordinates as 1..3
# components depending on the twist field).  PGHR13 payloads use the
# canonical-JSON fallback field.
G1_POINT = {1: ("x", "string"), 2: ("y", "string")}

G2_POINT = {
    1: ("x", repeated("string")),
    2: ("y", repeated("string")),
}

GROTH16_VERIFICATION_KEY = {
    1: ("alpha", (MSG, G1_POINT)),
    2: ("beta", (MSG, G2_POINT)),
    3: ("delta", (MSG, G2_POINT)),
    4: ("abc", repeated((MSG, G1_POINT))),
}

GROTH16_PROOF = {
    1: ("a", (MSG, G1_POINT)),
    2: ("b", (MSG, G2_POINT)),
    3: ("c", (MSG, G1_POINT)),
}

VERIFICATION_KEY = {
    1: ("json", "string"),  # PGHR13 / fallback
    2: ("groth16", (MSG, GROTH16_VERIFICATION_KEY)),
}

VERIFICATION_KEY_HASH = {1: ("hash", "string")}

APPLICATION_DESCRIPTION = {
    1: ("application_name", "string"),
    2: ("vk", (MSG, VERIFICATION_KEY)),
}

EXTENDED_PROOF = {
    1: ("json", "string"),  # PGHR13 / fallback
    2: ("groth16", (MSG, GROTH16_PROOF)),
    3: ("inputs", repeated("string")),
}

NESTED_TRANSACTION = {
    1: ("application_name", "string"),
    2: ("extended_proof", (MSG, EXTENDED_PROOF)),
    3: ("parameters", "bytes"),
    4: ("fee_in_wei", "int64"),
}

AGGREGATED_TRANSACTION_REQUEST = {1: ("application_name", "string")}

AGGREGATED_TRANSACTION = {
    1: ("application_name", "string"),
    2: ("extended_proof", (MSG, EXTENDED_PROOF)),
    3: ("nested_parameters", repeated("bytes")),
}


# ---------------------------------------------------------------------------
# service-dict <-> proto-dict converters (the service layer speaks the
# canonical-JSON dict shapes of serialization/json_codec.py)
# ---------------------------------------------------------------------------

import json as _json


def _gen_elem_to_str(e) -> str:
    # G1 generator coords are hex strings; G2 coords over extension fields
    # are (nested) lists — carried as their canonical JSON text
    return e if isinstance(e, str) else _json.dumps(e, sort_keys=True)


def _gen_elem_from_str(s: str):
    return _json.loads(s) if s.startswith(("[", "{")) else s


def config_to_proto(cfg: dict) -> dict:
    out = dict(cfg)
    for k in ("nested_pairing_parameters", "wrapper_pairing_parameters"):
        pp = dict(cfg[k])
        for g in ("generator_g1", "generator_g2"):
            pp[g] = [_gen_elem_to_str(e) for e in pp[g]]
        out[k] = pp
    return out


def config_from_proto(msg: dict) -> dict:
    out = dict(msg)
    for k in ("nested_pairing_parameters", "wrapper_pairing_parameters"):
        pp = dict(msg[k])
        for g in ("generator_g1", "generator_g2"):
            pp[g] = [_gen_elem_from_str(e) for e in pp[g]]
        out[k] = pp
    return out


def _g1_to_msg(pt) -> dict:
    return {"x": pt[0], "y": pt[1]}


def _g1_from_msg(m) -> list:
    return [m["x"], m["y"]]


def _g2_to_msg(pt) -> dict:
    def comps(c):
        return [c] if isinstance(c, str) else list(c)

    return {"x": comps(pt[0]), "y": comps(pt[1])}


def _g2_from_msg(m) -> list:
    def un(comps):
        return comps[0] if len(comps) == 1 else list(comps)

    return [un(m["x"]), un(m["y"])]


def vk_to_proto(vk_json: dict) -> dict:
    if {"alpha", "beta", "delta", "ABC"} <= set(vk_json):  # Groth16
        return {
            "groth16": {
                "alpha": _g1_to_msg(vk_json["alpha"]),
                "beta": _g2_to_msg(vk_json["beta"]),
                "delta": _g2_to_msg(vk_json["delta"]),
                "abc": [_g1_to_msg(p) for p in vk_json["ABC"]],
            }
        }
    return {"json": _json.dumps(vk_json, sort_keys=True)}


def vk_from_proto(msg: dict) -> dict:
    g = msg.get("groth16")
    if g:
        return {
            "alpha": _g1_from_msg(g["alpha"]),
            "beta": _g2_from_msg(g["beta"]),
            "delta": _g2_from_msg(g["delta"]),
            "ABC": [_g1_from_msg(p) for p in g.get("abc", [])],
        }
    return _json.loads(msg["json"])


def ext_proof_to_proto(ep_json: dict) -> dict:
    p = ep_json.get("proof", {})
    if {"a", "b", "c"} <= set(p):  # Groth16
        return {
            "groth16": {
                "a": _g1_to_msg(p["a"]),
                "b": _g2_to_msg(p["b"]),
                "c": _g1_to_msg(p["c"]),
            },
            "inputs": list(ep_json.get("inputs", [])),
        }
    return {"json": _json.dumps(ep_json, sort_keys=True)}


def ext_proof_from_proto(msg: dict) -> dict:
    g = msg.get("groth16")
    if g:
        return {
            "proof": {
                "a": _g1_from_msg(g["a"]),
                "b": _g2_from_msg(g["b"]),
                "c": _g1_from_msg(g["c"]),
            },
            "inputs": list(msg.get("inputs", [])),
        }
    return _json.loads(msg["json"])


def nested_tx_to_proto(tx_json: dict) -> dict:
    return {
        "application_name": tx_json["app_name"],
        "extended_proof": ext_proof_to_proto(tx_json["extended_proof"]),
        "parameters": bytes.fromhex(tx_json.get("parameters", "")),
        "fee_in_wei": int(tx_json.get("fee_in_wei", 0)),
    }


def nested_tx_from_proto(msg: dict) -> dict:
    return {
        "app_name": msg["application_name"],
        "extended_proof": ext_proof_from_proto(msg["extended_proof"]),
        "parameters": msg["parameters"].hex(),
        "fee_in_wei": msg["fee_in_wei"],
    }


def agg_tx_to_proto(agg_json: dict) -> dict:
    return {
        "application_name": agg_json["app_name"],
        "extended_proof": ext_proof_to_proto(agg_json["ext_proof"]),
        "nested_parameters": [
            bytes.fromhex(p) for p in agg_json["nested_parameters"]
        ],
    }


def agg_tx_from_proto(msg: dict) -> dict:
    return {
        "app_name": msg["application_name"],
        "ext_proof": ext_proof_from_proto(msg["extended_proof"]),
        "nested_parameters": [p.hex() for p in msg["nested_parameters"]],
    }
