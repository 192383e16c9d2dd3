# Copied from zecale_tpu/zeth/merkle.py (JAX-free); only imports and build paths changed.
"""Field-element Merkle tree with MiMC-MP node compression.

Host side mirrors libsnark's merkle_tree_field as used by the rollup test
(aggregator_test.cpp:93-131: set_value / get_root / get_path); the gadget
side is the membership-path check inside the joinsplit
(libzeth merkle_path_authenticator equivalent).

Node hash: parent = MiMC_MP(left, right) (message = left child, key =
right child) over the curve's scalar field, with the per-field (e, rounds)
selection of gadgets/mimc.py.
"""

from __future__ import annotations

from typing import List

from ..gadgets import mimc
from ..gadgets.protoboard import LC, Protoboard


def node_hash(left: int, right: int, r: int) -> int:
    return mimc.mimc_mp(left, right, r)


class MerkleTreeField:
    """Dense fixed-depth Merkle tree over field elements (default leaves 0)."""

    def __init__(self, depth: int, r: int):
        self.depth = depth
        self.r = r
        self.num_leaves = 1 << depth
        # levels[0] = leaves, levels[depth] = [root]
        self._levels: List[List[int]] = []
        level = [0] * self.num_leaves
        self._levels.append(level)
        for _ in range(depth):
            level = [
                node_hash(level[2 * i], level[2 * i + 1], r)
                for i in range(len(level) // 2)
            ]
            self._levels.append(level)

    def set_value(self, address: int, value: int) -> None:
        assert 0 <= address < self.num_leaves
        self._levels[0][address] = value % self.r
        idx = address
        for lvl in range(self.depth):
            idx //= 2
            left = self._levels[lvl][2 * idx]
            right = self._levels[lvl][2 * idx + 1]
            self._levels[lvl + 1][idx] = node_hash(left, right, self.r)

    def get_root(self) -> int:
        return self._levels[self.depth][0]

    def get_path(self, address: int) -> List[int]:
        """Sibling values, leaf level first (path[i] = sibling at level i)."""
        path = []
        idx = address
        for lvl in range(self.depth):
            path.append(self._levels[lvl][idx ^ 1])
            idx //= 2
        return path


def merkle_root_gadget(
    pb: Protoboard,
    leaf: LC,
    address_bits: List[LC],
    path: List[LC],
) -> LC:
    """Recompute the root from ``leaf`` along ``path``.

    address_bits are boolean LCs, LSB-first (bit i = position at level i;
    1 means the current node is the RIGHT child)."""
    assert len(address_bits) == len(path)
    cur = leaf
    for bit, sib in zip(address_bits, path):
        left = pb.select(bit, sib, cur)
        right = pb.select(bit, cur, sib)
        cur = mimc.mimc_mp_gadget(pb, left, right)
    return cur
