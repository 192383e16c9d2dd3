# Copied from zecale_tpu/zeth/__init__.py (JAX-free); only imports and build paths changed.
"""TPU-native equivalent of the libzeth pieces the reference's rollup test
depends on (SURVEY.md §2b: libzeth circuit_wrapper, merkle tree, BLAKE2s and
MiMC gadgets; reference user: libzecale/tests/aggregator/aggregator_test.cpp).

The zeth submodule is absent from the reference snapshot, so this package is
a fresh implementation of the published Zeth protocol shape (2-in/2-out
joinsplit, BLAKE2s PRFs/commitments, MiMC Merkle tree, single hashed primary
input); bit-compatibility with zeth binaries cannot be validated here
(KNOWN_GAPS.md).
"""
