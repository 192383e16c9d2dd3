# Copied from zecale_tpu/aggregator/pool.py (JAX-free); unchanged but for this line.
"""Transaction pool: per-application fee-prioritized nested-transaction
queues.

Reference analogs: nested_transaction (libzecale/core/nested_transaction.
{hpp,tcc}) and application_pool (libzecale/core/application_pool.{hpp,tcc}):
transactions are ordered by fee (highest first) and batches are only
returned WHOLE — fewer than batch_size pending transactions yields nothing
(application_pool.tcc:48-63).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import List, Optional

from ..snark.groth16 import ExtendedProof, Groth16VerificationKey


@dataclasses.dataclass
class NestedTransaction:
    """A submitted proof plus application routing data.

    ``parameters`` is the opaque application payload forwarded on-chain
    (reference: nested_transaction.hpp:17-51).
    """

    application_name: str
    extended_proof: ExtendedProof
    parameters: bytes = b""
    fee_in_wei: int = 0


@dataclasses.dataclass
class AggregatedTransaction:
    application_name: str
    extended_proof: ExtendedProof  # the wrapping proof
    nested_parameters: List[bytes] = dataclasses.field(default_factory=list)


class ApplicationPool:
    """Fee-priority queue of nested transactions for one application."""

    def __init__(
        self,
        name: str,
        vk: Groth16VerificationKey,
        batch_size: int,
    ):
        self.name = name
        self.vk = vk
        self.batch_size = batch_size
        self._heap: list = []
        self._counter = itertools.count()  # FIFO tiebreak for equal fees

    def add_tx(self, tx: NestedTransaction) -> None:
        heapq.heappush(self._heap, (-tx.fee_in_wei, next(self._counter), tx))

    @property
    def size(self) -> int:
        return len(self._heap)

    def get_next_batch(self) -> Optional[List[NestedTransaction]]:
        """Pop exactly batch_size transactions (highest fee first), or None
        if fewer are pending (whole batches only, like the reference)."""
        if len(self._heap) < self.batch_size:
            return None
        return [heapq.heappop(self._heap)[2] for _ in range(self.batch_size)]
