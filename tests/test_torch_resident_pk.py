"""The resident device key of the device provers
(``TorchSnarkBase.resident_pk``, zecale_tpu_torch/snark/groth16_torch.py)
on the CPU: ``Groth16Torch`` on the BW6-761 and BLS12-377 dummy
applications and ``Pghr13Torch`` on BLS12-377.  A prover packs a host key
once and reuses it while later proves give the same key object; another
object, or another ``num_pub``, packs again and takes the slot; a given
``device_pk`` bypasses the slot.  Tolerance: exact -- every proof point
equal to a freshly packed key's.  The tests of the slot's rules stop
each prove after its key (``key_step``); one test a case proves in full."""

import copy
import functools
import os
import random
import sys
import threading
import time

import pytest
import torch

from zecale_tpu_torch.aggregator import dummy_app as da
from zecale_tpu_torch.snark import groth16_torch, pghr13_torch
from zecale_tpu_torch.snark.groth16_torch import Groth16Torch
from zecale_tpu_torch.snark.pghr13_torch import Pghr13Torch

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

#: (prover class, curve); the keypairs come from the host setups
CASES = [(Groth16Torch, "bw6-761"), (Groth16Torch, "bls12-377"),
         (Pghr13Torch, "bls12-377")]
IDS = ["groth16-bw6-761", "groth16-bls12-377", "pghr13-bls12-377"]
SEED = 2 ** 31 + 77


@functools.lru_cache(maxsize=None)
def _app(cls, curve):
    """The dummy application's R1CS, keypair and assignment (a = 9)."""
    r1cs = da.dummy_app_r1cs(curve)
    snark = "GROTH16" if cls is Groth16Torch else "PGHR13"
    kp = da.dummy_app_setup(curve, random.Random(5), snark)[1]
    return r1cs, kp, da.dummy_app_assignment(curve, 9)


def _counted(monkeypatch, prover):
    """Count the prover's ``pack_pk`` calls -> the list of host keys it
    packed, in order."""
    packed = []
    pack = prover.pack_pk

    def counting(pk, *args):
        packed.append(pk)
        return pack(pk, *args)

    monkeypatch.setattr(prover, "pack_pk", counting)
    return packed


def _args(prover, r1cs):
    """``pack_pk``'s arguments after the host key, as ``prove`` gives
    them."""
    return (r1cs.num_primary + 1,) if isinstance(prover, Groth16Torch) \
        else ()


def _points(proof):
    return tuple(sorted(vars(proof).items()))


def _prove(prover, r1cs, pk, asg, **kw):
    return _points(prover.prove(r1cs, pk, asg, random.Random(SEED), **kw))


class _Stop(Exception):
    pass


@pytest.fixture
def key_step(monkeypatch):
    """``key_step(prover, r1cs, pk, asg, **kw)`` runs ``prove`` up to the
    A/B/C evaluations, which follow the key's lookup in both provers, and
    stops there: the slot's rules without the MSMs' minutes on the
    CPU."""
    def stop(*a):
        raise _Stop

    monkeypatch.setattr(groth16_torch, "abc_evaluations", stop)
    monkeypatch.setattr(pghr13_torch, "abc_evaluations", stop)

    def run(prover, r1cs, pk, asg, **kw):
        with pytest.raises(_Stop):
            prover.prove(r1cs, pk, asg, random.Random(SEED), **kw)
    return run


@pytest.mark.parametrize("cls, curve", CASES, ids=IDS)
def test_same_key_packs_once(monkeypatch, key_step, cls, curve):
    r1cs, kp, asg = _app(cls, curve)
    prover = cls(curve, device="cpu")
    packed = _counted(monkeypatch, prover)
    for _ in range(3):
        key_step(prover, r1cs, kp.pk, asg)
    assert packed == [kp.pk]


@pytest.mark.parametrize("cls, curve", CASES, ids=IDS)
def test_a_hit_proves_as_a_fresh_pack_and_a_given_key(monkeypatch, cls,
                                                      curve):
    """The prover's first prove packs, as a fresh prover does; its second
    finds the key resident; a third prover is given a key packed
    beforehand.  One rng state: one proof."""
    r1cs, kp, asg = _app(cls, curve)
    prover = cls(curve, device="cpu")
    packed = _counted(monkeypatch, prover)
    fresh = _prove(prover, r1cs, kp.pk, asg)
    hit = _prove(prover, r1cs, kp.pk, asg)
    assert packed == [kp.pk]
    given = cls(curve, device="cpu")
    dpk = given.pack_pk(kp.pk, *_args(given, r1cs))
    assert hit == fresh
    assert _prove(given, r1cs, kp.pk, asg, device_pk=dpk) == fresh


@pytest.mark.parametrize("cls, curve", CASES, ids=IDS)
def test_another_key_object_packs_again_and_takes_the_slot(
        monkeypatch, key_step, cls, curve):
    r1cs, kp, asg = _app(cls, curve)
    pk2 = copy.copy(kp.pk)
    prover = cls(curve, device="cpu")
    packed = _counted(monkeypatch, prover)
    for pk in (kp.pk, pk2, pk2):
        key_step(prover, r1cs, pk, asg)
    assert [id(p) for p in packed] == [id(kp.pk), id(pk2)]
    assert prover._resident[0] is pk2
    key_step(prover, r1cs, kp.pk, asg)  # the copy took the slot
    assert [id(p) for p in packed] == [id(kp.pk), id(pk2), id(kp.pk)]


@pytest.mark.parametrize("cls, curve", CASES, ids=IDS)
def test_a_given_device_key_neither_reads_nor_replaces_the_slot(
        monkeypatch, key_step, cls, curve):
    r1cs, kp, asg = _app(cls, curve)
    prover = cls(curve, device="cpu")
    key_step(prover, r1cs, kp.pk, asg)  # packs: the slot holds kp.pk
    slot = prover._resident
    dpk = cls(curve, device="cpu").pack_pk(kp.pk, *_args(prover, r1cs))

    def refused(*a):
        raise AssertionError("resident_pk called with device_pk given")

    with monkeypatch.context() as m:
        m.setattr(prover, "resident_pk", refused)
        key_step(prover, r1cs, copy.copy(kp.pk), asg, device_pk=dpk)
    assert prover._resident is slot
    packed = _counted(monkeypatch, prover)
    key_step(prover, r1cs, kp.pk, asg)
    assert packed == []


@pytest.mark.parametrize("curve", ["bw6-761", "bls12-377"])
def test_another_num_pub_packs_again(monkeypatch, curve):
    r1cs, kp, _ = _app(Groth16Torch, curve)
    prover = Groth16Torch(curve, device="cpu")
    packed = _counted(monkeypatch, prover)
    n = r1cs.num_primary + 1
    dpk, hit = prover.resident_pk(kp.pk, n)
    assert (hit, dpk.num_pub) == (False, n)
    again, hit = prover.resident_pk(kp.pk, n)
    assert hit and again is dpk
    dpk2, hit = prover.resident_pk(kp.pk, n + 1)
    assert (hit, dpk2.num_pub) == (False, n + 1)
    again, hit = prover.resident_pk(kp.pk, n + 1)
    assert hit and again is dpk2
    assert len(packed) == 2


def test_threads_with_one_key_pack_it_once(monkeypatch):
    """More threads than cores start with one key at once, switching
    every microsecond: one packs it, every other finds it resident."""
    curve = "bls12-377"
    r1cs, kp, _ = _app(Groth16Torch, curve)
    prover = Groth16Torch(curve, device="cpu")
    pack = prover.pack_pk
    packed = []

    def slow(pk, *args):
        packed.append(pk)
        time.sleep(0.05)  # the other threads reach the slot meanwhile
        return pack(pk, *args)

    monkeypatch.setattr(prover, "pack_pk", slow)
    n = 2 * (os.cpu_count() or 1) + 2
    start = threading.Barrier(n, timeout=30)
    got = [None] * n

    def run(i):
        start.wait()
        got[i] = prover.resident_pk(kp.pk, r1cs.num_primary + 1)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(packed) == 1
    assert all(dpk is got[0][0] for dpk, _ in got)
    assert sorted(hit for _, hit in got) == [False] + [True] * (n - 1)
