"""The port's on-chain model, zecale_tpu_torch/evm/ (keccak, the assembler,
the hand-assembled contracts and the interpreter with its BW6-761
precompiles) and the on-chain commands of zecale_tpu_torch/client/,
against the JAX package's: keccak-256 on seeded inputs, the contracts'
bytecode and calldata at batch 1, 2 and 8, and the settlement of a BW6-761
Groth16 proof made by the port's Groth16Native on a small R1CS with the
dispatcher's input layout [vk_hash, results, inputs...] -- the same return
data, storage, logs and gas on both interpreters -- then the CLI's
deploy, submit-batch --wait, read-back, invalid and replayed batches on
that proof.  Nothing here reads golden files.  Tolerance: exact."""

import contextlib
import functools
import io
import json
import random

import pytest
import torch

from zecale_tpu.contracts import dispatcher as ref_dp
from zecale_tpu.evm import contracts_asm as ref_asm
from zecale_tpu.evm import keccak as ref_keccak
from zecale_tpu.evm import vm as ref_vm
from zecale_tpu_torch.client import cli as zcli
from zecale_tpu_torch.client import dummy_app_cli as app_cli
from zecale_tpu_torch.client.dispatcher_contract import (
    DispatcherContract, DummyAppContract)
from zecale_tpu_torch.contracts import dispatcher as dp
from zecale_tpu_torch.evm import asm, contracts_asm, keccak, vm
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.native import ec as nec
from zecale_tpu_torch.serialization import json_codec as jc
from zecale_tpu_torch.snark.groth16 import ExtendedProof
from zecale_tpu_torch.snark.groth16_native import Groth16Native
from zecale_tpu_torch.snark.r1cs import R1CS

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

R = P.CURVES["bw6-761"].r


@pytest.mark.parametrize("n", [0, 1, 31, 32, 135, 136, 137, 272, 1000])
def test_keccak256_equals_the_jax_packages(n):
    data = random.Random(n).randbytes(n)
    assert keccak.keccak256(data) == ref_keccak.keccak256(data)
    assert asm.selector("get(uint256)") == ref_asm.selector("get(uint256)")


def test_keccak256_known_answer():
    assert keccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_bytecode_and_calldata_equal_the_jax_packages(batch):
    assert contracts_asm.dispatcher_code() == ref_asm.dispatcher_code()
    assert (contracts_asm.dummy_application_code()
            == ref_asm.dummy_application_code())
    assert (contracts_asm.groth16_verifier_test_code()
            == ref_asm.groth16_verifier_test_code())
    rng = random.Random(batch)
    vk_words = [rng.getrandbits(256) for _ in range(6 * (3 + 3 + batch))]
    proof_words = [rng.getrandbits(256) for _ in range(18)]
    input_words = [rng.getrandbits(256) for _ in range(2 * (2 + batch))]
    params = [contracts_asm.encode_app_parameters(rng.getrandbits(64))
              for _ in range(batch)]
    assert params == [ref_asm.encode_app_parameters(
        int.from_bytes(p[64:], "big")) for p in params]
    assert (contracts_asm.encode_init_dispatcher(vk_words, batch)
            == ref_asm.encode_init_dispatcher(vk_words, batch))
    assert (contracts_asm.encode_process_batch(proof_words, input_words,
                                               params, 0xAB)
            == ref_asm.encode_process_batch(proof_words, input_words,
                                            params, 0xAB))
    assert (contracts_asm.encode_test_verify(vk_words, proof_words,
                                             input_words)
            == ref_asm.encode_test_verify(vk_words, proof_words,
                                          input_words))
    assert (contracts_asm.encode_init_app(0xAB, (1, 2))
            == ref_asm.encode_init_app(0xAB, (1, 2)))
    assert contracts_asm.encode_get(7) == ref_asm.encode_get(7)


# ---------------------------------------------------------------------------
# a real BW6-761 Groth16 batch proof in the dispatcher's layout
# ---------------------------------------------------------------------------

needs_native = pytest.mark.skipif(not nec.available(),
                                  reason="native toolchain unavailable")

VK_HASH = random.Random(1).randrange(R)


@functools.lru_cache(maxsize=None)
def batch_proof(batch: int, results: int):
    """(keypair, ExtendedProof) of a circuit with the dispatcher's primary
    inputs [vk_hash, results, s_1 .. s_batch] (s_i = 7 + i), each bound by
    a row v * 1 == v, and one product row, proved by Groth16Native."""
    cs = R1CS(r=R, num_primary=2 + batch, num_aux=1)
    for v in range(1, 3 + batch):
        cs.add_constraint([(v, 1)], [(0, 1)], [(v, 1)])
    cs.add_constraint([(3, 1)], [(3, 1)], [(3 + batch, 1)])
    primary = [VK_HASH, results] + [7 + i for i in range(batch)]
    asg = [1] + primary + [49]
    assert cs.is_satisfied(asg)
    prover = Groth16Native("bw6-761")
    rng = random.Random(batch)
    kp = prover.generate_setup(cs, rng)
    proof = prover.prove(cs, kp.pk, asg, rng)
    assert prover.verify(primary, proof, kp.vk)
    return kp, ExtendedProof(proof=proof, inputs=primary)


def _settle(vm_mod, asm_mod, dp_mod, kp, ep, batch, params):
    """Deploy the dispatcher and the dummy application on a fresh chain of
    ``vm_mod`` and process the batch: -> (chain, return data, gas, the
    application's answers for each scalar)."""
    chain = vm_mod.Chain()
    disp = chain.deploy(asm_mod.dispatcher_code())
    app = chain.deploy(asm_mod.dummy_application_code())
    chain.call(disp, asm_mod.encode_init_dispatcher(
        dp_mod.vk_to_contract_parameters(kp.vk), batch))
    words = dp_mod.inputs_to_contract_parameters(ep.inputs)
    chain.call(app, asm_mod.encode_init_app(disp, (words[0], words[1])))
    ret, gas = chain.call(disp, asm_mod.encode_process_batch(
        dp_mod.proof_to_contract_parameters(ep.proof), words, params, app))
    got = [int.from_bytes(chain.call(app, asm_mod.encode_get(s))[0], "big")
           for s in ep.inputs[2:]]
    return chain, ret, gas, got


def _state(chain):
    return ({a: dict(acct.storage) for a, acct in chain.accounts.items()},
            [(lg.address, list(lg.topics), lg.data) for lg in chain.logs])


@needs_native
@pytest.mark.parametrize("batch, results", [(1, 1), (2, 3), (2, 2)])
def test_process_batch_equals_the_jax_vm(batch, results):
    kp, ep = batch_proof(batch, results)
    params = [contracts_asm.encode_app_parameters(0xAA00 + i)
              for i in range(batch)]
    chain, ret, gas, got = _settle(vm, contracts_asm, dp, kp, ep, batch,
                                   params)
    ref_chain, ref_ret, ref_gas, ref_got = _settle(
        ref_vm, ref_asm, ref_dp, kp, ep, batch, params)
    assert int.from_bytes(ret, "big") == 1
    assert (ret, gas, got) == (ref_ret, ref_gas, ref_got)
    assert _state(chain) == _state(ref_chain)
    assert chain.to_json() == ref_chain.to_json()
    # a result bit of 0 skips its scalar
    assert got == [0xAA00 + i if (results >> i) & 1 else 0
                   for i in range(batch)]


@needs_native
def test_tampered_input_reverts_on_both_vms():
    kp, ep = batch_proof(2, 3)
    bad = ExtendedProof(proof=ep.proof, inputs=ep.inputs[:2]
                        + [ep.inputs[2] + 1, ep.inputs[3]])
    params = [contracts_asm.encode_app_parameters(1)] * 2
    for vm_mod, asm_mod, dp_mod in ((vm, contracts_asm, dp),
                                    (ref_vm, ref_asm, ref_dp)):
        with pytest.raises(vm_mod.EvmRevert):
            _settle(vm_mod, asm_mod, dp_mod, kp, bad, 2, params)


# ---------------------------------------------------------------------------
# the CLI's on-chain flow on that proof
# ---------------------------------------------------------------------------


def _run(main, *argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(list(argv))
    return rc, out.getvalue()


@needs_native
def test_cli_onchain_flow(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kp, ep = batch_proof(2, 3)
    with open("aggregator-vk.json", "w") as f:
        json.dump(jc.groth16_vk_to_json("bw6-761", kp.vk), f)

    def write_batch(path, ext_proof, values):
        with open(path, "w") as f:
            json.dump({"app_name": "dummy",
                       "ext_proof": jc.extended_proof_to_json("bw6-761",
                                                              ext_proof),
                       "nested_parameters": [
                           contracts_asm.encode_app_parameters(v).hex()
                           for v in values]}, f)

    write_batch("batch.json", ep, [0xAAA1, 0xBBB2])
    assert _run(zcli.main, "deploy", "--vk", "aggregator-vk.json",
                "--batch-size", "2")[0] == 0
    assert _run(app_cli.main, "--eth-network", "eth-chain.json", "deploy",
                hex(VK_HASH), "--instance", "app-instance")[0] == 0

    rc, out = _run(zcli.main, "submit-batch", "batch.json", "--app-address",
                   "app-instance", "--wait")
    assert rc == 0
    gas = int(out.split("gasUsed = ")[1].split()[0])
    assert gas > 100_000
    for s, v in zip(ep.inputs[2:], (0xAAA1, 0xBBB2)):
        assert _run(app_cli.main, "--eth-network", "eth-chain.json", "get",
                    hex(s), "--instance", "app-instance", "--check",
                    hex(v))[0] == 0
    assert _run(app_cli.main, "--eth-network", "eth-chain.json", "get",
                hex(99), "--instance", "app-instance")[0] == 1

    # a tampered proof input: the verifier rejects, the settlement reverts
    bad = ExtendedProof(proof=ep.proof, inputs=ep.inputs[:2]
                        + [ep.inputs[2] + 2, ep.inputs[3] + 2])
    write_batch("bad.json", bad, [1, 2])
    assert _run(zcli.main, "submit-batch", "bad.json", "--app-address",
                "app-instance")[0] == 1
    # the replay: its scalars were seen
    assert _run(zcli.main, "submit-batch", "batch.json", "--app-address",
                "app-instance")[0] == 1

    # the chain-state file holds what the handles read
    chain = vm.Chain.load("eth-chain.json")
    disp = DispatcherContract.load_instance(chain, "zecale-instance")
    app = DummyAppContract.load_instance(chain, "app-instance")
    assert disp.batch_size == 2
    assert app.get(ep.inputs[2]) == 0xAAA1
