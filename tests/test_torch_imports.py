"""The port must load where JAX does not exist: no module of
zecale_tpu_torch, and not chip_smoke.py, imports jax, jaxlib or the JAX
package zecale_tpu (it keeps its own copies of the JAX-free layers).  Only
the gRPC client, the CLI that drives it and the gRPC server import grpc
where they are loaded: the rest runs on a machine without it."""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "zecale_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "zecale_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    """(line, module name) of every absolute import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            yield node.lineno, n


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) > 20
    rel = {os.path.relpath(p, REPO) for p in files}
    for name in ("gadgets/blake2s.py", "zeth/__init__.py", "zeth/notes.py",
                 "zeth/merkle.py", "zeth/joinsplit.py",
                 "zeth/dev_vectors.py", "rollup_e2e.py", "batch32_e2e.py",
                 "parallel/__init__.py", "parallel/mesh.py",
                 "parallel/fft_dist.py", "parallel/sharded.py",
                 "multihost_dryrun.py", "client/__init__.py",
                 "client/aggregator_client.py", "client/cli.py",
                 "client/dispatcher_contract.py", "client/dummy_app_cli.py",
                 "client/zeth_bridge.py", "evm/__init__.py", "evm/keccak.py",
                 "evm/asm.py", "evm/contracts_asm.py", "evm/vm.py",
                 "snark/groth16_native.py", "test_client.py"):
        assert os.path.join("zecale_tpu_torch", name) in rel, name
    for path in files:
        bad += [f"{os.path.relpath(path, REPO)}:{line} {n}"
                for line, n in _imports(path) if _forbidden(n)]
    assert bad == []


#: the modules that may import grpc (anywhere in the file)
GRPC_MODULES = {"zecale_tpu_torch/api/grpc_server.py",
                "zecale_tpu_torch/client/aggregator_client.py",
                "zecale_tpu_torch/client/cli.py"}


def test_only_the_grpc_transport_and_its_client_import_grpc():
    users = {os.path.relpath(p, REPO) for p in _port_files()
             if any(n.split(".")[0] == "grpc" for _, n in _imports(p))}
    assert users == GRPC_MODULES


def test_main_path_imports_with_jax_unimportable():
    # grpc too: the card's machine may not have it, and only the serve
    # step of api/server_main.py imports it
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'zecale_tpu', 'grpc'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "import zecale_tpu_torch.snark.groth16_torch\n"
        "import zecale_tpu_torch.snark.setup_native\n"
        "import zecale_tpu_torch.aggregator.circuit\n"
        "import zecale_tpu_torch.aggregator.dummy_app\n"
        "import zecale_tpu_torch.api.server_main\n"
        "import zecale_tpu_torch.api.service\n"
        "import zecale_tpu_torch.aggregate_e2e\n"
        "import zecale_tpu_torch.bench\n"
        "import zecale_tpu_torch.graft_entry\n"
        "import zecale_tpu_torch.utils.profiling\n"
        "import zecale_tpu_torch.contracts.dispatcher\n"
        "import zecale_tpu_torch.snark.pghr13\n"
        "import zecale_tpu_torch.snark.pghr13_torch\n"
        "import zecale_tpu_torch.native.pairing\n"
        "import zecale_tpu_torch.gadgets.pghr13_verifier\n"
        "import zecale_tpu_torch.gadgets.mnt_pairing_gadget\n"
        "import zecale_tpu_torch.gadgets.blake2s\n"
        "import zecale_tpu_torch.zeth\n"
        "import zecale_tpu_torch.zeth.notes\n"
        "import zecale_tpu_torch.zeth.merkle\n"
        "import zecale_tpu_torch.zeth.joinsplit\n"
        "import zecale_tpu_torch.zeth.dev_vectors\n"
        "import zecale_tpu_torch.rollup_e2e\n"
        "import zecale_tpu_torch.batch32_e2e\n"
        "import zecale_tpu_torch.parallel\n"
        "import zecale_tpu_torch.parallel.mesh\n"
        "import zecale_tpu_torch.parallel.fft_dist\n"
        "import zecale_tpu_torch.parallel.sharded\n"
        "import zecale_tpu_torch.multihost_dryrun\n"
        "import zecale_tpu_torch.snark.groth16_native\n"
        "import zecale_tpu_torch.test_client\n"
        "import zecale_tpu_torch.client\n"
        "import zecale_tpu_torch.client.dispatcher_contract\n"
        "import zecale_tpu_torch.client.dummy_app_cli\n"
        "import zecale_tpu_torch.client.zeth_bridge\n"
        "import zecale_tpu_torch.evm.keccak\n"
        "import zecale_tpu_torch.evm.asm\n"
        "import zecale_tpu_torch.evm.contracts_asm\n"
        "import zecale_tpu_torch.evm.vm\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'zecale_tpu') and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
