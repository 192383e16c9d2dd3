"""The port must load where JAX does not exist: no module of
zecale_tpu_torch, and not chip_smoke.py, imports jax, jaxlib or the JAX
package zecale_tpu (it keeps its own copies of the JAX-free layers)."""

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


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert bad == []


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
