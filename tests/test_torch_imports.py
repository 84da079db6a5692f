"""The port imports neither JAX nor the JAX package, nor the JAX host
tier's third-party packages.

A fresh interpreter imports every module of ``cyberfabric_core_tpu_torch``
and ``chip_smoke.py``'s imports; afterwards no ``jax*`` and no
``cyberfabric_core_tpu`` module may have been loaded by them, and none of
the packages the JAX host tier serves with but the port does without
(``aiohttp``, ``yaml``, ``jsonschema``, ``pydantic``, ``cryptography``,
``psycopg``). An AST scan of the package's sources finds no such import
statement either.

``grpc`` (with ``google.protobuf``) is the one host package the port
imports: the federation's wire is the JAX package's ``llmworker.v1`` and
``directory.v1`` protobuf over ``grpc.aio``, so a JAX gateway and a port
worker serve each other, and the card's machine has both installed
(ROADMAP departure 16)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "cyberfabric_core_tpu_torch"


def _modules() -> list[str]:
    out = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


#: third-party packages of the JAX host tier the port does without (aiohttp
#: and jsonschema leave the list when the port's HTTP tier moves onto them,
#: ROADMAP queue 1 item 1)
HOST_ONLY = ("aiohttp", "yaml", "jsonschema", "pydantic", "cryptography", "psycopg")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "cyberfabric_core_tpu"


def _host_only(name: str) -> bool:
    return name.split(".")[0] in HOST_ONLY


def _loaded() -> list[str]:
    """Modules a fresh interpreter loads importing the port and chip_smoke."""
    script = (
        "import importlib, json, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def _import_statements() -> list[tuple[str, str]]:
    """(file, imported module) for every absolute import of the port and
    chip_smoke.py."""
    out = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            out += [(path.name, n) for n in names]
    return out


def test_port_and_chip_smoke_load_no_jax():
    loaded = _loaded()
    assert "cyberfabric_core_tpu_torch.runtime.scheduler" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_jax_import_statements_in_the_port():
    assert [f"{f}: {n}" for f, n in _import_statements() if _forbidden(n)] == []


def test_port_and_chip_smoke_load_no_host_only_package():
    loaded = _loaded()
    assert "cyberfabric_core_tpu_torch.server" in loaded
    assert "cyberfabric_core_tpu_torch.modules.llm_gateway.worker" in loaded
    assert [m for m in loaded if _host_only(m)] == []


def test_no_host_only_import_statements_in_the_port():
    assert [f"{f}: {n}" for f, n in _import_statements() if _host_only(n)] == []
