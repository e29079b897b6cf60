"""AST lint: source-tree invariants of the port, with no import of the
checked code; port of ``repro/analysis/ast_lint.py``.

Walks every ``.py`` under ``src/repro_torch/`` with the stdlib ``ast``
module.  Calls are resolved through each module's own imports
(``import torch.distributed as dist`` makes ``dist.all_reduce`` the
``torch.distributed.all_reduce`` it names), so a same-named helper of
another module is not mistaken for the library's collective:

* AS001: a raw ``torch.distributed`` collective outside ``comm/`` and
  ``dist/``.  ``comm/dispatch.py`` is the only place that issues them
  (``dist/overlap.py`` drives its ring through ``comm``); ``launch/mesh.py``
  only sets the groups up, which is no collective.
* AS002: a kernel entry point (the ``kernels/ops.py`` wrappers that
  launch K1, K3, K4 and K5, and the launchers of
  ``kernels/dequant_matmul.py``) called outside ``kernels/``; the rest of
  the package goes through ``kernels/dispatch.py``.  ``ops.flash_attention``
  is not among them: ``models/common.py`` calls it, as the reference's
  models call theirs.
* AS003: a dataclass in a spec module that is not frozen (specs key
  captured steps and engines' plans).
* AS004: a mutable default argument anywhere in the package.
"""

from __future__ import annotations

import ast
import os
from typing import Optional

from repro_torch.analysis.findings import Finding

PACKAGE = "repro_torch"

#: ``torch.distributed`` collectives the comm layer owns
COLLECTIVE_NAMES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
    "send", "recv", "isend", "irecv", "batch_isend_irecv",
})
COLLECTIVE_MODULE = "torch.distributed"

#: directories (relative to ``src/``) allowed to issue raw collectives
COLLECTIVE_ALLOWED_DIRS = (f"{PACKAGE}/comm/", f"{PACKAGE}/dist/")

#: the kernel entry points only ``kernels/`` may call, fully qualified
KERNEL_ENTRY_POINTS = frozenset(
    [f"{PACKAGE}.kernels.ops.{name}" for name in (
        "dequant_matmul", "dequant_matmul_gidx", "dequant_matmul_wire",
        "dequantize")]
    + [f"{PACKAGE}.kernels.dequant_matmul.{name}" for name in (
        "dequant_matmul_ordered", "dequant_matmul_gidx",
        "dequantize_ordered", "dequant_matmul_wire_ordered")])
KERNEL_ALLOWED_DIRS = (f"{PACKAGE}/kernels/",)

#: spec modules whose dataclasses must all be frozen
SPEC_MODULES = tuple(f"{PACKAGE}/{m}" for m in (
    "core/policy.py", "comm/spec.py", "cache/spec.py", "dist/topology.py"))


def _attr_chain(node: ast.AST) -> Optional[str]:
    """``dist.all_reduce`` -> "dist.all_reduce"; None for non-name
    chains."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _imports(tree: ast.Module, rel: str) -> dict:
    """Each name a module's imports bind, to the dotted name it stands
    for (``from repro_torch.kernels import ops`` -> ``ops``:
    ``repro_torch.kernels.ops``); relative imports resolved from
    ``rel``."""
    package = rel[:-len(".py")].split("/")[:-1]
    names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    names[a.asname] = a.name
                else:       # ``import torch.distributed`` binds ``torch``
                    head = a.name.split(".")[0]
                    names[head] = head
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package[:len(package) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            for a in node.names:
                names[a.asname or a.name] = f"{base}.{a.name}"
    return names


def _qualified(chain: str, names: dict) -> str:
    head, _, rest = chain.partition(".")
    full = names.get(head, head)
    return f"{full}.{rest}" if rest else full


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        return _attr_chain(node.func) in ("list", "dict", "set")
    return False


def _dataclass_frozen(dec: ast.AST) -> Optional[bool]:
    """True/False for a dataclass decorator, None for other decorators."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    chain = _attr_chain(target)
    if chain is None or chain.split(".")[-1] != "dataclass":
        return None
    if not isinstance(dec, ast.Call):
        return False                      # bare @dataclass
    for kw in dec.keywords:
        if kw.arg == "frozen":
            return (isinstance(kw.value, ast.Constant)
                    and bool(kw.value.value))
    return False


def _under(rel: str, dirs) -> bool:
    return any(rel.startswith(d) for d in dirs)


def lint_source(src: str, rel: str) -> list[Finding]:
    """Lint one module's source text (``rel``: its '/'-separated path
    relative to ``src/``, e.g. ``"repro_torch/core/schemes.py"``)."""
    out: list[Finding] = []
    try:
        tree = ast.parse(src, filename=rel)
    except SyntaxError as e:
        return [Finding("AS004", f"unparseable module: {e.msg}",
                        location=f"{rel}:{e.lineno or 0}")]

    names = _imports(tree, rel)
    check_collectives = not _under(rel, COLLECTIVE_ALLOWED_DIRS)
    check_kernels = not _under(rel, KERNEL_ALLOWED_DIRS)
    spec_module = rel in SPEC_MODULES

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            chain = _attr_chain(node.func)
            if chain is None:
                continue
            full = _qualified(chain, names)
            module, _, leaf = full.rpartition(".")
            if (check_collectives and module == COLLECTIVE_MODULE
                    and leaf in COLLECTIVE_NAMES):
                out.append(Finding(
                    "AS001",
                    f"raw collective {chain}() ({full}) outside comm/ and "
                    f"dist/: route it through repro_torch.comm.dispatch",
                    location=f"{rel}:{node.lineno}"))
            if check_kernels and full in KERNEL_ENTRY_POINTS:
                out.append(Finding(
                    "AS002",
                    f"kernel entry point {chain}() ({full}) called "
                    f"outside kernels/: go through kernels/dispatch.py",
                    location=f"{rel}:{node.lineno}"))
        elif isinstance(node, ast.ClassDef) and spec_module:
            for dec in node.decorator_list:
                if _dataclass_frozen(dec) is False:
                    out.append(Finding(
                        "AS003",
                        f"spec dataclass {node.name} is not frozen=True",
                        location=f"{rel}:{node.lineno}"))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args
            for default in list(args.defaults) + [
                    d for d in args.kw_defaults if d is not None]:
                if _is_mutable_literal(default):
                    out.append(Finding(
                        "AS004",
                        f"mutable default argument in {node.name}()",
                        location=f"{rel}:{default.lineno}"))
    return out


def lint_tree(root: str) -> list[Finding]:
    """Lint every ``.py`` under ``root/repro_torch`` (``root``: the
    ``src/`` directory)."""
    out: list[Finding] = []
    for dirpath, dirnames, filenames in os.walk(os.path.join(root,
                                                             PACKAGE)):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            with open(path, encoding="utf-8") as f:
                out.extend(lint_source(f.read(), rel))
    return out


def run(src_root: Optional[str] = None) -> list[Finding]:
    """Entry point the CLI calls: lint the port's tree under ``src/``."""
    if src_root is None:
        # .../src/repro_torch/analysis/ast_lint.py -> .../src
        here = os.path.dirname(os.path.abspath(__file__))
        src_root = os.path.dirname(os.path.dirname(here))
    return lint_tree(src_root)
