"""The port's lint: AST and source rules ``src/repro_torch`` holds itself to.

The counterpart of the JAX package's ``tools/lint_repro.py``, inside the
package and run as ``python -m repro_torch.analysis.lint``.  No module of
the port is executed (it parses sources; the contracts and the module
graph are import-light), so it runs on any host.  Rules, over every module
under ``src/repro_torch`` and every CUDA source under ``kernels/csrc``:

  no-jax     no import of ``jax``, ``jaxlib`` or the JAX package ``repro``,
             at module level or inside a function: the port runs where
             there is no JAX.
  mutable-default
             no mutable default arguments (list/dict/set literals or
             constructors): state shared across calls.
  bare-except
             no bare ``except:`` — it would swallow KeyboardInterrupt and
             the ContractError / SanitizerError the analysis layer raises.
  kernel-doc every launch contract's entry documents its shared-memory
             budget ("shared memory") and each paper equation the contract
             names ("eq. N"), in the entry's or its module's docstring.
  launch-registry
             every ``__global__`` function in ``kernels/csrc/*.cu`` and
             ``*.cuh`` outside the quarantine is named by a launch contract
             (``analysis.contracts``): an unbudgeted launch fails, as the
             JAX package's ``blockspec`` rule fails a BlockSpec the
             analyzer cannot see.
  module-graph
             ``analysis.modules.check_module_graph``: every module
             unreachable from the reproduction's roots is quarantined, and
             the quarantine holds nothing stale.
  f64        no float64 dtype literal: the kernels compute in float32.  A
             deliberate float64 accumulator (the φ̂(k) re-sums, the host
             totals) says so with a trailing ``# lint: host-f64`` comment.

Exit status: the number of rule classes hit (0 == clean).
"""
from __future__ import annotations

import ast
import os
import re
import sys
from typing import Iterable, List, Tuple

from repro_torch.analysis.contracts import CONTRACT_KERNELS, KERNEL_CONTRACTS
from repro_torch.analysis.modules import (
    QUARANTINED_MODULES,
    check_module_graph,
    default_src_root,
)

#: CUDA sources that belong to a quarantined kernel module under another
#: stem, exempt from the launch registry as that module's own source is:
#: flash_attention_bwd.cu is the backward of flash_attention.py's kernel
QUARANTINED_SOURCES = frozenset({"flash_attention_bwd"})
HOST_F64_TAG = "lint: host-f64"
_F64 = "float64"  # lint: host-f64
FORBIDDEN_IMPORTS = ("jax", "jaxlib", "repro")
_MUTABLE_CALLS = {"list", "dict", "set", "defaultdict", "OrderedDict"}
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")

Source = Tuple[str, str, str, ast.AST]     # path, module, text, tree


def _module_name(src: str, path: str) -> str:
    rel = os.path.relpath(path, src)[:-len(".py")]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def iter_sources(src: str, package: str = "repro_torch") -> Iterable[Source]:
    for dirpath, _, files in os.walk(os.path.join(src, package)):
        for fn in sorted(files):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                with open(path, "r", encoding="utf-8") as f:
                    text = f.read()
                yield (path, _module_name(src, path), text,
                       ast.parse(text, path))


def check_no_jax(path, module, text, tree) -> List[str]:
    out = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        for name in names:
            if name.split(".")[0] in FORBIDDEN_IMPORTS:
                out.append(f"{path}:{node.lineno}: [no-jax] imports "
                           f"{name}: the port imports nothing of JAX or of "
                           f"the JAX package")
    return out


def check_mutable_defaults(path, module, text, tree) -> List[str]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for d in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            bad = isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(d, ast.Call) and isinstance(d.func, ast.Name)
                and d.func.id in _MUTABLE_CALLS)
            if bad:
                out.append(f"{path}:{d.lineno}: [mutable-default] "
                           f"{node.name}() has a mutable default argument "
                           f"— default to None and build inside")
    return out


def check_bare_except(path, module, text, tree) -> List[str]:
    return [f"{path}:{node.lineno}: [bare-except] bare `except:` — name "
            f"the exception (it would swallow contract/sanitizer errors)"
            for node in ast.walk(tree)
            if isinstance(node, ast.ExceptHandler) and node.type is None]


def check_kernel_docs(path, module, text, tree, contracts=None) -> List[str]:
    contracts = KERNEL_CONTRACTS if contracts is None else contracts
    want = {}
    for c in contracts.values():
        if c.module == module:
            want.setdefault(c.entry, set()).update(c.equations)
    if not want:
        return []
    mod_doc = ast.get_docstring(tree) or ""
    out = []
    found = set()
    for node in tree.body:
        if not isinstance(node, ast.FunctionDef) or node.name not in want:
            continue
        found.add(node.name)
        doc = (ast.get_docstring(node) or "") + "\n" + mod_doc
        missing = [tag for tag in ("shared memory", *sorted(want[node.name]))
                   if tag not in doc]
        if missing:
            out.append(f"{path}:{node.lineno}: [kernel-doc] contract entry "
                       f"{node.name}() must document "
                       f"{', '.join(missing)} in its (or the module's) "
                       f"docstring")
    for entry in sorted(set(want) - found):
        out.append(f"{path}:1: [kernel-doc] contract entry {entry}() is not "
                   f"defined in {module}")
    return out


def check_f64(path, module, text, tree) -> List[str]:
    lines = text.splitlines()
    out = []
    for node in ast.walk(tree):
        is_f64 = ((isinstance(node, ast.Attribute) and node.attr == _F64)
                  or (isinstance(node, ast.Name) and node.id == _F64)
                  or (isinstance(node, ast.Constant) and node.value == _F64))
        if not is_f64 or HOST_F64_TAG in lines[node.lineno - 1]:
            continue
        out.append(f"{path}:{node.lineno}: [f64] float64 without a "
                   f"`# {HOST_F64_TAG}` tag — the kernels compute in "
                   f"float32; tag a deliberate accumulator")
    return out


def cuda_globals(text: str) -> List[Tuple[int, str]]:
    """``(line, name)`` of every ``__global__`` function in a CUDA
    source."""
    return [(text.count("\n", 0, m.start()) + 1, m.group(1))
            for m in _GLOBAL.finditer(text)]


def check_launch_registry(csrc: str, kernels=None,
                          quarantine=QUARANTINED_MODULES) -> List[str]:
    kernels = CONTRACT_KERNELS if kernels is None else kernels
    out = []
    for fn in sorted(os.listdir(csrc)):
        if not fn.endswith((".cu", ".cuh")):
            continue
        stem = fn.rsplit(".", 1)[0]
        if (f"repro_torch.kernels.{stem}" in quarantine
                or stem in QUARANTINED_SOURCES):
            continue
        with open(os.path.join(csrc, fn), "r", encoding="utf-8") as f:
            text = f.read()
        for line, name in cuda_globals(text):
            if name not in kernels:
                out.append(f"{os.path.join(csrc, fn)}:{line}: "
                           f"[launch-registry] __global__ {name} has no "
                           f"launch contract — register it in "
                           f"repro_torch.analysis.contracts so the analyzer "
                           f"budgets it")
    return out


RULES = (check_no_jax, check_mutable_defaults, check_bare_except,
         check_kernel_docs, check_f64)


def run_lint(src: str = None) -> List[str]:
    src = src or default_src_root()
    violations: List[str] = []
    for source in iter_sources(src):
        for rule in RULES:
            violations.extend(rule(*source))
    violations.extend(check_launch_registry(
        os.path.join(src, "repro_torch", "kernels", "csrc")))
    graph_violations, _ = check_module_graph(src)
    violations.extend(f"module-graph: {v}" for v in graph_violations)
    return violations


def rule_classes(violations: List[str]) -> set:
    return {v.split("[")[1].split("]")[0] if "] " in v else "module-graph"
            for v in violations}


def main() -> int:
    violations = run_lint()
    for v in violations:
        print(v)
    classes = rule_classes(violations)
    print(f"lint: {len(violations)} violation(s) in {len(classes)} "
          f"class(es)" if violations else "lint: clean")
    return len(classes)


if __name__ == "__main__":
    sys.exit(main())
