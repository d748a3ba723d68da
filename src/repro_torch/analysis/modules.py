"""Module-graph hygiene of the port: which of ``src/repro_torch`` is the
paper reproduction, and which is quarantined LM code.

The port of ``repro.analysis.modules``: an AST import graph over every
module under ``repro_torch`` (no import is executed), reachability from
the reproduction's entry points (:data:`ROOTS`), and an audited allowlist
(:data:`QUARANTINED_MODULES`) that every unreachable module must be on —
and that may hold nothing reachable or nonexistent, so it cannot rot.
``check_module_graph()`` returns the violations; the port's lint
(``analysis.lint``) and ``tests/test_torch_analysis.py`` gate on it.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Set, Tuple

#: Entry points of the reproduction: the trainers and algorithm drivers,
#: the sharded engine, serving and the launch scripts, the fault-tolerant
#: runtime, the data pipeline and the analysis layer.  Everything the paper
#: pipeline can execute must be importable from here.
ROOTS = (
    "repro_torch.analysis",
    "repro_torch.analysis.__main__",
    "repro_torch.analysis.card",        # the contracts held on the card
    "repro_torch.analysis.lint",
    "repro_torch.analysis.modules",
    "repro_torch.analysis.sanitizer",   # lazy-loaded behind debug_checks
    "repro_torch.core.trainer",
    "repro_torch.core.foem_sharded",
    "repro_torch.core.baselines",
    "repro_torch.core.sem",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.build",        # loaded at a kernel's first launch
    "repro_torch.runtime.elastic",      # elastic fault-tolerant driver
    "repro_torch.checkpoint",           # crash-consistent checkpoints
    "repro_torch.configs.foem_lda",     # the LDA cells (stream_1k, …)
    "repro_torch.launch.mesh",          # spawn_mesh: the sharded ranks
    "repro_torch.launch.train",
    "repro_torch.launch.serve",
    "repro_torch.launch.replica",       # replica pool (serve --replicas)
    "repro_torch.launch.lifelong",      # train-while-serve driver
    "repro_torch.launch.specs",         # the LDA cells
    "repro_torch.launch.roofline",      # a step's roofline terms
    "repro_torch.launch.dryrun",        # the cells' dry run on one card
    "repro_torch.data.uci",
)

#: Audited quarantine: the LM stack (ROADMAP.md queue 1 item 10), kept for
#: its own tests and ``chip_smoke.py`` but not reachable from the
#: reproduction's entry points.  Adding a module here says it is not the
#: reproduction; removing one requires linking it in or deleting it.
QUARANTINED_MODULES = frozenset({
    # LM-architecture configs, loaded only through configs.registry's lazy
    # TEMPLATE_ARCHS allowlist
    "repro_torch.configs.base",
    "repro_torch.configs.granite_20b",
    "repro_torch.configs.granite_8b",
    "repro_torch.configs.h2o_danube_3_4b",
    "repro_torch.configs.internlm2_20b",
    "repro_torch.configs.jamba_1_5_large_398b",
    "repro_torch.configs.llama_3_2_vision_11b",
    "repro_torch.configs.mamba2_370m",
    "repro_torch.configs.musicgen_medium",
    "repro_torch.configs.qwen2_moe_a2_7b",
    "repro_torch.configs.qwen3_moe_235b_a22b",
    "repro_torch.configs.registry",
    # the attention kernel of the LM stack — not an LDA kernel
    # (ops.attention loads it at its first call; no launch contract)
    "repro_torch.kernels.flash_attention",
    # the decoder LM (serving and training): dense, MoE, Mamba2, hybrid,
    # cross-attention and audio-frame layers
    "repro_torch.models",
    "repro_torch.models.convert",
    "repro_torch.models.layers",
    "repro_torch.models.lm",
    "repro_torch.models.moe",
    "repro_torch.models.ssm",
    # the LM's distribution: the expert-parallel MoE over a mesh of ranks,
    # the sharding rules, collectives, int8 compression and the pipeline
    "repro_torch.parallel",
    "repro_torch.parallel.collectives",
    "repro_torch.parallel.compression",
    "repro_torch.parallel.moe_ep",
    "repro_torch.parallel.pipeline",
    "repro_torch.parallel.sharding",
    # the LM trainer's AdamW and schedules, loaded inside
    # launch.train.train_lm (the LDA trainers' step sizes are their own)
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.optim.schedules",
})


def _module_name(root: str, path: str) -> str:
    rel = os.path.relpath(path, root)[:-len(".py")]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p)


def _eager_nodes(tree: ast.AST):
    """Statements that run at import time: the module body, descending
    into if/try/with blocks and class bodies, but NOT function bodies — a
    function-local import is lazy and is no reachability edge (which is
    how quarantined modules stay callable outside the import graph)."""
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _imports_of(path: str, module: str) -> Set[str]:
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    pkg_parts = module.split(".")
    is_pkg = os.path.basename(path) == "__init__.py"
    out: Set[str] = set()
    for node in _eager_nodes(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out.add(a.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative import: resolve against this module's package
                keep = len(pkg_parts) - node.level + (1 if is_pkg else 0)
                base = pkg_parts[:keep]
                prefix = ".".join(base + ([node.module] if node.module
                                          else []))
            else:
                prefix = node.module or ""
            out.add(prefix)
            for a in node.names:
                out.add(f"{prefix}.{a.name}" if prefix else a.name)
    return out


def build_import_graph(src_root: str,
                       package: str = "repro_torch") -> Dict[str, Set[str]]:
    """The package's internal import graph: module -> the package modules
    it imports (edges to modules outside the tree are dropped)."""
    pkg_root = os.path.join(src_root, package)
    modules: Dict[str, str] = {}
    for dirpath, _, files in os.walk(pkg_root):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                modules[_module_name(src_root, path)] = path
    graph: Dict[str, Set[str]] = {}
    known = set(modules)
    for mod, path in modules.items():
        edges = set()
        for imp in _imports_of(path, mod):
            # "repro_torch.core.em.fold_theta" -> "repro_torch.core.em"
            name = imp
            while name and name not in known:
                name = name.rpartition(".")[0]
            if name:
                edges.add(name)
        graph[mod] = edges - {mod}
    return graph


def reachable_from(graph: Dict[str, Set[str]], roots) -> Set[str]:
    seen: Set[str] = set()
    stack = [r for r in roots if r in graph]
    while stack:
        mod = stack.pop()
        if mod in seen:
            continue
        seen.add(mod)
        stack.extend(graph.get(mod, ()))
        # a module's package __init__ runs on import
        parent = mod.rpartition(".")[0]
        if parent and parent in graph and parent not in seen:
            stack.append(parent)
    return seen


def default_src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def check_module_graph(src_root: str = None, roots=ROOTS,
                       quarantine=QUARANTINED_MODULES
                       ) -> Tuple[List[str], Set[str]]:
    """``(violations, unreachable)`` for the port's tree.

    Violations name (a) modules unreachable from the roots and missing
    from the quarantine and (b) stale quarantine entries (reachable or
    nonexistent).  An empty list is a clean tree."""
    root = src_root or default_src_root()
    graph = build_import_graph(root)
    live = reachable_from(graph, roots)
    dead = set(graph) - live
    violations = []
    for mod in sorted(dead - quarantine):
        violations.append(
            f"{mod}: unreachable from the reproduction roots and not in "
            f"QUARANTINED_MODULES — dead code must be quarantined "
            f"explicitly or deleted")
    for mod in sorted(quarantine):
        if mod not in graph:
            violations.append(
                f"{mod}: QUARANTINED_MODULES entry does not exist — "
                f"remove the stale allowlist line")
        elif mod in live:
            violations.append(
                f"{mod}: QUARANTINED_MODULES entry is reachable from the "
                f"reproduction roots — it is live code, un-quarantine it")
    return violations, dead


if __name__ == "__main__":
    import sys

    violations, dead = check_module_graph()
    for v in violations:
        print(f"module-graph: {v}")
    print(f"{len(dead)} quarantined/dead modules, "
          f"{len(violations)} violations")
    sys.exit(1 if violations else 0)
