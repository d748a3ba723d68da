"""The port's analysis layer on the CPU: contracts, checks, lint, graph.

The port's copies of ``tests/test_analysis.py``'s cases that mean
something on Hopper: the reference cells fit; the registry names real
kernels (every contract's ``__global__`` is in its CUDA source, every
non-quarantined ``__global__`` has a contract); shared memory grows with
the problem; ``kernel_fits`` drives ``theta_sweep.sweep_path`` and
``foem_estep.estep_path`` to the same choices as the formulas they had
before the contracts; the cooperative rule and each structural check fire
on a hand-made bad spec; the CLI's ``--reference`` gate; the lint tree is
clean and each rule fires on a planted source; the module graph is clean,
its quarantine unreachable, an unquarantined dead module flagged; and the
occupancy arithmetic against a table of hand-worked cases.  Nothing here
needs a card: the contracts are held against the card's own records in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import ast
import dataclasses
import importlib
import itertools
import os

import pytest

from repro_torch.analysis import budget as bm
from repro_torch.analysis import card, checks, contracts, launches, lint
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.budget import H100, Cell, LaunchSpec
from repro_torch.analysis.checks import (
    REFERENCE_CELLS,
    assert_reference_cells,
    check_spec,
    kernel_fits,
)
from repro_torch.analysis.contracts import (
    CONTRACT_KERNELS,
    KERNEL_CONTRACTS,
    VARIANTS,
)
from repro_torch.analysis.modules import (
    QUARANTINED_MODULES,
    ROOTS,
    build_import_graph,
    check_module_graph,
    default_src_root,
    reachable_from,
)
from repro_torch.kernels import build, ops
from repro_torch.kernels.foem_estep import EstepPath, estep_path
from repro_torch.kernels.theta_sweep import sweep_path

CSRC = os.path.join(default_src_root(), "repro_torch", "kernels", "csrc")


# ---------------------------------------------------------------------------
# Reference cells and the registry
# ---------------------------------------------------------------------------

def test_reference_cells_fit():
    reports = assert_reference_cells()
    assert reports and all(r.ok for r in reports)
    checked = {r.name for r in reports}
    assert checked == set(KERNEL_CONTRACTS)   # every contract somewhere


def test_reference_cells_hold_the_jax_and_chip_shapes():
    cells = {label: cell for label, cell, _ in REFERENCE_CELLS}
    assert cells["BENCH_sweep full"] == Cell(256, 64, 128, 8192, 16)
    assert cells["BENCH_sweep quick"] == Cell(32, 16, 32, 512, 8)
    assert cells["serving A=16"].K == 10_000
    assert cells["serving dense"].W_s == 141_043
    assert (cells["training dense"].D, cells["training dense"].L) == (1024,
                                                                     128)
    assert cells["sharded K/mp"].K == 2500
    assert cells["estep block T=16384"].T == 16_384
    assert cells["training A=16"].T == 131_072            # SEM's slab
    assert cells["bigmodel K=50000"].K == 50_000


def test_registry_names_real_kernels():
    found = {}
    for fn in os.listdir(CSRC):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn)) as f:
                found[fn] = {name for _, name in lint.cuda_globals(f.read())}
    for name, c in KERNEL_CONTRACTS.items():
        assert c.kernel in found[c.source], (name, c.source)
        entry = getattr(importlib.import_module(c.module), c.entry)
        assert callable(entry), name
        assert set(c.libraries) <= set(build.KERNELS), name
        assert c.kernel in VARIANTS, name
    assert lint.check_launch_registry(CSRC) == []
    # the quarantined attention source's kernels have no contract
    assert found["flash_attention.cu"] and not (
        found["flash_attention.cu"] & CONTRACT_KERNELS)


def test_contract_error_is_one_class():
    from repro_torch.analysis.validate import ContractError, SanitizerError

    assert ops.ContractError is ContractError
    assert ops.SanitizerError is SanitizerError
    assert issubclass(ContractError, ValueError)
    assert issubclass(SanitizerError, RuntimeError)


# ---------------------------------------------------------------------------
# The byte model
# ---------------------------------------------------------------------------

def _dyn(name, cell, **opts):
    return KERNEL_CONTRACTS[name].spec(cell, **opts).dynamic_smem


def test_shared_memory_monotone_in_problem_size():
    ks = (4, 64, 1000, 10_000, 10_240)
    for name in ("gs_loop_kernel", "sweep_loglik_kernel"):
        sizes = [_dyn(name, Cell(8, 8, k, 16)) for k in ks]
        assert sizes == sorted(sizes) and sizes[0] < sizes[-1], name
    wide = [_dyn("theta_sweep_wide", Cell(8, 8, k, 16), state="shared")
            for k in (11_000, 15_000, 19_000)]
    assert wide == sorted(wide) and wide[0] < wide[-1]
    # the register path's staged token columns: 16 bytes a column
    for L in (16, 64, 256):
        ring = contracts.theta_ring(10_000, 0, L, 4)
        assert ring.smem - ring.meta_off == 16 * L


def test_contract_geometry_is_the_wrappers():
    path = sweep_path(10_000, 16, 256, 2, 0)
    spec = KERNEL_CONTRACTS["theta_sweep_sched_bf16"].spec(
        Cell(256, 256, 10_000, 141_043, 16))
    assert (spec.dynamic_smem, spec.grid, spec.threads) == (path.smem, 256,
                                                           512)
    gs = KERNEL_CONTRACTS["gs_loop_kernel"].spec(Cell(1024, 128, 10_000, 9))
    assert gs.dynamic_smem == 2 * 16 * 2500 and gs.cooperative
    assert gs.grid == min(1024 // 4, H100.sms * 2)


# The path formulas of the tree before the contracts, verbatim.
_OLD_SMEM_BUDGET = 232_448 - 1024


def _old_sweep_path(K, A, L, itemsize, phi_ptr):
    row = K * itemsize
    stride = -(-row // 16) * 16 + 16
    room = 108 * 1024 - 16 * L
    slots = min(8, max(room, 0) // stride)
    sched = 8 * K + 16 * 1024 if A else 0
    if (K <= 512 * 4 * 5 and A <= 1024 and sched <= room
            and slots >= 2 * {4: 1, 2: 2, 1: 4}[itemsize]):
        vec = row % 16 == 0 and phi_ptr % 16 == 0
        meta_off = -(-max(slots * stride, sched) // 16) * 16
        return ("registers", 0 if vec else 1, slots, stride, meta_off,
                meta_off + 16 * L)
    if 3 * K * 4 <= _OLD_SMEM_BUDGET:
        return ("shared", 2, 0, 0, 0, 3 * K * 4)
    return ("scratch", 3, 0, 0, 0, 0)


class _Addr:
    def __init__(self, addr):
        self.addr = addr

    def data_ptr(self):
        return self.addr


def _old_estep_path(K, operands):
    if K > 512 * 5 * 4:
        return EstepPath("two-pass", 2)
    vec = K % 4 == 0 and all(t.data_ptr() % 16 == 0
                             for t in operands if t is not None)
    return EstepPath("registers", 0 if vec else 1)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_sweep_path_asks_the_contracts_with_the_old_choice(itemsize):
    Ks = (1, 4, 7, 1000, 10_000, 10_001, 10_239, 10_240, 10_241, 13_000,
          19_285, 19_286, 19_300, 50_000)
    As = (0, 1, 16, 33, 1024, 1025)
    Ls = (1, 16, 256, 2048, 6000, 6911, 6912, 7000)
    for K, A, L, ptr in itertools.product(Ks, As, Ls, (0, 4)):
        if A > max(K, 1):
            continue
        assert tuple(sweep_path(K, A, L, itemsize, ptr)) == \
            _old_sweep_path(K, A, L, itemsize, ptr), (K, A, L, ptr)


def test_estep_path_asks_the_contract_with_the_old_choice():
    for K in (1, 3, 4, 100, 10_000, 10_001, 10_236, 10_240, 10_241, 10_244,
              50_000):
        for addrs in ((0, 0), (0, 4), (16, 32)):
            ops_ = [_Addr(a) for a in addrs] + [None]
            assert estep_path(K, ops_) == _old_estep_path(K, ops_), (K,
                                                                    addrs)
    assert kernel_fits("fused_estep_regs", Cell(1, 1, 10_240, 0))
    assert not kernel_fits("fused_estep_regs", Cell(1, 1, 10_241, 0))


# ---------------------------------------------------------------------------
# Occupancy arithmetic against hand-worked cases
# ---------------------------------------------------------------------------

# (threads, regs, static, dynamic) -> CTAs an SM.  Worked by hand: a warp
# takes regs·32 rounded up to 256 registers; a sub-partition holds 16,384;
# a CTA takes static + dynamic + 1,024 bytes rounded up to 128 of 233,472.
OCCUPANCY_TABLE = [
    ((512, 64, 144, 0), 2),         # 2,048 a warp: 8 a sub-partition, 32 / 16
    ((512, 64, 480, 110_592), 2),   # 112,128 B a CTA: 2 fit 233,472
    ((512, 64, 144, 200_000), 1),   # 201,216 B a CTA
    ((256, 255, 0, 0), 1),          # 8,192 a warp: 2 a sub-partition, 8 / 8
    ((256, 110, 0, 0), 2),          # 3,584 a warp: 4 a sub-partition, 16 / 8
    ((256, 64, 0, 0), 4),           # 2,048: 32 warps / 8
    ((256, 32, 0, 0), 8),           # threads: 2,048 / 256
    ((128, 16, 0, 0), 16),          # threads and warps: 16
    ((1024, 64, 144, 180_000), 1),  # 32 warps of 32 by registers
    ((1024, 65, 0, 0), 0),          # 2,304 a warp × 32 > 65,536 a CTA
    ((384, 168, 0, 0), 1),          # 5,376 a warp: 3 a sub-partition, 12 / 12
    ((32, 8, 0, 0), 32),            # the CTA limit
    ((256, 40, 232_448, 0), 1),     # the whole opt-in
    ((256, 40, 232_449, 0), 0),     # one byte past it
    ((1025, 8, 0, 0), 0),           # past 1,024 threads a CTA
]


@pytest.mark.parametrize("args,want", OCCUPANCY_TABLE,
                         ids=[str(a) for a, _ in OCCUPANCY_TABLE])
def test_occupancy_matches_hand_worked_cases(args, want):
    assert bm.ctas_per_sm(*args) == want


@pytest.mark.parametrize("bounds,want", [((512, 2), 64), ((256, 4), 64),
                                         ((1024, 1), 64), ((256, 1), 255),
                                         ((384, 1), 168), ((128, 1), 255)])
def test_register_ceiling_of_launch_bounds(bounds, want):
    assert bm.reg_ceiling(bounds) == want


def test_cooperative_grid_rule():
    assert bm.cooperative_grid(1000, 2, 2) == 264
    assert bm.cooperative_grid(100, 2, 2) == 100
    assert bm.cooperative_grid(1000, 1, 2) == 132
    assert bm.cooperative_grid(0, 3, 2) == 1


# ---------------------------------------------------------------------------
# Structural checks fire on hand-made bad specs
# ---------------------------------------------------------------------------

GOOD = LaunchSpec(kernel="k", variant=0, grid=100, threads=256,
                  static_smem=144, dynamic_smem=0, bounds=(256, 1), regs=64)


def test_good_spec_passes():
    r = check_spec(GOOD)
    assert r.ok and r.ctas_per_sm == 4


@pytest.mark.parametrize("change,words", [
    (dict(threads=2048, bounds=(2048, 1)), "threads a CTA"),
    (dict(threads=512), "exceed its __launch_bounds__"),
    (dict(grid=0), "grid 0"),
    (dict(grid=2 ** 31), "grid 2147483648"),
    (dict(regs=300), "registers a thread exceed"),
    (dict(dynamic_smem=232_448), "exceed the 232448"),
    (dict(bounds=(256, 8)), "fall short of its __launch_bounds__"),
    (dict(vectors=(("phi row bytes", 40_004),)), "not a multiple of 16"),
    (dict(capacities=(("lanes", 10_241, 10_240),)), "needs 10241"),
    (dict(cooperative=True, per_sm=2, grid=265), "not co-resident"),
    (dict(cooperative=True, per_sm=2, grid=10, regs=255, threads=1024,
          bounds=(1024, 1)), "not co-resident"),
])
def test_each_structural_check_fires(change, words):
    r = check_spec(dataclasses.replace(GOOD, **change))
    assert not r.ok and any(words in e for e in r.errors), r.errors


def test_cooperative_rule_fires_on_a_contract_past_its_cap():
    spec = KERNEL_CONTRACTS["active_loop_kernel"].spec(
        Cell(100_000, 8, 64, 16, 16))
    assert check_spec(spec).ok                 # the entry caps the grid
    bad = dataclasses.replace(spec, grid=spec.grid + 1)
    assert any("co-resident" in e for e in check_spec(bad).errors)


def test_wide_stop_rule_falls_short_of_its_bounds():
    """K = 5·10⁴: w(k) staged in shared memory leaves one CTA an SM where
    the kernel's bounds ask two — a finding the default grid reports."""
    r = checks.check_cell(Cell(64, 128, 50_000, 9),
                          kernels=["sweep_loglik_kernel"])
    assert len(r) == 1 and not r[0].ok
    assert "fall short" in r[0].reason()


def test_cli_reference_gate(capsys):
    assert cli_main(["--reference"]) == 0
    out = capsys.readouterr().out
    assert "gs_loop_kernel" in out and "theta_sweep_wide_int8" in out
    assert "'fail': 0" in out
    assert cli_main(["--cell", "D=64,L=128,K=50000,W_s=9",
                     "--fail-only"]) == 1
    assert "sweep_loglik_kernel" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_main(["--cell", "D=1,Q=2"])


# ---------------------------------------------------------------------------
# The port's lint
# ---------------------------------------------------------------------------

def test_lint_tree_clean():
    assert lint.run_lint() == []


@pytest.mark.parametrize("src,rule,tag", [
    ("import torch\nx = torch.zeros(3, dtype=torch.float64)\n",
     "check_f64", "f64"),
    ("def f(x, acc=[]):\n    return acc\n",
     "check_mutable_defaults", "mutable-default"),
    ("def f(x, *, acc=dict()):\n    return acc\n",
     "check_mutable_defaults", "mutable-default"),
    ("try:\n    pass\nexcept:\n    pass\n",
     "check_bare_except", "bare-except"),
    ("import jax.numpy as jnp\n", "check_no_jax", "no-jax"),
    ("def f():\n    from repro.core import em\n", "check_no_jax", "no-jax"),
    ("import jaxlib\n", "check_no_jax", "no-jax"),
])
def test_lint_rules_fire(src, rule, tag):
    hits = getattr(lint, rule)("/x/y.py", "repro_torch.fake", src,
                               ast.parse(src))
    assert hits and all(f"[{tag}]" in h for h in hits)


def test_lint_accepts_what_it_should():
    ok = ("import torch\nx = torch.float64  # lint: host-f64\n"
          "import repro_torch.core\nfrom . import em\n"
          "def f(x=None, y=()):\n    return x\n"
          "try:\n    pass\nexcept ValueError:\n    pass\n")
    tree = ast.parse(ok)
    for rule in (lint.check_f64, lint.check_no_jax,
                 lint.check_mutable_defaults, lint.check_bare_except):
        assert rule("/x/y.py", "repro_torch.fake", ok, tree) == []


def test_lint_kernel_doc_fires_on_an_undocumented_entry():
    fake = {"c": contracts.LaunchContract(
        name="c", kernel="k", module="repro_torch.fake", entry="run",
        source="k.cu", libraries=(), equations=("eq. 38",),
        description="", build=lambda *a, **k: GOOD)}
    bare = '"""A module."""\ndef run():\n    """Runs."""\n'
    hits = lint.check_kernel_docs("/x/fake.py", "repro_torch.fake", bare,
                                  ast.parse(bare), contracts=fake)
    assert hits and "[kernel-doc]" in hits[0] and "eq. 38" in hits[0]
    assert "shared memory" in hits[0]
    doc = ('"""A module."""\ndef run():\n    """Its shared memory: none; '
           'eq. 38."""\n')
    assert lint.check_kernel_docs("/x/fake.py", "repro_torch.fake", doc,
                                  ast.parse(doc), contracts=fake) == []
    missing = '"""A module."""\n'
    hits = lint.check_kernel_docs("/x/fake.py", "repro_torch.fake", missing,
                                  ast.parse(missing), contracts=fake)
    assert hits and "not defined" in hits[0]


def test_lint_launch_registry_fires_on_an_unbudgeted_kernel(tmp_path):
    (tmp_path / "new.cu").write_text(
        "__global__ void __launch_bounds__(256, 2)\n    rogue_kernel(int* p) "
        "{}\n__global__ void copy_kernel(float* p) {}\n")
    (tmp_path / "flash_attention.cu").write_text(
        "__global__ void lm_kernel(float* p) {}\n")
    hits = lint.check_launch_registry(str(tmp_path))
    assert len(hits) == 1 and "rogue_kernel" in hits[0]
    assert "[launch-registry]" in hits[0] and "new.cu:1" in hits[0]


def test_lint_module_graph_rule_fires_on_a_planted_tree(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "core" / "__init__.py").write_text("")
    (pkg / "core" / "trainer.py").write_text("import repro_torch.core.em\n")
    (pkg / "core" / "em.py").write_text("")
    (pkg / "core" / "dead.py").write_text("")
    violations, dead = check_module_graph(str(tmp_path),
                                          roots=("repro_torch.core.trainer",),
                                          quarantine=frozenset({
                                              "repro_torch.gone"}))
    assert dead == {"repro_torch.core.dead"}
    assert any("repro_torch.core.dead: unreachable" in v for v in violations)
    assert any("repro_torch.gone: QUARANTINED_MODULES entry does not exist"
               in v for v in violations)
    assert lint.rule_classes(
        [f"module-graph: {v}" for v in violations]) == {"module-graph"}


# ---------------------------------------------------------------------------
# Module graph
# ---------------------------------------------------------------------------

def test_module_graph_clean():
    violations, dead = check_module_graph()
    assert violations == []
    assert dead == set(QUARANTINED_MODULES)


def test_quarantine_is_not_reachable():
    graph = build_import_graph(default_src_root())
    live = reachable_from(graph, ROOTS)
    assert not live & QUARANTINED_MODULES
    assert "repro_torch.analysis.sanitizer" in live
    assert "repro_torch.kernels.flash_attention" not in live


def test_module_graph_flags_unquarantined_dead_module():
    graph = {"repro_torch.a": {"repro_torch.b"}, "repro_torch.b": set(),
             "repro_torch.dead": set()}
    live = reachable_from(graph, ("repro_torch.a",))
    assert live == {"repro_torch.a", "repro_torch.b"}
    assert set(graph) - live == {"repro_torch.dead"}


def test_reachable_quarantine_entry_is_flagged():
    violations, _ = check_module_graph(
        quarantine=QUARANTINED_MODULES | {"repro_torch.kernels.ops"})
    assert any("repro_torch.kernels.ops: QUARANTINED_MODULES entry is "
               "reachable" in v for v in violations)


# ---------------------------------------------------------------------------
# Launch notes and the compiler's report (the card's side runs on the card)
# ---------------------------------------------------------------------------

def test_launch_notes_only_while_enabled():
    launches.clear()
    cell = Cell(2, 3, 4, 5)
    launches.note("gs_sweep", "gs_loop_kernel", cell, vec=True)
    assert launches.notes() == []
    launches.enable()
    try:
        for _ in range(3):
            launches.note("gs_sweep", "gs_loop_kernel", cell, vec=True)
        launches.note("gs_sweep", "gs_loop_kernel", cell, vec=False)
    finally:
        launches.enable(False)
    got = sorted(launches.notes(), key=lambda n: n[4])
    assert got == [("gs_sweep", "gs_loop_kernel", cell, {"vec": False}, 1),
                   ("gs_sweep", "gs_loop_kernel", cell, {"vec": True}, 3)]
    launches.clear()


class _FakeLibrary:
    """A loaded kernel library's recording switch, as ctypes exposes it."""

    def __init__(self, name):
        self.calls = []

        def switch(on):
            self.calls.append(on)

        setattr(self, f"{name}_launch_enable", switch)


def test_launch_records_follow_the_notes(monkeypatch):
    """``launches.enable`` switches the libraries' launch records
    (``csrc/launch_log.cuh``) with the notes: those loaded already at once,
    one loaded later as ``build.load`` loads it; off by default."""
    from repro_torch.kernels import build

    early, late = _FakeLibrary("gs_sweep"), _FakeLibrary("theta_sweep")
    monkeypatch.setattr(build, "_loaded", {"gs_sweep": early})
    monkeypatch.setattr(build, "build", lambda names: {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: late)
    launches.enable()
    try:
        assert early.calls == [1]
        assert build.load("theta_sweep") is late
        assert late.calls == [1]
    finally:
        launches.enable(False)
    assert early.calls == [1, 0] and late.calls == [1, 0]
    monkeypatch.setattr(build, "_loaded", {})
    other = _FakeLibrary("topk_estep")
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: other)
    build.load("topk_estep")
    assert other.calls == [0]


PTXAS = """\
ptxas info    : Compiling entry function '_ZN6active11copy_kernelEPKfPfmi' for 'sm_90a'
ptxas info    : Function properties for _ZN6active11copy_kernelEPKfPfmi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN5sweep19sweep_loglik_kernelILb1ELb0EEEvPKiPKfS4_S4_S4_Pfiiffff' for 'sm_90a'
ptxas info    : Function properties for _ZN5sweep19sweep_loglik_kernelILb1ELb0EEEvPKiPKfS4_S4_S4_Pfiiffff
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size, 144 bytes smem
"""


def test_compiler_report_is_parsed():
    got = card.parse_ptxas(PTXAS)
    copy = got["_ZN6active11copy_kernelEPKfPfmi"]
    assert copy == dict(stack=0, spill_stores=0, spill_loads=0, regs=40,
                        smem=0)
    (loglik,) = [v for k, v in got.items() if "loglik" in k]
    assert loglik["regs"] == 64 and loglik["smem"] == 144
    assert loglik["spill_stores"] + loglik["spill_loads"] == 20
    names = sorted(CONTRACT_KERNELS)
    assert {card.kernel_of(k, names) for k in got} == {
        "copy_kernel", "sweep_loglik_kernel"}


def test_card_check_matches_notes_to_records(monkeypatch):
    """``card.check_against_card`` with the libraries' side faked: a noted
    launch whose spec the records hold passes; a record no note predicts,
    a note the records lack, an occupancy or static shared memory the
    model gets wrong are each a mismatch."""
    cell = Cell(D=40, L=8, K=64, W_s=16)
    spec = KERNEL_CONTRACTS["gs_loop_kernel"].spec(cell, H100,
                                                  {("gs_loop_kernel", 0): 64})
    good = dict(kernel="gs_loop_kernel", variant=0, grid=spec.grid,
                threads=spec.threads, smem=spec.dynamic_smem, launches=3)
    card_q = dict(regs=64, static_smem=spec.static_smem, local_bytes=0,
                  max_threads=512, occupancy=bm.ctas_per_sm(
                      spec.threads, 64, spec.static_smem, spec.dynamic_smem),
                  last_grid=spec.grid, last_threads=512,
                  last_smem=spec.dynamic_smem, launches=3, configs=1)

    def run(records, q=card_q):
        monkeypatch.setattr(card, "launch_configs",
                            lambda lib: (records, 0))
        monkeypatch.setattr(card, "query", lambda *a: dict(q))
        return card.check_against_card(["gs_sweep"], hw=H100)

    launches.clear()
    launches.enable()
    try:
        launches.note("gs_sweep", "gs_loop_kernel", cell, vec=True,
                      wide=False)
    finally:
        launches.enable(False)
    try:
        rep = run([good])
        assert rep["mismatches"] == [] and rep["noted"] == 1
        (row,) = rep["kernels"]
        assert row["cooperative"] and row["ctas_per_sm"] == [[2, 2]]
        rep = run([good, dict(good, grid=spec.grid + 1)])
        assert any("no noted launch" in m for m in rep["mismatches"])
        rep = run([])
        assert any("never launched" in m for m in rep["mismatches"])
        rep = run([good], dict(card_q, occupancy=1))
        assert any("predicted 2 CTAs an SM, the card 1" in m
                   for m in rep["mismatches"])
        rep = run([good], dict(card_q, static_smem=spec.static_smem + 16))
        assert any("static shared memory" in m for m in rep["mismatches"])
    finally:
        launches.clear()


def test_sweep_contract_wants_float32_operands():
    """``ops.sweep`` computes in float32: a float64 μ, θ̂, φ̂ or φ̂(k)
    (a store's float64 total among them) is refused, as before the
    analysis layer took the check over."""
    import torch

    from repro_torch.analysis.validate import validate_sweep_args

    wid = torch.zeros((2, 3), dtype=torch.int32)
    cnt = torch.ones((2, 3))
    mu = torch.full((2, 3, 4), 0.25)
    args = [wid, cnt, mu, torch.ones((2, 4)), torch.ones((5, 4)),
            torch.ones(4)]
    validate_sweep_args(*args)
    for i in (2, 3, 4, 5):
        bad = list(args)
        bad[i] = bad[i].double()
        with pytest.raises(ops.ContractError, match="must all be float32"):
            validate_sweep_args(*bad)
    bad = list(args)
    bad[5] = bad[5].half()
    with pytest.raises(ops.ContractError, match="must all be float32"):
        validate_sweep_args(*bad)
