"""The PyTorch port stands alone: no JAX, no JAX package, GPU by default.

* Every module of ``repro_torch`` imports in a fresh interpreter in which
  ``import jax`` and ``import repro`` fail.
* No file of the port, nor ``chip_smoke.py`` or ``examples/torch``, has
  an import statement naming ``jax``/``jaxlib`` or ``repro``.
* The entry points — serving (``TopicServer``, ``ops.infer``, the serve
  CLI), training (``FOEMTrainer``, ``ops.sweep``, ``foem_minibatch``,
  the train CLI), the sharded step's meshes (``make_host_mesh``,
  ``spawn_mesh``), the LM's serving path (``LM``, ``build``,
  ``params_from_jax``), the baselines (``ovb_step``, ``scvb_step``,
  ``ogs_step``), the serving engine's θ̂₀ draw and ``--traffic`` CLI, and
  the lifelong entry points (``run_lifelong``, its CLI, the subscribed
  server), and the fault-tolerant layer's (``ReplicaSpec.build_server``,
  ``ReplicaPool`` on both backends, the serve CLI's ``--replicas``,
  ``ElasticFOEMRuntime``) —
  default to ``device="cuda"`` and raise on a host
  without a GPU instead of falling back to the CPU (SEM's and the
  coarse-block trainer's: ``tests/test_torch_blocked.py``).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples" / "torch").glob("*.py")))


def test_port_modules_import_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib, pkgutil, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    # each module first, in a fresh package state: no import cycle\n"
        "    for m in [m for m in sys.modules if m.startswith('repro_torch')]:\n"
        "        del sys.modules[m]\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 17     # every module was walked


@pytest.mark.parametrize("name", [
    "repro_torch.launch.mesh",
    "repro_torch.core.foem_sharded",
    "repro_torch.kernels.sharded_sweep",
])
def test_sharded_slice_modules_stand_alone(name):
    """The sharded slice's modules import without JAX, and the kernel's
    CUDA source is one of the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.kernels import build\n"
        "assert 'sharded_sweep' in build.KERNELS\n"
        "assert (build.CSRC / 'sharded_sweep.cu').exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name,kernel", [
    ("repro_torch.kernels.foem_estep", "fused_estep"),
    ("repro_torch.kernels.topk_estep", "topk_estep"),
    ("repro_torch.core.sem", "fused_estep"),
])
def test_blocked_slice_modules_stand_alone(name, kernel):
    """The coarse-block/SEM slice's modules import without JAX, and their
    kernels' CUDA sources are among the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.kernels import build\n"
        f"assert {kernel!r} in build.KERNELS\n"
        f"assert (build.CSRC / '{kernel}.cu').exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", [
    "repro_torch.kernels.flash_attention",
    "repro_torch.models.lm",
    "repro_torch.models.convert",
    "repro_torch.configs.registry",
    "repro_torch.models.moe",
    "repro_torch.models.ssm",
    "repro_torch.parallel.moe_ep",
    "repro_torch.parallel.sharding",
    "repro_torch.parallel.collectives",
    "repro_torch.parallel.compression",
    "repro_torch.parallel.pipeline",
])
def test_lm_slice_modules_stand_alone(name):
    """The LM slices' modules import without JAX, the registry's config
    modules too (the dense, MoE, SSM, hybrid, VLM and audio archs), and the
    attention kernel's CUDA source is one of the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.configs.registry import ARCHS\n"
        "assert {ARCHS[n].family for n in ARCHS} == {'dense', 'moe', "
        "'ssm', 'hybrid', 'vlm', 'audio'}\n"
        "from repro_torch.kernels import build\n"
        "assert 'flash_attention' in build.KERNELS\n"
        "assert (build.CSRC / 'flash_attention.cu').exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]] if not node.level \
                else []
        else:
            continue
        assert not FORBIDDEN & set(roots), (path, node.lineno, roots)


def test_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import LDAConfig, ParameterStore
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    store = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=8)
    cfg = LDAConfig(num_topics=4, vocab_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.TopicServer(store, cfg)
    w = np.zeros((2, 3), np.int32)
    c = np.ones((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.infer(w, c, np.ones((2, 4), np.float32),
                  np.full((8, 4), 0.125, np.float32), alpha_m1=0.01)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--workdir", str(tmp_path / "cli"), "--topics", "4",
                    "--vocab", "8", "--make-store"])
    # the explicit CPU choice runs the plain path
    r = ops.infer(w, c, np.ones((2, 4), np.float32),
                  np.full((8, 4), 0.125, np.float32), alpha_m1=0.01,
                  max_sweeps=2, check_every=2, device="cpu")
    assert r.sweeps == 2 and r.theta.device.type == "cpu"


def test_training_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import FOEMTrainer, LDAConfig, MinibatchData
    from repro_torch.core import ParameterStore, foem
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    store = ParameterStore(str(tmp_path), num_topics=4, vocab_capacity=8)
    cfg = LDAConfig(num_topics=4, vocab_size=8, max_sweeps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FOEMTrainer(cfg, store)
    w = np.zeros((2, 3), np.int32)
    c = np.ones((2, 3), np.float32)
    mu = np.full((2, 3, 4), 0.25, np.float32)
    th, phi = mu.sum(1), np.ones((8, 4), np.float32)
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=0.08)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.sweep(w, c, mu, th, phi, phi.sum(0), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        foem.foem_minibatch(None, MinibatchData(w, c), phi, phi.sum(0), cfg,
                            mu0=mu)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--workdir", str(tmp_path / "cli"), "--steps", "1"])
    # the explicit CPU choice runs the plain path
    r = ops.sweep(w, c, mu, th, phi, phi.sum(0), **kw, device="cpu")
    assert r.mu.device.type == "cpu" and r.loglik is None
    res = foem.foem_minibatch(None, MinibatchData(w, c), phi, phi.sum(0),
                              cfg, mu0=mu, device="cpu")
    assert res.diag.sweeps_run == 2
    assert FOEMTrainer(cfg, store, device="cpu").device.type == "cpu"


def test_dryrun_and_examples_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib.util

    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_lda_cell

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--lda", "stream_1k", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_lda_cell("stream_1k").materialize()
    for name in ("quickstart", "train_foem_stream", "serve_topics",
                 "lifelong_serve"):
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--quick", "--workdir", str(tmp_path / name)]
                     if name != "quickstart" else ["--quick"])


def test_cuda_tensors_never_fall_back():
    """The kernel wrappers refuse a device they have no kernel for rather
    than quietly running the plain version there."""
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.theta_sweep import theta_sweep

    t = torch.zeros((1, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        theta_sweep(t.int(), t, t, t, t, alpha_m1=0.01, num_sweeps=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gs_sweep(t.int(), t, t[..., None], t, t, t[0], alpha_m1=0.01,
                 beta_m1=0.01, wb=1.0)


def test_sharded_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.launch.mesh import make_host_mesh, spawn_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn_mesh(print, 1, 2)
    assert make_host_mesh(device="cpu").device.type == "cpu"


def test_lm_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import LM, build, params_from_jax

    cfg = ARCHS["granite-8b"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros((2, 2), np.float32)})
    # the explicit CPU choice runs the plain path
    m = build(cfg, device="cpu")
    p = m.init_params(torch.Generator().manual_seed(0))
    logits, _ = m.prefill(p, {"tokens": torch.zeros((1, 3), dtype=torch.long)})
    assert logits.device.type == "cpu" and logits.shape == (1, 3, 512)


@pytest.mark.parametrize("name", [
    "repro_torch.data.uci",
    "repro_torch.core.baselines",
    "repro_torch.launch.serve",
])
def test_baselines_and_engine_modules_stand_alone(name):
    """The corpus loader, the baselines and the serving engine import
    without JAX, and the E-step kernel OVB and SCVB run on is one of the
    build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.kernels import build\n"
        "assert 'fused_estep' in build.KERNELS\n"
        "assert (build.CSRC / 'fused_estep.cu').exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_baselines_and_engine_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import GlobalStats, LDAConfig, MinibatchData
    from repro_torch.core.baselines import ALGORITHMS
    from repro_torch.launch import serve

    cfg = LDAConfig(num_topics=4, vocab_size=8, max_sweeps=2)
    w = np.zeros((2, 3), np.int32)
    c = np.ones((2, 3), np.float32)
    phi = np.ones((8, 4), np.float32)
    stats = GlobalStats(phi, phi.sum(0), np.int32(0))
    for name, step in ALGORITHMS.items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            step(torch.Generator(), MinibatchData(w, c), stats, cfg)
        # the explicit CPU choice runs the plain path
        new, _, diag = step(torch.Generator(), MinibatchData(w, c), stats,
                            cfg, device="cpu")
        assert new.phi_wk.device.type == "cpu", name
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.document_theta0([0, 1], c, cfg)
    assert serve.document_theta0([0, 1], c, cfg, device="cpu").shape == (2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--workdir", str(tmp_path / "cli"), "--topics", "4",
                    "--vocab", "8", "--make-store", "--traffic",
                    "--requests", "4"])


@pytest.mark.parametrize("name", [
    "repro_torch.launch.lifelong",
    "repro_torch.core.scheduling",
    "repro_torch.core.streaming",
])
def test_lifelong_modules_stand_alone(name):
    """The lifelong slice's modules import without JAX, and the kernels its
    path runs are among the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.kernels import build\n"
        "for k in ('theta_sweep', 'gs_sweep', 'scheduled_sweep'):\n"
        "    assert k in build.KERNELS and (build.CSRC / f'{k}.cu').exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_lifelong_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import (
        FOEMTrainer, LDAConfig, ParameterStore, SnapshotPublisher,
    )
    from repro_torch.launch import lifelong, serve

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lifelong.run_lifelong(workdir=str(tmp_path / "run"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lifelong.main(["--quick", "--workdir", str(tmp_path / "cli")])
    assert not (tmp_path / "run").exists()        # raised before any I/O
    assert not (tmp_path / "cli").exists()
    store = ParameterStore(str(tmp_path / "s"), num_topics=4,
                           vocab_capacity=8)
    pub = SnapshotPublisher(store)
    cfg = LDAConfig(num_topics=4, vocab_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FOEMTrainer(cfg, store, publisher=pub, publish_every=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.TopicServer(store, cfg)
    # the explicit CPU choice serves the committed snapshot
    pub.publish()
    srv = serve.TopicServer(store, cfg, device="cpu")
    srv.subscribe(pub)
    srv.infer(np.zeros((1, 2), np.int32), np.ones((1, 2), np.float32))
    assert srv.last_version == 1


@pytest.mark.parametrize("name", [
    "repro_torch.runtime.fault_tolerance",
    "repro_torch.runtime.elastic",
    "repro_torch.checkpoint.ckpt",
    "repro_torch.checkpoint.elastic",
    "repro_torch.launch.replica",
])
def test_fault_tolerant_modules_stand_alone(name):
    """The fault-tolerant slice's modules import without JAX, and the
    kernels its paths run are among the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.kernels import build\n"
        "for k in ('theta_sweep', 'gs_sweep', 'scheduled_sweep',\n"
        "          'sharded_sweep'):\n"
        "    assert k in build.KERNELS and (build.CSRC / f'{k}.cu').exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_fault_tolerant_entry_points_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import LDAConfig, ParameterStore
    from repro_torch.launch import serve
    from repro_torch.launch.replica import ReplicaPool, ReplicaSpec
    from repro_torch.runtime.elastic import ElasticFOEMRuntime

    cfg = LDAConfig(num_topics=4, vocab_size=8)
    ParameterStore(str(tmp_path / "s"), num_topics=4,
                   vocab_capacity=8).flush()
    spec = ReplicaSpec(store_path=str(tmp_path / "s"), cfg=cfg,
                       vocab_capacity=8)
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spec.build_server()
    for backend in ("process", "thread"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReplicaPool(spec, replicas=2, backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticFOEMRuntime(cfg, num_shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--workdir", str(tmp_path / "cli"), "--topics", "4",
                    "--vocab", "8", "--make-store", "--traffic",
                    "--requests", "4", "--replicas", "2"])
    # the explicit CPU choice runs
    rt = ElasticFOEMRuntime(cfg, num_shards=2, device="cpu")
    assert rt.phi_wk.device.type == "cpu" and rt.phi_k.dtype == torch.float64
    srv = ReplicaSpec(store_path=str(tmp_path / "s"), cfg=cfg,
                      vocab_capacity=8, device="cpu").build_server()
    assert srv.device.type == "cpu"


@pytest.mark.parametrize("name", [
    "repro_torch.analysis",
    "repro_torch.analysis.__main__",
    "repro_torch.analysis.budget",
    "repro_torch.analysis.card",
    "repro_torch.analysis.checks",
    "repro_torch.analysis.contracts",
    "repro_torch.analysis.launches",
    "repro_torch.analysis.lint",
    "repro_torch.analysis.modules",
    "repro_torch.analysis.sanitizer",
    "repro_torch.analysis.validate",
])
def test_analysis_modules_stand_alone(name):
    """The analysis layer's modules import without JAX, and every CUDA
    source they check is among the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.analysis.contracts import KERNEL_CONTRACTS\n"
        "from repro_torch.kernels import build\n"
        "for c in KERNEL_CONTRACTS.values():\n"
        "    assert set(c.libraries) <= set(build.KERNELS)\n"
        "    assert (build.CSRC / c.source).exists()\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("argv", [["-m", "repro_torch.analysis",
                                   "--reference"],
                                  ["-m", "repro_torch.analysis.lint"]])
def test_analysis_cli_and_lint_run_without_jax_or_a_card(argv):
    """``python -m repro_torch.analysis --reference`` and ``python -m
    repro_torch.analysis.lint`` exit 0 on a host with no card, JAX
    hidden."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"sys.argv = [{argv[1]!r}] + {argv[2:]!r}\n"
            f"runpy.run_module({argv[1]!r}, run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert ("'fail': 0" in out.stdout) or ("lint: clean" in out.stdout)



@pytest.mark.parametrize("name", [
    "repro_torch.optim",
    "repro_torch.optim.adamw",
    "repro_torch.optim.schedules",
    "repro_torch.launch.train",
])
def test_lm_training_slice_modules_stand_alone(name):
    """The LM training slice's modules import without JAX, and the
    attention backward kernel's CUDA source is one of the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.kernels import build\n"
        "assert 'flash_attention_bwd' in build.KERNELS\n"
        "assert (build.CSRC / 'flash_attention_bwd.cu').exists()\n"
        "from repro_torch.kernels.flash_attention import (\n"
        "    FlashAttentionFunction, flash_attention_backward)\n"
        "from repro_torch.data.synthetic import synthetic_token_stream\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_lm_clis_and_example_default_to_the_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    import importlib.util

    from repro_torch.launch import serve, train

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "granite-8b", "--workdir", str(tmp_path / "t"),
                    "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "granite-8b", "--gen-tokens", "1"])
    spec = importlib.util.spec_from_file_location(
        "torch_example_train_lm", ROOT / "examples" / "torch" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--quick", "--workdir", str(tmp_path / "ex")])


def test_attention_backward_never_falls_back():
    """The backward wrapper refuses a device it has no kernel for."""
    from repro_torch.kernels.flash_attention import flash_attention_backward

    t = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention_backward(t, t, t, t, t, t[..., 0])
