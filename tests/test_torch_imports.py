"""The PyTorch port stands alone: no JAX, no JAX package, GPU by default.

* Every module of ``repro_torch`` imports in a fresh interpreter in which
  ``import jax`` and ``import repro`` fail.
* No file of the port, nor ``chip_smoke.py``, has an import statement
  naming ``jax``/``jaxlib`` or ``repro``.
* The entry points — serving (``TopicServer``, ``ops.infer``, the serve
  CLI), training (``FOEMTrainer``, ``ops.sweep``, ``foem_minibatch``,
  the train CLI), the sharded step's meshes (``make_host_mesh``,
  ``spawn_mesh``), the LM's serving path (``LM``, ``build``,
  ``params_from_jax``), the baselines (``ovb_step``, ``scvb_step``,
  ``ogs_step``), the serving engine's θ̂₀ draw and ``--traffic`` CLI, and
  the lifelong entry points (``run_lifelong``, its CLI, the subscribed
  server) —
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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
])
def test_lm_slice_modules_stand_alone(name):
    """The LM serving slice's modules import without JAX, the registry's
    config modules too, and the attention kernel's CUDA source is one of
    the build's."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"import importlib; importlib.import_module({name!r})\n"
        "from repro_torch.configs.registry import ARCHS\n"
        "assert all(ARCHS[n].family == 'dense' for n in ARCHS)\n"
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
