"""``LDAConfig(debug_checks=True)`` is refused, not ignored, by the port.

The JAX package turns ``cfg.debug_checks`` into its numerical-invariant
sanitizer (checkify in the trainer and the server, invariants in
``ops.sweep`` / ``ops.infer``).  The port has no sanitizer yet (ROADMAP.md
queue 1 item 6), so every entry point that takes the flag raises
``ContractError`` naming that item before it does any work, on the CPU as
on the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.foem_sharded import foem_step_sharded
from repro_torch.core.sem import sem_step
from repro_torch.core.streaming import ParameterStore
from repro_torch.core.trainer import FOEMTrainer
from repro_torch.core.types import GlobalStats, LDAConfig, MinibatchData
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import TopicServer

D, L, K, W = 3, 4, 5, 20


def _arrays():
    rng = np.random.default_rng(0)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 3, (D, L)).astype(np.float32)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    return wid, cnt, phi


def _stats(phi):
    return GlobalStats(phi, phi.sum(0), np.int32(0))


def _infer(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    ops.infer(wid, cnt, np.ones((D, K), np.float32), phi / phi.sum(0),
              alpha_m1=cfg.alpha_m1, debug_checks=cfg.debug_checks,
              device="cpu")


def _sweep(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    mu = np.full((D, L, K), 1.0 / K, np.float32)
    ops.sweep(wid, cnt, mu, np.ones((D, K), np.float32), phi, phi.sum(0),
              alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1,
              wb=W * cfg.beta_m1, debug_checks=cfg.debug_checks,
              device="cpu")


def _trainer(cfg, tmp_path):
    store = ParameterStore(str(tmp_path / "s"), num_topics=K,
                           vocab_capacity=W)
    FOEMTrainer(cfg, store, device="cpu")


def _server(cfg, tmp_path):
    store = ParameterStore(str(tmp_path / "s"), num_topics=K,
                           vocab_capacity=W)
    TopicServer(store, cfg, device="cpu")


def _sem_step(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    sem_step(torch.Generator().manual_seed(0), MinibatchData(wid, cnt),
             _stats(phi), cfg, device="cpu")


def _sharded_step(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    mesh = make_host_mesh(1, 1, device="cpu")
    foem_step_sharded(torch.Generator().manual_seed(0),
                      MinibatchData(wid, cnt), _stats(phi), cfg, mesh)


@pytest.mark.parametrize("entry", [_infer, _sweep, _trainer, _server,
                                   _sem_step, _sharded_step],
                         ids=["ops.infer", "ops.sweep", "FOEMTrainer",
                              "TopicServer", "sem_step", "foem_step_sharded"])
@pytest.mark.parametrize("debug_checks", [True, False])
def test_debug_checks_is_refused(entry, debug_checks, tmp_path):
    """True raises ContractError naming the sanitizer item; False passes
    the same call (it runs, or fails later for reasons of its own)."""
    cfg = LDAConfig(num_topics=K, vocab_size=W, max_sweeps=2,
                    ppl_check_every=1, topk_shards=1,
                    debug_checks=debug_checks)
    if debug_checks:
        with pytest.raises(ops.ContractError,
                           match="debug_checks.*queue 1 item 6"):
            entry(cfg, tmp_path)
    else:
        entry(cfg, tmp_path)
