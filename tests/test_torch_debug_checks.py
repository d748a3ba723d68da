"""``LDAConfig(debug_checks=True)`` in the port: the sanitizer, or a refusal.

The JAX package turns ``cfg.debug_checks`` into its numerical-invariant
sanitizer on every ``ops.sweep`` / ``ops.infer`` result (checkify in the
trainer and the server).  The port runs ``analysis.sanitizer`` at the same
two boundaries, so ``True`` checks every sweep and fit of ``ops.sweep``,
``ops.infer``, ``FOEMTrainer.step``, ``TopicServer``, ``prewarm_server``,
the ``ServingEngine``, ``foem_step_sharded`` and ``ElasticFOEMRuntime``
(each case counts the sanitizer's calls), and ``False`` runs none.
``sem_step`` and the baselines never reach either boundary — in the JAX
package the flag has no effect there — so the port refuses ``True`` with
``ContractError`` rather than run unchecked.
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitizer
from repro_torch.core.baselines import ogs_step, ovb_step, scvb_step
from repro_torch.core.foem_sharded import foem_step_sharded
from repro_torch.core.sem import sem_step
from repro_torch.core.streaming import ParameterStore
from repro_torch.core.trainer import FOEMTrainer
from repro_torch.core.types import GlobalStats, LDAConfig, MinibatchData
from repro_torch.data import synthetic_lda_corpus
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import ServingEngine, TopicServer, prewarm_server
from repro_torch.runtime.elastic import ElasticFOEMRuntime
from repro_torch.sparse import MinibatchStream

D, L, K, W = 3, 4, 5, 20


def _arrays():
    rng = np.random.default_rng(0)
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(1, 3, (D, L)).astype(np.float32)
    phi = rng.gamma(1.0, 1.0, (W, K)).astype(np.float32)
    return wid, cnt, phi


def _stats(phi):
    return GlobalStats(phi, phi.sum(0), np.int32(0))


def _store(tmp_path):
    _, _, phi = _arrays()
    store = ParameterStore(str(tmp_path / "s"), num_topics=K,
                           vocab_capacity=W)
    store.write_rows(np.arange(W), phi)
    store.phi_k[:] = phi.sum(0)
    return store


def _corpus():
    corpus, _ = synthetic_lda_corpus(12, W, K, mean_doc_len=8, seed=3)
    return corpus


def _infer(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    ops.infer(wid, cnt, np.ones((D, K), np.float32), phi / phi.sum(0),
              alpha_m1=cfg.alpha_m1, debug_checks=cfg.debug_checks,
              device="cpu")


def _sweep(cfg, tmp_path, word_topics=None):
    wid, cnt, phi = _arrays()
    mu = np.full((D, L, K), 1.0 / K, np.float32)
    # statistics that hold μ's own mass (a sweep takes it back out)
    np.add.at(phi, wid.reshape(-1), (cnt[..., None] * mu).reshape(-1, K))
    ops.sweep(wid, cnt, mu, np.einsum("dlk,dl->dk", mu, cnt), phi,
              phi.sum(0), alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1,
              wb=W * cfg.beta_m1, word_topics=word_topics,
              debug_checks=cfg.debug_checks, device="cpu")


def _scheduled_sweep(cfg, tmp_path):
    _, _, phi = _arrays()
    _sweep(cfg, tmp_path,
           word_topics=np.argsort(-phi, 1)[:, :2].astype(np.int32))


def _trainer(cfg, tmp_path):
    tr = FOEMTrainer(cfg, _store(tmp_path), device="cpu")
    tr.step(next(iter(MinibatchStream(_corpus(), 6, seed=0))))


def _server(cfg, tmp_path):
    wid, cnt, _ = _arrays()
    TopicServer(_store(tmp_path), cfg, device="cpu").infer(wid, cnt)


def _prewarm(cfg, tmp_path):
    srv = TopicServer(_store(tmp_path), cfg, device="cpu")
    assert prewarm_server(srv, max_batch=2, bucket_multiple=4,
                          max_len=8) == 2


def _engine(cfg, tmp_path):
    srv = TopicServer(_store(tmp_path), cfg, device="cpu")
    wid, cnt, _ = _arrays()
    with ServingEngine(srv, max_batch=2, bucket_multiple=4,
                       max_len=8) as engine:
        futures = [engine.submit(wid[i], cnt[i]) for i in range(D)]
        thetas = [f.result(timeout=60) for f in futures]
    assert all(np.isclose(t.sum(), 1.0, atol=1e-5) for t in thetas)


def _sharded_step(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    mesh = make_host_mesh(1, 1, device="cpu")
    foem_step_sharded(torch.Generator().manual_seed(0),
                      MinibatchData(wid, cnt), _stats(phi), cfg, mesh)


def _elastic(cfg, tmp_path):
    rt = ElasticFOEMRuntime(cfg, num_shards=2, seed=0, device="cpu")
    reports = rt.run(MinibatchStream(_corpus(), 6, seed=0))
    assert reports


def _sem_step(cfg, tmp_path):
    wid, cnt, phi = _arrays()
    sem_step(torch.Generator().manual_seed(0), MinibatchData(wid, cnt),
             _stats(phi), cfg, device="cpu")


def _baseline(step):
    def run(cfg, tmp_path):
        wid, cnt, phi = _arrays()
        step(torch.Generator().manual_seed(0), MinibatchData(wid, cnt),
             _stats(phi), cfg, device="cpu")
    return run


def _cfg(debug_checks):
    return LDAConfig(num_topics=K, vocab_size=W, max_sweeps=2,
                     ppl_check_every=1, topk_shards=1,
                     debug_checks=debug_checks)


@pytest.fixture
def sanitizer_calls(monkeypatch):
    """Count the sanitizer's sweep and inference checks (they still run)."""
    calls = {"sweep": 0, "infer": 0}
    for name, key in (("sweep_invariants", "sweep"),
                      ("infer_invariants", "infer")):
        real = getattr(sanitizer, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(sanitizer, name, counted)
    return calls


CHECKED = {
    "ops.infer": (_infer, "infer"),
    "ops.sweep": (_sweep, "sweep"),
    "ops.sweep scheduled": (_scheduled_sweep, "sweep"),
    "FOEMTrainer": (_trainer, "sweep"),
    "TopicServer": (_server, "infer"),
    "prewarm_server": (_prewarm, "infer"),
    "ServingEngine": (_engine, "infer"),
    "foem_step_sharded": (_sharded_step, "sweep"),
    "ElasticFOEMRuntime": (_elastic, "sweep"),
}


@pytest.mark.parametrize("entry", list(CHECKED))
@pytest.mark.parametrize("debug_checks", [True, False])
def test_debug_checks_runs_the_sanitizer(entry, debug_checks, tmp_path,
                                         sanitizer_calls):
    """True runs the sanitizer on every sweep or fit of the entry point,
    and the clean run passes it; False runs none."""
    fn, kind = CHECKED[entry]
    fn(_cfg(debug_checks), tmp_path)
    if debug_checks:
        assert sanitizer_calls[kind] >= 1
    else:
        assert sanitizer_calls == {"sweep": 0, "infer": 0}


REFUSED = {
    "sem_step": _sem_step,
    "ovb_step": _baseline(ovb_step),
    "scvb_step": _baseline(scvb_step),
    "ogs_step": _baseline(ogs_step),
}


@pytest.mark.parametrize("entry", list(REFUSED))
@pytest.mark.parametrize("debug_checks", [True, False])
def test_debug_checks_is_refused(entry, debug_checks, tmp_path):
    """Where the JAX package's flag has no effect, True raises
    ContractError saying so; False passes the same call."""
    if debug_checks:
        with pytest.raises(ops.ContractError,
                           match="debug_checks=True has no effect here"):
            REFUSED[entry](_cfg(True), tmp_path)
    else:
        REFUSED[entry](_cfg(False), tmp_path)


def test_faulty_sweep_raises_through_the_trainer(tmp_path):
    """A fault that reaches a checked sweep stops the trainer's step with
    SanitizerError: a negative count in the minibatch."""
    mb = next(iter(MinibatchStream(_corpus(), 6, seed=0)))
    mb.counts[0, 0] = -3.0
    tr = FOEMTrainer(_cfg(True), _store(tmp_path), device="cpu")
    with pytest.raises(ops.SanitizerError, match="sanitizer: "):
        tr.step(mb)
