"""The port's train CLI flags and its LDA examples, on the CPU.

* ``--topics-true`` draws the JAX CLI's synthetic corpus bitwise (0 means
  ``--topics``): both CLIs' ``synthetic_lda_corpus`` calls are captured
  and compared, the JAX one stopped before it trains.
* ``--log-every 2`` prints every second step's line.
* Each ``examples/torch/*.py`` runs in-process with ``--quick --device
  cpu``.
"""
import importlib.util
import os
import re

import numpy as np
import pytest

import repro.launch.train as jtrain
from repro_torch.launch import train

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples", "torch")
SMALL = ["--docs", "80", "--vocab", "200", "--topics", "8", "--minibatch",
         "32", "--doc-len", "24", "--max-sweeps", "6", "--active-topics",
         "4", "--seed", "3"]


class _Drawn(Exception):
    """Stops the JAX CLI once its corpus is drawn."""


def _capture(monkeypatch, module, stop):
    got = []
    draw = module.synthetic_lda_corpus

    def capture(*args, **kwargs):
        got.append(draw(*args, **kwargs))
        if stop:
            raise _Drawn
        return got[-1]

    monkeypatch.setattr(module, "synthetic_lda_corpus", capture)
    return got


@pytest.mark.parametrize("topics_true", [0, 3])
def test_topics_true_draws_the_jax_clis_corpus(monkeypatch, tmp_path,
                                              topics_true):
    flags = SMALL + ["--topics-true", str(topics_true)]
    want = _capture(monkeypatch, jtrain, stop=True)
    monkeypatch.setattr("sys.argv", ["train.py", "--workdir",
                                     str(tmp_path / "jax")] + flags)
    with pytest.raises(_Drawn):
        jtrain.main()
    got = _capture(monkeypatch, train, stop=False)
    train.main(flags + ["--steps", "1", "--device", "cpu", "--workdir",
                        str(tmp_path / "torch")])
    (corpus, phi_true), (jcorpus, jphi_true) = got[0], want[0]
    assert phi_true.shape == (200, topics_true or 8)
    np.testing.assert_array_equal(phi_true, np.asarray(jphi_true))
    for name in ("indptr", "word_ids", "counts"):
        np.testing.assert_array_equal(getattr(corpus, name),
                                      np.asarray(getattr(jcorpus, name)),
                                      err_msg=name)


def test_log_every_prints_every_second_step(tmp_path, capsys):
    ppl = train.main(SMALL + ["--steps", "4", "--log-every", "2",
                              "--device", "cpu", "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert [int(s) for s in re.findall(r"^step\s+(\d+) ", out, re.M)] == [2, 4]
    assert "trained 4 minibatches" in out and 1.0 < ppl < 200


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["quickstart", "train_foem_stream",
                                  "serve_topics", "lifelong_serve"])
def test_example_runs_quick_on_the_cpu(name, tmp_path, capsys):
    argv = ["--quick", "--device", "cpu"]
    if name != "quickstart":
        argv += ["--workdir", str(tmp_path / name)]
    out = _example(name).main(argv)
    text = capsys.readouterr().out
    if name == "quickstart":
        assert len(out) == 4 and all(np.isfinite(out)) and "topic 11" in text
    elif name == "train_foem_stream":
        assert 1.0 < out < 1000 and "predictive perplexity" in text
    elif name == "serve_topics":
        assert "no trained store found" in text and "served 64 docs" in text
    else:
        assert out["failed_requests"] == 0 and out["train_steps"] == 6
