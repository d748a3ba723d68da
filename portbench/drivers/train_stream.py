"""``train_stream``: ``FOEMTrainer.fit_stream`` over a seeded minibatch
stream, φ̂ resident in the store's hot buffer.

Set-up builds one trainer and drives it through ``checked_steps`` steps of
``fit_stream`` (the kernels build and warm up there), keeping each step's
minibatch, the rows it wrote back and the store's φ̂(k).  The window calls
``fit_stream`` again on the same trainer and stream and ends with the
first step that ends after ``--seconds``: the step's callback raises, so
``fit_stream`` never reaches its store flush.  After the window the
trainer and the store are freed, and the reference follows the checked
steps from the same φ̂, minibatches and μ₀ draws.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs
from portbench.drivers import common
from portbench.reference import lda as ref


#: tokens: the largest entry of a row the checks resolve (float32 spacing
#: 2⁻¹⁵ there, under a token's 1/K share of a sweep's Δ at K = 10⁴)
RESOLVED_ROW = 256.0


class _Stop(Exception):
    """Raised from a step's callback to end a ``fit_stream`` call."""


class MinibatchSource:
    """The seeded minibatch stream.  Minibatch i holds documents
    ``DocSource.docs(i, D_s)`` in the (D_s, L) layout.  Each ``stream()``
    call is a new iterator over the next indices; ``take(call)`` returns
    the oldest minibatch that call yielded and no step has taken yet (a
    ``fit_stream`` call trains its stream's items in order; what its
    prefetcher staged and never trained is dropped with the call)."""

    def __init__(self, cfg: dict, seed: int):
        self.docs = inputs.DocSource(cfg, seed)
        self.D, self.L = cfg["minibatch_docs"], cfg["bucket_len"]
        self.next_index = 0
        self.pending: Dict[int, collections.deque] = {}
        self.lock = threading.Lock()
        self.tokens_drawn = self.tokens_cut = 0

    def make(self, index: int):
        from repro_torch.sparse.minibatch import Minibatch

        docs = self.docs.docs(index, self.D)
        word_ids, counts = inputs.dense_layout(docs, self.L)
        vocab, local = inputs.localize(word_ids)
        mb = Minibatch(word_ids=word_ids, counts=counts, local_vocab=vocab,
                       local_word_ids=local, index=index)
        real = counts > 0
        mb.work = {"tokens": float(counts.sum()), "n": int(real.sum()),
                   "docs": int(real.any(1).sum()),
                   "rows": int(len(np.unique(word_ids[real])))}
        return mb, docs

    def stream(self, call: int):
        queue = self.pending.setdefault(call, collections.deque())
        while True:
            with self.lock:
                index = self.next_index
                self.next_index += 1
            mb, docs = self.make(index)
            with self.lock:
                self.tokens_drawn += docs.tokens_drawn
                self.tokens_cut += docs.tokens_cut
            queue.append(mb)
            yield mb

    def take(self, call: int):
        return self.pending[call].popleft()


class TrainStream:
    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.steps: List[dict] = []
        self.spans: List[tuple] = []
        self.checked: List[dict] = []
        self.t0 = self.t1 = 0.0

    # ------------------------------------------------------------ program

    def setup(self) -> None:
        from repro_torch.core.trainer import FOEMTrainer

        self.resident = common.ResidentStore(self.cfg, self.seed, self.device)
        self.source = MinibatchSource(self.cfg, self.seed)
        self.trainer = FOEMTrainer(
            common.lda_config(self.cfg), self.resident.store,
            seed=inputs.sub_seed(self.seed, inputs.TRAINER),
            prefetch_depth=self.mix["prefetch_depth"], device=self.device)
        store = self.resident.store

        def keep(m):
            mb = self.source.take(0)
            self.checked.append({
                "sweeps": m.sweeps, "ppl": m.train_ppl, "mb": mb,
                "rows": store.fetch_rows(mb.local_vocab, promote=False),
                "phi_k": store.phi_k.copy()})
            if len(self.checked) >= self.mix["checked_steps"]:
                raise _Stop

        self._fit(0, keep)

    def _fit(self, call: int, callback) -> None:
        try:
            self.trainer.fit_stream(self.source.stream(call),
                                    callback=callback)
        except _Stop:
            pass
        self.source.pending.pop(call, None)

    def window(self, seconds: float, trace) -> None:
        trace.start()
        self.t0 = time.perf_counter()
        end = self.t0 + seconds

        def record(m):
            t = time.perf_counter()
            mb = self.source.take(1)
            self.steps.append({
                "sweeps": m.sweeps, "seconds": m.seconds,
                "fetch_s": m.fetch_seconds, "compute_s": m.compute_seconds,
                "writeback_s": m.writeback_seconds, "t_end": t, **mb.work})
            start = t - m.seconds
            tc = start + m.fetch_seconds
            tw = tc + m.compute_seconds
            self.spans += [("step.fetch_wait", start, tc),
                           ("step.compute", tc, tw),
                           ("step.writeback", tw, tw + m.writeback_seconds),
                           ("step.other", tw + m.writeback_seconds, t)]
            if t >= end:
                self.t1 = t
                raise _Stop

        self._fit(1, record)
        trace.stop()

    def close_program(self) -> None:
        self.trainer = None
        self.resident.close()
        common.free_device(self.device)

    # ------------------------------------------------------------ results

    def attempted(self) -> int:
        return len(self.steps)

    def failed(self) -> int:
        return 0

    def record(self) -> dict:
        return {"kind": "train", "steps": self.steps, "spans": self.spans,
                "window_s": self.t1 - self.t0,
                "tokens_drawn": self.source.tokens_drawn,
                "tokens_cut": self.source.tokens_cut}

    def stand_in(self, dtype) -> None:
        """The reference at ``dtype``, with its own stop rule, in the
        program's place: it makes the checked steps (the control)."""
        self.source = MinibatchSource(self.cfg, self.seed)
        phi, phi_k = common.reference_phi(self.cfg, self.seed, self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            inputs.sub_seed(self.seed, inputs.TRAINER))
        for index in range(self.mix["checked_steps"]):
            mb, _ = self.source.make(index)
            vocab = torch.from_numpy(mb.local_vocab.astype(np.int64)).to(
                self.device)
            rows_in = phi[vocab]
            mu = ref.draw_mu0(gen, (self.cfg["minibatch_docs"],
                                    self.cfg["bucket_len"],
                                    self.cfg["num_topics"]))
            res = ref.foem_step(
                torch.from_numpy(mb.local_word_ids).to(self.device),
                torch.from_numpy(mb.counts).to(self.device),
                rows_in, phi_k.float(), mu, common.hyper(self.cfg),
                None, dtype)
            phi_k = phi_k + (res["rows"].double() - rows_in.double()).sum(0)
            phi[vocab] = res["rows"]
            self.checked.append({
                "sweeps": res["sweeps"], "ppl": res["ppl"], "mb": mb,
                "rows": ref.as_numpy(res["rows"]),
                "phi_k": ref.as_numpy(phi_k)})
            del mu, res, rows_in
        del phi
        common.free_device(self.device)

    def check(self, dtype=torch.float32) -> Dict[str, float]:
        """The reference's numbers over the checked steps (the largest of
        the steps).  The reference follows its own state from the seed's
        φ̂; the program's state before each step is rebuilt from the seed's
        φ̂ and the rows it wrote back, so each step's change is compared
        with the reference's change from the same start.

        The row numbers take the *resolved* rows, those whose largest
        entry before the step is under ``RESOLVED_ROW`` tokens: a float32
        row of ≈ 10⁶ tokens (the head words) rounds each column's fold of a
        token's Δ to its spacing (0.06–0.25), so there the change is mostly
        rounding, in another order on each side.

        * ``rows_gap``: Σ|Δrows_p − Δrows_r| / Σ|Δrows_r| over the resolved
          rows;
        * ``mass_gap``: the largest |Σ_k Δrows_p − Σ_k Δrows_r| of a
          resolved word over max(Σ_k Δrows_r, 1): each word's row grows by
          its tokens;
        * ``phik_gap``: Σ_k |Δφ̂(k)_p − Δφ̂(k)_r| / Σ_k |Δφ̂(k)_r|, the
          store's φ̂(k) change against the reference's (all rows);
        * ``ppl_gap``: |ppl_p − ppl_r| / ppl_r, the stop rule's last
          perplexity (all words);
        * ``stop_mismatch``, ``steps_missing`` (``reference/lda.py``);
        * ``rows_gap_all``: ``rows_gap`` over every row, head rows' rounding
          included (reported, not compared).

        A step that writes back nothing reads 1 on the first three.
        """
        cfg, hp = self.cfg, common.hyper(self.cfg)
        ref.exact_float32()
        phi, phi_k = common.reference_phi(cfg, self.seed, self.device)
        prog, prog_k = phi.clone(), phi_k.clone()
        gen = torch.Generator(device=self.device).manual_seed(
            inputs.sub_seed(self.seed, inputs.TRAINER))
        out = {"rows_gap": 0.0, "mass_gap": 0.0, "ppl_gap": 0.0,
               "rows_gap_all": 0.0, "phik_gap": 0.0, "stop_mismatch": 0.0,
               "steps_missing": float(self.mix["checked_steps"]
                                      - len(self.checked))}
        for step in self.checked:
            mb = step["mb"]
            vocab = torch.from_numpy(mb.local_vocab.astype(np.int64)).to(
                self.device)
            rows_in = phi[vocab]
            mu = ref.draw_mu0(gen, (cfg["minibatch_docs"], cfg["bucket_len"],
                                    cfg["num_topics"]))
            res = ref.foem_step(
                torch.from_numpy(mb.local_word_ids).to(self.device),
                torch.from_numpy(mb.counts).to(self.device),
                rows_in, phi_k.float(), mu, hp, step["sweeps"], dtype)
            del mu
            d_r = res["rows"] - rows_in
            got = torch.from_numpy(step["rows"]).to(self.device)
            d_p = got - prog[vocab]
            got_k = torch.from_numpy(step["phi_k"]).to(self.device)
            dk_r = d_r.sum(0, dtype=torch.float64)
            fine = rows_in.amax(1) < RESOLVED_ROW
            m_r = d_r[fine].sum(1, dtype=torch.float64)
            m_p = d_p[fine].sum(1, dtype=torch.float64)
            out["rows_gap"] = max(out["rows_gap"],
                                  ref.gap_l1(d_p[fine], d_r[fine]))
            out["mass_gap"] = max(out["mass_gap"], float(
                ((m_p - m_r).abs() / m_r.clamp_min(1.0)).max()))
            out["rows_gap_all"] = max(out["rows_gap_all"],
                                      ref.gap_l1(d_p, d_r))
            out["phik_gap"] = max(out["phik_gap"], ref.gap_l1(
                got_k - prog_k, dk_r))
            out["ppl_gap"] = max(out["ppl_gap"],
                                 abs(step["ppl"] - res["ppl"]) / res["ppl"])
            out["stop_mismatch"] += ref.stop_disagreements(
                res["checks"], step["sweeps"], hp["max_sweeps"],
                hp["ppl_rel_tol"])
            phi[vocab] = res["rows"]
            phi_k = phi_k + dk_r
            prog[vocab] = got
            prog_k = got_k
            del got, rows_in, res, d_r, d_p
        return out
