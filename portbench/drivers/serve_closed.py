"""``serve_closed``: a closed loop of ``clients`` clients against
``ServingEngine`` over ``TopicServer``, φ̂ resident in the store's hot
buffer.

Each client submits one document; the done-callback of its request (run
by the engine's launcher thread) records the answer and submits the
client's next document, so there is no thread a client and the engine
always has ``clients`` requests in flight.  Documents come from a pool of
``doc_pool`` seeded documents, request r taking document r mod the pool
and its own θ̂₀ seed.  Set-up prewarms one launch per L bucket the pool
reaches and then serves ``warmup_seconds`` before the window opens; the
window counts what resolves inside it.  Afterwards the clients stop, the
engine drains and closes, and the reference refits ``sampled_launches``
whole launches drawn from the seed, with each launch's own sweeps.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import inputs
from portbench.drivers import common
from portbench.reference import lda as ref

DRAIN_SECONDS = 60.0


def round_up(n: int, multiple: int) -> int:
    return -(-max(n, 1) // multiple) * multiple


class ServeClosed:
    def __init__(self, cfg: dict, mix: dict, seed: int,
                 device: torch.device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.lock = threading.Lock()
        self.requests: List[dict] = []
        self.t0 = self.t1 = 0.0
        self.t_stop = float("inf")
        self.engine = None

    # ------------------------------------------------------------ program

    def setup(self) -> None:
        from repro_torch.launch.serve import ServingEngine, TopicServer

        mix, cfg = self.mix, self.cfg
        docs = inputs.DocSource(cfg, self.seed).docs(0, mix["doc_pool"])
        self.pool = inputs.doc_list(docs)
        self.tokens_drawn, self.tokens_cut = docs.tokens_drawn, docs.tokens_cut
        rng = np.random.default_rng(inputs.sub_seed(self.seed, inputs.ROUTER))
        self.seeds = rng.integers(0, 1 << 32, size=1 << 22, dtype=np.int64)
        self.resident = common.ResidentStore(cfg, self.seed, self.device)
        server = TopicServer(
            self.resident.store, common.lda_config(cfg),
            fit_sweeps=mix["fit_sweeps"], phi_dtype=mix["phi_dtype"],
            hot_rows=mix["hot_rows"], device=self.device)
        self.engine = ServingEngine(
            server, max_batch=mix["max_batch"],
            bucket_multiple=mix["bucket_multiple"],
            max_delay_ms=mix["max_delay_ms"], max_len=cfg["bucket_len"],
            seed=inputs.sub_seed(self.seed, inputs.ROUTER))
        self.engine.prewarm(sorted({round_up(len(w), mix["bucket_multiple"])
                                    for w, _ in self.pool}))
        for _ in range(mix["clients"]):
            self._submit()
        time.sleep(mix["warmup_seconds"])

    def _submit(self) -> None:
        with self.lock:
            rid = len(self.requests)
            w, c = self.pool[rid % len(self.pool)]
            req = {"rid": rid, "seed": int(self.seeds[rid % len(self.seeds)]),
                   "doc": rid % len(self.pool), "t_sub": 0.0,
                   "t_done": None, "launch": -1, "theta": None,
                   "error": None}
            self.requests.append(req)
        req["t_sub"] = time.perf_counter()
        fut = self.engine.submit(w, c, seed=req["seed"])
        fut.add_done_callback(lambda f, req=req: self._done(req, f))

    def _done(self, req: dict, fut) -> None:
        t = time.perf_counter()
        # the launch's record is appended after all of its futures resolve
        req["launch"] = len(self.engine.router.batch_log)
        err = fut.exception()
        if err is None:
            req["theta"] = fut.result()
        else:
            req["error"] = repr(err)
        req["t_done"] = t
        if t < self.t_stop:
            self._submit()

    def window(self, seconds: float, trace) -> None:
        trace.start()
        self.t0 = time.perf_counter()
        self.t1 = self.t_stop = self.t0 + seconds
        time.sleep(max(0.0, self.t1 - time.perf_counter()))
        trace.stop()
        deadline = time.perf_counter() + DRAIN_SECONDS
        while time.perf_counter() < deadline:
            with self.lock:
                waiting = sum(r["t_done"] is None for r in self.requests)
            if not waiting:
                break
            time.sleep(0.05)
        if waiting:             # a launch hung: close admission only
            self.engine.router.close()
        else:
            self.engine.close()
        self.log = list(self.engine.router.batch_log)

    def close_program(self) -> None:
        self.engine = None
        self.resident.close()
        common.free_device(self.device)

    # ------------------------------------------------------------ results

    def _in_window(self):
        return [r for r in self.requests
                if r["t_done"] is not None and self.t0 <= r["t_done"] <= self.t1]

    def _lost(self):
        return [r for r in self.requests if r["t_done"] is None]

    def attempted(self) -> int:
        return len(self._in_window()) + len(self._lost())

    def failed(self) -> int:
        return (sum(r["error"] is not None for r in self._in_window())
                + len(self._lost()))

    def launches(self) -> Dict[int, List[dict]]:
        """The launches that resolved inside the window: index → requests."""
        out: Dict[int, List[dict]] = {}
        for r in self._in_window():
            if r["error"] is None:
                out.setdefault(r["launch"], []).append(r)
        return out

    def record(self) -> dict:
        ok = [r for r in self._in_window() if r["error"] is None]
        lat = [(r["t_done"] - r["t_sub"]) * 1e3 for r in ok]
        lat += [float("inf")] * self.failed()
        launches, spans = [], []
        for idx, reqs in sorted(self.launches().items()):
            log = self.log[idx]
            end = max(r["t_done"] for r in reqs)
            start = end - log["launch_seconds"]
            t_fit = end - log["fit_seconds"]
            spans += [("launch.theta0", start, t_fit - log["fetch_seconds"]),
                      ("launch.row_fetch", t_fit - log["fetch_seconds"],
                       t_fit),
                      ("launch.fit", t_fit, end)]
            if start < self.t0:
                continue            # partly before the window
            words = [self.pool[r["doc"]][0] for r in reqs]
            launches.append({
                **log, "n": int(sum(len(w) for w in words)),
                "docs": len(reqs),
                "rows": int(len(np.unique(np.concatenate(words))))})
        return {"kind": "serve", "window_s": self.t1 - self.t0,
                "resolved": len(ok), "latencies_ms": lat,
                "launches": launches, "spans": spans,
                "tokens_drawn": self.tokens_drawn,
                "tokens_cut": self.tokens_cut}

    def stand_in(self, dtype) -> None:
        """The reference at ``dtype`` in the program's place: the pool's
        documents packed by L bucket into launches of up to ``max_batch``,
        the ``sampled_launches`` fullest fitted, each with its own stop
        rule (the control)."""
        mix, cfg = self.mix, self.cfg
        docs = inputs.DocSource(cfg, self.seed).docs(0, mix["doc_pool"])
        self.pool = inputs.doc_list(docs)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, inputs.ROUTER))
        self.seeds = rng.integers(0, 1 << 32, size=1 << 22, dtype=np.int64)
        by_bucket: Dict[int, List[int]] = {}
        for i, (w, _) in enumerate(self.pool):
            by_bucket.setdefault(round_up(len(w), mix["bucket_multiple"]),
                                 []).append(i)
        batches = [m[i:i + mix["max_batch"]] for m in by_bucket.values()
                   for i in range(0, len(m), mix["max_batch"])]
        batches.sort(key=len, reverse=True)
        self.log = []
        for g, members in enumerate(batches[:mix["sampled_launches"]]):
            reqs = [{"rid": i, "seed": int(self.seeds[i]), "doc": i,
                     "launch": g, "error": None} for i in members]
            res = self._fit(reqs, None, dtype)
            for r, th in zip(reqs, ref.as_numpy(res["theta"])):
                r["theta"] = th
            self.log.append({"sweeps": res["sweeps"]})
            self.requests += reqs
        self.sampled = list(range(len(self.log)))
        common.free_device(self.device)

    def _fit(self, reqs: List[dict], sweeps, dtype, phi=None, phi_k=None):
        """The reference fit of one launch's documents, for ``sweeps``
        sweeps or, when None, to its own stop rule."""
        cfg, hp = self.cfg, common.hyper(self.cfg)
        if phi is None:
            phi, phi_k = common.reference_phi(cfg, self.seed, self.device)
        words = [self.pool[r["doc"]][0] for r in reqs]
        L = round_up(max(len(w) for w in words), self.mix["bucket_multiple"])
        vocab = np.unique(np.concatenate(words))
        ids = np.zeros((len(reqs), L), np.int64)
        counts = np.zeros((len(reqs), L), np.float32)
        for i, r in enumerate(reqs):
            w, c = self.pool[r["doc"]]
            ids[i, :len(w)] = np.searchsorted(vocab, w)
            counts[i, :len(c)] = c
        dev = self.device
        counts_t = torch.from_numpy(counts).to(dev)
        theta = ref.theta0([r["seed"] for r in reqs], counts_t,
                           cfg["num_topics"], dtype)
        rows = phi[torch.from_numpy(vocab.astype(np.int64)).to(dev)]
        phin = ref.normalize_phi(rows, phi_k.float(), hp, dtype)
        hp = dict(hp, max_sweeps=self.mix["fit_sweeps"])
        if sweeps is None:
            full = ref.theta_fit(torch.from_numpy(ids).to(dev), counts_t,
                                 theta, phin, hp, hp["max_sweeps"], dtype)
            stop = next((t for t, _, rel in full["checks"]
                         if rel < hp["ppl_rel_tol"]), hp["max_sweeps"])
            sweeps = stop
        out = ref.theta_fit(torch.from_numpy(ids).to(dev), counts_t, theta,
                            phin, hp, sweeps, dtype)
        out["sweeps"] = sweeps
        return out

    def check(self, dtype=torch.float32) -> Dict[str, float]:
        """The reference's numbers over the sampled launches: ``theta_gap``
        (the largest |θ_program − θ_reference| of any document and topic)
        and ``stop_mismatch``."""
        hp = common.hyper(self.cfg)
        ref.exact_float32()
        if not hasattr(self, "sampled"):
            launches = self.launches()
            rng = np.random.default_rng(inputs.sub_seed(self.seed,
                                                        inputs.SAMPLE))
            keys = sorted(launches)
            k = min(self.mix["sampled_launches"], len(keys))
            self.sampled = sorted(rng.choice(keys, size=k, replace=False)
                                  .tolist()) if k else []
        phi, phi_k = common.reference_phi(self.cfg, self.seed, self.device)
        out = {"theta_gap": 0.0, "stop_mismatch": 0.0,
               "launches_missing": float(self.mix["sampled_launches"]
                                         - len(self.sampled))}
        for idx in self.sampled:
            reqs = [r for r in self.requests
                    if r["launch"] == idx and r["error"] is None]
            sweeps = self.log[idx]["sweeps"]
            res = self._fit(reqs, sweeps, dtype, phi, phi_k)
            got = torch.from_numpy(np.stack([np.asarray(r["theta"])
                                             for r in reqs])).to(self.device)
            out["theta_gap"] = max(out["theta_gap"], float(
                (got - res["theta"]).abs().max()))
            out["stop_mismatch"] += ref.stop_disagreements(
                res["checks"], sweeps, self.mix["fit_sweeps"],
                hp["ppl_rel_tol"])
        return out
