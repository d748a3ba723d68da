"""Faults planted underneath a whole run, to see ``correct`` come out false
(``tests/test_portbench_faults.py`` on the CPU, ``control.py --mode
fault`` on the card).  The benchmark's own runs never load this module.

Each function returns ``(module, attribute, broken)``: set ``attribute``
of ``module`` to ``broken`` for the run, and back afterwards.

* ``unchanged``: the step or fit returns its state as it came in;
* ``half``: the second half of the batch's documents left out (counts 0;
  padding rows are not documents), the step or fit run over the rest;
* ``token``: a token altered where it is produced.  Training: one token
  added to the first slot whose word's row float32 resolves (largest
  entry under ``RESOLVED_ROW``: one token at a head row of ≈ 10⁶ tokens is
  under that row's own rounding, on both sides).  Serving: the first
  document's answer rolled by one topic.
"""
from __future__ import annotations

import torch

from portbench.drivers.train_stream import RESOLVED_ROW

KINDS = ("unchanged", "half", "token")


def drop_half(counts: torch.Tensor) -> torch.Tensor:
    """``counts`` with the second half of its documents' rows zeroed."""
    docs = torch.nonzero(counts.sum(1) > 0).reshape(-1)
    out = counts.clone()
    out[docs[len(docs) // 2:]] = 0
    return out


def train_fault(kind: str):
    from repro_torch.core import foem

    real = foem.foem_minibatch

    def broken(gen, batch, rows, phi_k, cfg, **kw):
        if kind == "half":
            batch = batch._replace(counts=drop_half(batch.counts))
        if kind == "token":
            counts = batch.counts.clone()
            ids = batch.word_ids.long()
            fine = (torch.as_tensor(rows).amax(1) < RESOLVED_ROW).to(
                counts.device)
            slot = int(torch.nonzero(((counts > 0) & fine[ids]).reshape(-1))
                       [0])
            counts.view(-1)[slot] += 1
            batch = batch._replace(counts=counts)
        res = real(gen, batch, rows, phi_k, cfg, **kw)
        if kind == "unchanged":
            res = res._replace(phi_wk=torch.as_tensor(rows).clone(),
                               phi_k=torch.as_tensor(phi_k).clone())
        return res
    return foem, "foem_minibatch", broken


def serve_fault(kind: str):
    from repro_torch.kernels import ops

    real = ops.infer

    def broken(word_ids, est_counts, theta0, phi_norm, **kw):
        if kind == "half":
            est_counts = drop_half(torch.as_tensor(est_counts))
        res = real(word_ids, est_counts, theta0, phi_norm, **kw)
        if kind == "unchanged":
            res = res._replace(theta=torch.as_tensor(theta0).clone())
        if kind == "token":
            theta = res.theta.clone()
            theta[0] = theta[0].roll(1)
            res = res._replace(theta=theta)
        return res
    return ops, "infer", broken


def plant(mix: dict, kind: str):
    """The fault ``kind`` for a cell whose traffic mix is ``mix``."""
    if kind not in KINDS:
        raise ValueError(f"no fault {kind!r}; have {KINDS}")
    make = train_fault if mix["driver"] == "train_stream" else serve_fault
    return make(kind)
