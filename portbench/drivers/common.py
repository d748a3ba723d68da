"""What both drivers build: the program's LDA configuration and a
``ParameterStore`` that holds the seed's φ̂ in RAM."""
from __future__ import annotations

import gc
import shutil
import tempfile

import numpy as np
import torch

from portbench import inputs


def lda_config(cfg: dict):
    """The program's ``LDAConfig`` for configuration ``cfg``."""
    from repro_torch.core.types import LDAConfig

    return LDAConfig(
        num_topics=cfg["num_topics"], vocab_size=cfg["vocab_size"],
        alpha_m1=cfg["alpha_m1"], beta_m1=cfg["beta_m1"],
        max_sweeps=cfg["max_sweeps"],
        ppl_check_every=cfg["ppl_check_every"],
        ppl_rel_tol=cfg["ppl_rel_tol"], iem_blocks=0,
        active_topics=cfg["active_topics"],
        warmup_sweeps=cfg["warmup_sweeps"], rho_mode="accumulate")


def hyper(cfg: dict) -> dict:
    """The reference's hyperparameters of configuration ``cfg``."""
    return {"K": cfg["num_topics"], "W": cfg["vocab_size"],
            "alpha_m1": cfg["alpha_m1"], "beta_m1": cfg["beta_m1"],
            "active_topics": cfg["active_topics"],
            "warmup_sweeps": cfg["warmup_sweeps"],
            "ppl_check_every": cfg["ppl_check_every"],
            "ppl_rel_tol": cfg["ppl_rel_tol"],
            "max_sweeps": cfg["max_sweeps"]}


class ResidentStore:
    """A ``ParameterStore`` under ``TMPDIR`` whose hot buffer holds every
    row of the seed's φ̂, written through ``write_rows``; φ̂(k) is the
    rows' float64 column sums.  The backing file is never written: it
    stays a sparse file, and nothing flushes."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from repro_torch.core.streaming import ParameterStore

        K, W = cfg["num_topics"], cfg["vocab_size"]
        self.path = tempfile.mkdtemp(prefix="portbench-store-")
        self.store = ParameterStore(self.path, K, W, buffer_rows=W)
        phi_k = torch.zeros(K, dtype=torch.float64, device=device)
        staging = None
        for lo, block in inputs.phi_blocks(cfg, seed, device):
            phi_k += block.sum(0, dtype=torch.float64)
            if staging is None:
                staging = torch.empty(block.shape, dtype=torch.float32,
                                      pin_memory=device.type == "cuda")
            n = block.shape[0]
            staging[:n].copy_(block)
            self.store.write_rows(np.arange(lo, lo + n), staging[:n].numpy())
        self.store.phi_k = phi_k.cpu().numpy()
        self.store.ensure_vocab(W - 1)

    def close(self) -> None:
        self.store = None
        gc.collect()
        shutil.rmtree(self.path, ignore_errors=True)


def reference_phi(cfg: dict, seed: int, device: torch.device):
    """The seed's (W, K) φ̂ and its float64 φ̂(k), drawn again for the
    reference."""
    K, W = cfg["num_topics"], cfg["vocab_size"]
    phi = torch.empty((W, K), dtype=torch.float32, device=device)
    for lo, block in inputs.phi_blocks(cfg, seed, device):
        phi[lo:lo + block.shape[0]] = block
    return phi, phi.sum(0, dtype=torch.float64)


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

