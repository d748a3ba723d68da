#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a host with one NVIDIA H100:

    python3 chip_smoke.py

It builds every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
with ``nvcc`` (one ``nvcc`` per source, all started together) and then, in
order:

1. holds the frozen-φ ``theta_sweep`` kernel against its plain PyTorch
   version at the serving path's shapes (K = 10,000 topics, 256 documents
   of 64–256 tokens; f32 dense and scheduled, bf16, int8), each form with
   its kernel path, launches per call, time beside the prior design's,
   share of the bound, bitwise repeat and documents independent of their
   batch-mates; then both kernels' wide-K paths at bigmodel's K = 50,000
   (``theta_sweep``'s global scratch, ``fused_estep``'s two-pass path);
2. drives the serving path — ``TopicServer`` over a disk-backed
   ``ParameterStore`` at the ``stream_1k`` width (capacity W = 141,043 rows
   × K = 10,000, 5.6 GB of float32 written to ``build/``, deleted at the
   end) — and checks the answers; one warm batch runs under
   ``torch.profiler``; then the continuous-batching ``ServingEngine``
   (256-document launches, 16-token L buckets, a 5 ms deadline) over the
   same store: 1,024 Zipf requests replayed unpaced, then paced at half the
   unpaced documents/s (documents/s, p50/p99 latency, batches, fill,
   ``theta_sweep`` launches, every θ row summing to 1), the per-document
   θ̂₀ draw of a full batch timed alone, and 32 documents of a
   ``rel_tol=0`` engine equal bitwise to the same documents in another
   packing through ``TopicServer.infer``; then the multi-replica
   ``ReplicaPool`` with the engine's settings, ``rel_tol=0``, over 2 worker
   processes on the card that attach the store READONLY: the same 1,024
   requests unpaced, then again with replica 0 SIGKILLed before its second
   launch (every θ bitwise the clean run's, one death, one respawn, back to
   2 replicas), on that pool a publish of the store (v1, 5.64 GB) broadcast
   to both workers and 256 requests served on version 1, then a
   thread-backend pool over 256 of the documents, bitwise the clean run's
   (``replica pool`` lines: documents/s, p50/p99, dispatch per replica,
   spawn-to-ready and respawn seconds, swap-ack seconds a replica, peak
   RSS of the process tree, the workers' ``theta_sweep`` launches);
3. holds the two training sweep kernels (``gs_sweep``, ``scheduled_sweep``)
   against their plain versions at the ``stream_1k`` training shapes (one
   bucketed 1,024 × 128 minibatch, K = 10,000, A = 16), with and without
   the stop-rule phase, each with its path, time beside its prior
   design's, share of the bound and CUDA launches per call (the kernel's
   own count), the dense forms with the bytes their column loop moves by
   design; then the stop-rule phase alone beside its row-gather floor, and
   ``gs_sweep``'s two-pass path at bigmodel's K = 50,000;
4. drives the training path — ``FOEMTrainer(device="cuda")`` for three
   minibatches of ``lda_config(stream_1k)`` on the same store, then one
   more step under ``torch.profiler`` — and serves a batch from the
   trained store; then the elastic runtime, ``ElasticFOEMRuntime`` over 2
   shards with dense φ̂ (5.64 GB) on the card, on the first 4 of those
   minibatches: a clean run, a post-fold drop (re-queued), a pre-probe
   kill followed by a 5.64 GB checkpoint, the shard's removal, a restore
   into a fresh runtime through the recovery scan and the resumed rounds,
   and a kill inside a second save that leaves LATEST on the first
   (``elastic`` lines: seconds a round, Σφ̂(k) against the tokens, the
   clean run's and the rows', save and restore GB/s, ``gs_sweep`` /
   ``scheduled_sweep`` launches);
5. holds the two kernels of the topic-sharded sweep (``sharded_probe``,
   ``sharded_fold``) against their plain versions at one rank's share of
   the stream_1k width (K/mp = 2,500 of K = 10,000 lanes, all W = 141,043
   rows, the 1,024 × 128 minibatch), dense and scheduled (A/mp = 4; times
   as for the sweeps, the probe's also in a CUDA graph), and
   measures where the fold's running φ̂(k) total drifts from its rows: the
   kernel, and the plain version in float32 and in float64, from one
   renormalised two-phase state;
6. drives the topic-sharded path — ``foem_step_sharded`` on a
   (data = 1, model = 4) mesh of four ranks sharing the card
   (``spawn_mesh``, gloo), two minibatches, then
   ``heldout_perplexity_sharded`` on 256 held-out documents; then one step
   of the per-column hooks mode (``sharded_impl="hooks"``) on the first
   minibatch from the first step's stats and μ0 (``sharded hooks step``
   line: sweeps, model-axis all-reduces, seconds by rank, perplexity
   beside the two-phase step's, mass; no sweep kernel may launch, the mass
   must hold to ``MASS_RTOL``, the ranks agree, and the perplexity is
   within ``HOOKS_PPL_RTOL`` of the two-phase step's);
7. holds the two E-step kernels of the coarse-block / scan sweeps, BEM and
   SEM (``fused_estep``, ``topk_estep``) against their plain versions at
   the stream_1k width: a block of ``iem_blocks=8`` (T = 16,384 tokens)
   with the exclusion, a ragged T, SEM's T = 131,072 tokens without it,
   with the residual and as SEM's own call (each ``fused_estep`` form with
   its path, launches per call, time beside the prior design's and share of
   the bound); A = 16 active lanes with pad lanes and inactive tokens; then
   the block loop that runs a whole blocked or scan scheduled sweep
   (``blocked_sweep``) at B = 8 and B = L, with its time beside the sweep
   the parent tree ran, its bound and design bytes, and the device
   operations a sweep of each;
8. drives the coarse-block and SEM paths on the same store —
   ``FOEMTrainer(device="cuda")`` with ``iem_blocks=8`` for two minibatches,
   one with ``sweep_impl="scan"``, one more blocked step and one more scan
   step under ``torch.profiler``, then ``algorithm="sem"`` for two
   minibatches — and serves the held-out batch from the trained store;
   then holds ``fused_estep`` in the two input forms of the OVB and SCVB
   E-steps (OVB: exp Ψ inputs, a = b = c = 0; SCVB: a = α, b = β, c = Wβ)
   against its plain version at SEM's shape from the trained store's rows
   (``baselines kernel`` lines: path, ms, bound, launches per call), and
   drives OVB, SCVB and OGS (``core/baselines.py``) at the stream_1k width,
   two minibatches each from zero statistics on the card, the minibatches
   read by ``load_docword`` from the training corpus written as a gzipped
   UCI docword file (``baselines step`` lines: wall ms, ``fused_estep``
   launches — ``max_sweeps`` a step for OVB and SCVB, 0 for OGS —, train
   perplexity, peak device memory, Σφ̂(k) against the merge's mass);
9. dry-runs the LDA cells (``launch.dryrun.run_lda_cell``, dense): stream_1k
   must fit the card, run one step from zero statistics, launch both sweep
   kernels and peak below the card's memory; stream_4k and bigmodel are
   sized and run only if they fit (``dryrun`` lines, one record each:
   argument and working-set bytes, free bytes, fits, peak, step seconds,
   sweeps, perplexity, launches, roofline terms); then runs
   ``examples/torch/quickstart.py --quick`` on the card in a process of
   its own, which must exit 0 (``quickstart`` line);
10. drives the lifelong train-while-serve path at the stream_1k width on a
   store of its own (the same seeded rows, written twice): a replica run
   trains four minibatches with a ``SnapshotPublisher`` (a publish every
   2 steps, ``retain`` 2: v1, v2, v3) and no serving, and a fresh server
   subscribed to it scores the held-out batch; the live run
   (``launch.lifelong.serve_while_training``) trains the same minibatches
   while the ``ServingEngine`` (256-document launches, 16-token buckets,
   a 5 ms deadline) over a subscribed ``TopicServer`` (16,384 hot rows)
   serves waves of 512 Zipf requests unpaced.  Each version's crc must
   equal the replica's, every request resolve with a committed version,
   launch versions never decrease nor fall more than ``retain`` behind,
   θ rows sum to 1, ``theta_sweep``/``gs_sweep``/``scheduled_sweep``
   launch, the eq. 21 perplexity equal the replica server's (rtol 1e-3)
   and an int8-subscribed server's θ stay within 0.05 of f32
   (``lifelong publish`` / ``lifelong swap`` lines, then a ``lifelong``
   line: publish and swap seconds, rows changed against cache rows dropped
   and resident, p50/p99 and documents/s beside the engine phase's, live
   step seconds beside the replica's, host ``MemAvailable`` before and
   peak RSS during the phase, its wall time);
11. holds the flash-attention kernel against its plain version at the LM
   serving path's shapes (bf16): granite-8b prefill (8 prompts × 32 query
   heads over 8 KV heads, S = 2,048, d = 128, causal) and decode (Sq = 1 at
   q_offset 2,048..2,079 in a 4,096-slot cache), danube-3-4b (d = 120,
   window 4,096, S = 6,144) and its ring-ordered decode call (which must
   equal the absolute-position call bitwise), ragged Sq/Sk and MQA at small
   size, and the prefill_32k length (B = 1, S = 32,768; its last 128 rows
   checked), the VLM's cross-attention (8 × 32 heads over 8 × 8,
   non-causal, 2,048 queries and one decode query over 1,601 image keys),
   musicgen (8 × 24 over 8 × 24, d = 64: prefill and decode) and jamba's
   attention layer (2 × 64 over 2 × 8, prefill); each with its bound, its
   share of the bound and the time of
   one ``scaled_dot_product_attention`` call on the same inputs (a
   yardstick the port never calls); after the build it counts the
   tensor-core instructions (HGMMA, HMMA) in the SASS of the attention
   library and of its backward's;
12. drives the dense LM's serving path — ``build(granite-8b)`` at full width
   (36 layers, bf16, seeded random weights) prefills 8 prompts of 2,048
   tokens and takes 32 greedy ``decode_step``s into a 4,096-slot cache
   (one more under ``torch.profiler``); a float32 copy's decode logits and
   greedy tokens must continue one prefill over the same 2,080 tokens; then
   danube-3-4b (full width, 4 layers, float32) decodes 16 steps from a
   4,096-slot ring placed from a 6,128-token prefill, against one prefill
   of all 6,144 tokens;
13. holds the attention backward kernels (``csrc/flash_attention_bwd.cu``:
   D, dk/dv, dq — bf16 on the tensor cores, float32 on the CUDA cores; no
   TPU counterpart) against ``torch.autograd`` of the plain attention at
   the training shapes — danube-3-4b (B = 1, 32 heads over 8,
   S = 4,096, d = 120, window 4,096, bf16), granite (32 over 8, S = 2,048,
   d = 128, causal, bf16 and float32), a 512-key window, qwen2-moe's
   and musicgen's calls (G = 1; d 128, d 64) and the VLM's non-causal
   cross-attention (4,096 queries over 1,601 image keys) — each with its
   ms beside the replaced CUDA-core design's (``BWD_PRIOR_MS``), its path,
   launches, bound, the plain version's ms, the backward of one
   ``scaled_dot_product_attention`` (a yardstick the port never calls) and
   two launches' bits compared; bf16 by 64-row tile against the float32
   truth, with two planted faults that must fail that check (``attention
   backward kernel`` lines);
14. drives the dense LM's training path — h2o-danube-3-4b at full width and
   depth (24 layers, bf16, seeded random weights), 4 steps of
   ``launch.train.lm_train_step`` on one 4,096-token sequence a step from
   ``synthetic_token_stream``, the last under ``torch.profiler``: finite
   losses, step 1 (lr 0) leaving every parameter's bits and setting the
   moments, steps 2–4 changing every weight matrix, 24 forward and 24
   backward attention launches a step, step 1's loss against the plain
   attention's forward, the peak below 75 GB; then every leaf's gradient of
   2-layer full-width float32 and bf16 copies through the kernels against
   the plain attention's autograd, and the 4 steps' losses at full width
   and depth (S = 1,024) through the kernels against the plain attention's
   (``lm training`` line: losses, step seconds, tokens/s, peak GB, the
   profiled step's busy share, top ops and attention kernels' ms, the
   witness curves);
15. runs the LM CLIs in processes of their own: ``launch.serve --arch
   granite-8b --gen-tokens 8``, ``launch.train --arch granite-8b --steps
   12 --ckpt-every 5`` (the loss must fall) and its ``--resume --steps 14``
   (from step 10), and ``examples/torch/train_lm.py --quick``, the serve
   CLI and the example beside the two train runs (``lm cli`` line);
16. drives the MoE and Mamba2 paths (no kernel of their own: the JAX
   package has none there; their attention layers go through the two
   attention kernels): qwen2-moe-a2.7b at full width and depth (24 layers,
   60 experts padded to 64, top-4, 4 shared; bf16, ~30 GB) prefills 8
   prompts of 2,048 tokens and takes 32 greedy decode steps (``moe
   serving`` line: prefill ms and tokens/s, decode ms on the host clock
   and the profiled step's device busy ms and device operations, peak GB,
   each layer's largest and smallest expert group, the MoE layers' share
   of a prefill by CUDA events, a profiled prefill, the attention
   launches); a float32 copy on 4 layers continues one prefill over the
   2,080 tokens (``moe continuity``: routing flips between decode and
   prefill counted, each a near-tie); qwen3-moe-235b-a22b at full width
   on 4 of its 94 layers, 2 x 2,048 tokens and 8 steps (``moe serving
   (qwen3)``); the expert-parallel form of one qwen2-moe layer on a
   (1, 4) mesh of ranks sharing the card over gloo against the TP form,
   dropless and at the config's capacity factor 2.0 (``moe ep``: dropped
   share, ms a layer, all-to-all bytes); mamba2-370m at full width and
   depth, 8 x 2,048 tokens with 32 steps and one 32,768-token prompt with
   64 steps (``ssm serving``: the state bytes a sequence equal at both
   lengths), its float32 decode against one prefill (``ssm continuity``);
   and 4 AdamW steps on one 4,096-token sequence of mamba2 at full depth
   and of qwen2-moe on 4 layers (``moe/ssm training``: losses, step s,
   tokens/s, peak GB, every matrix moved, any expert slice that did not
   reported, the padded experts still zero, 4 + 4 attention launches a
   qwen2 step);
17. drives the VLM, audio and hybrid paths (their attention layers through
   the two attention kernels): llama-3.2-vision-11b at full width and
   depth (40 layers, 8 of them cross-attending to 1,601 seeded image
   embeddings a prompt; bf16, 10.11 B parameters) prefills 8 prompts of
   2,048 tokens and takes 32 greedy decode steps (``vlm serving`` line: as
   the MoE lines, 48 attention launches a call, and the cross layers' K/V
   recompute a decode step timed alone beside the step's busy time); its
   float32 copy on one super-block (5 layers) continues one prefill (``vlm
   continuity``); musicgen-medium whole (48 layers, MHA 24 × 64; bf16)
   prefills 8 × 2,048 seeded frame embeddings and decodes 32 steps fed
   seeded frames (``audio serving``), its float32 copy continuing one
   prefill (``audio continuity``); jamba-1.5-large-398b on one super-block
   of 8 layers at its attention and SSM widths, 16 experts top-2, d_ff cut
   from 24,576 to 12,288 (24.59 B parameters; the cut printed on the
   line), 2 × 2,048 and 8 decode steps writing K/V and SSM state in one
   block's caches (``hybrid serving``), a float32 copy at d_ff 2,048
   continuing one prefill with routing flips only at near-ties (``hybrid
   continuity``); and 4 AdamW steps on one 4,096-position sequence of
   musicgen whole (one-hot frames) and of the VLM on 5 layers with seeded
   image embeddings (``vlm/audio training``: losses, step s, peak GB, the
   lr-0 step bitwise, every matrix moved, self + cross attention launches
   forward and backward a step, step 1's loss against the plain attention,
   and float32 loss and gradients of 2 musicgen layers and the VLM's
   super-block against the plain attention);
18. the analysis layer: from the build on, every launch the wrappers make
   is noted (``repro_torch.analysis.launches``) and recorded by its
   library (``csrc/launch_log.cuh``); after the baselines, a
   ``debug_checks=True`` ``FOEMTrainer.step`` at the stream_1k width and a
   served 256-document batch beside the same step and batch without checks,
   and one dense sweep of the step's minibatch plain and checked
   (``sanitized`` line: seconds, peak memory, every failed invariant, the
   checked sweep's float32 outputs bitwise the plain sweep's, and
   ``phi_gap``: the φ̂ lockstep gap read from the float64 φ̂(k) total that
   the checked sweep handed the sanitizer and from its float32 φ̂(k), each
   with its worst ratio to the bound and topic, beside each topic's bound
   on the float32 rows' own rounding); the elastic runtime's checked run
   (``elastic (checked)``) must run whole; the checked step and the
   sharded checked step may raise ``SANITIZER_OPEN`` alone, and each such
   raise is held, topic by topic, to that rounding bound, computed from
   the sweep that raised (``PhiGaps``); planted faults — a NaN φ row
   before ``ops.infer``, a negative count before ``ops.sweep``, a
   perturbed φ̂(k), the kernel's float64 total short of 0.5 token a topic
   — each raise ``SanitizerError`` with the JAX package's message, and a
   float32 φ̂(k) short of 0.5 token a topic, its total intact, the port's
   own float32 check's; the three sweep kernels' float32 outputs are the
   same bits with the float64 total and without, the total is its seed
   plus the kernel's own increments (``TOTAL64_OWN_RTOL``) and within the
   two summation orders' bound of the plain version's (the ``total64``
   entry of the ``sweep kernel`` and ``sharded kernel`` lines); at the end every noted launch, rebuilt from
   its contract with the card's registers, must equal a recorded launch
   configuration and back, and every predicted CTAs an SM the runtime's
   (``analysis`` line: per kernel variant its registers, shared memory,
   spills, CTAs an SM and grids, with the card's name and power limit, and
   the reference cells' static check).

Each path's kernel launch counters are set to 0 just before it and read
just after.  Any failed check exits non-zero before the result lines.  The
last two lines of standard output are a ``{"kernels": [...]}`` JSON object
and the device record ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, it exits non-zero
and prints no result.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the H100's data-sheet peaks: one set with the port's roofline terms
from repro_torch.launch.roofline import (  # noqa: E402
    H100_BF16_FLOPS as BF16_FLOPS,
    H100_F32_FLOPS as FP32_FLOPS,
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
)

D_KERNEL = 256              # documents per checked kernel launch
K_FULL = 10_000             # stream_1k topics
W_FULL = 141_043            # stream_1k vocabulary (store capacity)
DOC_LEN = (64, 256)         # tokens per request
SWEEPS = 10                 # one check_every chunk
A_SCHED = 16                # active topics of the scheduled variant
# Kernel vs plain tolerances (rtol, atol) and why.
TOL = {"theta": (1e-4, 1e-4), "est_ll": (1e-4, 1e-3), "ev_ll": (1e-4, 1e-3)}
TOL_REASON = (
    "theta is in token units (a row sums to the document's estimation "
    "tokens), so atol 1e-4 is 1e-4 of one token's mass; the partials "
    "x*log(lik) are in nats (atol 1e-3); rtol 1e-4 covers float32 sums of "
    "K = 1e4 terms taken in another order (~log2(K)*2^-24 = 1e-6 per sum) "
    "carried through 10 sweeps, with a 10x margin")
D_TRAIN = 1024              # stream_1k minibatch documents
L_TRAIN = 128               # stream_1k bucket length
# Sweep kernel vs plain tolerances (rtol, atol) and why.
SWEEP_TOL = {"mu": (1e-4, 1e-6), "residual": (1e-4, 1e-5),
             "theta": (1e-4, 1e-4), "phi_wk": (1e-4, 1e-3),
             "phi_k": (1e-5, 1.0), "loglik": (1e-5, 0.0)}
SWEEP_TOL_REASON = (
    "mu is a probability (atol 1e-6 against float32's 6e-8 at 1); the "
    "residual is counts*|dmu| (<= 4 tokens here: atol 1e-5); theta is in "
    "token units (atol 1e-4 of one token); phi_wk rows hold up to ~1e6 "
    "tokens (atol 1e-3, rtol 1e-4); phi_k holds ~5e4 tokens per topic "
    "(one float32 ulp ~4e-3) and each of the 128 columns adds a sum of "
    "1,024 deltas taken in another order, a few ulps apart (rtol 1e-5, "
    "atol 1 token); the loglik sums 1e5 token partials (rtol 1e-5). "
    "rtol 1e-4 elsewhere covers K = 1e4 term sums in another order carried "
    "through 128 Gauss-Seidel columns")
# φ̂(k)'s float64 total against its seed plus the kernel's own increments
# (a second call seeded with zeros): float64 sums of the same float32
# increments, in one order, from two starting points (~L·2^-53 relative)
TOTAL64_OWN_RTOL = 1e-12
STOP_RULE_ATOL = 1e-4       # nats: a token's x·log(lik), x <= a few tokens,
# log(lik) ~ -10 summed over K = 1e4 terms in another order (~1e-6 relative)
# The sweep and sharded kernels' times at these shapes before this design of
# gs_sweep's column loop, the stop-rule phase and the sharded probe (the
# previous final run of this script on an H100 80GB HBM3, 700.00 W;
# PERF.md §6), printed beside this run's
PRIOR_MS = {"dense": 33.405, "dense +loglik": 37.478,
            "scheduled A=16": 8.095, "scheduled A=16 +loglik": 12.211,
            "probe dense": 0.948, "fold dense": 5.917,
            "fold dense +loglik": 6.441, "probe scheduled A/mp=4": 0.0841,
            "fold scheduled A/mp=4": 4.042,
            "fold scheduled A/mp=4 +loglik": 4.583, "stop rule": None}
# theta_sweep's and fused_estep's times at these shapes in their design
# before the register and row-ring one (a CTA of 1,024 threads per document
# with its state in shared memory; a CTA of 256 per E-step row with a second
# pass over μ): its final run of this script on an H100 80GB HBM3, 700.00 W
# (PERF.md §6), printed beside this run's; None where it was not timed
PRIOR_MS_THETA = {"f32 dense": 11.14, "f32 scheduled A=16": 3.47,
                  "bf16 dense": 12.04, "int8 dense": 14.26}
PRIOR_MS_ESTEP = {"blocked, with residual": 2.30, "blocked": 1.68,
                  "ragged, with residual": None,
                  "SEM, with residual": 15.24, "SEM": None}
# The serving engine phase: 1,024 Zipf requests into 256-document launches
# with a 5 ms flush deadline.
ENGINE_REQUESTS, ENGINE_BATCH, ENGINE_DELAY_MS = 1024, 256, 5.0
# The replica pool phase: the engine phase's settings over 2 worker
# processes on the card; requests served on version 1 after the swap, and
# documents through the thread backend.
POOL_REPLICAS, POOL_SWAP_REQUESTS, POOL_THREAD_DOCS = 2, 256, 256
# Host memory the pool phase's guard asks for, in φ copies (+ 8 GiB): its
# process tree peaked at 11.1 copies resident on an H100 host.
POOL_SWAP_PHI_COPIES = 12
# The elastic phase: the training phase's first 4 minibatches over 2 shards.
ELASTIC_MINIBATCHES = 4
ELASTIC_MASS_RTOL = 1e-4    # Σφ̂(k) against the minibatches' tokens: each
# μ row sums to 1 within a few float32 ulps over K = 1e4 lanes, and the
# rows' deltas are float32 running totals (as STEP_MASS_RTOL)
LIFELONG_STEPS = 4          # training minibatches of the lifelong phase
LIFELONG_PUBLISH_EVERY = 2  # v1 before training, then v2 and v3
LIFELONG_RETAIN = 2         # snapshots the publisher keeps
LIFELONG_HOT_ROWS = 16_384  # the lifelong server's hot-row cache
LIFELONG_WAVE = 512         # requests a traffic wave, replayed unpaced
LIFELONG_PPL_RTOL = 1e-3    # eq. 21 perplexity of the lifelong server against
                            # a fresh server subscribed to the replica: the
                            # same φ bits, so equal bits are expected
LIFELONG_INT8_ATOL = 0.05   # int8-subscribed θ against f32 (per-row int8
                            # steps of amax/254 move θ by a few 1e-3)
BASELINE_MASS_RTOL = 1e-4   # a baseline step's Σφ̂(k) against (1−ρ)·before
# + ρ·tokens: float32 sums over W·K = 1.4e9 entries, each μ row summing to 1
# within a few ulps
PHI_K_SUM_RTOL = 1e-4       # phi_k against sum_w phi_wk after a sweep:
# two float32 sums of ~2e4 rows of ~1e4-token magnitude in different orders
MP = 4                      # model ranks of the sharded phases
K_SHARD = K_FULL // MP      # topic lanes per rank
A_SHARD = A_SCHED // MP     # active lanes per word per rank
# Sharded kernel vs plain tolerances (rtol, atol) beyond SWEEP_TOL's, and why.
SHARD_TOL = {"s": (1e-4, 0.0), "prev_mass": (1e-4, 1e-6),
             "live": (1e-4, 1e-6), "u": (1e-4, 0.0)}
SHARD_TOL_REASON = (
    "s and u are positive sums of 2,500 lane terms taken in another order "
    "(~1e-6 relative) carried through 128 Gauss-Seidel columns (rtol 1e-4, "
    "as SWEEP_TOL); prev_mass and live are sums of probabilities (<= 1: "
    "atol 1e-6); mu, residual, theta, phi_wk, phi_k as SWEEP_TOL")
MU_SUM_ATOL = 1e-5          # dense sum_k mu over the 4 ranks against 1:
# four float32 sums of 2,500 lanes (~1e-7 relative each) and their sum
# phi mass growth over a sharded step against the minibatch's token count,
# relative: the rows are float32 running totals of mostly small entries
# (on an H100 they grew within 1.2e-5 of the token count); phase D sets
# phi_k to their float64 sum rounded once per topic, whose half-ulp
# roundings (ulp 4e-3 at ~5e4 tokens) over 1e4 topics add up to ~0.3 token
MASS_RTOL = {"phi_rows_mass_growth": 1e-4, "phi_k_mass_growth": 1e-4}
# The hooks step (sharded_impl="hooks") against the first two-phase step on
# the same minibatch from the same stats and μ0: the two are different
# update rules (per-column exact normalisers against one phase of
# staleness), so only the JAX package's coarse envelope holds
# (tests/test_sharded_sweep.py:390-391: |Δppl| / ppl < 0.25)
HOOKS_PPL_RTOL = 0.25
# The dry-run phase: the dense cells of every LDA_SHAPES regime, in order;
# the first must fit and run
DRYRUN_SHAPES = ("stream_1k", "stream_4k", "bigmodel")
DRIFT64_ATOL = 1e-3         # tokens: the float64 fold's phi_k drift, a
# difference of float64 sums of ~1.3e8 tokens (ulp 1.5e-8)
IEM_BLOCKS = 8              # the coarse-block cells: L = 128 in 8 blocks
# E-step kernel vs plain tolerances (rtol, atol) and why.
ESTEP_TOL = {"mu": (1e-5, 1e-6), "residual": (1e-5, 1e-5),
             "delta": (1e-5, 1e-6)}
ESTEP_TOL_REASON = (
    "one E-step: mu = num / sum over K = 1e4 (A = 16) float32 terms summed "
    "in another order, a few 1e-7 relative apart (rtol 1e-5); mu is a "
    "probability (atol 1e-6); residual = counts*|mu - mu_old| and delta = "
    "counts*(mu - mu_prev) carry mu's error times up to 4 tokens (atol "
    "1e-5 / 1e-6)")
STEP_MASS_RTOL = 1e-4       # rows' growth against the step's tokens: float32
# row sums of ~25,000 rows (as MASS_RTOL)
PHI_K_ROWS_ATOL = 1.0       # tokens: the FOEM store's phi_k growth against
# its rows' growth, both float64 sums of the same float32 increments
SEM_PHI_K_RTOL = 1e-4       # SEM stores the JAX package's float32 phi_k
# (its total cast to float32 and the minibatch's float32 sum added)


# The LM serving phases: granite-8b at full width, 8 prompts of 2,048
# tokens and 32 decode steps into a 4,096-slot cache (the decode_32k shape
# with batch and cache cut to one card); danube-3-4b at full width, 4 layers.
LM_ARCH = "granite-8b"
LM_BATCH, LM_PROMPT, LM_STEPS, LM_CACHE = 8, 2048, 32, 4096
SWA_ARCH, SWA_LAYERS, SWA_BATCH = "h2o-danube-3-4b", 4, 2
SWA_PROMPT, SWA_STEPS = 6128, 16          # crosses the 4,096-key window
PREFILL_32K = 32_768                      # the JAX prefill_32k length
# Attention kernel vs plain tolerances (rtol, atol) by type, and why.
ATTN_TOL = {"bfloat16": (8e-3, 1.6e-2), "float32": (1e-5, 2e-5)}
ATTN_TOL_REASON = (
    "outputs are convex combinations of N(0,1) values; in float32 the "
    "kernel and the plain version differ only in the order of the score "
    "and p.v sums and the online rescaling (~1e-6: atol 2e-5 as the JAX "
    "package's own kernel test); in bfloat16 both round the output to 8 "
    "bits (one ulp is 7.8e-3 at 1) and round p at another running max: two "
    "ulps at 1")
# The attention backward kernel against torch.autograd of its plain version
# (rtol, atol) by type, and why.
BWD_TOL = {"bfloat16": (2.0 ** -7, 2.0 ** -4), "float32": (1e-4, 1e-4)}
BWD_TOL_REASON = (
    "dq, dk, dv sum up to 4 x 4,096 (query, key) terms of N(0,1)-scale "
    "values; in float32 the kernel and cuBLAS take the score, dp and "
    "gradient sums in other orders (~1e-6 relative a sum, carried through "
    "exp and the products: rtol / atol 1e-4); in bfloat16 the elementwise "
    "(rtol, atol) is only a coarse screen (2^-4 is the size of a typical "
    "entry far from the diagonal), and BWD_TILE_TOL holds the gradients")
# bfloat16: against the float32 truth (the plain version on float32 copies
# of the same bf16 values), each (head, 64-row tile) block of dq (queries)
# and of dk, dv (keys) within 2^-7 of its norm: ||got_t - true_t|| <= 2^-7
# (||true_t|| + 2^-4 rms_t ||true_t||).  The kernel rounds the gradients to
# 8 bits once (half an ulp, ~2^-9 of a block's norm) from float32 sums, and
# takes D = rowsum(dO o) from the bf16 o, as SDPA's backward does; that D
# moves a row whose attention sits on one key (query 1: dq_1 is a small
# difference of large terms) by up to ~0.2 of its own norm, a row error the
# library shares, so the check is by tile (the kernel's unit of work), where
# such a row weighs little.  The bf16 plain version's own error (p rounded
# to bf16 before p.v) is reported beside; the floor, 1/16 of a typical
# tile's norm, holds tiles that are ~0 (the last keys') to an absolute error.
BWD_TILE, BWD_TILE_TOL, BWD_TILE_FLOOR = 64, 2.0 ** -7, 2.0 ** -4
# The faults the tile check must see (it fails on each; the elementwise
# screen's verdict is reported beside): one 64-key tile of dk zeroed, in the
# middle of the sequence of KV head 0, and the lse of query head 0's 64 rows
# there shifted by 2^-5 (p scaled by 0.97 on them)
BWD_FAULT_LSE_SHIFT = 2.0 ** -5
# The LM training phase: h2o-danube-3-4b at full width and depth (24
# layers, bf16, seeded random weights), one sequence of 4,096 tokens (the
# JAX train_4k length; its global batch of 256 cut to 1 for one card),
# TRAIN_STEPS steps of train_lm's step; the last one profiled.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = ("h2o-danube-3-4b", 1,
                                                   4096, 4)
TRAIN_PEAK_GB = 75.0        # above it the cell drops to S = 2,048
TRAIN_LOSS_RTOL = 1e-4      # step 1's bf16 loss against the same forward
# through the plain attention under no_grad: the two attentions' outputs
# differ by an ulp or two of bf16 an element, carried through 24 layers and
# averaged over 4,096 tokens' cross-entropies of ~11 (1.4e-5 apart on an
# H100 80GB HBM3 at 700 W); a loss this close to ln V says little about the
# attention, so the gradient checks below hold it
TRAIN_GRAD_LAYERS = 2       # the gradient checks: full width, 2 layers
TRAIN_GRAD_TOL = 1e-3       # float32: max |g_kernel - g_plain| / max
# |g_plain| a leaf: float32 sums in other orders (~1e-6 relative an op, see
# BWD_TOL) through 2 layers, the 32,000-way softmax of the CE and rmsnorm;
# the CPU tests hold the reduced configs' leaves to JAX's within 1e-4
TRAIN_GRAD_TOL_BF16 = 2.0 ** -5     # bfloat16: ||g_kernel - g_plain|| /
# ||g_plain|| a leaf: the two attentions' outputs differ by one or two bf16
# ulps (2^-8 relative) an element, and every product of the backward rounds
# to bf16 (2^-9) on both sides, through 2 layers and the CE's softmax
# The witness of the bf16 loss curve: the same TRAIN_STEPS steps of
# train_lm's step at full width and depth, once through the kernels and once
# through the plain attention (the same seeds and batches), at S = 1,024 so
# that the plain attention's saved (32, S, S) float32 scores fit beside the
# weights and moments; each step's loss within TRAIN_WITNESS_RTOL: the two
# paths' gradients differ by bf16 roundings, which move some weights'
# update by one ulp, so the curves part slowly (at most 4.3e-4 apart over
# the 4 steps on an H100 80GB HBM3 at 700 W, while the loss rose from 11.0
# to 16.6: a few times that gap)
TRAIN_WITNESS_SEQ, TRAIN_WITNESS_RTOL = 1024, 2e-3
LM_CLI_ARCH = "granite-8b"  # the CLIs' reduced config
# The attention backward checks: (name, (BH, BHkv, S, d, window), type),
# causal over S = Sq = Sk, or non-causal over S = (Sq, Sk); the first,
# danube's training call, is the kernel's main line
BWD_CASES = (
    ("danube training window=4096", (32, 8, TRAIN_SEQ, 120, 4096),
     "bfloat16"),
    ("granite causal", (32, 8, 2048, 128, 0), "bfloat16"),
    ("granite causal f32", (32, 8, 2048, 128, 0), "float32"),
    ("granite window=512", (32, 8, 2048, 128, 512), "bfloat16"),
    # qwen2-moe's training call: 16 heads over 16 (G = 1), causal
    ("qwen2-moe training", (16, 16, TRAIN_SEQ, 128, 0), "bfloat16"),
    # llama-3.2-vision's cross-attention training call: 32 heads over 8,
    # non-causal, Sq 4,096 over the 1,601 image tokens (S given as (Sq, Sk))
    ("vlm cross-attention training", (32, 8, (TRAIN_SEQ, 1601), 128, 0),
     "bfloat16"),
    # musicgen's: 24 heads over 24 (G = 1), d 64, causal
    ("musicgen training", (24, 24, TRAIN_SEQ, 64, 0), "bfloat16"),
)
# The CUDA-core design that the tensor-core bf16 path replaced (float32
# fmaf for both types; the float32 path keeps it): its ms for each
# BWD_CASES call, from the run that last timed it (PERF.md §6, row 9's
# "before" column; NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's ms
BWD_PRIOR_MS = {"danube training window=4096": 23.39, "granite causal": 7.30,
                "granite causal f32": 7.32, "granite window=512": 2.91}
# Decode logits against one prefill over the same tokens, float32 copy.
#: The analysis phase: the JAX package's sanitizer messages that the
#: planted faults must raise (tests/test_torch_sanitizer.py holds the two
#: packages' first messages equal on the same faults).
PHI_LOCKSTEP = ("sanitizer: phi_k deltas inconsistent with column sums of "
                "phi_wk")
SANITIZER_FAULTS = {
    "nan_phi_row": "sanitizer: non-finite values in theta",
    "negative_count": "sanitizer: negative values in phi_wk",
    "perturbed_phi_k": PHI_LOCKSTEP,
    "dropped_total64": PHI_LOCKSTEP,
    # the port's own check (sanitizer.PHI_K_FLOAT32): the float32 φ̂(k)
    # against the float64 total
    "short_phi_k32": ("sanitizer: float32 phi_k parts from its float64 "
                      "total by more than float32 rounding"),
}
#: What a checked sweep at the stream_1k store's magnitude may raise on
#: results that are right to float32: the φ̂ lockstep invariant.  Its
#: φ̂(k) side is the float64 total the sweep kernels carry (the float32
#: φ̂(k)'s own rounding no longer enters), its other side the float32
#: rows' column sums: a row entry of ~10⁶ tokens rounds each Δ it takes by
#: up to a half-ulp (0.06 token at 1.1·10⁶), more than the bound leaves a
#: topic that barely moves (an open finding, PERF.md §7).  The run then
#: holds every topic's miss, in every checked sweep that raised it, to
#: those rows' own rounding bound (``PhiGaps``, ``phi_gap``); any other
#: failed invariant fails it.
#: The topics of one block of ``phi_gap``'s row-rounding bound: a (W, this)
#: float32 array at a time.
GAP_TOPICS = 1024
SANITIZER_OPEN = (PHI_LOCKSTEP,)
ANALYSIS_BUDGET_S = 60.0    # the sanitized runs and the contract check

LM_TOL = (1e-3, 1e-3)
LM_TOL_REASON = (
    "logits of scale ~1 in float32: the decode step and the prefill run "
    "other cuBLAS kernels (1 row against 2,080) whose sums differ by ~1e-7 "
    "relative, carried through 36 layers' residual stream")

# The MoE and SSM phases.  qwen2-moe-a2.7b at full width and depth (24
# layers, 60 experts padded to 64, top-4, 4 shared; bf16, ~30 GB): 8 prompts
# of 2,048 tokens, 32 greedy decode steps; its continuity in float32 on 4
# of the 24 layers.  qwen3-moe-235b-a22b at full width (128 experts top-8,
# GQA 64/4, head dim 128) with its depth cut to 4 of 94 layers (~22 GB bf16;
# the whole model is ~470 GB): 2 prompts of 2,048, 8 decode steps.
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_STEPS = "qwen2-moe-a2.7b", 8, 2048, 32
MOE_CONT_LAYERS = 4
QWEN3_ARCH, QWEN3_LAYERS, QWEN3_BATCH, QWEN3_PROMPT, QWEN3_STEPS = (
    "qwen3-moe-235b-a22b", 4, 2, 2048, 8)
# A routing decision that differs between the decode step and the prefill
# (the router's float32 sums over another number of rows) must be a
# near-tie: its k-th and (k+1)-th probabilities within this gap in the
# prefill (~1e-7 is the float32 noise of a probability; 1e-4 leaves room
# for the hidden state's own float32 drift over the layers before it).  The
# row is compared no further from that step on; the flips are counted.
MOE_FLIP_GAP = 1e-4
# The expert-parallel MoE: one qwen2-moe MoE layer at full width on a
# (1, 4) mesh of ranks sharing the card (gloo), 8 x 2,048 tokens, against
# the TP form on the same rank: dropless at cf = E / k (C = T_loc), and at
# the config's 2.0, where every token with no dropped pair must equal the
# TP form.  bf16 tolerance: |ep - tp| <= EP_RTOL |tp| + EP_ATOL_RMS rms(tp)
# elementwise: the expert products run as a batched product over the
# capacity slots against one product a group, other cuBLAS kernels whose
# float32 sums round to bf16 once each (2^-8 relative), a few ulps of the
# output's scale
EP_MESH, EP_BATCH, EP_SEQ, EP_REPS = (1, 4), 8, 2048, 2
EP_RTOL, EP_ATOL_RMS = 2.0 ** -7, 2.0 ** -5
# mamba2-370m at full width and depth (48 layers, bf16): 8 prompts of 2,048
# tokens with 32 decode steps, then prefill_32k's length (its batch of 32
# cut to 1) with 64 decode steps; continuity in float32 at full depth on
# SSM_CONT_BATCH prompts of 2,048 with 32 steps
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_STEPS = "mamba2-370m", 8, 2048, 32
SSM_LONG, SSM_LONG_STEPS, SSM_CONT_BATCH = 32_768, 64, 2
# Training: one sequence of 4,096 tokens (train_4k's length, its batch of
# 256 cut to 1), 4 AdamW steps of lm_train_step: mamba2 at full width and
# depth, qwen2-moe at full width with 4 of 24 layers (~3.0 B parameters)
MOESSM_TRAIN_SEQ, MOESSM_TRAIN_STEPS, MOE_TRAIN_LAYERS = 4096, 4, 4
# Their 2-layer float32 loss and gradient checks against the plain path
# (TRAIN_GRAD_TOL a leaf): mamba2's on the first SSM_GRAD_SEQ tokens (4 of
# its 256-token chunks), so that the sequential recurrence's steps stay
# few; the loss within F32_LOSS_RTOL: float32 hidden states of the two
# paths differ by ~1e-6 relative (sums in other orders), and the loss is a
# mean of 4,096 cross-entropies of ~12
SSM_GRAD_SEQ, F32_LOSS_RTOL = 1024, 1e-5
# The serving runs: timed prefills after a full-size warm-up (the median
# is reported)
SERVE_PREFILL_REPS = 3
# The VLM, audio and hybrid phases.  llama-3.2-vision-11b at full width and
# depth (40 layers, cross-attention in 8 of them to 1,601 image tokens;
# bf16, 10.11 B parameters, 20.2 GB): 8 prompts of 2,048 tokens with seeded
# image embeddings, 32 greedy decode steps (decode_32k's batch and cache cut
# to one card); its float32 continuity on one super-block (5 layers) on
# CONT_BATCH prompts.  musicgen-medium whole (48 layers, 24 heads of 64 over
# 24: MHA; bf16): 8 x 2,048 seeded frame embeddings, then 32 decode steps
# fed seeded frames; float32 continuity at full depth on CONT_BATCH.
VLM_ARCH, VLM_BATCH, VLM_PROMPT, VLM_STEPS = ("llama-3.2-vision-11b", 8,
                                              2048, 32)
AUDIO_ARCH, AUDIO_BATCH, AUDIO_PROMPT, AUDIO_STEPS = ("musicgen-medium", 8,
                                                      2048, 32)
VLM_CONT_LAYERS, CONT_BATCH = 5, 2
# jamba-1.5-large-398b on one super-block of 8 layers (attention at j = 4,
# Mamba2 elsewhere, MoE on odd j) at its attention and SSM widths (d 8,192,
# 64 heads over 8, SSM state 64, d_inner 16,384) with its 16 experts top-2,
# and one cut of width: d_ff (the MLP and each expert) from 24,576 to
# 12,288 (24.59 B parameters, 49.2 GB in bf16).  The 8 layers whole are
# 45.1 B, 90 GB; cutting the experts instead saves nothing, since the
# expert weights are padded to a multiple of 16 (pad_experts, the JAX
# layout).  2 prompts of 2,048, 8 decode steps; the float32 continuity on
# the same layers at d_ff 2,048 (7.48 B parameters, 29.9 GB)
HYBRID_ARCH, HYBRID_LAYERS, HYBRID_FF = "jamba-1.5-large-398b", 8, 12288
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_STEPS, HYBRID_CONT_FF = 2, 2048, 8, 2048
# Training: one sequence of 4,096 tokens, 4 AdamW steps of lm_train_step:
# musicgen whole (one-hot frames, the JAX train_lm's batch), the VLM on one
# super-block of 5 of its 40 layers (2.18 B parameters) with seeded image
# embeddings; the float32 gradient check on 2 layers of musicgen and on the
# VLM's super-block (its period is 5: no 2-layer VLM has a cross layer)
VLM_TRAIN_LAYERS, AUDIO_GRAD_LAYERS = 5, 2


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()                                    # warm
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_time_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed between two events, so the host's cost of each call
    (checks, allocations, the launch) drops out.  Each call's outputs are
    dropped before the next, so the graph's pool reuses their memory."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()                          # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def device_profile(torch, fn):
    """Run ``fn`` once under ``torch.profiler``.  Returns its result, the
    host wall ms, the device ms by operation (largest first) and the busy
    ms: the union of the device events' intervals."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    by_op, busy_us, cur = {}, 0.0, None
    for s, e, name in events:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e3
        if cur is None or s > cur[1]:
            busy_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0.0 if cur is None else cur[1] - cur[0]
    by_op = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    return out, wall_ms, by_op, busy_us / 1e3


def top_ops(by_op: dict, n: int) -> dict:
    """The ``n`` largest device times by operation, names cut to 80
    characters; the times of names that the cut makes equal (template
    variants of one kernel) are summed."""
    out = {}
    for name, ms in by_op.items():
        out[name[:80]] = out.get(name[:80], 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


def kernel_ms(by_op: dict, prefix: str) -> dict:
    """The device ms of the kernels whose names start with ``prefix``
    (the identifier in the profiler's name), summed by that identifier."""
    import re

    out = {}
    for name, ms in by_op.items():
        m = re.search(rf"\b{prefix}\w*", name)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + ms
    return out


def errors(got, want) -> dict:
    diff = (got - want).abs()
    rel = diff / want.abs().clamp_min(1e-30)
    return {"max_abs": float(diff.max()), "max_rel": float(rel.max())}


def col_sum64(torch, x):
    """The float64 sums of ``x`` over every axis but the last, a block of
    rows at a time (``gs_sweep.col_sum64``)."""
    from repro_torch.kernels.gs_sweep import col_sum64 as sum64

    return sum64(x.reshape(-1, x.shape[-1]))


def total64_check(torch, name, run, phi_k, base, plain_total, n, moved):
    """φ̂(k)'s float64 total on the card, for a kernel whose call ``run(t)``
    takes ``phi_k64=t``: every float32 output the same bits as ``base``
    (the call without a total); the total equal, to TOTAL64_OWN_RTOL, to
    its seed plus the kernel's own increments (a call seeded with zeros);
    and within ``sanitizer.sum_order_bound`` of the plain version's total
    ``plain_total`` (its float32 sums of a column's Δ take another order,
    ≤ ``n`` terms; ``moved`` the (K,) float64 Σ|Δ| of each topic)."""
    from repro_torch.analysis.sanitizer import sum_order_bound

    f64 = torch.float64  # lint: host-f64
    seed = phi_k.to(f64)
    total = seed.clone()
    out = run(total)
    torch.cuda.synchronize()
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(base, out))
    del out
    check(same, f"{name}: a float32 output differs with the float64 total "
          "and without")
    own = torch.zeros_like(seed)
    run(own)
    torch.cuda.synchronize()
    own_err = float(((total - (seed + own)).abs()
                     / total.abs().clamp_min(1e-30)).max())
    check(own_err <= TOTAL64_OWN_RTOL, f"{name}: the float64 total is not "
          f"its seed plus the kernel's own increments ({own_err})")
    diff = (total - plain_total).abs()
    bound = 1e-12 * plain_total.abs() + sum_order_bound(n, moved)
    check(bool((diff <= bound).all()), f"{name}: the float64 total lies "
          f"{float((diff - bound).max())} past the plain version's bound")
    return {"float32_bitwise": same, "own_increments_rel_err": own_err,
            "plain_max_abs": float(diff.max()),
            "plain_max_rel": float((diff / plain_total.abs().clamp_min(
                1e-30)).max()),
            "share_of_order_bound": float((diff / bound).max())}


def kernel_phase(torch, dev, report):
    """Kernel vs plain version, four variants, at the serving shapes."""
    import numpy as np

    from repro_torch.core import em
    from repro_torch.core.perplexity import (
        init_theta, serving_active_topics, split_heldout_counts,
    )
    from repro_torch.core.types import LDAConfig, MinibatchData
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.kernels.theta_sweep import (
        quantize_phi, sweep_path, theta_sweep, theta_sweep_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import bucketize, localize_vocab

    gen = TrafficGenerator(vocab_size=W_FULL, doc_len=DOC_LEN, seed=1)
    corpus = gen.corpus(D_KERNEL)
    w, c = bucketize(corpus, list(range(D_KERNEL)), pad_multiple=16)
    uniq, local = localize_vocab(w)
    est, ev = split_heldout_counts(c, np.random.default_rng(2))
    Ws = len(uniq)
    rows = np.concatenate(list(trained_like_phi_blocks(
        Ws, K_FULL, ranks=gen.word_ranks()[uniq], seed=3)))
    cfg = LDAConfig(num_topics=K_FULL, vocab_size=W_FULL)
    phi_k = torch.from_numpy(rows.sum(0) * (W_FULL / Ws)).to(dev)
    phi_norm = em.normalize_phi(torch.from_numpy(rows).to(dev), phi_k, cfg)
    wid_t = torch.from_numpy(local).to(dev)
    est_t = torch.from_numpy(est).to(dev)
    ev_t = torch.from_numpy(ev).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    theta0 = init_theta(g, MinibatchData(wid_t, est_t), cfg)
    L = local.shape[1]
    fit_tok = int((est > 0).sum())
    ev_tok = int(((est > 0) | (ev > 0)).sum())
    rows_used = len(np.unique(local[(est > 0) | (ev > 0)]))
    print(f"kernel shapes: D={D_KERNEL} L={L} K={K_FULL} W_s={Ws} "
          f"fit tokens={fit_tok} eval tokens={ev_tok} sweeps={SWEEPS}")
    print(f"tolerance (rtol, atol): {json.dumps(TOL)}: {TOL_REASON}")

    variants = []
    for name, dtype, sched in (("f32 dense", "float32", False),
                               ("f32 scheduled A=16", "float32", True),
                               ("bf16 dense", "bfloat16", False),
                               ("int8 dense", "int8", False)):
        phi, scale = quantize_phi(phi_norm, dtype)
        wt = serving_active_topics(phi_norm, A_SCHED) if sched else None
        args = (wid_t, est_t, ev_t, theta0, phi, wt, scale)
        kw = dict(alpha_m1=cfg.alpha_m1, num_sweeps=SWEEPS)
        got = theta_sweep(*args, **kw)
        torch.cuda.synchronize()
        want = theta_sweep_reference(*args, **kw)
        errs = {}
        for key, a, b in zip(("theta", "est_ll", "ev_ll"), got, want):
            rtol, atol = TOL[key]
            errs[key] = errors(a, b)
            ok = bool(torch.allclose(a, b, rtol=rtol, atol=atol))
            check(ok, f"{name}: {key} disagrees with the plain version "
                      f"{errs[key]} beyond rtol {rtol} / atol {atol}")
        before = theta_sweep.launches
        again = theta_sweep(*args, **kw)
        per_call = theta_sweep.launches - before
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{name}: two launches on the same inputs differ")
        # a document's θ̂ does not depend on its batch-mates: 64 documents
        # of every length, alone, give the same bits (the kernel takes
        # them in another order)
        sub = slice(96, 160)
        part = theta_sweep(*[x[sub].contiguous() for x in args[:4]],
                           *args[4:], **kw)
        check(all(torch.equal(x, y[sub]) for x, y in zip(part, got)),
              f"{name}: a document's θ̂ depends on its batch-mates")
        del part
        path = sweep_path(K_FULL, A_SCHED if sched else 0, L,
                          phi.element_size(), phi.data_ptr())
        ms = cuda_time_ms(lambda: theta_sweep(*args, **kw), 5)
        plain_ms = cuda_time_ms(lambda: theta_sweep_reference(*args, **kw), 2)
        # least time: each input read once, each output written once (φ:
        # the rows this data touches), against the float32 operations
        lanes = A_SCHED if sched else K_FULL
        nbytes = (3 * D_KERNEL * L * 4 + 2 * D_KERNEL * K_FULL * 4
                  + 2 * D_KERNEL * L * 4 + rows_used * K_FULL * phi.element_size()
                  + (rows_used * 4 if scale is not None else 0)
                  + (rows_used * A_SCHED * 4 if sched else 0))
        flops = (5 * lanes * fit_tok * SWEEPS + 2 * K_FULL * ev_tok
                 + 3 * D_KERNEL * K_FULL * (SWEEPS + 1))
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        o_ms = flops / FP32_FLOPS * 1e3
        gather = (SWEEPS * fit_tok * lanes + ev_tok * K_FULL) * phi.element_size()
        bound = max(b_ms, o_ms)
        rec = {"variant": name, "path": path.kind, "path_code": path.code,
               "ring_slots": path.slots, "launches_per_call": per_call,
               "ms": ms, "prior_ms": PRIOR_MS_THETA[name],
               "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if b_ms >= o_ms else "operations",
               "share_of_bound": bound / ms,
               "row_gather_bytes": gather,
               "row_gather_ms_at_hbm_rate": gather / HBM_BYTES_PER_S * 1e3,
               "errors": errs, "bitwise_repeat": True,
               "documents_independent_of_batch": True}
        variants.append(rec)
        print("kernel " + json.dumps(rec))
    report["variants"] = variants

    # bigmodel's K = 5·10⁴: 3·K floats per document exceed shared memory and
    # the same kernel keeps them in a global scratch
    Kb, Db = 50_000, min(32, D_KERNEL)
    rng = np.random.default_rng(4)
    phib = torch.from_numpy(rng.gamma(0.3, 1.0, (Ws, Kb)).astype(np.float32))
    phib = (phib / phib.sum(0, keepdim=True)).to(dev)
    thb = torch.from_numpy(rng.gamma(1.0, 1.0, (Db, Kb)).astype(np.float32))
    argb = (wid_t[:Db].contiguous(), est_t[:Db].contiguous(),
            ev_t[:Db].contiguous(), thb.to(dev), phib)
    kw = dict(alpha_m1=cfg.alpha_m1, num_sweeps=2)
    got = theta_sweep(*argb, **kw)
    torch.cuda.synchronize()
    want = theta_sweep_reference(*argb, **kw)
    for key, a, b in zip(("theta", "est_ll", "ev_ll"), got, want):
        rtol, atol = TOL[key]
        check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
              f"K={Kb} global-scratch path: {key} disagrees "
              f"{errors(a, b)}")
    print(f"kernel K={Kb} D={Db} (path "
          f"{sweep_path(Kb, 0, L, 4, phib.data_ptr()).kind}): agrees with "
          f"the plain version, max abs err "
          f"{max(errors(a, b)['max_abs'] for a, b in zip(got, want)):.3g}")
    del phi_norm, phi, theta0, phib, thb, argb, got, want
    torch.cuda.empty_cache()
    wide_estep_check(torch, dev, Kb)


def wide_estep_check(torch, dev, K):
    """fused_estep at bigmodel's K = 5·10⁴, past the register path: the
    two-pass kernel path against its plain version, 256 rows, θ̂ one row
    per 16 tokens, with the exclusion and the residual."""
    import numpy as np

    from repro_torch.kernels.foem_estep import (
        estep_path, fused_estep, fused_estep_reference,
    )

    T, G = 256, 16
    rng = np.random.default_rng(6)
    th = rng.gamma(1.0, 3.0, (T // G, K)).astype(np.float32)
    ph = rng.gamma(0.5, 2.0, (T, K)).astype(np.float32)
    pt = (ph.sum(0) * 40).astype(np.float32)
    mu = rng.dirichlet(np.ones(K), T).astype(np.float32)
    cnt = rng.integers(0, 5, T).astype(np.float32)
    args = [torch.from_numpy(x).to(dev)
            for x in (th, ph, pt, cnt[:, None] * mu, mu, cnt)]
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=W_FULL * 0.01)
    path = estep_path(K, args[:5])
    got = fused_estep(*args, **kw)
    torch.cuda.synchronize()
    want = fused_estep_reference(*args, **kw)
    errs = {key: _check_close(f"fused_estep K={K}", key, a, b,
                              ESTEP_TOL[key])
            for key, a, b in zip(("mu", "residual"), got, want)}
    again = fused_estep(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"fused_estep K={K}: two launches on the same inputs differ")
    print(f"estep kernel K={K} T={T} (path {path.kind}): agrees with the "
          f"plain version {json.dumps(errs)}")


def make_store(store_dir, report):
    """The stream_1k serving/training store: trained-like random φ̂ rows
    from a seed, written straight into the memmap under ``build/``."""
    from repro_torch.core.streaming import store_from_arrays
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.launch.serve import TrafficGenerator

    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.parent.mkdir(parents=True, exist_ok=True)
    cap = W_FULL
    free = shutil.disk_usage(store_dir.parent).free
    need = cap * K_FULL * 4
    if free < need + (4 << 30):
        cap = int((free - (4 << 30)) // (K_FULL * 4))
        check(cap > 16_384, f"only {free} bytes free for the store")
        print(f"store capacity cut from {W_FULL} to {cap} rows: "
              f"{free} bytes free on disk")
    report["store_capacity"] = cap
    gen = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN, seed=7)
    t0 = time.perf_counter()
    store = store_from_arrays(
        str(store_dir), trained_like_phi_blocks(
            cap, K_FULL, ranks=gen.word_ranks(), seed=0),
        live_vocab=cap, vocab_capacity=cap)
    report["store_write_s"] = time.perf_counter() - t0
    print(f"store written: {cap} x {K_FULL} float32 "
          f"({cap * K_FULL * 4 / 1e9:.2f} GB) in "
          f"{report['store_write_s']:.1f} s")
    return store, gen


def serving_phase(torch, store, gen, report):
    """The serving main path at the stream_1k width."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.perplexity import split_heldout_counts
    from repro_torch.kernels.theta_sweep import theta_sweep
    from repro_torch.launch.serve import TopicServer
    from repro_torch.sparse import bucketize

    cfg = lda_config(lda_shape("stream_1k"))
    B = 256
    corpus = gen.corpus(5 * B)

    theta_sweep.launches = 0          # counts of the main path only
    srv = TopicServer(store, cfg, device="cuda")
    lat, fetch, fit, sweeps = [], [], [], []
    stream = srv.infer_stream(corpus, list(range(3 * B)), B)
    for _ in range(3):
        t0 = time.perf_counter()
        chunk, theta = next(stream)
        lat.append(time.perf_counter() - t0)
        fetch.append(srv.last_seconds["fetch"])
        fit.append(srv.last_seconds["fit"])
        sweeps.append(srv.last_sweeps)
        check(theta.shape == (B, K_FULL) and np.isfinite(theta).all(),
              "served θ has the wrong shape or is not finite")
        check(np.allclose(theta.sum(-1), 1.0, rtol=1e-4),
              "served θ rows do not sum to 1")
    w, c = bucketize(corpus, list(range(3 * B, 4 * B)), pad_multiple=16)
    t1 = srv.infer(w, c)
    # the same (warm) batch again, under the profiler: where its time goes
    t2, wall_ms, by_op, busy_ms = device_profile(
        torch, lambda: srv.infer(w, c))
    check(np.array_equal(t1, t2), "identical requests gave different θ")
    profiled = {"wall_ms": wall_ms,
                "fetch_ms": srv.last_seconds["fetch"] * 1e3,
                "fit_ms": srv.last_seconds["fit"] * 1e3,
                "sweeps": srv.last_sweeps,
                "device_busy_ms": busy_ms if by_op else None,
                "device_busy_share": busy_ms / wall_ms if by_op else None,
                "device_ms_by_op": top_ops(by_op, 10)}
    print("profiled batch " + json.dumps(profiled) if by_op else
          "profiled batch: device time not measured (no device events)")
    est, ev = split_heldout_counts(c, np.random.default_rng(5))
    _, ppl = srv.evaluate(w, est, ev)
    check(np.isfinite(ppl) and 1.0 < ppl < cfg.W,
          f"eq. 21 perplexity {ppl} is not finite and in (1, W)")

    hot = TopicServer(store, cfg, hot_rows=16_384, device="cuda")
    w2, c2 = bucketize(corpus, list(range(4 * B, 5 * B)), pad_multiple=16)
    hot.infer(w, c)
    t_hot = hot.infer(w2, c2)
    check(np.isfinite(t_hot).all(), "hot-row-cache θ is not finite")
    hit_rate = hot.hot_cache.stats.hit_rate

    q = TopicServer(store, cfg, phi_dtype="int8", device="cuda")
    _, ppl_q = q.evaluate(w, est, ev)
    check(np.isfinite(ppl_q), "int8 eq. 21 perplexity is not finite")
    launches = theta_sweep.launches
    check(launches > 0, "the serving path launched no theta_sweep kernel")
    report["heldout"] = (w, est, ev)

    lat_ms = [x * 1e3 for x in lat]
    rec = {"batch_docs": B, "batch_ms": lat_ms,
           "fetch_ms": [x * 1e3 for x in fetch],
           "fit_ms": [x * 1e3 for x in fit], "sweeps": sweeps,
           "docs_per_s": B * len(lat) / sum(lat),
           "eq21_ppl_f32": ppl, "eq21_ppl_int8": ppl_q,
           "int8_drift": ppl_q / ppl - 1.0, "hot_cache_hit_rate": hit_rate,
           "store_write_s": report["store_write_s"], "launches": launches}
    print("serving " + json.dumps(rec))
    report["serving"] = rec


def serving_engine_phase(torch, store, report):
    """The continuous-batching engine at the stream_1k width on the store:
    ServingEngine(max_batch = 256, 16-token L buckets up to 256, 5 ms
    deadline) over TopicServer(device="cuda"); 1,024 Zipf(1.1) requests
    replayed unpaced, then paced at half the unpaced documents/s; the
    per-document θ̂₀ draw of a full batch timed alone; then 32 documents of
    a rel_tol = 0 engine against the same documents in another packing
    through TopicServer.infer, bitwise."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.kernels.theta_sweep import theta_sweep
    from repro_torch.launch.serve import (
        ServingEngine, TopicServer, TrafficGenerator, document_theta0,
    )

    t_phase = time.perf_counter()
    cfg = lda_config(lda_shape("stream_1k"))
    traffic = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                               seed=31)
    docs = [traffic.document() for _ in range(ENGINE_REQUESTS)]
    srv = TopicServer(store, cfg, device="cuda")
    kw = dict(max_batch=ENGINE_BATCH, bucket_multiple=16,
              max_len=DOC_LEN[1], max_delay_ms=ENGINE_DELAY_MS)
    runs = {}
    with ServingEngine(srv, **kw) as eng:
        t0 = time.perf_counter()
        warm = eng.prewarm()
        warm_s = time.perf_counter() - t0
        rng = np.random.default_rng(37)
        rate = None
        for mode in ("unpaced", "paced"):
            if mode == "unpaced":
                trace = [(0.0, w, c) for w, c in docs]
            else:          # Poisson arrivals at half the unpaced docs/s
                t_arr = np.cumsum(rng.exponential(1.0 / rate, len(docs)))
                trace = [(float(t), w, c) for t, (w, c) in zip(t_arr, docs)]
            eng.metrics(reset=True)
            theta_sweep.launches = 0      # counts of the main path only
            t0 = time.perf_counter()
            futs = TrafficGenerator.replay(trace, eng.submit,
                                           pace=mode == "paced")
            thetas = np.stack([f.result(timeout=120) for f in futs])
            wall = time.perf_counter() - t0
            eng.drain()                   # the last batch's accounting
            launches = theta_sweep.launches
            m = eng.metrics(reset=False)
            log = list(eng.batch_log)
            check(thetas.shape == (len(docs), K_FULL)
                  and np.isfinite(thetas).all(),
                  f"engine {mode}: θ has the wrong shape or is not finite")
            row_err = float(np.abs(thetas.sum(1, dtype=np.float64)
                                   - 1.0).max())
            check(row_err <= 1e-5,
                  f"engine {mode}: a θ row sums to 1 ± {row_err}")
            check(m["requests"] == len(docs) and m["failed_batches"] == 0,
                  f"engine {mode}: {m}")
            check(launches > 0, f"engine {mode} launched no theta_sweep")
            if rate is None:
                rate = 0.5 * len(docs) / wall
            runs[mode] = {
                "requests": len(docs), "wall_s": wall,
                "docs_per_s": len(docs) / wall,
                "offered_docs_per_s": None if mode == "unpaced" else rate,
                "p50_ms": m["p50_ms"], "p99_ms": m["p99_ms"],
                "mean_ms": m["mean_ms"], "batches": m["batches"],
                "mean_fill": m["mean_fill"],
                "L_buckets": sorted({b["L"] for b in log}),
                "launch_ms_mean": 1e3 * float(np.mean(
                    [b["launch_seconds"] for b in log])),
                "fetch_ms_mean": 1e3 * float(np.mean(
                    [b["fetch_seconds"] for b in log])),
                "fit_ms_mean": 1e3 * float(np.mean(
                    [b["fit_seconds"] for b in log])),
                "theta_sweep_launches": launches,
                "max_row_sum_error": row_err}
            print(f"serving engine ({mode}) " + json.dumps(runs[mode]))

    # the per-document θ̂₀ draw of a full batch (256 × 256 × 10⁴ draws)
    cd = np.ones((ENGINE_BATCH, DOC_LEN[1]), np.float32)
    seeds = np.arange(ENGINE_BATCH)
    draw = lambda: document_theta0(seeds, cd, cfg, device="cuda")  # noqa
    draw_ms = cuda_time_ms(draw, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    draw()
    torch.cuda.synchronize()
    draw_wall_ms = (time.perf_counter() - t0) * 1e3
    _, _, by_op, draw_busy_ms = device_profile(torch, draw)
    del cd

    # slot invariance: 32 documents through a rel_tol = 0 engine, then the
    # same documents, grouped by L bucket, in reverse slot order after 16
    # strangers through TopicServer.infer with their per-document θ̂₀
    exact = TopicServer(store, cfg, rel_tol=0.0, device="cuda")
    few = docs[:32]
    seeds = np.random.default_rng(41).integers(0, 2**32, len(few))
    with ServingEngine(exact, **kw) as eng:
        got = [f.result(timeout=120) for f in
               [eng.submit(w, c, seed=int(s)) for (w, c), s
                in zip(few, seeds)]]
    groups = {}
    for i, (w, _) in enumerate(few):
        groups.setdefault(eng._bucket(len(w)), []).append(i)
    strangers = docs[32:48]
    for L, ids in groups.items():
        wp = np.zeros((ENGINE_BATCH, L), np.int32)
        cp = np.zeros((ENGINE_BATCH, L), np.float32)
        sp = np.full(ENGINE_BATCH, -1, np.int64)
        slots = {}
        for slot, (w, c) in enumerate(strangers):
            n = min(len(w), L)
            wp[slot, :n], cp[slot, :n], sp[slot] = w[:n], c[:n], 1000 + slot
        for slot, i in enumerate(reversed(ids), start=len(strangers)):
            w, c = few[i]
            wp[slot, : len(w)], cp[slot, : len(c)] = w, c
            sp[slot] = seeds[i]
            slots[i] = slot
        direct = exact.infer(wp, cp, theta0=document_theta0(
            sp, cp, cfg, device="cuda"))
        for i, slot in slots.items():
            check(np.array_equal(got[i], direct[slot]),
                  f"engine: document {i} (L = {L}) differs from the same "
                  "document in another packing")
    rec = {"prewarm_launches": warm, "prewarm_s": warm_s,
           "theta0_draw_ms": draw_ms, "theta0_draw_wall_ms": draw_wall_ms,
           "theta0_draw_busy_ms": draw_busy_ms if by_op else None,
           "theta0_draw_shape": [ENGINE_BATCH, DOC_LEN[1], K_FULL],
           "slot_invariance": {"documents": len(few),
                               "buckets": sorted(groups),
                               "bitwise": True},
           "phase_s": time.perf_counter() - t_phase}
    print("serving engine " + json.dumps(rec))
    report["serving_engine"] = dict(rec, runs=runs)


def replica_pool_phase(torch, store, store_dir, report):
    """The multi-replica pool at the stream_1k width on the flushed store,
    each worker attaching it READONLY: ReplicaPool(process backend,
    POOL_REPLICAS replicas on the card, the engine phase's 256-document
    launches, 16-token buckets up to 256, a 5 ms deadline, rel_tol = 0,
    fit_sweeps 50).  A clean run of the engine phase's 1,024 Zipf(1.1)
    requests (seed 31) unpaced; the same trace with replica 0 SIGKILLed
    before its second launch (every θ bitwise the clean run's, one death,
    one respawn, back to POOL_REPLICAS); on that pool a publish of the
    store (v1) broadcast to every replica, then POOL_SWAP_REQUESTS requests
    that must all carry version 1; then a thread-backend pool over the
    first POOL_THREAD_DOCS documents, bitwise the clean run's."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core import SnapshotPublisher
    from repro_torch.kernels.theta_sweep import theta_sweep
    from repro_torch.launch.replica import ReplicaPool, ReplicaSpec
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.runtime.faults import REPLICA_KILL, FaultSpec

    t_phase = time.perf_counter()
    cfg = lda_config(lda_shape("stream_1k"))
    cap = store.capacity
    phi_bytes = cap * K_FULL * 4
    # the publisher's copy, one pickled payload a replica in the parent's
    # queue feeders, and a worker's received bytes and unpickled copy are
    # 7 φ copies at 2 replicas; the phase's process tree was measured at
    # 62.7 GB resident (11.1 copies, shared pages counted in each process),
    # so the guard asks for POOL_SWAP_PHI_COPIES and 8 GiB, and the run
    # checks that the host memory the phase took stayed inside it
    need = POOL_SWAP_PHI_COPIES * phi_bytes + (8 << 30)
    avail = host_mem_available()
    print(f"replica pool host memory: MemAvailable {avail} bytes, need "
          f"{need} ({POOL_SWAP_PHI_COPIES} φ copies of {phi_bytes})")
    check(avail >= need, f"replica pool: {avail} bytes of host memory "
          f"available, {need} needed for the swap at the stream_1k width")
    traffic = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN, seed=31)
    docs = [traffic.document() for _ in range(ENGINE_REQUESTS)]
    spec = ReplicaSpec(store_path=str(store_dir), cfg=cfg,
                       vocab_capacity=cap, fit_sweeps=50, rel_tol=0.0,
                       device="cuda")
    kw = dict(replicas=POOL_REPLICAS, max_batch=ENGINE_BATCH,
              bucket_multiple=16, max_len=DOC_LEN[1],
              max_delay_ms=ENGINE_DELAY_MS)
    runs, launches = {}, 0

    def serve(pool, name, batch_docs):
        pool.metrics(reset=True)
        t0 = time.perf_counter()
        futs = [pool.submit(w, c) for w, c in batch_docs]
        got = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        pool.drain()
        m = pool.metrics(reset=True)
        thetas = np.stack(got)
        check(thetas.shape == (len(batch_docs), K_FULL)
              and np.isfinite(thetas).all(),
              f"pool {name}: θ has the wrong shape or is not finite")
        row_err = float(np.abs(thetas.sum(1, dtype=np.float64) - 1.0).max())
        check(row_err <= 1e-5, f"pool {name}: a θ row sums to 1 ± {row_err}")
        check(m["requests"] == len(batch_docs) and m["failed_batches"] == 0,
              f"pool {name}: {m}")
        rec = {"requests": len(batch_docs), "wall_s": wall,
               "docs_per_s": len(batch_docs) / wall, "p50_ms": m["p50_ms"],
               "p99_ms": m["p99_ms"], "batches": m["batches"],
               "mean_fill": m["mean_fill"], "dispatch": m["dispatch"],
               "theta_sweep_launches": m["theta_sweep_launches"],
               "max_row_sum_error": row_err}
        runs[name] = rec
        return got, [r.version for r in got], rec

    def ready_record(pool):
        return {"spawn_to_ready_s": [r["seconds"] for r in pool.ready_log
                                     if not r["respawn"]],
                "respawn_s": [r["seconds"] for r in pool.ready_log
                              if r["respawn"]]}

    # 1. clean run
    with ReplicaPool(spec, backend="process", **kw) as pool:
        pool.wait_ready(600)
        warm = pool.prewarm()
        clean, _, rec = serve(pool, "clean", docs)
        rec.update(ready_record(pool), prewarmed_replicas=warm)
        check(pool.metrics()["deaths"] == 0, "pool clean: a worker died")
    launches += rec["theta_sweep_launches"] or 0
    print("replica pool (clean) " + json.dumps(rec))

    # 2. the same trace, replica 0 SIGKILLed before its second launch; 4.
    # then a publish broadcast to the pool and traffic on version 1
    kill = (FaultSpec(point=REPLICA_KILL, kind="kill", step=1, shard=0,
                      hard=True),)
    swap = {}
    with RssSampler(tree=True) as rss:
        with ReplicaPool(dataclasses.replace(spec, fault_specs=kill),
                         backend="process", **kw) as pool:
            pool.wait_ready(600)
            pool.prewarm()
            faulted, _, rec = serve(pool, "hard kill", docs)
            deadline = time.monotonic() + 600
            while pool.respawns < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            pool.wait_ready(600)
            m = pool.metrics()
            rec.update(ready_record(pool), deaths=pool.deaths,
                       respawns=m["respawns"], replicas=m["replicas"])
            check(m["deaths"] == 1 and m["respawns"] == 1
                  and m["replicas"] == POOL_REPLICAS,
                  f"pool hard kill: deaths {m['deaths']}, respawns "
                  f"{m['respawns']}, replicas {m['replicas']}")
            check(pool.deaths[0]["kind"] == "hard"
                  and pool.deaths[0]["exitcode"] == -9,
                  f"pool hard kill: {pool.deaths}")
            same = all(np.array_equal(a, b) for a, b in zip(clean, faulted))
            check(same, "pool hard kill: a θ differs from the clean run")
            launches += rec["theta_sweep_launches"] or 0
            print("replica pool (hard kill) " + json.dumps(rec))

            t0 = time.perf_counter()
            pub = SnapshotPublisher(store)
            snap = pub.publish()
            publish_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            pool.subscribe(pub)
            deadline = time.monotonic() + 600
            while (len({a["rid"] for a in pool.swap_acks}) < POOL_REPLICAS
                   and not pool.swap_errors
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            acks_s = time.perf_counter() - t0
            check(not pool.swap_errors, f"pool swap: {pool.swap_errors}")
            check(pool.balancer.versions() == {
                r: 1 for r in range(POOL_REPLICAS)},
                f"pool swap: versions {pool.balancer.versions()}")
            _, versions, rec = serve(pool, "after swap",
                                     docs[:POOL_SWAP_REQUESTS])
            check(set(versions) == {1},
                  f"pool swap: served versions {sorted(set(versions))}")
            launches += rec["theta_sweep_launches"] or 0
            del pub, snap
    taken = avail - rss.min_available
    check(taken <= need, f"replica pool: the phase took {taken} bytes of "
          f"host memory, more than the {need} its guard asks for")
    swap = {"version": 1, "publish_s": publish_s,
            "ack_s": {a["rid"]: a["seconds"] for a in pool.swap_acks},
            "all_acked_s": acks_s, "crc_checked": True,
            "peak_tree_rss_bytes": rss.peak, "mem_available_bytes": avail,
            "min_mem_available_bytes": rss.min_available,
            "host_memory_taken_bytes": taken, "guard_bytes": need}
    print("replica pool (swap) " + json.dumps(swap))

    # 3. the thread backend: replica r on cuda:{r mod cards}, one process
    theta_sweep.launches = 0               # counts of this run only
    with ReplicaPool(spec, backend="thread", **kw) as pool:
        pool.wait_ready(600)
        threaded, _, rec = serve(pool, "thread",
                                 docs[:POOL_THREAD_DOCS])
    thread_launches = theta_sweep.launches
    check(thread_launches > 0, "pool thread: no theta_sweep launch")
    same = all(np.array_equal(a, b) for a, b in zip(clean, threaded))
    check(same, "pool thread: a θ differs from the process pool's")
    rec["theta_sweep_launches"] = thread_launches
    launches += thread_launches
    print("replica pool (thread) " + json.dumps(rec))
    check(launches > 0, "the replica pool launched no theta_sweep kernel")
    out = {"replicas": POOL_REPLICAS, "theta_sweep_launches": launches,
           "engine_unpaced_docs_per_s":
               report["serving_engine"]["runs"]["unpaced"]["docs_per_s"],
           "bitwise_equal_clean": True, "phase_s":
               time.perf_counter() - t_phase}
    print("replica pool " + json.dumps(out))
    report["replica_pool"] = dict(out, runs=runs, swap=swap)


def _bound(nbytes, flops) -> tuple:
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_FLOPS * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def _sweep_bound_ms(D, L, K, rows_used, live_tokens, lanes, A,
                    loglik, extra_bytes=0) -> tuple:
    """Least time of one sweep on these inputs: each input read once and
    each output written once — μ (D·L·K) in, μ_new and the residual out,
    θ̂ and the touched φ̂ rows in and out, φ̂(k), the token ids and counts
    (+ the active sets and λ_w mask, + ``extra_bytes``) — against ≈ 21
    float32 operations per computed (token, lane) entry (+ 7 per (token,
    topic) of ``live_tokens`` for the stop rule)."""
    nbytes = (3 * D * L * K * 4 + 2 * D * L * 4 + 2 * D * K * 4
              + 2 * rows_used * K * 4 + 2 * K * 4 + extra_bytes)
    if A:
        nbytes += rows_used * A * 4 + D * L
    flops = 21 * lanes + (7 * live_tokens * K if loglik else 0)
    return _bound(nbytes, flops)


def _dense_design_bytes(wid, cnt, K, group_docs) -> dict:
    """The bytes the dense column loop (csrc/gs_sweep.cu) moves by design on
    this minibatch, column by column: μ in, μ_new and the residual out; θ̂
    read (every document) and written (live tokens); each distinct word's
    φ̂ row read and, live, written; Δ written and read for tokens whose word
    is shared in the column (a lone live token folds its row in the E-step);
    the group sums written and read.  Against the bound's once-a-sweep θ̂
    and rows, this is what keeps the loop above its bound."""
    import numpy as np

    D, L = wid.shape
    row = K * 4
    groups = -(-D // group_docs)
    total = 0
    for l in range(L):
        w, live = wid[:, l], cnt[:, l] != 0
        uniq, inv, n = np.unique(w, return_inverse=True, return_counts=True)
        shared = int((live & (n[inv] > 1)).sum())
        nbytes = (3 * D + D + int(live.sum()) + len(uniq)
                  + len(np.unique(w[live])) + 2 * shared + 2 * groups) * row
        total += nbytes
    return {"design_bytes": total, "design_bytes_per_column": total / L,
            "design_ms_at_hbm_rate": total / HBM_BYTES_PER_S * 1e3}


def sweep_kernel_phase(torch, dev, store, report):
    """Both training sweep kernels against their plain versions at the
    stream_1k training shapes: one bucketed 1,024 × 128 minibatch from the
    store, its minibatch-start state, then a post-warm-up scheduled
    state."""
    import numpy as np

    from repro_torch.core import em, scheduling
    from repro_torch.core.types import uniform_responsibilities
    from repro_torch.kernels.gs_sweep import (
        GROUP_DOCS, dense_path, gs_sweep, gs_sweep_reference, sweep_loglik,
        sweep_loglik_partials, token_loglik,
    )
    from repro_torch.kernels.scheduled_sweep import (
        scheduled_sweep, scheduled_sweep_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=3)
    mb = next(iter(MinibatchStream(gen.corpus(D_TRAIN), D_TRAIN,
                                   bucket_len=L_TRAIN, seed=0)))
    Ws = len(mb.local_vocab)
    wid = torch.from_numpy(mb.local_word_ids).to(dev)
    cnt = torch.from_numpy(mb.counts).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    mu = uniform_responsibilities(g, (D_TRAIN, L_TRAIN, K_FULL))
    theta = em.fold_theta(mu, cnt)
    phi = torch.from_numpy(store.fetch_rows(mb.local_vocab)).to(dev)
    phi = phi + em.fold_phi(mu, cnt, wid, Ws)[0]
    ptot = phi.sum(0)                       # a consistent local view
    wb = W_FULL * 0.01
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=wb)
    live = mb.counts > 0
    rows_used = len(np.unique(mb.local_word_ids[live]))
    live_tok = int(live.sum())
    print(f"sweep kernel shapes: D={D_TRAIN} L={L_TRAIN} K={K_FULL} "
          f"W_s={Ws} live tokens={live_tok} rows touched={rows_used} "
          f"A={A_SCHED}")
    print(f"sweep tolerance (rtol, atol): {json.dumps(SWEEP_TOL)}: "
          f"{SWEEP_TOL_REASON}")

    design = _dense_design_bytes(mb.local_word_ids, mb.counts, K_FULL,
                                 GROUP_DOCS)
    # the post-warm-up state the scheduled sweeps start from: one dense
    # sweep, its residuals ranked into the eq. 36 active sets
    warm = gs_sweep(wid, cnt, mu, theta, phi, ptot, **kw)
    sched = scheduling.residuals_from_sweep(warm[1], wid, Ws)
    wt = scheduling.select_active_topics(sched.r_wk, A_SCHED)
    act = cnt > 0
    post = (warm[0], warm[2], warm[3], warm[4])
    del warm, sched
    names = ("mu", "residual", "theta", "phi_wk", "phi_k", "loglik")
    variants = []
    for name, fn, ref, extra in (
            ("dense", gs_sweep, gs_sweep_reference, None),
            ("scheduled A=16", scheduled_sweep, scheduled_sweep_reference,
             (wt, act))):
        args = ((wid, cnt, mu, theta, phi, ptot) if extra is None
                else (wid, cnt) + post + extra)
        for loglik in (False, True):
            vkw = dict(kw, emit_loglik=loglik)
            got = fn(*args, **vkw)
            torch.cuda.synchronize()
            plain64 = args[5].to(torch.float64)  # lint: host-f64
            want = ref(*args, **vkw, phi_k64=plain64)
            errs = {}
            for key, a, b in zip(names, got, want):
                if a is None:
                    continue
                rtol, atol = SWEEP_TOL[key]
                errs[key] = errors(a, b)
                check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
                      f"{name} sweep: {key} disagrees with the plain "
                      f"version {errs[key]} beyond rtol {rtol} / atol {atol}")
            del want
            total64 = total64_check(
                torch, f"{name} sweep", lambda t: fn(*args, **vkw, phi_k64=t),
                args[5], got, plain64, D_TRAIN, col_sum64(torch, got[1]))
            again = fn(*args, **vkw)
            check(all(torch.equal(x, y) for x, y in zip(got, again)
                      if x is not None),
                  f"{name} sweep: two launches on the same inputs differ")
            del again
            zero = cnt == 0
            check(float(got[1][zero].abs().max()) == 0.0,
                  f"{name} sweep: a zero-count slot has a residual")
            check(bool(torch.allclose(got[4], got[3].sum(0),
                                      rtol=PHI_K_SUM_RTOL)),
                  f"{name} sweep: phi_k is not the sum of the phi rows "
                  f"{errors(got[4], got[3].sum(0))}")
            drift = phi_k_drift(torch, args[5], args[4], got[4], got[3])
            del got
            ms = cuda_time_ms(lambda: fn(*args, **vkw), 3)
            plain_ms = cuda_time_ms(lambda: ref(*args, **vkw), 1)
            lanes = (D_TRAIN * L_TRAIN * K_FULL if extra is None
                     else A_SCHED * live_tok)
            bound, by = _sweep_bound_ms(
                D_TRAIN, L_TRAIN, K_FULL, rows_used, live_tok, lanes,
                A_SCHED if extra is not None else 0, loglik)
            variant = name + (" +loglik" if loglik else "")
            rec = {"variant": variant, "kernel": fn.__name__,
                   "path": (dense_path(K_FULL, [mu]).kind if extra is None
                            else "active-set column loop"),
                   "ms": ms, "prior_ms": PRIOR_MS[variant],
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "share_of_bound": bound / ms,
                   "launches_per_call": fn.launches_per_call,
                   "phi_k_drift_tokens": drift, "total64": total64,
                   "errors": errs}
            if extra is None:
                rec.update(design)
            variants.append(rec)
            print("sweep kernel " + json.dumps(rec))
            torch.cuda.empty_cache()
    # the stop-rule phase alone, on the post-warm-up statistics: its kernel
    # against the plain per-token partials, its time beside the least time
    # of its row gather (a K-float φ̂ row for every live token)
    ll_args = (wid, cnt) + post[1:]
    got = sweep_loglik_partials(*ll_args, **kw)
    torch.cuda.synchronize()
    want = token_loglik(*ll_args, wb, alpha_m1=0.01, beta_m1=0.01)
    err = _check_close("stop rule", "loglik partials", got, want,
                       (SWEEP_TOL["loglik"][0], STOP_RULE_ATOL))
    total = sweep_loglik(*ll_args, wb, alpha_m1=0.01, beta_m1=0.01)
    _check_close("stop rule", "loglik", got.sum(), total, SWEEP_TOL["loglik"])
    check(torch.equal(got, sweep_loglik_partials(*ll_args, **kw)),
          "stop rule: two launches on the same inputs differ")
    del got, want
    ms = cuda_time_ms(lambda: sweep_loglik_partials(*ll_args, **kw), 5)
    gather = live_tok * K_FULL * 4
    rec = {"variant": "stop rule", "kernel": "sweep_loglik_partials",
           "ms": ms, "prior_ms": PRIOR_MS["stop rule"],
           "row_gather_bytes": gather,
           "row_gather_ms_at_hbm_rate": gather / HBM_BYTES_PER_S * 1e3,
           "launches_per_call": 1, "errors": {"loglik partials": err}}
    variants.append(rec)
    print("sweep kernel " + json.dumps(rec))
    report["sweep_variants"] = variants
    del mu, theta, phi, ptot, post, args, ll_args
    torch.cuda.empty_cache()
    wide_sweep_check(torch, dev, mb)


def wide_sweep_check(torch, dev, mb):
    """gs_sweep at bigmodel's K = 5·10⁴, past the register path: the
    two-pass path against its plain version and bitwise twice, on the
    minibatch's first 32 documents × 8 columns over their own rows."""
    import numpy as np

    from repro_torch.kernels.gs_sweep import (
        dense_path, gs_sweep, gs_sweep_reference,
    )

    K, D, L = 50_000, min(32, len(mb.local_word_ids)), 8
    w = mb.local_word_ids[:D, :L]
    uniq, local = np.unique(w, return_inverse=True)
    rng = np.random.default_rng(8)
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    cnt = np.ascontiguousarray(mb.counts[:D, :L])
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = (rng.gamma(1.0, 1.0, (len(uniq), K)) * 3).astype(np.float32)
    args = [torch.from_numpy(x).to(dev) for x in (
        local.reshape(D, L).astype(np.int32), cnt, mu, theta, phi,
        phi.sum(0))]
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=W_FULL * 0.01,
              emit_loglik=True)
    got = gs_sweep(*args, **kw)
    torch.cuda.synchronize()
    want = gs_sweep_reference(*args, **kw)
    errs = {key: _check_close(f"gs_sweep K={K}", key, a, b, SWEEP_TOL[key])
            for key, a, b in zip(("mu", "residual", "theta", "phi_wk",
                                  "phi_k", "loglik"), got, want)}
    again = gs_sweep(*args, **kw)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"gs_sweep K={K}: two launches on the same inputs differ")
    print(f"sweep kernel K={K} D={D} L={L} (path "
          f"{dense_path(K, [args[2]]).kind}): agrees with the plain version "
          f"{json.dumps(errs)}")


def training_phase(torch, store, report):
    """The training main path at the stream_1k width: FOEMTrainer on the
    card for three minibatches, one more step under the profiler, then a
    served batch from the trained store."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.trainer import FOEMTrainer
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.launch.serve import TopicServer, TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    cfg = lda_config(lda_shape("stream_1k"))
    t0 = time.perf_counter()
    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=13)
    corpus = gen.corpus(4 * D_TRAIN)
    mbs = list(MinibatchStream(corpus, D_TRAIN, bucket_len=L_TRAIN, seed=0))
    corpus_s = time.perf_counter() - t0
    print(f"training corpus: {4 * D_TRAIN} documents, {len(mbs)} "
          f"minibatches of {D_TRAIN} x {L_TRAIN}, W_s "
          f"{[len(m.local_vocab) for m in mbs]}, made in {corpus_s:.1f} s")
    warm = max(1, cfg.warmup_sweeps)
    steps = []

    def record(m):
        rec = {"step": m.step, "sweeps": m.sweeps, "train_ppl": m.train_ppl,
               "residual_mass": m.residual_mass, "seconds": m.seconds,
               "fetch_s": m.fetch_seconds, "compute_s": m.compute_seconds,
               "writeback_s": m.writeback_seconds,
               "prefetch_hit": m.prefetch_hit}
        print("train step " + json.dumps(rec))
        steps.append(rec)
        check(warm <= m.sweeps <= cfg.max_sweeps,
              f"step {m.step} ran {m.sweeps} sweeps, not in "
              f"[{warm}, {cfg.max_sweeps}]")
        check(np.isfinite(m.train_ppl) and 1.0 < m.train_ppl < cfg.W,
              f"step {m.step} train perplexity {m.train_ppl} is not finite "
              "and in (1, W)")

    gs_sweep.launches = 0                 # counts of the main path only
    scheduled_sweep.launches = 0
    trainer = FOEMTrainer(cfg, store, seed=0, prefetch_depth=1,
                          device="cuda")
    t0 = time.perf_counter()
    trainer.fit_stream(iter(mbs[:3]), max_steps=3, callback=record)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {"gs_sweep": gs_sweep.launches,
                "scheduled_sweep": scheduled_sweep.launches}
    check(len(steps) == 3, f"the trainer ran {len(steps)} of 3 steps")
    check(all(v > 0 for v in launches.values()),
          f"the training path did not launch both sweep kernels {launches}")
    print(f"training: 3 steps in {train_s:.1f} s, kernel calls "
          + json.dumps(launches))

    # one more step, synchronous, under the profiler
    torch.cuda.reset_peak_memory_stats()
    m, wall_ms, by_op, busy_ms = device_profile(
        torch, lambda: trainer.step(mbs[3]))
    record(m)
    groups = {}
    for name, v in by_op.items():
        key = ("dense sweep column loop" if "gs_loop_kernel" in name else
               "scheduled sweep column loop" if "active_loop_kernel" in name
               else "scheduled sweep pass"
               if "active::copy_kernel" in name
               or "active::zero_kernel" in name else
               "stop-rule loglik" if "loglik_kernel" in name else
               "memcpy HtoD" if "HtoD" in name else
               "memcpy DtoH" if "DtoH" in name else "other")
        groups[key] = groups.get(key, 0.0) + v
    profiled = {"wall_ms": wall_ms, "fetch_ms": m.fetch_seconds * 1e3,
                "compute_ms": m.compute_seconds * 1e3,
                "writeback_ms": m.writeback_seconds * 1e3,
                "sweeps": m.sweeps,
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
                "device_busy_ms": busy_ms if by_op else None,
                "device_busy_share": busy_ms / wall_ms if by_op else None,
                "device_ms_by_group": groups,
                "device_ms_by_op": top_ops(by_op, 12)}
    print("profiled training step " + json.dumps(profiled) if by_op else
          "profiled training step: device time not measured "
          "(no device events)")

    # train, then serve: the trained store answers a held-out batch
    w, est, ev = report["heldout"]
    _, ppl = TopicServer(store, cfg, device="cuda").evaluate(w, est, ev)
    check(np.isfinite(ppl) and 1.0 < ppl < cfg.W,
          f"eq. 21 perplexity {ppl} of the trained store is not finite "
          "and in (1, W)")
    print(f"served from the trained store: eq. 21 perplexity {ppl}")
    report["training_corpus"] = corpus     # the baselines step reads it
    report["training"] = {"steps": steps, "train_s": train_s,
                          "corpus_s": corpus_s, "launches": launches,
                          "profiled": profiled, "served_ppl": ppl}


def elastic_phase(torch, report):
    """The elastic FOEM runtime at the stream_1k width: dense φ̂ (W, K) on
    the card, the training phase's first ELASTIC_MINIBATCHES minibatches of
    1,024 × 128 over 2 shards.  A clean run (2 rounds), the same run
    with ``debug_checks=True``, which must run whole (its seconds and peak
    GB beside the clean run's); a run with shard
    1's delta dropped after its fold in round 0 (re-queued, re-run); a run
    with shard 1 killed before its probe in round 1, then a checkpoint of
    the runtime (5.64 GB, fsync'd), the shard removed, the checkpoint
    restored through the recovery scan into a fresh runtime that takes the
    killed round's minibatches and resumes; then a kill inside a second
    save (mid-flush), after which LATEST still names the first.  Every
    run's Σφ̂(k) must equal the minibatches' tokens and the clean run's
    within ELASTIC_MASS_RTOL, Σφ̂(k) the rows' float64 sum within
    PHI_K_ROWS_ATOL, nothing lost."""
    import numpy as np

    from repro_torch.checkpoint import (
        latest_step, restore_checkpoint, save_checkpoint, scan_checkpoints,
    )
    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.runtime import (
        MID_FLUSH, POST_FOLD, PRE_PROBE, FaultPlan, FaultSpec, InjectedFault,
    )
    from repro_torch.runtime.elastic import ElasticFOEMRuntime
    from repro_torch.sparse import MinibatchStream

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = lda_config(lda_shape("stream_1k"))
    mbs = list(MinibatchStream(report["training_corpus"], D_TRAIN,
                               bucket_len=L_TRAIN, seed=0))
    mbs = mbs[:ELASTIC_MINIBATCHES]
    check(len(mbs) == ELASTIC_MINIBATCHES, f"elastic: {len(mbs)} minibatches")
    tokens = sum(float(mb.counts.sum(dtype=np.float64)) for mb in mbs)
    phi_bytes = cfg.W * cfg.K * 4
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    free = shutil.disk_usage(ckpt).free
    need = 2 * phi_bytes + (2 << 30)      # a checkpoint and a torn second
    print(f"elastic disk: {free} bytes free, need {need}")
    check(free >= need, f"elastic: {free} bytes free on disk, {need} needed "
          "for two 5.64 GB checkpoints")
    gs_sweep.launches = 0                 # counts of this path only
    scheduled_sweep.launches = 0
    runs = {}

    def record(name, rt, reports, wall):
        torch.cuda.synchronize()
        mass = float(rt.phi_k.sum())
        rows = float(rt.phi_wk.sum(dtype=torch.float64))
        rec = {"rounds": [r.round_idx for r in reports],
               "round_s": [r.seconds for r in reports],
               "shards_run": [r.shards_run for r in reports],
               "requeued": [r.requeued for r in reports],
               "train_ppl": [r.train_ppl for r in reports],
               "lost": rt.lost, "cursor": rt.cursor, "wall_s": wall,
               "phi_k_mass": mass, "tokens": tokens,
               "mass_rel_err": mass / tokens - 1.0,
               "phi_k_minus_rows": mass - rows,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        check(abs(mass - tokens) <= ELASTIC_MASS_RTOL * tokens,
              f"elastic {name}: Σφ̂(k) {mass} against {tokens} tokens")
        check(abs(mass - rows) <= PHI_K_ROWS_ATOL,
              f"elastic {name}: Σφ̂(k) {mass} against the rows' {rows}")
        check(rt.lost == [], f"elastic {name}: lost {rt.lost}")
        if "clean" in runs:
            clean = runs["clean"]["phi_k_mass"]
            check(abs(mass - clean) <= ELASTIC_MASS_RTOL * clean,
                  f"elastic {name}: Σφ̂(k) {mass} against the clean {clean}")
        runs[name] = rec
        print(f"elastic ({name}) " + json.dumps(rec))

    def run(name, c=cfg, **kw):
        rt = ElasticFOEMRuntime(c, num_shards=2, device="cuda", **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reports = rt.run(iter(mbs))
        record(name, rt, reports, time.perf_counter() - t0)
        return rt, reports

    rt, reports = run("clean")
    check(len(reports) == 2, f"elastic clean: {len(reports)} rounds")
    del rt
    # the clean run with debug_checks=True: the sanitizer on every sweep
    # of both shards' minibatches before the runtime folds their deltas;
    # any raise fails the run
    rt, reports = run("checked", c=dataclasses.replace(cfg, debug_checks=True))
    check(len(reports) == 2, f"elastic checked: {len(reports)} rounds")
    del rt
    plan = FaultPlan([FaultSpec(point=POST_FOLD, kind="drop", step=0,
                                shard=1)])
    rt, reports = run("drop", faults=plan)
    check(reports[0].requeued == 1 and sum(r.requeued for r in reports) == 1,
          f"elastic drop: requeued {[r.requeued for r in reports]}")
    del rt

    try:
        plan = FaultPlan([FaultSpec(point=PRE_PROBE, kind="kill", step=1,
                                    shard=1)])
        rt = ElasticFOEMRuntime(cfg, num_shards=2, faults=plan,
                                device="cuda")
        t0 = time.perf_counter()
        try:
            rt.run(iter(mbs))
            check(False, "elastic kill: the seeded kill never fired")
        except InjectedFault as e:
            check((e.shard, e.step) == (1, 1),
                  f"elastic kill: fired at shard {e.shard}, round {e.step}")
        killed_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(str(ckpt), rt.round, rt.checkpoint_tree(), keep=2)
        save_s = time.perf_counter() - t0
        rt.remove_shard(1)
        # a fresh runtime resumes from the checkpoint alone, as after a
        # crash: it takes the killed round's minibatches back from the
        # stream replayed from its start
        fresh = ElasticFOEMRuntime(cfg, num_shards=rt.num_shards, seed=1,
                                   device="cuda")
        t0 = time.perf_counter()
        step, tree = restore_checkpoint(str(ckpt), fresh.checkpoint_tree())
        fresh.load_checkpoint_tree(tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        owed = tree["retry"].tolist()
        del tree
        check(owed == [[3, 1], [4, 1]],
              f"elastic kill: the checkpoint owes {owed}")
        check(step == 1 and fresh.round == 1 and fresh.cursor == 4,
              f"elastic kill: restored step {step}, round {fresh.round}, "
              f"cursor {fresh.cursor}")
        check(torch.equal(fresh.phi_wk, rt.phi_wk)
              and torch.equal(fresh.phi_k, rt.phi_k),
              "elastic kill: the restored φ̂ differs from the saved one")
        del rt
        t0 = time.perf_counter()
        reports = fresh.run(iter(mbs))
        record("kill, restore, resume", fresh, reports,
               killed_s + time.perf_counter() - t0)
        check(fresh.cursor == 4, f"elastic kill: cursor {fresh.cursor}")

        plan = FaultPlan([FaultSpec(point=MID_FLUSH, kind="kill")])
        t0 = time.perf_counter()
        try:
            save_checkpoint(str(ckpt), fresh.round, fresh.checkpoint_tree(),
                            keep=2, faults=plan)
            check(False, "elastic: the mid-flush kill never fired")
        except InjectedFault:
            pass
        torn_s = time.perf_counter() - t0
        check(latest_step(str(ckpt)) == 1,
              f"elastic: LATEST names {latest_step(str(ckpt))} after a "
              "mid-flush kill")
        check(scan_checkpoints(str(ckpt)) == [1]
              and not any(p.name.endswith(".tmp") for p in ckpt.iterdir()),
              "elastic: the recovery scan left a torn checkpoint")
        del fresh
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = {"gs_sweep": gs_sweep.launches,
                "scheduled_sweep": scheduled_sweep.launches}
    check(all(v > 0 for v in launches.values()),
          f"the elastic path did not launch both sweep kernels {launches}")
    out = {"minibatches": ELASTIC_MINIBATCHES, "shards": 2,
           "checkpoint_bytes": phi_bytes, "save_s": save_s,
           "save_gb_per_s": phi_bytes / save_s / 1e9,
           "restore_s": restore_s,
           "restore_gb_per_s": phi_bytes / restore_s / 1e9,
           "torn_save_s": torn_s, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    print("elastic " + json.dumps(out))
    report["elastic"] = dict(out, runs=runs)


def phi_slice(cap, lo, hi):
    """Columns [lo, hi) of the store phase's φ̂ (the same generator and
    seed), built block by block: the whole (cap, K) model never exists."""
    import numpy as np

    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.launch.serve import TrafficGenerator

    ranks = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN,
                             seed=7).word_ranks()
    return np.concatenate([b[:, lo:hi] for b in trained_like_phi_blocks(
        cap, K_FULL, ranks=ranks, seed=0)])


def phi_k_drift(torch, ptot_in, phi_in, ptot_out, phi_out) -> float:
    """How far a call's φ̂(k) growth strays from its rows' growth, in
    tokens (float64 sums): 0 in exact arithmetic, since every Δ goes into
    both."""
    def tot(t):
        return float(t.double().sum())

    return ((tot(ptot_out) - tot(ptot_in)) - (tot(phi_out) - tot(phi_in)))


def fold_drift_witness(torch, wid, cnt, folded, kw) -> dict:
    """Where φ̂(k) drifts in a two-phase sweep.  From the dense fold's
    output, phase D as four equal shards would run it (Σ_k μ = 1 over the
    shards), then one more fold — the kernel, its plain version in float32
    and in float64 — against its own probe's remainder.  Each call's
    φ̂(k) drift against its rows, and the rows' growth (the shift of the
    shard's mass that phase D takes back)."""
    from repro_torch.kernels.gs_sweep import segment_sum
    from repro_torch.kernels.sharded_sweep import (
        sharded_fold, sharded_fold_reference, sharded_probe,
    )

    mu_new, _, theta, phi, _, live, _ = folded
    mu1 = mu_new / (MP * live).clamp_min(1e-30)[..., None]
    delta = (mu1 - mu_new) * cnt[..., None]
    theta1 = theta + delta.sum(1)
    phi1 = phi + segment_sum(delta.reshape(-1, K_SHARD), wid, phi.shape[0])
    del delta
    state = (wid, cnt, mu1, theta1, phi1,
             phi1.sum(0, dtype=torch.float64).float())
    s1, _ = sharded_probe(*state, **kw)
    rem = s1 * (MP - 1)
    out = {"mean_phi_k": float(state[5].double().mean())}
    for name, fn, dtype in (("kernel_f32", sharded_fold, torch.float32),
                            ("plain_f32", sharded_fold_reference,
                             torch.float32),
                            ("plain_f64", sharded_fold_reference,
                             torch.float64)):
        args = [x.to(dtype) if x.is_floating_point() else x
                for x in state + (rem,)]
        got = fn(*args, **kw)
        out[f"drift_{name}"] = phi_k_drift(torch, args[5], args[4], got[4],
                                           got[3])
        out[f"rows_growth_{name}"] = float(got[3].double().sum()
                                           - args[4].double().sum())
        del got, args
        torch.cuda.empty_cache()
    check(abs(out["drift_plain_f64"]) <= DRIFT64_ATOL,
          f"the float64 fold's phi_k drifts from its rows by "
          f"{out['drift_plain_f64']} tokens")
    return out


def _check_close(name, key, a, b, tol) -> dict:
    import torch

    rtol, atol = tol
    err = errors(a, b)
    check(bool(torch.allclose(a, b, rtol=rtol, atol=atol)),
          f"{name}: {key} disagrees with the plain version {err} beyond "
          f"rtol {rtol} / atol {atol}")
    return err


def sharded_kernel_phase(torch, dev, cap, report):
    """Both sharded sweep kernels against their plain versions at one
    rank's share of the stream_1k width: the 1,024 × 128 minibatch over all
    ``cap`` rows of a K/mp = 2,500-lane φ̂ slice, dense from the minibatch
    start, scheduled (A/mp = 4) after one dense sweep; the cross-shard
    columns are the probe's own sums as three peers would send them."""
    import numpy as np

    from repro_torch.core import em, scheduling
    from repro_torch.core.types import uniform_responsibilities
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.kernels.sharded_sweep import (
        probe_path, sharded_fold, sharded_fold_reference, sharded_probe,
        sharded_probe_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    gen = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN, seed=3)
    mb = next(iter(MinibatchStream(gen.corpus(D_TRAIN), D_TRAIN,
                                   bucket_len=L_TRAIN, seed=0)))
    D, L, K = D_TRAIN, L_TRAIN, K_SHARD
    wid = torch.from_numpy(mb.word_ids).to(dev)
    cnt = torch.from_numpy(mb.counts).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    mu = uniform_responsibilities(g, (D, L, K)) / MP   # one rank's share
    theta = em.fold_theta(mu, cnt)
    phi = torch.from_numpy(phi_slice(cap, 0, K)).to(dev)
    phi += em.fold_phi(mu, cnt, wid, cap)[0]
    ptot = phi.sum(0)
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=W_FULL * 0.01)
    live = mb.counts > 0
    rows_used = len(np.unique(mb.word_ids[live]))
    live_tok = int(live.sum())
    print(f"sharded kernel shapes: D={D} L={L} K/mp={K} W={cap} "
          f"live tokens={live_tok} rows touched={rows_used} A/mp={A_SHARD}")
    print(f"sharded tolerance (rtol, atol): {json.dumps(SHARD_TOL)}: "
          f"{SHARD_TOL_REASON}")
    variants = []

    def measure(name, kernel, fn, ref, args, vkw, outs, bound, gather,
                path):
        got = fn(*args, **vkw)
        torch.cuda.synchronize()
        fold = kernel == "sharded_fold"
        plain64 = args[5].to(torch.float64)  # lint: host-f64
        want = ref(*args, **vkw, **({"phi_k64": plain64} if fold else {}))
        errs = {}
        for key, a, b in zip(outs, got, want):
            if a is not None:
                tol = SHARD_TOL.get(key) or SWEEP_TOL[key]
                errs[key] = _check_close(name, key, a, b, tol)
        del want
        total64 = (total64_check(
            torch, name, lambda t: fn(*args, **vkw, phi_k64=t), args[5], got,
            plain64, D, col_sum64(torch, got[1])) if fold else None)
        again = fn(*args, **vkw)
        check(all(torch.equal(x, y) for x, y in zip(got, again)
                  if x is not None),
              f"{name}: two launches on the same inputs differ")
        del again
        ms = cuda_time_ms(lambda: fn(*args, **vkw), 3)
        plain_ms = cuda_time_ms(lambda: ref(*args, **vkw), 1)
        if kernel == "sharded_probe":
            # one short launch: CUDA events around back-to-back calls time
            # the host's wrapper; a captured graph times the device
            graph = cuda_graph_time_ms(lambda: fn(*args, **vkw), 20)
            extra = {"graph_ms": graph, "share_of_bound_graph":
                     bound[0] / graph}
        else:
            extra = {}
        rec = {"variant": name, "kernel": kernel, "path": path, "ms": ms,
               **extra, "prior_ms": PRIOR_MS[name], "plain_ms": plain_ms,
               "bound_ms": bound[0], "bound_by": bound[1],
               "share_of_bound": bound[0] / ms,
               # the probe is one launch
               "launches_per_call": getattr(fn, "launches_per_call", 1),
               "gather_ms": gather, "total64": total64, "errors": errs}
        variants.append(rec)
        print("sharded kernel " + json.dumps(rec))
        return got

    def probe_bound(lanes_read, sched):
        # μ, θ̂ and the φ̂ row read at the computed (token, lane) entries
        # (dense: every token, all lanes; θ̂ and the touched rows once),
        # φ̂(k), ids and counts (+ the active sets and mask), s (+ p) out;
        # ≈ 12 float32 operations per computed entry
        nbytes = (lanes_read * 4 * (3 if sched else 1) + K * 4
                  + 2 * D * L * 4 + D * L * 4 * (2 if sched else 1))
        if sched:
            nbytes += rows_used * A_SHARD * 4 + D * L
        else:
            nbytes += D * K * 4 + rows_used * K * 4
        return _bound(nbytes, 12 * lanes_read)

    def fold_bound(sched, loglik):
        lanes = A_SHARD * live_tok if sched else D * L * K
        extra = D * L * 4 * (3 if sched else 2) + (D * L * 4 if loglik
                                                   else 0)
        return _sweep_bound_ms(D, L, K, rows_used, D * L, lanes,
                               A_SHARD if sched else 0, loglik, extra)

    outs_p = ("s", "prev_mass")
    outs_f = ("mu", "residual", "theta", "phi_wk", "phi_k", "live", "u")
    base = (wid, cnt, mu, theta, phi, ptot)
    s, _ = measure("probe dense", "sharded_probe", sharded_probe,
                   sharded_probe_reference, base, kw, outs_p,
                   probe_bound(D * L * K, False),
                   D * L * K * 4 / HBM_BYTES_PER_S * 1e3,
                   probe_path(K, 0, base[2:]).kind)
    rem = s * (MP - 1)
    fold_gather = live_tok * K * 4 / HBM_BYTES_PER_S * 1e3
    for loglik in (False, True):
        warm = measure("fold dense" + (" +loglik" if loglik else ""),
                       "sharded_fold", sharded_fold, sharded_fold_reference,
                       base + (rem,), dict(kw, emit_loglik=loglik), outs_f,
                       fold_bound(False, loglik), fold_gather,
                       "dense column loop")
    zero = torch.zeros_like(rem)
    got = sharded_fold(*base, zero, **kw)
    want = gs_sweep(*base, **kw)
    for key, a, b in zip(outs_f[:5], got, want):
        _check_close("fold dense, remainder 0 vs gs_sweep", key, a, b,
                     SWEEP_TOL[key])
    check(float(got[1][cnt == 0].abs().max()) == 0.0,
          "fold dense: a zero-count slot has a residual")
    del got, want
    drift = fold_drift_witness(torch, wid, cnt, warm, kw)
    print("sharded fold drift " + json.dumps(drift))

    # the scheduled state: one dense sweep's residuals ranked per rank
    sched = scheduling.residuals_from_sweep(warm[1], wid, cap)
    wt = scheduling.select_active_topics(sched.r_wk, A_SHARD)
    act = cnt > 0
    post = (wid, cnt, warm[0], warm[2], warm[3], warm[4])
    del warm, sched
    act_tok = int(act.sum())
    s, pm = measure("probe scheduled A/mp=4", "sharded_probe", sharded_probe,
                    sharded_probe_reference, post + (wt, act), kw, outs_p,
                    probe_bound(act_tok * A_SHARD, True),
                    act_tok * A_SHARD * 4 / HBM_BYTES_PER_S * 1e3,
                    f"{probe_path(K, A_SHARD, post[2:]).kind} "
                    f"({probe_path(K, A_SHARD, post[2:]).code} threads a "
                    "token)")
    fargs = post + (s * (MP - 1), pm * MP, wt, act)
    for loglik in (False, True):
        got = measure("fold scheduled A/mp=4" + (" +loglik" if loglik
                                                 else ""),
                      "sharded_fold", sharded_fold, sharded_fold_reference,
                      fargs, dict(kw, emit_loglik=loglik), outs_f,
                      fold_bound(True, loglik),
                      live_tok * A_SHARD * 4 / HBM_BYTES_PER_S * 1e3,
                      "active-set column loop")
        check(float(got[1][cnt == 0].abs().max()) == 0.0,
              "fold scheduled: a zero-count slot has a residual")
        del got
    got = sharded_fold(*post, zero, pm, wt, act, **kw)
    want = scheduled_sweep(*post, wt, act, **kw)
    for key, a, b in zip(outs_f[:5], got, want):
        _check_close("fold scheduled, remainder 0 vs scheduled_sweep", key,
                     a, b, SWEEP_TOL[key])
    print("sharded kernel: fold with remainder 0 equals gs_sweep and "
          "scheduled_sweep within SWEEP_TOL; zero-count slots carry no "
          "residual; two launches give the same bits")
    report["sharded_variants"] = variants
    report["sharded_fold_drift"] = drift
    del got, want, post, fargs, mu, theta, phi, ptot, base
    torch.cuda.empty_cache()


def _sharded_rank(mesh, cap, minibatches, heldout):
    """One rank of the sharded training phase: its φ̂ slice, two
    ``foem_step_sharded`` minibatches (the second under the profiler on
    rank 0), the held-out perplexity, one step with ``debug_checks=True``,
    one step of the per-column hooks mode (``sharded_impl="hooks"``) on the
    first minibatch from the first step's stats and μ0 draw, then the
    checks that need the mesh."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.analysis import SanitizerError
    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core import em
    from repro_torch.core.foem_sharded import (
        foem_step_sharded, heldout_perplexity_sharded,
    )
    from repro_torch.core.types import (
        GlobalStats, LocalState, MinibatchData, SweepPlan,
    )
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.kernels.sharded_sweep import sharded_fold, sharded_probe
    from repro_torch.launch.mesh import MeshAxis

    torch.backends.cuda.matmul.allow_tf32 = False
    m, dev = mesh.model.index, mesh.device
    t0 = time.perf_counter()
    phi = torch.from_numpy(phi_slice(cap, m * K_SHARD,
                                     (m + 1) * K_SHARD)).to(dev)
    slice_s = time.perf_counter() - t0
    cfg = dataclasses.replace(lda_config(lda_shape("stream_1k")),
                              topk_shards=MP)
    stats = GlobalStats(phi, phi.sum(0, dtype=torch.float64).float(),
                        torch.zeros((), dtype=torch.int32))
    del phi
    gen = torch.Generator().manual_seed(0)

    def mass(st):
        pk, rows = mesh.model.all_reduce(
            st.phi_k.double().sum().reshape(1),
            st.phi_wk.double().sum().reshape(1))
        return float(pk[0]), float(rows[0])

    # the hooks step starts from these stats too: kept on the host, where
    # they take none of the card's memory from the two-phase steps
    stats0 = GlobalStats(stats.phi_wk.cpu(), stats.phi_k.cpu(), stats.step)
    mass0 = mass(stats)
    steps = []
    sharded_probe.launches = 0            # counts of the main path only
    sharded_fold.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for i, (wid, cnt) in enumerate(minibatches):
        before = mass(stats)
        launched = (sharded_probe.launches, sharded_fold.launches)
        batch = MinibatchData(torch.from_numpy(wid), torch.from_numpy(cnt))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = lambda: foem_step_sharded(gen, batch, stats, cfg, mesh)  # noqa
        prof = None
        if i == len(minibatches) - 1 and m == 0:
            (stats, ppl, sweeps), wall_ms, by_op, busy_ms = device_profile(
                torch, step)
            prof = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                    "device_busy_share": busy_ms / wall_ms if by_op else None,
                    # the sharded_fold kernel's own launches: column loops
                    # and the streaming pass
                    "fold_device_ms": sum(
                        v for k, v in by_op.items()
                        if "loop_kernel" in k or "active::copy_kernel" in k
                        or "active::zero_kernel" in k),
                    # the sharded_probe kernel's launches
                    "probe_device_ms": sum(
                        v for k, v in by_op.items() if "probe_" in k),
                    "device_ms_by_op": top_ops(by_op, 10)}
        else:
            stats, ppl, sweeps = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = mass(stats)
        steps.append({
            "step": i + 1, "sweeps": sweeps, "train_ppl": ppl,
            "wall_s": wall, "tokens": float(cnt.sum()),
            "phi_k_mass_growth": after[0] - before[0],
            "phi_rows_mass_growth": after[1] - before[1],
            "probe_launches": sharded_probe.launches - launched[0],
            "fold_launches": sharded_fold.launches - launched[1],
            "profiled_rank0": prof})
    launches = {"sharded_probe": sharded_probe.launches,
                "sharded_fold": sharded_fold.launches}
    peak = torch.cuda.max_memory_allocated()

    w, est, ev = heldout
    t0 = time.perf_counter()
    held = heldout_perplexity_sharded(
        gen, MinibatchData(torch.from_numpy(w), torch.from_numpy(est)),
        MinibatchData(torch.from_numpy(w), torch.from_numpy(ev)), stats,
        cfg, mesh)
    held_s = time.perf_counter() - t0

    # one checked step (debug_checks=True) on the first minibatch, its
    # result dropped: every failed invariant, summed over the model axis so
    # that every rank raises alike, or none
    wid, cnt = minibatches[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gaps = PhiGaps(torch)                   # the sweep that raised, if any
    with gaps:
        try:
            foem_step_sharded(
                torch.Generator().manual_seed(1),
                MinibatchData(torch.from_numpy(wid), torch.from_numpy(cnt)),
                stats, dataclasses.replace(cfg, debug_checks=True), mesh)
            checked_failed = []
        except SanitizerError as e:
            checked_failed = e.failed
    torch.cuda.synchronize()
    checked = {"seconds": time.perf_counter() - t0, "failed": checked_failed,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    checked["phi_gap"] = gaps.take()        # this rank's K/mp lanes

    # one dense two-phase sweep from a fresh μ0: Σ_k μ over the ranks is 1
    wid = torch.from_numpy(minibatches[0][0]).to(dev)
    cnt = torch.from_numpy(minibatches[0][1]).to(dev)
    g = torch.empty((D_TRAIN, L_TRAIN, K_SHARD), device=dev).uniform_(
        0.5, 1.5, generator=torch.Generator(device=dev).manual_seed(m))
    (gs,) = mesh.model.all_reduce(g.sum(-1, keepdim=True))
    mu0 = g / gs
    del g, gs
    phi_w = stats.phi_wk + em.fold_phi(mu0, cnt, wid, cap)[0]
    r = em.gs_sweep_with_residuals(
        MinibatchData(wid, cnt), LocalState(mu0, em.fold_theta(mu0, cnt)),
        phi_w, phi_w.sum(0), cfg, plan=SweepPlan(axis_name=mesh.model))
    (mu_sum,) = mesh.model.all_reduce(r.mu.sum(-1))
    mu_err = float((mu_sum[cnt > 0] - 1.0).abs().max())
    del r, phi_w, mu0, mu_sum, stats       # room for the hooks step

    # one step of the per-column hooks mode on the first minibatch, from the
    # first two-phase step's stats and μ0 draw (a generator seeded alike),
    # last, on the memory the rank's other work has freed: the plain column
    # loops on the card, one model-axis all_reduce a column, no sweep kernel
    @dataclasses.dataclass(frozen=True)
    class CountingAxis(MeshAxis):
        calls: list = dataclasses.field(default_factory=list)

        def all_reduce(self, *tensors):
            self.calls.append(len(tensors))
            return super().all_reduce(*tensors)

    model = CountingAxis(mesh.model.name, mesh.model.size, mesh.model.index,
                         mesh.model.group)
    kernels = (sharded_probe, sharded_fold, gs_sweep, scheduled_sweep)
    launched = [k.launches for k in kernels]
    torch.cuda.empty_cache()              # four ranks share the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_h, ppl_h, sweeps_h = foem_step_sharded(
        torch.Generator().manual_seed(0),
        MinibatchData(*map(torch.from_numpy, minibatches[0])), stats0,
        dataclasses.replace(cfg, sharded_impl="hooks"),
        dataclasses.replace(mesh, model=model))
    torch.cuda.synchronize()
    hooks_s = time.perf_counter() - t0
    after = mass(st_h)
    hooks = {"sweeps": sweeps_h, "train_ppl": ppl_h, "seconds": hooks_s,
             "all_reduces": len(model.calls),
             "tokens": float(minibatches[0][1].sum()),
             "phi_k_mass_growth": after[0] - mass0[0],
             "phi_rows_mass_growth": after[1] - mass0[1],
             "kernel_launches": {k.__name__: k.launches - n
                                 for k, n in zip(kernels, launched)}}
    del st_h, stats0
    return {"rank": mesh.rank, "slice_s": slice_s, "steps": steps,
            "launches": launches, "peak_device_gb": peak / 1e9,
            "heldout_ppl": held, "heldout_s": held_s, "mu_sum_err": mu_err,
            "checked_step": checked, "hooks_step": hooks,
            "max_sweeps": cfg.max_sweeps,
            "warmup_sweeps": max(1, cfg.warmup_sweeps)}


def sharded_training_phase(torch, cap, report):
    """The topic-sharded main path: four ranks of a (1, 4) mesh share the
    card, each with its 2,500-lane slice of the stream_1k model over all
    rows, two 1,024 × 128 minibatches of foem_step_sharded, then
    heldout_perplexity_sharded on the serving phase's held-out batch and
    one checked step (its failed invariants, held to ``SANITIZER_OPEN`` by
    the analysis phase)."""
    import gc

    import numpy as np

    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    gen = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN, seed=17)
    mbs = [(mb.word_ids, mb.counts) for mb in MinibatchStream(
        gen.corpus(2 * D_TRAIN), D_TRAIN, bucket_len=L_TRAIN, seed=0)]
    gc.collect()
    torch.cuda.empty_cache()        # the ranks need the card's memory
    t0 = time.perf_counter()
    ranks = spawn_mesh(_sharded_rank, 1, MP, device="cuda",
                       args=(cap, mbs, report["heldout"]), timeout=900)
    wall = time.perf_counter() - t0
    for r in ranks:
        for st in r["steps"]:
            check(r["warmup_sweeps"] <= st["sweeps"] <= r["max_sweeps"],
                  f"rank {r['rank']} step {st['step']} ran {st['sweeps']} "
                  f"sweeps")
            check(np.isfinite(st["train_ppl"])
                  and 1.0 < st["train_ppl"] < W_FULL,
                  f"rank {r['rank']} train perplexity {st['train_ppl']}")
            check(st["probe_launches"] == st["fold_launches"] == st["sweeps"],
                  f"rank {r['rank']} step {st['step']}: {st['sweeps']} "
                  f"sweeps but {st['probe_launches']} probe and "
                  f"{st['fold_launches']} fold kernel calls (a plain "
                  "version ran)")
            for key, rtol in MASS_RTOL.items():
                rel = abs(st[key] - st["tokens"]) / st["tokens"]
                check(rel <= rtol,
                      f"step {st['step']}: {key} {st[key]} against "
                      f"{st['tokens']} tokens (relative {rel})")
        check(all(v > 0 for v in r["launches"].values()),
              f"rank {r['rank']} did not launch both sharded kernels "
              f"{r['launches']}")
        check(r["mu_sum_err"] <= MU_SUM_ATOL,
              f"rank {r['rank']}: sum_k mu over the ranks is off 1 by "
              f"{r['mu_sum_err']}")
        check(np.isfinite(r["heldout_ppl"]) and 1.0 < r["heldout_ppl"]
              < W_FULL, f"held-out perplexity {r['heldout_ppl']}")
    check(len({tuple(r["checked_step"]["failed"]) for r in ranks}) == 1,
          "the ranks disagree on the checked step's failed invariants")
    for r in ranks:
        h, first = r["hooks_step"], r["steps"][0]
        check(r["warmup_sweeps"] <= h["sweeps"] <= r["max_sweeps"]
              and np.isfinite(h["train_ppl"]),
              f"rank {r['rank']} hooks step: {h['sweeps']} sweeps, "
              f"perplexity {h['train_ppl']}")
        check(not any(h["kernel_launches"].values()),
              f"rank {r['rank']}: the hooks step launched a sweep kernel "
              f"{h['kernel_launches']}")
        # every column's normaliser (or eq. 38 mass and sum) is reduced
        check(h["all_reduces"] >= h["sweeps"] * L_TRAIN,
              f"rank {r['rank']}: {h['all_reduces']} model-axis all_reduces "
              f"for {h['sweeps']} sweeps of {L_TRAIN} columns")
        for key, rtol in MASS_RTOL.items():
            rel = abs(h[key] - h["tokens"]) / h["tokens"]
            check(rel <= rtol, f"hooks step: {key} {h[key]} against "
                               f"{h['tokens']} tokens (relative {rel})")
        rel = abs(h["train_ppl"] - first["train_ppl"]) / first["train_ppl"]
        check(rel < HOOKS_PPL_RTOL,
              f"hooks step perplexity {h['train_ppl']} against the two-phase "
              f"step's {first['train_ppl']} (relative {rel})")
    check(len({r["hooks_step"]["train_ppl"] for r in ranks}) == 1,
          "the ranks disagree on the hooks step's perplexity")
    check(len({r["heldout_ppl"] for r in ranks}) == 1
          and len({tuple(s["train_ppl"] for s in r["steps"])
                   for r in ranks}) == 1,
          "the ranks disagree on a perplexity")
    for i in range(len(mbs)):
        rec = {k: v for k, v in ranks[0]["steps"][i].items()}
        rec["wall_s_by_rank"] = [r["steps"][i]["wall_s"] for r in ranks]
        rec["peak_device_gb_by_rank"] = [r["peak_device_gb"] for r in ranks]
        print("sharded step " + json.dumps(rec))
    h = ranks[0]["hooks_step"]
    rec = {k: h[k] for k in ("sweeps", "all_reduces", "train_ppl", "tokens",
                             "phi_k_mass_growth", "phi_rows_mass_growth",
                             "kernel_launches")}
    rec["two_phase_train_ppl"] = ranks[0]["steps"][0]["train_ppl"]
    rec["seconds_by_rank"] = [r["hooks_step"]["seconds"] for r in ranks]
    rec["all_reduces_by_rank"] = [r["hooks_step"]["all_reduces"]
                                  for r in ranks]
    print("sharded hooks step " + json.dumps(rec))
    hooks_rec = rec
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    rec = {"ranks": MP, "mesh_s": wall,
           "slice_build_s_by_rank": [r["slice_s"] for r in ranks],
           "heldout_ppl": ranks[0]["heldout_ppl"],
           "heldout_s": ranks[0]["heldout_s"],
           "mu_sum_max_err": max(r["mu_sum_err"] for r in ranks),
           "checked_step": {
               "seconds_by_rank": [r["checked_step"]["seconds"]
                                   for r in ranks],
               "peak_gb_by_rank": [r["checked_step"]["peak_gb"]
                                   for r in ranks],
               "failed": ranks[0]["checked_step"]["failed"],
               "phi_gap_by_rank": [r["checked_step"]["phi_gap"]
                                   for r in ranks]},
           "launches_by_rank": [r["launches"] for r in ranks],
           "launches": launches, "hooks_step": hooks_rec}
    print("sharded training " + json.dumps(rec))
    report["sharded_training"] = rec


def dryrun_phase(torch, report):
    """The LDA cells' dry run (``launch.dryrun.run_lda_cell``) on the card, the
    dense cell of each ``DRYRUN_SHAPES`` regime: each sized from its
    stand-ins against the card's free memory, and run from seed 0 when it
    fits.  stream_1k must fit, run, launch both sweep kernels, peak below
    the card's memory and give a finite perplexity, its Σφ̂(k) grown by the
    minibatch's tokens (from zero statistics); the others print their
    records as they come."""
    import numpy as np

    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.launch import dryrun

    torch.cuda.empty_cache()
    gs_sweep.launches = 0                 # counts of this path only
    scheduled_sweep.launches = 0
    t0 = time.perf_counter()
    recs = [dryrun.run_lda_cell(name, impl="dense", seed=0,
                                out_dir=str(ROOT / "build" / "dryrun"))
            for name in DRYRUN_SHAPES]
    wall = time.perf_counter() - t0
    launched = {"gs_sweep": gs_sweep.launches,
                "scheduled_sweep": scheduled_sweep.launches}
    first = recs[0]
    check(first["fits"] and first["ran"],
          f"the {first['shape']} dry-run cell did not fit the card: "
          f"{first['predicted_bytes_on_card']} of {first['free_bytes']} "
          "bytes")
    check(all(first["launches"][k] > 0 for k in launched)
          and launched == {k: sum(r["launches"][k] for r in recs
                                  if r["ran"]) for k in launched},
          f"the dry-run cell's sweep kernels: record {first['launches']}, "
          f"counts {launched}")
    total = torch.cuda.get_device_properties(0).total_memory
    check(0 < first["peak_allocated_bytes"] < total,
          f"dry-run peak {first['peak_allocated_bytes']} of {total} bytes")
    check(np.isfinite(first["train_ppl"])
          and 1.0 < first["train_ppl"] < first["dims"]["W"],
          f"dry-run perplexity {first['train_ppl']}")
    rel = abs(first["phi_k_mass"] - first["tokens"]) / first["tokens"]
    check(rel <= STEP_MASS_RTOL,
          f"dry-run phi_k mass {first['phi_k_mass']} against "
          f"{first['tokens']} tokens (relative {rel})")
    report["dryrun"] = {"seconds": wall, "launches": launched,
                        "records": recs}
    print(f"dryrun phase {wall:.1f} s, launches {json.dumps(launched)}")


#: The LM dry run's cells that must fit one card and run at full width and
#: depth: (arch, shape) → the attention kernel's launches a step.
LM_DRYRUN_FIT = {("h2o-danube-3-4b", "decode_32k"): 24,
                 ("h2o-danube-3-4b", "long_500k"): 24,
                 ("mamba2-370m", "decode_32k"): 0,
                 ("mamba2-370m", "long_500k"): 0}
#: The named card shape of the LM train cell: musicgen-medium whole, two
#: microbatches of one 2,048-token sequence, at the end of the warm-up
#: (count 2000: lr 3e-4; at count 0 the warm-up's lr is 0 and nothing
#: would move).
LM_CARD_ARCH, LM_CARD_SEQ, LM_CARD_BATCH = "musicgen-medium", 2048, 2
LM_CARD_MICRO, LM_CARD_COUNT = 2, 2000
#: The accumulated gradient against two single-microbatch passes summed
#: in float32, over every leaf: ||acc - ref|| / ||ref||.  Both run the same
#: kernels on the same (1, 2,048) microbatches (the attention backward
#: writes each gradient tile once, without atomics), so their bf16
#: gradients agree and the float32 sums and the halving are the same
#: operations: a sound run reads ~0.  One microbatch taken twice reads
#: ||g0 - g1|| / ||g0 + g1||, orders of magnitude above this.
LM_CARD_GRAD_RTOL = 1e-5
PAR_RANKS = 4               # the parallel phase's mesh: (1, 4), gloo
PAR_ELEMENTS = 1 << 20      # the compressed gradient's elements a rank
PAR_ATOL = 1e-5             # collectives against the all-reduce
PAR_COMPRESS_RTOL = 0.02    # compressed_psum against the exact sum (norm)
PIPE_WIDTH = 3840           # h2o-danube-3-4b's d_model
PIPE_STAGES, PIPE_MICRO, PIPE_ROWS = 4, 8, 8   # S, M, rows a microbatch
PIPE_TOL = 1e-4             # the pipeline against the sequential product


def lm_dryrun_phase(torch, report):
    """The LM half of the dry run (``launch.dryrun.run_lm_cell``) over every
    (arch × shape) of the registry: each cell sized per device on the
    16 × 16 production mesh and whole against the card's free memory, and
    run from seed 0 when it fits (two steps, the second timed).  The four
    cells of ``LM_DRYRUN_FIT`` must fit and run at full width and depth:
    finite logits, the decode's ring-cache rows written at the position's
    slot alone (danube) or every block's SSM state (mamba2), 24 attention
    launches a danube step, a peak below the card's memory.  Then the
    musicgen-medium train cell at its card shape, two microbatches: a
    finite loss, both attention kernels launched, every weight matrix
    moved (the bf16 norm scales at 1.0 do not move at lr 3e-4: the update
    is below their half-ulp), and the accumulated gradient
    (``LMCell.grad_fn``) against two single-microbatch passes summed in
    float32, leaf by leaf: ||acc - ref|| / ||ref|| over every leaf."""
    import math

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward)
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_lm_cell
    from repro_torch.launch.mesh import make_production_mesh

    torch.cuda.empty_cache()
    flash_attention.launches = 0          # counts of this path only
    flash_attention_backward.launches = 0
    out_dir = str(ROOT / "build" / "dryrun")
    total = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    recs = [dryrun.run_lm_cell(arch, shape, seed=0, out_dir=out_dir)
            for arch, shape in dryrun.iter_all_cells()
            if arch != "foem-lda"]
    cells_s = time.perf_counter() - t0
    ran = {(r["arch"], r["shape"]): r for r in recs if r["ran"]}
    check(set(ran) == set(LM_DRYRUN_FIT),
          f"the LM dry-run cells that ran: {sorted(ran)}, expected "
          f"{sorted(LM_DRYRUN_FIT)}")
    for key, attn in LM_DRYRUN_FIT.items():
        r = ran[key]
        pos = r["dims"]["S"] - 1
        check(r["finite"], f"dry-run {key}: non-finite logits")
        check(r["launches"]["flash_attention"] == attn,
              f"dry-run {key}: {r['launches']} attention launches, "
              f"expected {attn}")
        check(0 < r["peak_allocated_bytes"] < total,
              f"dry-run {key}: peak {r['peak_allocated_bytes']} of {total}")
        if attn:
            ring = get_arch(key[0]).sliding_window   # the ring's slots
            check(r["written_slots"] == [pos % ring],
                  f"dry-run {key}: ring slots written {r['written_slots']},"
                  f" expected [{pos % ring}]")
        else:
            check(r["ssm_states_written"] == r["dims"]["layers"],
                  f"dry-run {key}: {r['ssm_states_written']} SSM states "
                  f"written of {r['dims']['layers']}")
    t1 = time.perf_counter()
    card = ShapeConfig("train_card", seq_len=LM_CARD_SEQ,
                       global_batch=LM_CARD_BATCH, kind="train")
    overrides = {"micro_batches": LM_CARD_MICRO}
    train = dryrun.run_lm_cell(LM_CARD_ARCH, card, overrides=overrides,
                               seed=0, opt_count=LM_CARD_COUNT,
                               out_dir=out_dir)
    train_s = time.perf_counter() - t1
    check(train["fits"] and train["ran"] and train["finite"],
          f"the {LM_CARD_ARCH} card train cell: fits {train['fits']}, ran "
          f"{train['ran']}, loss {train.get('loss')}")
    check(all(train["launches"][k] > 0 for k in dryrun.LM_KERNELS),
          f"the card train cell's attention launches {train['launches']}")
    check(train["matrices_changed"] == train["matrices"],
          f"the card train steps moved {train['matrices_changed']} of "
          f"{train['matrices']} weight matrices")
    launched = {"flash_attention": flash_attention.launches,
                "flash_attention_backward": flash_attention_backward.launches}
    check(launched == {k: sum(r["launches_all"][k] for r in [*recs, train]
                              if r["ran"]) for k in launched},
          f"the LM dry run's records against the counters {launched}")
    # the accumulated gradient against two single-microbatch passes
    t2 = time.perf_counter()
    cell = build_lm_cell(LM_CARD_ARCH, card, make_production_mesh(),
                         overrides=overrides)
    one = build_lm_cell(LM_CARD_ARCH, ShapeConfig(
        "train_card_micro", seq_len=LM_CARD_SEQ, global_batch=1,
        kind="train"), make_production_mesh())
    params, opt, batch = cell.materialize("cuda", seed=0)
    del opt
    _, acc = cell.grad_fn(params, batch)
    acc = dryrun._leaves(acc)
    ref = None
    for i in range(LM_CARD_MICRO):
        _, g = one.grad_fn(params, {k: v[i:i + 1] for k, v in batch.items()})
        if ref is None:
            ref = [t.float() for t in dryrun._leaves(g)]
        else:
            for a, t in zip(ref, dryrun._leaves(g)):
                a.add_(t.float())
        del g
    acc_sq = ref_sq = diff_sq = 0.0
    for a, r in zip(acc, ref):
        r.div_(LM_CARD_MICRO)
        acc_sq += float(a.double().square().sum())
        ref_sq += float(r.double().square().sum())
        diff_sq += float((a - r).double().square().sum())
    del acc, ref, params, batch
    torch.cuda.empty_cache()
    acc_norm, ref_norm = math.sqrt(acc_sq), math.sqrt(ref_sq)
    grad_rel = math.sqrt(diff_sq) / ref_norm
    check(math.isfinite(acc_norm) and grad_rel <= LM_CARD_GRAD_RTOL,
          f"the card train cell's accumulated gradient against the "
          f"microbatches' mean: ||acc - ref|| / ||ref|| = {grad_rel} "
          f"(norms {acc_norm}, {ref_norm})")
    grad_s = time.perf_counter() - t2
    rec = {"seconds": time.perf_counter() - t0, "cells_s": cells_s,
           "train_card_s": train_s, "grad_check_s": grad_s,
           "launches": launched,
           "cells": len(recs), "ran": [list(k) for k in ran],
           "train_card": train, "grad_norm": acc_norm,
           "grad_norm_microbatches": ref_norm, "grad_rel_err": grad_rel}
    for key, r in ran.items():
        print("lm dryrun cell " + json.dumps({
            "arch": key[0], "shape": key[1], "step_s": r["step_s"],
            "first_step_s": r["first_step_s"],
            "peak_gb": r["peak_allocated_bytes"] / 1e9,
            "predicted_gb": r["predicted_bytes_on_card"] / 1e9,
            "argument_gb": r["argument_bytes"] / 1e9,
            "per_device_gb_16x16":
                r["argument_bytes_per_device"]["16x16"] / 1e9,
            "launches": r["launches"],
            "roofline_bound_s": r["roofline"]["bound_s"],
            "roofline_dominant": r["roofline"]["dominant"],
            "bound_fraction": r["roofline"]["bound_fraction"]}))
    print("lm dryrun train card " + json.dumps({
        k: train[k] for k in ("step_s", "first_step_s", "losses",
                              "launches", "peak_allocated_bytes",
                              "predicted_bytes_on_card", "argument_bytes",
                              "working_set_bytes", "leaves_changed",
                              "leaves", "matrices_changed", "matrices",
                              "sample_elements_changed", "roofline")}))
    print("lm dryrun " + json.dumps({k: v for k, v in rec.items()
                                     if k != "train_card"}))
    report["lm_dryrun"] = rec


def _parallel_rank(mesh, seed):
    """One rank of the parallel phase (a (1, 4) mesh sharing the card over
    gloo): the collectives against the all-reduce, ``compressed_psum`` on a
    (PAR_ELEMENTS,) float32 gradient against the exact sum, and the GPipe
    forward against the sequential product."""
    import torch

    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import compression as Z
    from repro_torch.parallel import make_pipelined_apply

    torch.backends.cuda.matmul.allow_tf32 = False
    axis, r, dev = mesh.model, mesh.model.index, mesh.device
    out = {"rank": r}
    g = torch.Generator(device=dev).manual_seed(seed + r)
    t0 = time.perf_counter()
    x = torch.randn((4 * PAR_RANKS, 1024), generator=g, device=dev)
    (want,) = axis.all_reduce(x)
    errs = {
        "psum_scatter_then_gather": C.psum_scatter_then_gather(x, axis)
        - want,
        "chunked_psum": C.chunked_psum(x, axis, 4) - want,
        "reduce_scatter": C.reduce_scatter(x, axis)
        - want[4 * r:4 * r + 4]}
    out["collective_err"] = {k: float(v.abs().max()) for k, v in errs.items()}
    gathered = C.all_gather(x, axis)
    ring = C.ring_all_gather(x, axis, PAR_RANKS)
    out["ring_equal"] = bool(torch.equal(ring.reshape(gathered.shape),
                                         gathered))
    y = torch.randn((PAR_RANKS * 2, 64), generator=g, device=dev)
    moved = C.all_to_all_tokens(y, axis, PAR_RANKS)
    out["all_to_all_equal"] = bool(torch.equal(moved, axis.all_to_all(y)))
    torch.cuda.synchronize()
    out["collectives_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    grad = torch.randn((PAR_ELEMENTS,), generator=g, device=dev)
    approx, state = Z.compressed_psum(grad, axis, Z.ef_init(grad))
    (exact,) = axis.all_reduce(grad.double())
    out["compress_rel"] = float((approx.double() - exact).norm()
                                / exact.norm())
    out["compress_finite"] = bool(torch.isfinite(state.error).all())
    torch.cuda.synchronize()
    out["compress_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gw = torch.Generator(device=dev).manual_seed(seed)   # the same on all
    w = torch.randn((PIPE_STAGES, PIPE_WIDTH, PIPE_WIDTH), generator=gw,
                    device=dev) / PIPE_WIDTH ** 0.5
    xp = torch.randn((PIPE_MICRO * PIPE_ROWS, PIPE_WIDTH), generator=gw,
                     device=dev)
    run = make_pipelined_apply(lambda p, h: torch.tanh(h @ p), axis,
                               num_stages=PIPE_STAGES,
                               num_microbatches=PIPE_MICRO)
    with torch.no_grad():
        piped = run(w[r:r + 1], xp)
        h = xp
        for s in range(PIPE_STAGES):
            h = torch.tanh(h @ w[s])
    torch.cuda.synchronize()
    out["pipeline_s"] = time.perf_counter() - t0
    out["pipeline_err"] = float((piped - h).abs().max())
    out["pipeline_finite"] = bool(torch.isfinite(piped).all())
    return out


def parallel_phase(torch, report):
    """``parallel/`` on the card: ONE ``spawn_mesh`` of 4 ranks sharing it
    over gloo, each checking the collectives against the all-reduce, the
    int8 error-feedback all-reduce against the exact sum, and a GPipe
    forward of 4 stages × 8 microbatches of tanh(x @ w) at danube's width
    against the sequential product."""
    from repro_torch.launch.mesh import spawn_mesh

    t0 = time.perf_counter()
    ranks = spawn_mesh(_parallel_rank, 1, PAR_RANKS, device="cuda",
                       args=(11,), timeout=300)
    rec = {"seconds": time.perf_counter() - t0, "ranks": PAR_RANKS,
           "collective_err": max(max(r["collective_err"].values())
                                 for r in ranks),
           "compress_rel": max(r["compress_rel"] for r in ranks),
           "pipeline_err": max(r["pipeline_err"] for r in ranks),
           "collectives_s": max(r["collectives_s"] for r in ranks),
           "compress_s": max(r["compress_s"] for r in ranks),
           "pipeline_s": max(r["pipeline_s"] for r in ranks),
           "compress_elements_per_rank": PAR_ELEMENTS,
           "pipeline": {"stages": PIPE_STAGES, "micro": PIPE_MICRO,
                        "rows": PIPE_ROWS, "width": PIPE_WIDTH}}
    check(rec["collective_err"] <= PAR_ATOL,
          f"parallel: collectives differ from the all-reduce by "
          f"{rec['collective_err']}")
    check(all(r["ring_equal"] and r["all_to_all_equal"] for r in ranks),
          "parallel: the ring all-gather or the all-to-all moved the "
          "wrong blocks")
    check(rec["compress_rel"] <= PAR_COMPRESS_RTOL
          and all(r["compress_finite"] for r in ranks),
          f"parallel: compressed_psum {rec['compress_rel']} from the exact "
          "sum")
    check(rec["pipeline_err"] <= PIPE_TOL
          and all(r["pipeline_finite"] for r in ranks),
          f"parallel: the pipeline differs from the sequential product by "
          f"{rec['pipeline_err']}")
    print("parallel " + json.dumps(rec))
    report["parallel"] = rec


def quickstart_phase(report):
    """``examples/torch/quickstart.py --quick`` on the card, in a process of
    its own (the kernels this run built are loaded, not rebuilt): it must
    exit 0 and print its four minibatches."""
    import os

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / "quickstart.py"),
         "--quick"], cwd=str(ROOT), capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    wall = time.perf_counter() - t0
    lines = [x for x in proc.stdout.splitlines() if x.startswith("minibatch")]
    check(proc.returncode == 0 and len(lines) == 4,
          f"examples/torch/quickstart.py --quick exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    report["quickstart"] = {"seconds": wall, "minibatches": lines}
    print("quickstart " + json.dumps(report["quickstart"]))


def _estep_bound(T, K, D, exclude, residual) -> tuple:
    """Least time of one fused_estep call: φ̂ rows (and exclude, μ_old) in,
    μ (and the residual) out, θ̂ (D, K) once, φ̂(k) and counts; ≈ 12
    float32 operations per (token, topic)."""
    slabs = 2 + (1 if exclude else 0) + (2 if residual else 0)
    nbytes = slabs * T * K * 4 + D * K * 4 + K * 4 + T * 4
    return _bound(nbytes, 12 * T * K)


def estep_kernel_phase(torch, dev, store, report):
    """Both E-step kernels against their plain versions at the stream_1k
    width: one 1,024 × 128 minibatch from the store with a fresh μ folded
    in; a block of iem_blocks = 8 (16 columns, T = 16,384) with the
    exclusion and θ̂ one row per document, SEM's T = 131,072 without it, a
    ragged T; then the active-set E-step at A = 16 on both T, and the block
    loop that runs a blocked or scan scheduled sweep (topk_loop_check)."""
    import numpy as np

    from repro_torch.core import em, scheduling
    from repro_torch.core.types import uniform_responsibilities
    from repro_torch.kernels.foem_estep import (
        estep_path, fused_estep, fused_estep_reference,
    )
    from repro_torch.kernels.topk_estep import (
        topk_estep, topk_estep_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=23)
    mb = next(iter(MinibatchStream(gen.corpus(D_TRAIN), D_TRAIN,
                                   bucket_len=L_TRAIN, seed=0)))
    D, L, K = D_TRAIN, L_TRAIN, K_FULL
    Ws = len(mb.local_vocab)
    wid = torch.from_numpy(mb.local_word_ids).to(dev)
    cnt = torch.from_numpy(mb.counts).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    mu = uniform_responsibilities(g, (D, L, K))
    theta = em.fold_theta(mu, cnt)
    phi = torch.from_numpy(store.fetch_rows(mb.local_vocab)).to(dev)
    phi += em.fold_phi(mu, cnt, wid, Ws)[0]
    ptot = phi.sum(0)
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=W_FULL * 0.01)
    blk = L // IEM_BLOCKS
    print(f"estep kernel shapes: D={D} L={L} K={K} W_s={Ws} block "
          f"columns={blk} (iem_blocks={IEM_BLOCKS}) A={A_SCHED}")
    print(f"estep tolerance (rtol, atol): {json.dumps(ESTEP_TOL)}: "
          f"{ESTEP_TOL_REASON}")
    lines = []

    def compare(name, fn, ref, args, fkw, outs, bound, form=None):
        got = fn(*args, **fkw)
        torch.cuda.synchronize()
        want = ref(*args, **fkw)
        errs = {}
        for key, a, b in zip(outs, got, want):
            if a is not None:
                errs[key] = _check_close(name, key, a, b, ESTEP_TOL[key])
        del want
        before = fn.launches
        again = fn(*args, **fkw)
        per_call = fn.launches - before
        check(all(torch.equal(x, y) for x, y in zip(got, again)
                  if x is not None),
              f"{name}: two launches on the same inputs differ")
        del again
        ms = cuda_time_ms(lambda: fn(*args, **fkw), 5)
        plain_ms = cuda_time_ms(lambda: ref(*args, **fkw), 1)
        # ms above is the wrapper's rate, which the host sets when the
        # kernel is short; graph_ms is the kernel's own device time
        graph_ms = cuda_graph_time_ms(lambda: fn(*args, **fkw),
                                      2 if args[1].numel() > 1 << 28 else 5)
        rec = {"variant": name, "kernel": fn.__name__, "ms": ms,
               "graph_ms": graph_ms,
               "plain_ms": plain_ms, "bound_ms": bound[0],
               "bound_by": bound[1], "share_of_bound": bound[0] / graph_ms,
               "launches_per_call": per_call, "errors": errs,
               "bitwise_repeat": True}
        if fn is fused_estep:
            rec.update(form=form, prior_ms=PRIOR_MS_ESTEP[form],
                       path=estep_path(args[1].shape[1], args[:5]).kind)
        lines.append(rec)
        return got, rec

    # the first block of an iem_blocks = 8 sweep: T = D·blk tokens, the
    # exclusion x·μ_old, θ̂ one row per document (G = blk)
    T = D * blk
    mu_b = mu[:, :blk].reshape(T, K)
    cnt_b = cnt[:, :blk].reshape(T).contiguous()
    ex = cnt_b[:, None] * mu_b
    rows = phi[wid[:, :blk].reshape(T).long()]
    args = (theta, rows, ptot, ex, mu_b, cnt_b)
    full, rec = compare(f"T={T} exclude, G={blk}, with residual", fused_estep,
                        fused_estep_reference, args, kw,
                        ("mu", "residual"), _estep_bound(T, K, D, True, True),
                        "blocked, with residual")
    print("estep kernel " + json.dumps(rec))
    # the blocked sweep's own call: no μ_old, no residual
    main_args = (theta, rows, ptot, ex, None, None)
    got, rec = compare(f"T={T} exclude, G={blk} (blocked sweep's call)",
                       fused_estep, fused_estep_reference, main_args,
                       kw, ("mu", "residual"),
                       _estep_bound(T, K, D, True, False), "blocked")
    check(torch.equal(got[0], full[0]),
          "fused_estep: mu without the residual differs from mu with it")
    rec["mu_equals_residual_form"] = True
    print("estep kernel " + json.dumps(rec))
    report["estep_main"] = rec
    # a ragged T: 15,344 tokens (959 documents' blocks), a multiple of no
    # power of two above 16
    Tr = T - blk * (D // 16 + 1)
    rag_args = (theta[:Tr // blk].contiguous(), rows[:Tr], ptot, ex[:Tr],
                mu_b[:Tr], cnt_b[:Tr])
    rag, rec = compare(f"T={Tr} ragged, exclude, G={blk}", fused_estep,
                       fused_estep_reference, rag_args, kw,
                       ("mu", "residual"), _estep_bound(Tr, K, D, True, True),
                       "ragged, with residual")
    check(all(torch.equal(a, b[:Tr]) for a, b in zip(rag, full)),
          "fused_estep: a row's bits depend on T")
    rec["rows_equal_full_call"] = True
    print("estep kernel " + json.dumps(rec))
    del full, got, rag, args, main_args, rag_args, ex, rows, mu_b
    torch.cuda.empty_cache()

    # SEM's shape: all D·L tokens, no exclusion, θ̂ one row per document
    T = D * L
    rows = phi[wid.reshape(-1).long()]
    cnt_f = cnt.reshape(-1)
    args = (theta, rows, ptot, None, mu.reshape(T, K), cnt_f)
    got, rec = compare(f"T={T} no exclude, G={L}, with residual",
                       fused_estep, fused_estep_reference, args,
                       kw, ("mu", "residual"),
                       _estep_bound(T, K, D, False, True),
                       "SEM, with residual")
    print("estep kernel " + json.dumps(rec))
    full_mu = got[0]
    del got, args
    torch.cuda.empty_cache()
    # SEM's own call: no exclusion, no μ_old, no residual
    got, rec = compare(f"T={T} no exclude, G={L} (SEM's call)", fused_estep,
                       fused_estep_reference,
                       (theta, rows, ptot, None, None, None), kw,
                       ("mu", "residual"),
                       _estep_bound(T, K, D, False, False), "SEM")
    check(torch.equal(got[0], full_mu),
          "fused_estep: SEM's call (no residual) differs from the full form")
    rec["mu_equals_residual_form"] = True
    print("estep kernel " + json.dumps(rec))
    del got, full_mu, rows
    torch.cuda.empty_cache()

    # the active-set E-step on word-level top-16 sets, with pad lanes
    # (5% of lanes with no μ_prev and no θ̂ mass) and 20% inactive tokens
    r = torch.rand((Ws, K), device=dev, generator=g)
    wt = scheduling.select_active_topics(r, A_SCHED)
    del r
    for cols in (blk, L):
        T = D * cols
        top = wt[wid[:, :cols].long()].long()                  # (D, c, A)
        doc = torch.arange(D, device=dev)[:, None, None].expand_as(top)
        w3 = wid[:, :cols].long()[..., None].expand_as(top)
        mu_a = mu[:, :cols].gather(-1, top).reshape(T, A_SCHED)
        th_a = theta[doc, top].reshape(T, A_SCHED)
        pad = torch.rand(mu_a.shape, device=dev, generator=g) < 0.05
        mu_a = mu_a.masked_fill(pad, 0.0)
        th_a = th_a.masked_fill(pad, 0.0)
        c = cnt[:, :cols].reshape(T).contiguous()
        act = (c > 0) & (torch.rand(T, device=dev, generator=g) > 0.2)
        targs = (th_a, phi[w3, top].reshape(T, A_SCHED),
                 ptot[top].reshape(T, A_SCHED), mu_a, c, act)
        nbytes = 6 * T * A_SCHED * 4 + T * 4 + T
        got, rec = compare(f"T={T} A={A_SCHED}", topk_estep,
                           topk_estep_reference, targs, kw,
                           ("mu", "delta"),
                           _bound(nbytes, 15 * T * A_SCHED))
        part = topk_estep(*[x[:T // 3].contiguous() for x in targs], **kw)
        check(all(torch.equal(a, b[:T // 3]) for a, b in zip(part, got)),
              "topk_estep: a token's bits depend on T")
        check(torch.equal(got[0][~act], mu_a[~act]),
              "topk_estep: an inactive token's mu moved")
        rec.update(rows_equal_full_call=True, pad_lanes=int(pad.sum()),
                   inactive_tokens=int((~act).sum()))
        print("topk kernel " + json.dumps(rec))
        del got, part, targs, top, doc, w3, mu_a, th_a
    torch.cuda.empty_cache()
    report["estep_lines"] = lines
    report["topk_loop_lines"] = topk_loop_check(torch, wid, cnt, wt, mu,
                                                theta, phi, ptot, kw)
    del mu, theta, phi, ptot, wt
    torch.cuda.empty_cache()


def device_ops(torch, fn) -> tuple:
    """The device operations (kernels, copies, memsets) one call of ``fn``
    runs, counted from a ``torch.profiler`` trace (which may drop events:
    a lower bound), and their device ms by name (``top_ops``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    by_op = {}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        by_op[e.name] = by_op.get(e.name, 0.0) + ms
    return len(events), top_ops(by_op, 6)


def _loop_bytes(D, L, K, Ws, A, nb, blocks, lanes) -> dict:
    """The block loop's bytes (csrc/topk_estep.cu): ``bound`` — each input
    read once and each output written once: μ (D·L·K) in and out, φ̂, θ̂ and
    φ̂(k) in and out (the contract's new tensors), the token ids, counts,
    mask and active sets in, |Δ| and the topic ids (D, L, A) out; and
    ``design`` — what the design moves: the μ copy pass, the three clones
    read and written, a 32-byte sector for each of the active lanes' four
    gathers (μ, θ̂, φ̂_w, φ̂(k)) and three writes (μ, θ̂, Δ), the visiting
    orders read once."""
    f = 4
    bound = (2 * D * L * K * f + 2 * (Ws * K + D * K + K) * f
             + D * L * (f + f + 1) + Ws * A * f + 2 * D * L * A * f)
    design = (2 * D * L * K * f + 2 * (Ws * K + D * K + K) * f
              + 7 * 32 * lanes + 2 * f * blocks * D * nb * (1 + A))
    return {"bound": bound, "design": design}


def topk_loop_check(torch, wid, cnt, wt, mu, theta, phi, ptot, kw):
    """The block loop (``blocked_sweep``) against its plain version at the
    stream_1k width, B = 8 and B = L: every output within the sweep
    tolerance, two launches bitwise equal, no input modified; its time
    beside the sweep the parent tree ran (the blocked scan over the slab
    kernel, ``blocked_sweep_reference(estep=ops.topk_estep)`` on the card),
    the plain version's, the bound and the design's bytes, and the device
    operations a sweep of each."""
    from repro_torch.kernels import ops, topk_estep
    from repro_torch.kernels.topk_estep import (
        block_width, blocked_sweep, blocked_sweep_reference,
    )

    D, L = wid.shape
    K = mu.shape[-1]
    Ws, A = wt.shape
    act = cnt > 0                       # stream_1k: λ_w = 1
    args = (wid, cnt, wt, act, mu, theta, phi, ptot)
    sums = [float(x.double().sum()) for x in (mu, theta, phi, ptot)]
    lanes = A * int(act.sum())
    names = ("theta", "phi_wk", "phi_k", "mu", "residual")
    out = []
    for B in (IEM_BLOCKS, L):
        bkw = dict(kw, num_blocks=B)
        nb, blocks = block_width(L, B)
        before = blocked_sweep.launches
        got = blocked_sweep(*args, **bkw)
        torch.cuda.synchronize()
        launches = blocked_sweep.launches - before
        want = blocked_sweep_reference(*args, **bkw)
        name = f"B={B} (nb={nb})"
        errs = {key: _check_close(f"topk loop {name}", key, a, b,
                                  SWEEP_TOL[key])
                for key, a, b in zip(names, got[:5], want[:5])}
        check(torch.equal(got[5], want[5]),
              f"topk loop {name}: token topics differ")
        drift = phi_k_drift(torch, ptot, phi, got[2], got[1])
        del want
        again = blocked_sweep(*args, **bkw)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"topk loop {name}: two launches on the same inputs differ")
        del got, again
        torch.cuda.empty_cache()
        ms = cuda_time_ms(lambda: blocked_sweep(*args, **bkw), 3)

        def parent():
            return blocked_sweep_reference(*args, **bkw,
                                           estep=ops.topk_estep)

        parent_ms = cuda_time_ms(parent, 2)
        plain_ms = cuda_time_ms(lambda: blocked_sweep_reference(*args, **bkw),
                                1)
        n_ops, by_op = device_ops(torch, lambda: blocked_sweep(*args, **bkw))
        parent_ops, _ = device_ops(torch, parent)
        # the call's parts alone: the μ copy pass, the clone of φ̂ (θ̂'s
        # and φ̂(k)'s are small) and the plan (block_orders)
        out_mu = torch.empty_like(mu)
        lib = topk_estep._launcher()
        stream = torch.cuda.current_stream().cuda_stream

        def copy_pass():
            check(lib.topk_loop_pass_launch(mu.data_ptr(), out_mu.data_ptr(),
                                            mu.numel(), stream) == 0,
                  "topk loop: the copy pass was refused")

        parts = {
            "mu_copy_ms": cuda_time_ms(copy_pass, 3),
            "phi_clone_ms": cuda_time_ms(lambda: phi.clone(), 3),
            "plan_ms": cuda_time_ms(lambda: topk_estep.block_orders(
                wid, act, Ws, wt, K, B), 3)}
        del out_mu
        nbytes = _loop_bytes(D, L, K, Ws, A, nb, blocks, lanes)
        bound, by = _bound(nbytes["bound"], 21 * lanes)
        rec = {"variant": name, "kernel": "blocked_sweep", "blocks": blocks,
               "ms": ms, "parent_design_ms": parent_ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": by,
               "share_of_bound": bound / ms,
               "bound_bytes": nbytes["bound"],
               "design_bytes": nbytes["design"],
               "design_ms_at_hbm_rate":
                   nbytes["design"] / HBM_BYTES_PER_S * 1e3,
               "loop_launches_per_sweep": launches,
               "library_ops_per_sweep": blocked_sweep.launches_per_call,
               "device_ops_per_sweep": n_ops,
               "parent_design_device_ops_per_sweep": parent_ops,
               "device_ms_by_op": by_op, **parts,
               "active_lanes": lanes, "phi_k_drift_tokens": drift,
               "errors": errs, "bitwise_repeat": True}
        check(launches == 1, f"topk loop {name}: {launches} loop launches")
        print("topk loop kernel " + json.dumps(rec))
        out.append(rec)
        torch.cuda.empty_cache()
    check([float(x.double().sum()) for x in (mu, theta, phi, ptot)] == sums,
          "topk loop: an input was modified")
    return out


def blocked_training_phase(torch, store, report):
    """The coarse-block and SEM paths at the stream_1k width on the store:
    FOEMTrainer with iem_blocks = 8 for two minibatches, one minibatch with
    sweep_impl = "scan", one blocked and one scan step under the profiler,
    then algorithm = "sem" for two minibatches; the held-out batch served
    from the trained store.  Every step checks the mass its rows and the
    store's φ̂(k) gained, and a blocked or scan step one block-loop launch
    a scheduled sweep."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core import foem
    from repro_torch.core.trainer import FOEMTrainer
    from repro_torch.core.types import MinibatchData
    from repro_torch.kernels.foem_estep import fused_estep
    from repro_torch.kernels.topk_estep import blocked_sweep, topk_estep
    from repro_torch.launch.serve import TopicServer, TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    base = lda_config(lda_shape("stream_1k"))
    cfgs = {"blocked": dataclasses.replace(base, iem_blocks=IEM_BLOCKS),
            "scan": dataclasses.replace(base, sweep_impl="scan"),
            "sem": base}
    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=29)
    mbs = list(MinibatchStream(gen.corpus(6 * D_TRAIN), D_TRAIN,
                               bucket_len=L_TRAIN, seed=0))
    check(len(mbs) == 6, f"{len(mbs)} minibatches, not 6")
    # one more for the profiled scan step, so the first six are the ones
    # earlier versions of this script ran
    extra = next(iter(MinibatchStream(gen.corpus(D_TRAIN), D_TRAIN,
                                      bucket_len=L_TRAIN, seed=1)))
    warm = max(1, base.warmup_sweeps)
    trainers = {}

    def trainer(kind):
        if kind not in trainers:
            trainers[kind] = FOEMTrainer(
                cfgs[kind], store, seed=0, prefetch_depth=0,
                algorithm="sem" if kind == "sem" else "foem", device="cuda")
        return trainers[kind]

    def rows_mass(mb):
        return float(store.fetch_rows(mb.local_vocab).sum(dtype=np.float64))

    lines = []

    def run(kind, mb, profiled=False):
        before = (rows_mass(mb), float(store.phi_k.sum()),
                  fused_estep.launches, topk_estep.launches,
                  blocked_sweep.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = trainer(kind)
        prof = None
        if profiled:
            m, wall_ms, by_op, busy_ms = device_profile(
                torch, lambda: tr.step(mb))
            groups = {}
            for name, v in by_op.items():
                key = ("fused_estep" if "fused_estep_" in name else
                       "topk_estep" if "topk_estep_kernel" in name else
                       "topk_estep block loop" if "topk_loop_kernel" in name
                       else "block loop's mu copy" if "copy_kernel" in name
                       else
                       "sorted folds (index_put_)"
                       if "indexing_backward" in name or "RadixSort" in name
                       else "memcpy HtoD" if "HtoD" in name else
                       "memcpy DtoH" if "DtoH" in name else
                       "memcpy DtoD" if "DtoD" in name else "other")
                groups[key] = groups.get(key, 0.0) + v
            prof = {"wall_ms": wall_ms,
                    "device_busy_ms": busy_ms if by_op else None,
                    "device_busy_share": busy_ms / wall_ms if by_op
                    else None,
                    "device_ms_by_group": groups,
                    "device_ms_by_op": top_ops(by_op, 12)}
        else:
            m = tr.step(mb)
        peak = torch.cuda.max_memory_allocated() / 1e9
        tokens = float(mb.counts.sum())
        rows_growth = rows_mass(mb) - before[0]
        phi_k_growth = float(store.phi_k.sum()) - before[1]
        rec = {"path": kind, "step": m.step, "sweeps": m.sweeps,
               "train_ppl": m.train_ppl, "seconds": m.seconds,
               "fetch_s": m.fetch_seconds, "compute_s": m.compute_seconds,
               "writeback_s": m.writeback_seconds,
               "fused_estep_launches": fused_estep.launches - before[2],
               "topk_estep_launches": topk_estep.launches - before[3],
               "topk_loop_launches": blocked_sweep.launches - before[4],
               "peak_device_gb": peak, "tokens": tokens,
               "rows_mass_growth": rows_growth,
               "phi_k_mass_growth": phi_k_growth,
               "phi_k_minus_rows_growth": phi_k_growth - rows_growth}
        if prof is not None:
            rec["profiled"] = prof
        label = "sem step " if kind == "sem" else "blocked train step "
        print(label + json.dumps(rec))
        lines.append(rec)
        check(warm <= m.sweeps <= base.max_sweeps if kind != "sem"
              else 1 <= m.sweeps <= base.max_sweeps,
              f"{kind} step {m.step} ran {m.sweeps} sweeps")
        check(np.isfinite(m.train_ppl) and 1.0 < m.train_ppl < base.W,
              f"{kind} step {m.step} train perplexity {m.train_ppl}")
        check(rec["fused_estep_launches"] > 0,
              f"{kind} step {m.step} launched no fused_estep kernel")
        if kind != "sem":   # one block-loop launch a scheduled sweep
            check(rec["topk_loop_launches"] == m.sweeps - warm,
                  f"{kind} step {m.step}: {rec['topk_loop_launches']} "
                  f"block-loop launches for {m.sweeps - warm} scheduled "
                  f"sweeps")
        rel = abs(rows_growth - tokens) / tokens
        check(rel <= STEP_MASS_RTOL,
              f"{kind} step {m.step}: rows grew {rows_growth} for {tokens} "
              f"tokens (relative {rel})")
        if kind == "sem":
            rel = abs(phi_k_growth - rows_growth) / tokens
            check(rel <= SEM_PHI_K_RTOL,
                  f"sem step {m.step}: phi_k grew {phi_k_growth}, the rows "
                  f"{rows_growth} (relative {rel})")
        else:
            check(abs(phi_k_growth - rows_growth) <= PHI_K_ROWS_ATOL,
                  f"{kind} step {m.step}: phi_k grew {phi_k_growth}, the "
                  f"rows {rows_growth}")

    # where the coarse blocks start: the first minibatch's perplexity
    # after the warm-up sweeps alone, blocked and column-serial, from the
    # μ₀ a fresh trainer draws (these calls are not the path's run)
    mb = mbs[0]
    rows = store.fetch_rows(mb.local_vocab)
    warm_ppl = {}
    for name, cfg in (("iem_blocks=8", cfgs["blocked"]),
                      ("column-serial", base)):
        gen0 = torch.Generator(device="cuda").manual_seed(0)
        r = foem.foem_minibatch(
            gen0, MinibatchData(mb.local_word_ids, mb.counts), rows,
            store.phi_k.astype(np.float32),
            dataclasses.replace(cfg, max_sweeps=warm),
            vocab_size=base.W, device="cuda")
        warm_ppl[name] = float(r.diag.final_train_ppl)
        del r
    del rows
    print("blocked warm-up " + json.dumps(
        {"warmup_sweeps": warm, "train_ppl_after_warmup": warm_ppl}))

    fused_estep.launches = 0              # counts of the main path only
    topk_estep.launches = 0
    blocked_sweep.launches = 0
    t0 = time.perf_counter()
    for kind, mb, profiled in (("blocked", mbs[0], False),
                               ("blocked", mbs[1], False),
                               ("scan", mbs[2], False),
                               ("blocked", mbs[3], True),
                               ("scan", extra, True),
                               ("sem", mbs[4], False),
                               ("sem", mbs[5], False)):
        run(kind, mb, profiled)
    wall = time.perf_counter() - t0
    launches = {"fused_estep": fused_estep.launches,
                "topk_loop": blocked_sweep.launches,
                "topk_estep": topk_estep.launches}
    check(launches["fused_estep"] > 0 and launches["topk_loop"] > 0,
          f"the blocked/SEM paths did not launch the fused E-step and the "
          f"block loop {launches}")
    w, est, ev = report["heldout"]
    _, ppl = TopicServer(store, base, device="cuda").evaluate(w, est, ev)
    check(np.isfinite(ppl) and 1.0 < ppl < base.W,
          f"eq. 21 perplexity {ppl} of the trained store")
    rec = {"steps": len(lines), "wall_s": wall, "launches": launches,
           "served_eq21_ppl": ppl}
    print("blocked/sem training " + json.dumps(rec))
    report["blocked_training"] = dict(rec, lines=lines)


def write_docword(path, corpus) -> None:
    """``corpus`` as a gzipped UCI docword file (1-based ids, integer
    counts), the format ``repro_torch.data.load_docword`` reads."""
    import gzip

    import numpy as np

    counts = corpus.counts.astype(np.int64)
    check(np.array_equal(counts, corpus.counts),
          "the corpus counts are not integers")
    docs = np.repeat(np.arange(1, corpus.num_docs + 1),
                     np.diff(corpus.indptr))
    body = "\n".join(f"{d} {w} {c}" for d, w, c in zip(
        docs.tolist(), (corpus.word_ids.astype(np.int64) + 1).tolist(),
        counts.tolist()))
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        f.write(f"{corpus.num_docs}\n{corpus.vocab_size}\n{corpus.nnz}\n")
        f.write(body + "\n")


def baselines_kernel_phase(torch, dev, store, report):
    """fused_estep in the two input forms of the OVB and SCVB E-steps at
    SEM's shape (D = 1,024, L = 128, T = 131,072, K = 10⁴, θ̂ one row per
    document), its inputs from the trained store's rows, against its plain
    version."""
    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.perplexity import init_theta
    from repro_torch.core.types import MinibatchData
    from repro_torch.kernels.foem_estep import (
        estep_path, fused_estep, fused_estep_reference,
    )
    from repro_torch.launch.serve import TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    torch.cuda.empty_cache()
    cfg = lda_config(lda_shape("stream_1k"))
    gen = TrafficGenerator(vocab_size=store.capacity, doc_len=DOC_LEN,
                           seed=43)
    mb = next(iter(MinibatchStream(gen.corpus(D_TRAIN), D_TRAIN,
                                   bucket_len=L_TRAIN, seed=0)))
    D, L, K = D_TRAIN, L_TRAIN, K_FULL
    T = D * L
    wid = torch.from_numpy(mb.local_word_ids).to(dev).reshape(-1).long()
    cnt = torch.from_numpy(mb.counts).to(dev)
    phi = torch.from_numpy(store.fetch_rows(mb.local_vocab)).to(dev)
    ptot = torch.from_numpy(store.phi_k.astype(np.float32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    theta = init_theta(g, MinibatchData(wid.reshape(D, L), cnt), cfg)
    alpha, beta = cfg.alpha_m1 + 1.0, cfg.beta_m1 + 1.0
    dg = torch.special.digamma
    lines = []
    for form in ("OVB", "SCVB"):
        if form == "OVB":
            args = (dg(theta + alpha).exp_(),
                    phi[wid].add_(beta).digamma_().exp_(),
                    dg(ptot + cfg.W * beta).exp_(), None, None, None)
            kw = dict(alpha_m1=0.0, beta_m1=0.0, wb=0.0)
        else:
            args = (theta, phi[wid], ptot, None, None, None)
            kw = dict(alpha_m1=alpha, beta_m1=beta, wb=cfg.W * beta)
        before = fused_estep.launches
        got = fused_estep(*args, **kw)
        torch.cuda.synchronize()
        per_call = fused_estep.launches - before
        want = fused_estep_reference(*args, **kw)
        err = _check_close(f"fused_estep {form} form", "mu", got[0],
                           want[0], ESTEP_TOL["mu"])
        del want
        check(torch.equal(got[0], fused_estep(*args, **kw)[0]),
              f"fused_estep {form} form: two launches differ")
        del got
        ms = cuda_time_ms(lambda: fused_estep(*args, **kw), 5)
        plain_ms = cuda_time_ms(lambda: fused_estep_reference(*args, **kw),
                                1)
        bound = _estep_bound(T, K, D, False, False)
        rec = {"form": form, "kernel": "fused_estep",
               "shape": {"D": D, "L": L, "T": T, "K": K, "G": L},
               "alpha_m1": kw["alpha_m1"], "beta_m1": kw["beta_m1"],
               "wb": kw["wb"], "path": estep_path(K, args[:5]).kind,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
               "bound_by": bound[1], "share_of_bound": bound[0] / ms,
               "launches_per_call": per_call, "errors": {"mu": err},
               "bitwise_repeat": True}
        print("baselines kernel " + json.dumps(rec))
        lines.append(rec)
        del args
        torch.cuda.empty_cache()
    report["baselines_kernel"] = lines
    del phi, ptot, theta
    torch.cuda.empty_cache()


def baselines_step_phase(torch, report):
    """OVB, SCVB and OGS at the stream_1k width (rho_mode = "stepwise",
    zero statistics on the card), two minibatches each, read from the
    training phase's corpus written as a gzipped UCI docword file and
    loaded back with load_docword."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core.baselines import ALGORITHMS
    from repro_torch.core.types import GlobalStats, MinibatchData
    from repro_torch.data import load_docword
    from repro_torch.kernels.foem_estep import fused_estep
    from repro_torch.sparse import MinibatchStream

    torch.cuda.empty_cache()
    corpus = report["training_corpus"]
    path = ROOT / "build" / "chip_smoke_uci" / "docword.stream_1k.txt.gz"
    t0 = time.perf_counter()
    write_docword(path, corpus)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mat = load_docword(str(path))
    load_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in (
        (mat.indptr, corpus.indptr), (mat.word_ids, corpus.word_ids),
        (mat.counts, corpus.counts))) and mat.vocab_size == corpus.vocab_size
    check(same, "load_docword did not read back the corpus it was written "
                "from")
    print("uci corpus " + json.dumps({
        "documents": mat.num_docs, "nnz": mat.nnz, "tokens": mat.ntokens(),
        "gz_bytes": path.stat().st_size, "write_s": write_s,
        "load_s": load_s, "bitwise_equal": True}))
    shutil.rmtree(path.parent, ignore_errors=True)

    cfg = dataclasses.replace(lda_config(lda_shape("stream_1k")),
                              rho_mode="stepwise")
    mbs = list(MinibatchStream(mat, D_TRAIN, bucket_len=L_TRAIN, seed=0))[:2]
    dev = torch.device("cuda")
    lines = []
    for algo, step in ALGORITHMS.items():
        stats = GlobalStats(torch.zeros((cfg.W, cfg.K), device=dev),
                            torch.zeros(cfg.K, device=dev),
                            torch.zeros((), dtype=torch.int32, device=dev))
        gen = torch.Generator(device=dev).manual_seed(0)
        for mb in mbs:
            before_k = float(stats.phi_k.double().sum())
            s = int(stats.step) + 1
            rho = (cfg.tau0 + s) ** (-cfg.kappa)
            tokens = float(mb.counts.sum(dtype=np.float64))
            launched = fused_estep.launches
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            new, local, diag = step(
                gen, MinibatchData(mb.word_ids, mb.counts), stats, cfg,
                device="cuda")
            ppl = float(diag.final_train_ppl)           # waits for the card
            wall_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            launched = fused_estep.launches - launched
            del local
            after_k = float(new.phi_k.double().sum())
            want_k = (1.0 - rho) * before_k + rho * tokens
            rel = abs(after_k - want_k) / want_k
            rec = {"algorithm": algo, "step": int(new.step),
                   "sweeps": diag.sweeps_run, "wall_ms": wall_ms,
                   "fused_estep_launches": launched, "train_ppl": ppl,
                   "peak_device_gb": peak, "tokens": tokens, "rho": rho,
                   "phi_k_mass": after_k, "phi_k_mass_expected": want_k,
                   "phi_k_mass_rel_err": rel}
            print("baselines step " + json.dumps(rec))
            lines.append(rec)
            want_launches = 0 if algo == "ogs" else cfg.max_sweeps
            check(launched == want_launches,
                  f"{algo} step {s}: {launched} fused_estep launches, not "
                  f"{want_launches}")
            check(np.isfinite(ppl) and 1.0 < ppl < cfg.W,
                  f"{algo} step {s}: train perplexity {ppl} is not finite "
                  "and in (1, W)")
            check(float(new.phi_wk.min()) >= 0.0,
                  f"{algo} step {s}: a φ̂ entry is negative")
            check(rel <= BASELINE_MASS_RTOL,
                  f"{algo} step {s}: Σφ̂(k) = {after_k}, expected {want_k} "
                  f"(relative {rel})")
            stats = new
            del new
        del stats
        torch.cuda.empty_cache()
    report["baselines_step"] = lines


def host_mem_available() -> int:
    """Bytes the host can still give (``MemAvailable`` of /proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("no MemAvailable line in /proc/meminfo")


class RssSampler:
    """This process's resident set — with ``tree=True`` the sum over it and
    every process it started (a page shared by several counts in each) —
    sampled every ``period`` s in a thread while the ``with`` block runs;
    ``peak`` is the largest sample and ``min_available`` the least
    ``MemAvailable`` of the host seen at the same samples (bytes)."""

    def __init__(self, period: float = 0.1, tree: bool = False):
        import os
        import threading

        self.period = period
        self.tree = tree
        self.peak = 0
        self.min_available = host_mem_available()
        self._pid = os.getpid()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _statm(self, pid) -> int:
        try:
            with open(f"/proc/{pid}/statm") as f:
                return int(f.read().split()[1]) * self._page
        except (OSError, ValueError, IndexError):
            return 0                      # the process ended meanwhile

    def rss(self) -> int:
        if not self.tree:
            return self._statm("self")
        import os

        children = {}
        for name in os.listdir("/proc"):
            if not name.isdigit():
                continue
            try:
                with open(f"/proc/{name}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            children.setdefault(ppid, []).append(int(name))
        total, todo = 0, [self._pid]
        while todo:
            pid = todo.pop()
            total += self._statm(pid)
            todo.extend(children.get(pid, ()))
        return total

    def _sample(self) -> None:
        self.peak = max(self.peak, self.rss())
        self.min_available = min(self.min_available, host_mem_available())

    def _run(self) -> None:
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.period)

    def __enter__(self) -> "RssSampler":
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        self._thread.join(timeout=10)
        self._sample()


def lifelong_phase(torch, report):
    """The lifelong train-while-serve path at the stream_1k width.

    Its own 5.64 GB store (the store phase's seeded rows), written twice:
    a replica run trains LIFELONG_STEPS minibatches with a
    SnapshotPublisher (publish_every = 2, retain = 2: v1 before training,
    then v2 and v3) and no serving, and a fresh server subscribed to it
    scores the held-out batch; then the live run
    (launch.lifelong.serve_while_training) trains the same minibatches
    while a ServingEngine (256-document launches, 16-token buckets up to
    256, a 5 ms deadline) over a server subscribed to the publisher
    (hot_rows = 16,384) serves waves of Zipf requests unpaced.  Every
    version's crc must equal the replica's (training bitwise under
    traffic), every request resolve with a committed version, launch
    versions never decrease nor pass the published version by more than
    retain, θ rows sum to 1, the three kernels launch, the eq. 21
    perplexity equal the replica server's within LIFELONG_PPL_RTOL, and an
    int8-subscribed server's θ stay within LIFELONG_INT8_ATOL of f32."""
    import gc

    import numpy as np

    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core import (
        FOEMTrainer, ShiftDetector, SnapshotPublisher,
    )
    from repro_torch.core.streaming import store_from_arrays
    from repro_torch.data import trained_like_phi_blocks
    from repro_torch.kernels.gs_sweep import gs_sweep
    from repro_torch.kernels.scheduled_sweep import scheduled_sweep
    from repro_torch.kernels.theta_sweep import theta_sweep
    from repro_torch.launch.lifelong import serve_while_training
    from repro_torch.launch.serve import TopicServer, TrafficGenerator
    from repro_torch.sparse import MinibatchStream

    t_phase = time.perf_counter()
    cfg = lda_config(lda_shape("stream_1k"))
    cap = report["store_capacity"]
    phi_bytes = cap * K_FULL * 4
    # retained snapshots, the one a publish is copying, the server's pinned
    # epoch, the store's mapped pages and the int8 copy of the last version
    need = (LIFELONG_RETAIN + 3) * phi_bytes + phi_bytes // 4 + (4 << 30)
    avail = host_mem_available()
    print(f"lifelong host memory: MemAvailable {avail} bytes, need {need} "
          f"({LIFELONG_RETAIN} retained + 3 more φ copies of {phi_bytes})")
    check(avail >= need, f"lifelong: {avail} bytes of host memory "
          f"available, {need} needed at the stream_1k width")
    store_dir = ROOT / "build" / "chip_smoke_lifelong"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(store_dir.parent).free
    check(free >= phi_bytes + (2 << 30), f"lifelong: {free} bytes free on "
          f"disk, {phi_bytes + (2 << 30)} needed for its store")
    ranks = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN,
                             seed=7).word_ranks()
    mbs = list(MinibatchStream(report["training_corpus"], D_TRAIN,
                               bucket_len=L_TRAIN, seed=0))[:LIFELONG_STEPS]
    check(len(mbs) == LIFELONG_STEPS, f"lifelong: {len(mbs)} minibatches")
    w_ev, est, ev = report["heldout"]

    def fresh():
        shutil.rmtree(store_dir, ignore_errors=True)
        t0 = time.perf_counter()
        store = store_from_arrays(
            str(store_dir), trained_like_phi_blocks(cap, K_FULL, ranks=ranks,
                                                    seed=0),
            live_vocab=cap, vocab_capacity=cap)
        write_s = time.perf_counter() - t0
        pub = SnapshotPublisher(store, retain=LIFELONG_RETAIN)
        det = ShiftDetector()
        trainer = FOEMTrainer(cfg, store, seed=0, publisher=pub,
                              publish_every=LIFELONG_PUBLISH_EVERY,
                              shift_detector=det, device="cuda")
        crcs = {pub.publish().version: pub.latest().crc}     # v1
        return store, pub, det, trainer, crcs, write_s

    def versions(pub, crcs):
        for rec in pub.publish_log:
            snap = pub.get(rec["version"])
            if snap is not None:
                crcs[rec["version"]] = snap.crc
        check(sorted(crcs) == [r["version"] for r in pub.publish_log],
              f"lifelong: crcs of {sorted(crcs)} only")
        return crcs

    def counts():
        return {"theta_sweep": theta_sweep.launches,
                "gs_sweep": gs_sweep.launches,
                "scheduled_sweep": scheduled_sweep.launches}

    def zero_counts():
        theta_sweep.launches = 0
        gs_sweep.launches = 0
        scheduled_sweep.launches = 0

    with RssSampler() as rss:
        # ---- replica: the same steps and publishes, no serving
        store, pub, det, trainer, crcs, write_s = fresh()
        zero_counts()                     # counts of the main path only
        t0 = time.perf_counter()
        trainer.step(mbs[0])
        trainer.fit_stream(iter(mbs[1:]), max_steps=LIFELONG_STEPS - 1)
        train_s = time.perf_counter() - t0
        crcs = versions(pub, crcs)
        replica_srv = TopicServer(store, cfg, device="cuda")
        replica_srv.subscribe(pub)
        _, ppl_replica = replica_srv.evaluate(w_ev, est, ev)
        replica = {
            "store_write_s": write_s, "train_s": train_s,
            "step_s": [m.seconds for m in trainer.history],
            "compute_s": [m.compute_seconds for m in trainer.history],
            "sweeps": [m.sweeps for m in trainer.history],
            "published": [m.published_version for m in trainer.history],
            "publish_log": pub.publish_log, "swap_log": replica_srv.swap_log,
            "crcs": crcs, "heldout_ppl": ppl_replica, "launches": counts()}
        del store, pub, det, trainer, replica_srv
        gc.collect()

        # ---- live: the same training while the engine serves
        store, pub, det, trainer, live_crcs, write_s = fresh()
        srv = TopicServer(store, cfg, hot_rows=LIFELONG_HOT_ROWS,
                          device="cuda")
        srv.subscribe(pub)
        trace = TrafficGenerator(vocab_size=cap, doc_len=DOC_LEN,
                                 seed=43).trace([(1000.0, LIFELONG_WAVE)])
        record = {}
        zero_counts()                     # counts of the main path only
        t0 = time.perf_counter()
        rep = serve_while_training(
            trainer, pub, det, srv, iter(mbs), trace, steps=LIFELONG_STEPS,
            heldout=(w_ev, est, ev), max_batch=ENGINE_BATCH,
            max_delay_ms=ENGINE_DELAY_MS, max_len=DOC_LEN[1], pace=False,
            seed=0, record=record)
        live_s = time.perf_counter() - t0
        launches = counts()
        live_crcs = versions(pub, live_crcs)

        # an int8-subscribed server on the final version against f32
        c_ev = est + ev
        t0 = time.perf_counter()
        q = TopicServer(store, cfg, phi_dtype="int8", device="cuda")
        q.subscribe(pub)
        int8_swap_s = time.perf_counter() - t0
        th8 = q.infer(w_ev, c_ev)
        th32 = srv.infer(w_ev, c_ev)
        int8_err = float(np.abs(th8 - th32).max())
        cache = srv.hot_cache.stats
        resident = srv.hot_cache.resident_rows()
        history = trainer.history
        del q, srv, trainer, det, pub, store
        gc.collect()
    shutil.rmtree(store_dir, ignore_errors=True)

    # ---- checks
    check(live_crcs == replica["crcs"],
          f"lifelong: snapshot crcs under traffic {live_crcs} differ from "
          f"the replica's {replica['crcs']}")
    check(sorted(live_crcs) == [1, 2, 3],
          f"lifelong: versions {sorted(live_crcs)}, expected [1, 2, 3]")
    check(rep["failed_requests"] == 0 and rep["uncommitted_versions"] == []
          and record["metrics"]["failed_batches"] == 0,
          f"lifelong: {rep['failed_requests']} failed requests, "
          f"uncommitted versions {rep['uncommitted_versions']}")
    thetas = np.stack(record["thetas"])
    check(len(thetas) == rep["requests"] and thetas.shape[1] == K_FULL
          and np.isfinite(thetas).all(),
          "lifelong: θ has the wrong shape or is not finite")
    committed = set(live_crcs)
    check(all(t.version in committed for t in record["thetas"]),
          "lifelong: a θ carries an uncommitted version")
    row_err = float(np.abs(thetas.sum(1, dtype=np.float64) - 1.0).max())
    check(row_err <= 1e-5, f"lifelong: a θ row sums to 1 ± {row_err}")
    del thetas
    log = record["batch_log"]
    vers = [b["version"] for b in log]
    check(all(v >= 1 for v in vers) and vers == sorted(vers),
          f"lifelong: launch versions {vers} decrease or are unpublished")
    stale = [b["published_version"] - b["version"] for b in log]
    check(all(0 <= x <= LIFELONG_RETAIN for x in stale),
          f"lifelong: staleness {stale} outside [0, {LIFELONG_RETAIN}]")
    check(all(v > 0 for v in launches.values()),
          f"lifelong: a kernel of the path did not launch {launches}")
    ppl_diff = rep["heldout_ppl"] / replica["heldout_ppl"] - 1.0
    check(abs(ppl_diff) <= LIFELONG_PPL_RTOL,
          f"lifelong: eq. 21 perplexity {rep['heldout_ppl']} against the "
          f"replica server's {replica['heldout_ppl']}")
    check(int8_err <= LIFELONG_INT8_ATOL,
          f"lifelong: int8 θ within {int8_err} of f32")

    for name, plog in (("replica", replica["publish_log"]),
                       ("live", rep["publish_log"])):
        for r in plog:
            print(f"lifelong publish ({name}) " + json.dumps(r))
    for r in rep["swap_log"]:
        print("lifelong swap " + json.dumps(r))
    print(f"lifelong int8 swap (verify + quantize) {int8_swap_s:.3f} s")
    engine = report["serving_engine"]["runs"]["unpaced"]
    served = len(record["thetas"])
    rec = {
        "steps": LIFELONG_STEPS, "retain": LIFELONG_RETAIN,
        "publish_every": LIFELONG_PUBLISH_EVERY,
        "versions": sorted(live_crcs), "crcs_equal_replica": True,
        "publish_s": [r["seconds"] for r in rep["publish_log"]],
        "replica_publish_s": [r["seconds"] for r in replica["publish_log"]],
        "swap_s": [r["seconds"] for r in rep["swap_log"]],
        "int8_swap_s": int8_swap_s,
        "changed_rows": [r["changed_rows"] for r in rep["publish_log"]],
        "cache_rows_dropped": cache.rows_dropped,
        "cache_invalidations": cache.invalidations,
        "cache_rows_resident": resident, "cache_hit_rate": cache.hit_rate,
        "requests": rep["requests"], "waves": rep["traffic_waves"],
        "failed_requests": rep["failed_requests"],
        "launch_versions": sorted(set(vers)),
        "max_staleness_versions": rep["staleness_versions_max"],
        "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
        "docs_per_s": served / record["traffic_seconds"],
        "traffic_s": record["traffic_seconds"],
        "batches": record["metrics"]["batches"],
        "launch_ms_mean": 1e3 * float(np.mean(
            [b["launch_seconds"] for b in log])),
        "fetch_ms_mean": 1e3 * float(np.mean(
            [b["fetch_seconds"] for b in log])),
        "fit_ms_mean": 1e3 * float(np.mean([b["fit_seconds"] for b in log])),
        "mean_fill": rep["mean_fill"],
        "engine_unpaced": {k: engine[k] for k in
                           ("p50_ms", "p99_ms", "docs_per_s")},
        "live_step_s": [m.seconds for m in history],
        "replica_step_s": replica["step_s"],
        "live_compute_s": [m.compute_seconds for m in history],
        "replica_compute_s": replica["compute_s"],
        "live_sweeps": [m.sweeps for m in history],
        "replica_sweeps": replica["sweeps"],
        "training_slowdown": (sum(m.seconds for m in history[1:])
                              / sum(replica["step_s"][1:])),
        "heldout_ppl": rep["heldout_ppl"],
        "replica_heldout_ppl": replica["heldout_ppl"],
        "heldout_ppl_rel_diff": ppl_diff,
        "int8_max_abs_theta_diff": int8_err, "max_row_sum_error": row_err,
        "shift_events": rep["shift_events"],
        "launches": launches, "replica_launches": replica["launches"],
        "live_s": live_s,
        "store_write_s": [replica["store_write_s"], write_s],
        "mem_available_bytes": avail, "peak_rss_bytes": rss.peak,
        "phase_s": time.perf_counter() - t_phase}
    print("lifelong " + json.dumps(rec))
    report["lifelong"] = rec


def _attn_bound(q, k, pairs, kv_rows) -> tuple:
    """Least time of one attention call: q and o once, the visible keys and
    values once (``kv_rows`` rows of each KV head), against 4·d operations
    per visible (query head, query, key) pair — ``pairs`` per query head —
    at the inputs' type's peak (bf16 tensor cores or float32)."""
    import torch

    BH, Sq, d = q.shape
    esz = q.element_size()
    nbytes = 2 * q.numel() * esz + 2 * k.shape[0] * kv_rows * d * esz
    flops = 4 * d * BH * pairs
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / rate * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def _visible_pairs(Sq, Sk, q_offset, window) -> int:
    """Causal (and windowed) query-key pairs of one query head."""
    total = 0
    for i in range(Sq):
        hi = min(Sk, i + q_offset + 1)
        lo = max(0, i + q_offset - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def _library_attention(torch, q, k, v, B, causal_square, mask):
    """One ``scaled_dot_product_attention`` call (GQA) on the same inputs
    — timed as a yardstick only, never called by the port — and its
    output."""
    import torch.nn.functional as F

    BH, Sq, d = q.shape
    BHkv, Sk, _ = k.shape
    q4 = q.view(B, BH // B, Sq, d)
    k4, v4 = k.view(B, BHkv // B, Sk, d), v.view(B, BHkv // B, Sk, d)

    def call():
        if causal_square:
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              enable_gqa=True)
    return call, call().view(BH, Sq, d)


def _shares(bound_ms, ms, library_ms) -> dict:
    """The kernel's share of its bound and its time over the library
    call's (None without one)."""
    return {"share_of_bound": bound_ms / ms,
            "vs_library": None if library_ms is None else ms / library_ms}


def attention_sass_counts(library: str) -> dict:
    """Tensor-core instructions in a built attention library's SASS
    (``cuobjdump --dump-sass``): HGMMA (wgmma), HMMA (mma.sync)."""
    from repro_torch.kernels import build

    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "--dump-sass", str(build.library_path(library))],
        capture_output=True, text=True, check=True).stdout
    return {name: len(re.findall(rf"\b{name}\b", sass))
            for name in ("HGMMA", "HMMA")}


def attention_kernel_phase(torch, dev, report):
    """The flash-attention kernel against its plain version at the LM
    serving path's shapes: granite-8b prefill (8 × 32 heads over 8 × 8, S =
    2,048, d = 128, bf16) and decode (Sq = 1 at q_offset 2,048..2,079 in a
    4,096-slot cache), the MoE serving phases' calls (qwen2-moe, 8 × 16
    heads over 8 × 16, and qwen3-moe, 2 × 64 over 2 × 4: S = 2,048, d =
    128, prefill and decode), the VLM's cross-attention (8 × 32 heads over
    8 × 8, non-causal, 2,048 queries and one over 1,601 image keys),
    musicgen (8 × 24 over 8 × 24, d = 64, causal prefill of 2,048 and
    decode), jamba's attention layer (2 × 64 over 2 × 8, prefill of
    2,048), danube-3-4b (d = 120, window 4,096) prefill of 6,144 and its
    ring-ordered decode call, ragged Sq/Sk and MQA at small size, and the
    prefill_32k length (B = 1, S = 32,768)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(9)
    print(f"attention tolerance (rtol, atol): {json.dumps(ATTN_TOL)}: "
          f"{ATTN_TOL_REASON}")
    lines = []

    def qkv(BH, BHkv, Sq, Sk, d, dtype):
        return [torch.randn((n, s, d), generator=g, device=dev).to(dtype)
                for n, s in ((BH, Sq), (BHkv, Sk), (BHkv, Sk))]

    def run(name, q, k, v, kw, B, pairs, kv_rows, library=None,
            graph=False, reps=5):
        dtype = str(q.dtype)[6:]
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_attention_reference(q, k, v, **kw)
        err = _check_close(name, "o", got.float(), want.float(),
                           ATTN_TOL[dtype])
        del want
        check(torch.equal(flash_attention(q, k, v, **kw), got),
              f"{name}: two launches on the same inputs differ")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw), reps)
        plain_ms = cuda_time_ms(
            lambda: flash_attention_reference(q, k, v, **kw), 1)
        rec = {"case": name, "dtype": dtype, "q": list(q.shape),
               "kv": list(k.shape), **kw, "ms": ms, "plain_ms": plain_ms}
        if graph:
            rec["graph_ms"] = cuda_graph_time_ms(
                lambda: flash_attention(q, k, v, **kw), 20)
        rec["library_ms"] = None
        if library is not None:
            call, out = _library_attention(torch, q, k, v, B, *library)
            rec["library_max_abs_diff"] = (out.float()
                                           - got.float()).abs().max().item()
            rec["library_ms"] = cuda_time_ms(call, reps)
        bound = _attn_bound(q, k, pairs, kv_rows)
        rec.update(bound_ms=bound[0], bound_by=bound[1],
                   **_shares(bound[0], ms, rec["library_ms"]),
                   errors={"o": err}, bitwise_repeat=True)
        print("attention kernel " + json.dumps(rec))
        lines.append(rec)
        return got, rec

    # granite-8b prefill: B = 8, 32 heads over 8, S = 2,048, d = 128
    B, S, d = LM_BATCH, LM_PROMPT, 128
    q, k, v = qkv(B * 32, B * 8, S, S, d, torch.bfloat16)
    _, main = run("granite prefill", q, k, v, dict(causal=True), B,
                  _visible_pairs(S, S, 0, 0), S, library=(True, None))
    # granite decode: one query against a 4,096-slot cache at 2,048..2,079
    qd = q[:, :1].contiguous()
    kc, vc = qkv(B * 8, B * 8, 1, LM_CACHE, d, torch.bfloat16)[1:]
    for pos in (LM_PROMPT, LM_PROMPT + 15, LM_PROMPT + LM_STEPS - 1):
        mask = (torch.arange(LM_CACHE, device=dev) <= pos)[None, None, None]
        _, rec = run(f"granite decode q_offset={pos}", qd, kc, vc,
                     dict(causal=True, q_offset=pos), B,
                     _visible_pairs(1, LM_CACHE, pos, 0), pos + 1,
                     library=(False, mask), graph=True, reps=20)
    report["attention_decode"] = rec
    del q, k, v, qd, kc, vc
    torch.cuda.empty_cache()

    # the MoE serving phases' calls, d = 128: qwen2-moe's 16 heads over 16
    # (G = 1) and qwen3-moe's 64 over 4 (G = 16: a CTA's 128 rows are 8
    # positions of 16 heads) — prefill, and decode into the S + steps-slot
    # cache at its first and last position
    for arch, Bm, H, Hkv, Sm, steps in (
            ("qwen2-moe", MOE_BATCH, 16, 16, MOE_PROMPT, MOE_STEPS),
            ("qwen3-moe", QWEN3_BATCH, 64, 4, QWEN3_PROMPT, QWEN3_STEPS)):
        q, k, v = qkv(Bm * H, Bm * Hkv, Sm, Sm, 128, torch.bfloat16)
        run(f"{arch} prefill", q, k, v, dict(causal=True), Bm,
            _visible_pairs(Sm, Sm, 0, 0), Sm, library=(True, None))
        qd = q[:, :1].contiguous()
        kc, vc = qkv(Bm * H, Bm * Hkv, 1, Sm + steps, 128,
                     torch.bfloat16)[1:]
        for pos in (Sm, Sm + steps - 1):
            mask = (torch.arange(Sm + steps, device=dev) <= pos)[
                None, None, None]
            run(f"{arch} decode q_offset={pos}", qd, kc, vc,
                dict(causal=True, q_offset=pos), Bm,
                _visible_pairs(1, Sm + steps, pos, 0), pos + 1,
                library=(False, mask), graph=True, reps=20)
        del q, k, v, qd, kc, vc
        torch.cuda.empty_cache()

    # the VLM's cross-attention, d = 128: 8 x 32 heads over 8 x 8,
    # non-causal, the prompt's 2,048 queries and one decode query over the
    # 1,601 image keys (ragged against every key tile); SDPA unmasked
    nimg = 1601
    q, k, v = qkv(VLM_BATCH * 32, VLM_BATCH * 8, VLM_PROMPT, nimg, 128,
                  torch.bfloat16)
    _, rec = run("vlm cross-attention prefill", q, k, v, dict(causal=False),
                 VLM_BATCH, VLM_PROMPT * nimg, nimg, library=(False, None))
    report["attention_cross_prefill"] = rec
    _, rec = run("vlm cross-attention decode", q[:, :1].contiguous(), k, v,
                 dict(causal=False), VLM_BATCH, nimg, nimg,
                 library=(False, None), graph=True, reps=20)
    report["attention_cross_decode"] = rec
    del q, k, v
    # musicgen, d = 64 (the padded d <= 64 path): 8 x 24 heads over 8 x 24
    # (G = 1), causal prefill of 2,048 and decode at its first and last step
    Sa, steps = AUDIO_PROMPT, AUDIO_STEPS
    q, k, v = qkv(AUDIO_BATCH * 24, AUDIO_BATCH * 24, Sa, Sa + steps, 64,
                  torch.bfloat16)
    kp, vp = k[:, :Sa].contiguous(), v[:, :Sa].contiguous()
    _, rec = run("musicgen prefill", q, kp, vp, dict(causal=True),
                 AUDIO_BATCH, _visible_pairs(Sa, Sa, 0, 0), Sa,
                 library=(True, None))
    report["attention_audio_prefill"] = rec
    qd = q[:, :1].contiguous()
    for pos in (Sa, Sa + steps - 1):
        mask = (torch.arange(Sa + steps, device=dev) <= pos)[None, None, None]
        run(f"musicgen decode q_offset={pos}", qd, k, v,
            dict(causal=True, q_offset=pos), AUDIO_BATCH,
            _visible_pairs(1, Sa + steps, pos, 0), pos + 1,
            library=(False, mask), graph=True, reps=20)
    del q, k, v, kp, vp, qd
    # jamba's one attention layer in 8, d = 128: 2 x 64 heads over 2 x 8
    # (G = 8), causal prefill of 2,048
    q, k, v = qkv(HYBRID_BATCH * 64, HYBRID_BATCH * 8, HYBRID_PROMPT,
                  HYBRID_PROMPT, 128, torch.bfloat16)
    run("jamba prefill", q, k, v, dict(causal=True), HYBRID_BATCH,
        _visible_pairs(HYBRID_PROMPT, HYBRID_PROMPT, 0, 0), HYBRID_PROMPT,
        library=(True, None))
    del q, k, v
    torch.cuda.empty_cache()

    # danube-3-4b: d = 120, window 4,096, B = 1, S = 6,144
    W, Sd = 4096, 6144
    q, k, v = qkv(32, 8, Sd, Sd, 120, torch.bfloat16)
    ip = torch.arange(Sd, device=dev)
    band = (ip[None, :] <= ip[:, None]) & (ip[None, :] > ip[:, None] - W)
    full, _ = run("danube prefill window=4096", q, k, v,
                  dict(causal=True, window=W), 1,
                  _visible_pairs(Sd, Sd, 0, W), Sd,
                  library=(False, band[None, None]))
    del band
    # the ring of the last 4,096 positions rolled into position order, the
    # query at q_offset = Wc - 1: the same keys as the absolute call above
    kr, vr = k[:, Sd - W:].contiguous(), v[:, Sd - W:].contiguous()
    kp = torch.arange(W, device=dev)
    ring_mask = ((kp <= W - 1) & (kp > W - 1 - W))[None, None, None]
    ring, _ = run("danube ring decode", q[:, -1:].contiguous(), kr, vr,
                  dict(causal=True, window=W, q_offset=W - 1), 1,
                  W, W, library=(False, ring_mask), graph=True, reps=20)
    _check_close("danube ring decode", "o vs absolute", ring.float(),
                 full[:, -1:].float(), ATTN_TOL["bfloat16"])
    same = bool(torch.equal(ring, full[:, -1:]))
    print(f"attention ring decode vs the absolute-position call: bitwise "
          f"{same}")
    check(same, "danube ring decode: the ring-ordered call's bits differ "
          "from the absolute-position call's")
    lines[-1]["equals_absolute_call_bitwise"] = same
    del q, k, v, kr, vr, full, ring
    torch.cuda.empty_cache()

    # ragged Sq/Sk and MQA, small
    q, k, v = qkv(6, 1, 45, 77, 128, torch.bfloat16)
    run("MQA ragged", q, k, v, dict(causal=True, q_offset=32), 6,
        _visible_pairs(45, 77, 32, 0), 77)
    q, k, v = qkv(8, 2, 70, 70, 120, torch.float32)
    run("ragged window f32", q, k, v, dict(causal=True, window=24), 1,
        _visible_pairs(70, 70, 0, 24), 70)

    # prefill_32k: B = 1, 32 heads over 8, S = 32,768; the last 128 rows
    # against the plain version at q_offset = 32,640
    S = PREFILL_32K
    q, k, v = qkv(32, 8, S, S, 128, torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    tail = q[:, -128:].contiguous()
    want = flash_attention_reference(tail, k, v, causal=True,
                                     q_offset=S - 128)
    err = _check_close("prefill_32k", "o (last 128 rows)",
                       got[:, -128:].float(), want.float(),
                       ATTN_TOL["bfloat16"])
    check(torch.equal(flash_attention(tail, k, v, causal=True,
                                      q_offset=S - 128), got[:, -128:]),
          "prefill_32k: the last rows' bits depend on Sq")
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, causal=True), 2)
    plain_ms = cuda_time_ms(lambda: flash_attention_reference(
        tail, k, v, causal=True, q_offset=S - 128), 1)
    call, out = _library_attention(torch, q, k, v, 1, True, None)
    lib_ms = cuda_time_ms(call, 2)
    bound = _attn_bound(q, k, _visible_pairs(S, S, 0, 0), S)
    rec = {"case": "prefill_32k", "dtype": "bfloat16", "q": list(q.shape),
           "kv": list(k.shape), "causal": True, "ms": ms,
           "plain_ms_last_128_rows": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound[0], "bound_by": bound[1],
           **_shares(bound[0], ms, lib_ms),
           "errors": {"o_last_128_rows": err},
           "last_rows_equal_tail_call": True}
    print("attention kernel " + json.dumps(rec))
    lines.append(rec)
    del q, k, v, got, tail, want, out, call
    torch.cuda.empty_cache()
    report["attention_lines"] = lines
    report["attention_main"] = main


def _place(cache, pre, slot_of=None):
    """Prefill caches into decode caches, in place: every leaf at its
    origin (``launch.serve.place_prefill``, as ``generate`` places them) or,
    for a K/V ring of W slots, the last W positions p to slot ``slot_of(p)``
    (the JAX package has no such glue: its ring test decodes from position
    0)."""
    import torch

    from repro_torch.launch.serve import place_prefill

    if slot_of is None:
        place_prefill(cache, pre)
        return
    for j in cache:
        for n, src in pre[j].items():
            dst = cache[j][n]
            P, W = src.shape[3], dst.shape[3]
            pos = torch.arange(P - W, P, device=src.device)
            dst[:, :, :, slot_of(pos)] = src[:, :, :, pos]


def lm_serving_phase(torch, dev, report):
    """The dense LM's serving path on the card at full width: granite-8b
    (36 layers, bf16) prefills 8 prompts of 2,048 random tokens and takes
    32 greedy decode steps; a float32 copy's decode continues one prefill
    over the same 2,080 tokens; danube-3-4b (4 layers, float32) decodes 16
    steps from a ring past its 4,096-key window against one prefill."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build

    cfg = ARCHS[LM_ARCH]
    B, S = LM_BATCH, LM_PROMPT
    print(f"lm serving: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
          f"{cfg.hd} d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.dtype}; "
          f"{B} prompts x {S} tokens, {LM_STEPS} decode steps, cache "
          f"{LM_CACHE} (decode_32k is 128 x 32,768: batch and cache cut to "
          f"one card)")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    model.prefill(params, {"tokens": tokens[:, :64]})       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits, pre = model.prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    check(bool(torch.isfinite(logits).all()), "granite prefill: non-finite")
    cache = model.init_cache(B, LM_CACHE)
    _place(cache, pre)
    del pre
    nxt = logits[:, -1].argmax(-1)
    del logits
    step_ms, greedy = [], []
    for t in range(LM_STEPS):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache,
                                      {"tokens": nxt[:, None]}, S + t)
        nxt = lg[:, -1].argmax(-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(lg).all()),
              f"granite decode step {t}: non-finite logits")
        greedy.append(nxt)
    launches = flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = cfg.num_layers
    check(prefill_launches == n, f"prefill launched the attention kernel "
          f"{prefill_launches} times, not {n}")
    check(launches - prefill_launches == n * LM_STEPS,
          f"{LM_STEPS} decode steps launched the attention kernel "
          f"{launches - prefill_launches} times, not {n * LM_STEPS}")
    def one_step():
        return model.decode_step(params, cache, {"tokens": nxt[:, None]},
                                 S + LM_STEPS)

    _, wall_ms, by_op, busy_ms = device_profile(torch, one_step)
    # the same step's device time alone: captured in a CUDA graph, replayed
    graph_ms = cuda_graph_time_ms(one_step, 3)
    ms_sorted = sorted(step_ms)
    rec = {"arch": cfg.name, "dtype": cfg.dtype, "batch": B, "prompt": S,
           "init_params_s": init_s, "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": B * S / prefill_s,
           "decode_ms_median": ms_sorted[len(ms_sorted) // 2],
           "decode_ms_min": ms_sorted[0], "decode_ms_max": ms_sorted[-1],
           "decode_tokens_per_s": B * 1e3 / ms_sorted[len(ms_sorted) // 2],
           "decode_step_graph_ms": graph_ms,
           "decode_idle_share": 1 - graph_ms / ms_sorted[len(ms_sorted) // 2],
           "peak_gb": peak_gb, "attention_launches": launches,
           "prefill_launches": prefill_launches,
           "profiled_step": {"wall_ms": wall_ms, "busy_ms": busy_ms,
                             "busy_share": busy_ms / wall_ms,
                             "top_ops_ms": top_ops(by_op, 6)}}
    print("lm serving " + json.dumps(rec))
    report["lm_serving"] = rec
    del params, cache, lg, model
    torch.cuda.empty_cache()

    # continuity in a float32 copy at full width: prefill 2,048, 32 greedy
    # decode steps, then one prefill over the 2,080 tokens
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model = build(cfg32)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    print(f"lm continuity tolerance (rtol, atol): {LM_TOL}: "
          f"{LM_TOL_REASON}")
    torch.cuda.reset_peak_memory_stats()
    logits, pre = model.prefill(params, {"tokens": tokens})
    cache = model.init_cache(B, LM_CACHE)
    _place(cache, pre)
    del pre
    fed = [logits[:, -1].argmax(-1)]
    last_prefill = logits[:, -1].clone()
    del logits
    dec = []
    for t in range(LM_STEPS):
        lg, cache = model.decode_step(params, cache,
                                      {"tokens": fed[-1][:, None]}, S + t)
        dec.append(lg[:, 0])
        fed.append(lg[:, 0].argmax(-1))
    del cache
    torch.cuda.empty_cache()
    dec = torch.stack(dec, 1)                            # (B, steps, V)
    seq = torch.cat([tokens, torch.stack(fed[:-1], 1)], 1)
    full = model.prefill(params, {"tokens": seq})[0]
    ref = full[:, S:]
    err = _check_close("granite float32 decode", "logits vs prefill", dec,
                       ref, LM_TOL)
    _check_close("granite float32 prefill", "last logits vs the longer "
                 "prefill", last_prefill, full[:, S - 1], LM_TOL)
    same = torch.equal(dec.argmax(-1), ref.argmax(-1))
    top2 = ref.topk(2, dim=-1).values
    gap = float((top2[..., 0] - top2[..., 1]).min())
    check(same, "granite float32: decode's greedy tokens differ from the "
          f"prefill's (smallest top-2 gap {gap})")
    peak32 = torch.cuda.max_memory_allocated() / 1e9
    rec32 = {"arch": cfg.name, "dtype": "float32", "tokens": S + LM_STEPS,
             "logits_err": err, "greedy_equal": same,
             "smallest_top2_gap": gap, "peak_gb": peak32}
    print("lm continuity " + json.dumps(rec32))
    report["lm_continuity"] = rec32
    del params, model, full, ref, dec, last_prefill, top2
    torch.cuda.empty_cache()

    # danube-3-4b: full width, 4 layers, float32; ring decode past the window
    cfgd = dataclasses.replace(ARCHS[SWA_ARCH], num_layers=SWA_LAYERS,
                               dtype="float32")
    Wd = cfgd.sliding_window
    model = build(cfgd)
    params = model.init_params(torch.Generator(device=dev).manual_seed(2))
    Sd = SWA_PROMPT + SWA_STEPS
    tok = torch.randint(0, cfgd.vocab_size, (SWA_BATCH, Sd),
                        generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    flash_attention.launches = 0
    _, pre = model.prefill(params, {"tokens": tok[:, :SWA_PROMPT]})
    cache = model.init_cache(SWA_BATCH, Sd)
    check(cache["l0"]["k"].shape[3] == Wd, "danube: the cache is not a ring "
          "of window slots")
    _place(cache, pre, slot_of=lambda p: p % Wd)
    del pre
    dec = []
    for t in range(SWA_PROMPT, Sd):
        lg, cache = model.decode_step(params, cache,
                                      {"tokens": tok[:, t:t + 1]}, t)
        dec.append(lg[:, 0])
    dec = torch.stack(dec, 1)
    swa_launches = flash_attention.launches
    full = model.prefill(params, {"tokens": tok})[0]
    ref = full[:, SWA_PROMPT:]
    errd = _check_close("danube ring decode", "logits vs prefill", dec, ref,
                        LM_TOL)
    samed = torch.equal(dec.argmax(-1), ref.argmax(-1))
    check(samed, "danube: ring decode's greedy tokens differ from the "
          "prefill's")
    check(swa_launches == SWA_LAYERS * (1 + SWA_STEPS),
          f"danube launched the attention kernel {swa_launches} times")
    recd = {"arch": cfgd.name, "layers": SWA_LAYERS, "dtype": "float32",
            "window": Wd, "prompt": SWA_PROMPT, "steps": SWA_STEPS,
            "logits_err": errd, "greedy_equal": samed,
            "attention_launches": swa_launches}
    print("lm ring decode " + json.dumps(recd))
    report["lm_ring"] = recd
    del params, model, cache, full, ref, dec
    torch.cuda.empty_cache()


def _bwd_bound(q, k, pairs) -> tuple:
    """Least time of one attention backward call: q, o, dO and lse read and
    dq written once a query head, k and v read and dk, dv written once a
    KV head, against 5 products of 2·d operations per visible (query head,
    query, key) pair — ``pairs`` per query head — at the inputs' type's
    peak (bf16 tensor cores or float32)."""
    import torch

    BH, Sq, d = q.shape
    esz = q.element_size()
    nbytes = 4 * q.numel() * esz + 4 * k.numel() * esz + 4 * BH * Sq
    flops = 10 * d * BH * pairs
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / rate * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def bwd_tile_error(got, want) -> float:
    """Largest error of a gradient's (head, BWD_TILE-row tile) blocks
    against ``want``'s, each over its own norm: max_t ||got_t - want_t|| /
    (||want_t|| + BWD_TILE_FLOOR · rms_t ||want_t||)."""
    import torch

    err, norm = [], []
    for a, b in zip(got.float().split(BWD_TILE, 1),
                    want.float().split(BWD_TILE, 1)):
        err.append((a - b).flatten(1).norm(dim=1))
        norm.append(b.flatten(1).norm(dim=1))
    err, norm = torch.stack(err, 1), torch.stack(norm, 1)
    floor = BWD_TILE_FLOOR * norm.pow(2).mean().sqrt()
    return float((err / (norm + floor)).max())


def attention_backward_phase(torch, dev, report):
    """The attention backward kernels (``flash_attention_backward``: the
    delta, dkdv and dq launches of ``csrc/flash_attention_bwd.cu``) against
    ``torch.autograd`` of the plain attention on the same inputs, at the LM
    training shapes: danube-3-4b (B = 1, 32 heads over 8, S = 4,096, d =
    120, window 4,096, bf16), granite (32 over 8, S = 2,048, d = 128,
    causal, bf16 and float32), a window shorter than S (512), qwen2-moe
    (16 heads over 16, S = 4,096, d = 128, causal, bf16), the VLM's
    cross-attention (32 over 8, non-causal, 4,096 queries over 1,601 image
    keys, d = 128, bf16) and musicgen (24 over 24, S = 4,096, d = 64,
    causal, bf16).  Float32
    is held elementwise (BWD_TOL), bfloat16 tile by tile against the
    float32 truth (BWD_TILE_TOL), and each bfloat16 case plants two faults
    that the tile check must see.  Each line has the kernel's ms (CUDA events over 3 calls),
    its launches, its bound, the plain version's ms and the backward of one
    ``scaled_dot_product_attention`` (timed only, never called by the
    port), and two launches' bits compared."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
        flash_attention_backward_reference,
    )

    g = torch.Generator(device=dev).manual_seed(11)
    print(f"attention backward tolerance (rtol, atol): {json.dumps(BWD_TOL)}"
          f": {BWD_TOL_REASON}; bfloat16 {BWD_TILE}-row tiles within "
          f"{BWD_TILE_TOL} of (norm + {BWD_TILE_FLOOR} of the rms norm) of "
          f"the float32 truth")
    lines = []

    def verdicts(got, want, truth, dtype):
        """Each gradient's errors: elementwise against the plain version
        (BWD_TOL: float32's check, bfloat16's screen) and, in bfloat16, by
        tile against the float32 truth (the check), beside the plain
        version's own tile error."""
        rtol, atol = BWD_TOL[dtype]
        out = {}
        for n, a, b, t in zip(("dq", "dk", "dv"), got, want, truth):
            a, b = a.float(), b.float()
            screen = bool(torch.allclose(a, b, rtol=rtol, atol=atol))
            out[n] = {**errors(a, b), "screen": screen, "ok": screen}
            if dtype == "bfloat16":
                tile = bwd_tile_error(a, t)
                out[n].update(tile_err=tile,
                              plain_tile_err=bwd_tile_error(b, t),
                              ok=screen and tile <= BWD_TILE_TOL)
        return out

    def faults(name, q, k, v, o, dout, lse, got, want, truth, kw):
        """The planted faults: each must fail the tile check."""
        Sq, Sk = q.shape[1], k.shape[1]
        dk = got[1].clone()
        dk[0, Sk // 2:Sk // 2 + BWD_TILE] = 0
        shifted = lse.clone()
        shifted[0, Sq // 2:Sq // 2 + BWD_TILE] += BWD_FAULT_LSE_SHIFT
        bad = flash_attention_backward(q, k, v, o, dout, shifted, **kw)
        out = {}
        for fault, grads in (("dk_tile_zeroed", (got[0], dk, got[2])),
                             ("lse_shifted", bad)):
            res = verdicts(grads, want, truth, "bfloat16").values()
            out[fault] = {"tile_err": max(e["tile_err"] for e in res),
                          "screen_passes": all(e["screen"] for e in res)}
            check(out[fault]["tile_err"] > BWD_TILE_TOL, f"{name}: the "
                  f"planted fault {fault} passes the tile check")
        return out

    def run(name, BH, BHkv, S, d, window, dtype):
        causal = not isinstance(S, tuple)       # (Sq, Sk): cross-attention
        Sq, Sk = (S, S) if causal else S
        q, k, v, dout = [torch.randn((n, s, d), generator=g, device=dev)
                         .to(dtype) for n, s in ((BH, Sq), (BHkv, Sk),
                                                 (BHkv, Sk), (BH, Sq))]
        kw = dict(causal=causal, window=window)
        o, lse = flash_attention(q, k, v, **kw, return_lse=True)
        before = flash_attention_backward.launches
        got = flash_attention_backward(q, k, v, o, dout, lse, **kw)
        torch.cuda.synchronize()
        launches = flash_attention_backward.launches - before
        want = flash_attention_backward_reference(q, k, v, dout, **kw)
        ty = str(dtype)[6:]
        truth = (flash_attention_backward_reference(
            q.float(), k.float(), v.float(), dout.float(), **kw)
            if ty == "bfloat16" else want)
        errs = verdicts(got, want, truth, ty)
        bad = {n: e for n, e in errs.items() if not e["ok"]}
        check(not bad, f"{name}: the kernel disagrees with the plain "
              f"version: {bad}")
        planted = (faults(name, q, k, v, o, dout, lse, got, want, truth, kw)
                   if ty == "bfloat16" else None)
        del want, truth
        again = flash_attention_backward(q, k, v, o, dout, lse, **kw)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name}: two launches on the same inputs differ")
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"{name}: a non-finite gradient")
        del again, got
        ms = cuda_time_ms(lambda: flash_attention_backward(
            q, k, v, o, dout, lse, **kw), 3)
        plain_ms = cuda_time_ms(lambda: flash_attention_backward_reference(
            q, k, v, dout, **kw), 1)
        q4 = q.view(1, BH, Sq, d).detach().requires_grad_()
        k4 = k.view(1, BHkv, Sk, d).detach().requires_grad_()
        v4 = v.view(1, BHkv, Sk, d).detach().requires_grad_()
        if not causal:
            o4 = F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True)
        elif 0 < window < S:
            ip = torch.arange(S, device=dev)
            band = (ip[None, :] <= ip[:, None]) & (
                ip[None, :] > ip[:, None] - window)
            o4 = F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=band[None, None], enable_gqa=True)
        else:                           # causal (the window holds all of S)
            o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                enable_gqa=True)
        g4 = dout.view(1, BH, Sq, d)
        lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g4, retain_graph=True), 3)
        bound = _bwd_bound(q, k, _visible_pairs(Sq, Sk, 0, window)
                           if causal else Sq * Sk)
        prior = BWD_PRIOR_MS.get(name)
        rec = {"case": name, "dtype": ty, "q": list(q.shape),
               "kv": list(k.shape), **kw,
               "path": ("tensor cores (wgmma, TMA)" if ty == "bfloat16"
                        else "CUDA cores (float32 fmaf)"),
               "ms": ms, "prior_design_ms": prior,
               "vs_prior_design": None if prior is None else ms / prior,
               "launches": launches,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": bound[0], "bound_by": bound[1],
               **_shares(bound[0], ms, lib_ms), "errors": errs,
               "planted_faults": planted, "bitwise_repeat": True}
        print("attention backward kernel " + json.dumps(rec))
        lines.append(rec)
        del q, k, v, dout, o, lse, q4, k4, v4, o4, g4
        torch.cuda.empty_cache()
        return rec

    recs = [run(name, *shape, getattr(torch, dtype))
            for name, shape, dtype in BWD_CASES]
    report["attention_backward_lines"] = lines
    report["attention_backward_main"] = recs[0]


def plain_attention():
    """A context in which ``ops.attention`` — the LM's attention core —
    runs the plain version (``flash_attention_reference``, differentiated
    by autograd) on the card instead of the kernels."""
    import contextlib

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_reference

    @contextlib.contextmanager
    def swapped():
        kernel = ops.attention
        ops.attention = (
            lambda q, k, v, *, causal=True, window=0, q_offset=0:
            flash_attention_reference(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset))
        try:
            yield
        finally:
            ops.attention = kernel
    return swapped()


def lm_training_phase(torch, dev, report):
    """The dense LM's training path on the card at full width and depth:
    h2o-danube-3-4b (24 layers, bf16, seeded random weights) trains
    TRAIN_STEPS steps of ``launch.train.lm_train_step`` on one
    ``synthetic_token_stream`` sequence of TRAIN_SEQ tokens each, the last
    step under ``torch.profiler``.  Checks: finite losses; step 1 (lr 0)
    leaves every parameter bitwise unchanged and sets the moments; steps
    2–4 change every weight matrix; 24 forward and 24 backward attention
    launches a step; step 1's loss within TRAIN_LOSS_RTOL of the same
    forward through the plain attention under no_grad; the peak below
    TRAIN_PEAK_GB.  Then, on 2-layer full-width copies in float32 and in
    bfloat16, every leaf's gradient through the kernels against the plain
    attention's autograd (TRAIN_GRAD_TOL, TRAIN_GRAD_TOL_BF16); and the
    witness of the bf16 loss curve: TRAIN_STEPS steps at full width and
    depth at S = TRAIN_WITNESS_SEQ through the kernels and through the
    plain attention, each step's loss within TRAIN_WITNESS_RTOL."""
    import contextlib

    import numpy as np

    from repro_torch.checkpoint.ckpt import tree_flatten
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.synthetic import synthetic_token_stream
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
    )
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw_init

    cfg = ARCHS[TRAIN_ARCH]
    B, S, n = TRAIN_BATCH, TRAIN_SEQ, cfg.num_layers
    print(f"lm training: {cfg.name} {n} layers d_model {cfg.d_model} heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.hd} d_ff {cfg.d_ff} "
          f"vocab {cfg.vocab_size} {cfg.dtype} window {cfg.sliding_window}; "
          f"{B} x {S} tokens a step (train_4k's global batch of 256 cut to "
          f"1 for one card), {TRAIN_STEPS} steps of train_lm's step")
    print(f"lm training tolerances: loss rtol {TRAIN_LOSS_RTOL}; 2-layer "
          f"gradients, float32 {TRAIN_GRAD_TOL} of each leaf's largest, "
          f"bfloat16 {TRAIN_GRAD_TOL_BF16} of its norm; the loss curves "
          f"through the kernels and the plain attention at S = "
          f"{TRAIN_WITNESS_SEQ} within {TRAIN_WITNESS_RTOL}")
    t_phase = time.perf_counter()
    stream = synthetic_token_stream(B, S, cfg.vocab_size, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                next(stream).items()} for _ in range(TRAIN_STEPS)]
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = tree_flatten(params)[0]
    names = [".".join(map(str, path)) for path in _tree_paths(params)]
    with torch.no_grad(), plain_attention():
        plain_loss = model.loss_fn(params, batches[0]).item()
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    for p in leaves:
        p.requires_grad_()
    t0 = time.perf_counter()
    snap = [p.detach().to("cpu", copy=True) for p in leaves]
    snap_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_backward.launches = 0
    losses, step_s, launches = [], [], []
    profiled = None
    for i, b in enumerate(batches):
        fwd0 = flash_attention.launches
        bwd0 = flash_attention_backward.launches

        def step():
            out = lm_train_step(model, params, opt, b,
                                total_steps=TRAIN_STEPS)
            torch.cuda.synchronize()        # the wall clock sees it all
            return out

        t0 = time.perf_counter()
        if i == TRAIN_STEPS - 1:
            out, wall_ms, by_op, busy_ms = device_profile(torch, step)
            profiled = {"step": i + 1, "wall_ms": wall_ms,
                        "busy_ms": busy_ms, "busy_share": busy_ms / wall_ms,
                        "top_ops_ms": top_ops(by_op, 8),
                        "attention_kernels_ms": kernel_ms(
                            by_op, "flash_attention")}
        else:
            out = step()
        loss, params, opt = out
        step_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
        launches.append([flash_attention.launches - fwd0,
                         flash_attention_backward.launches - bwd0])
        if i == 0:
            same = [torch.equal(p.detach().cpu(), s)
                    for p, s in zip(leaves, snap)]
            check(all(same), "lm training step 1 (lr 0) changed "
                  + ", ".join(nm for nm, ok in zip(names, same) if not ok))
            unset = [nm for nm, m in zip(names, tree_flatten(opt.mu)[0])
                     if not bool(m.abs().sum() > 0)]
            check(not unset, f"lm training step 1 left moments at 0: "
                  f"{unset}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = {nm: not torch.equal(p.detach().cpu(), s)
               for nm, p, s in zip(names, leaves, snap)}
    # the weight matrices: a layer's parameter of rank 2 (a stacked leaf
    # holds one a layer); the norm scales sit at 1.0, where bf16's spacing
    # (2^-8) is wider than lr·step here
    matrices = [nm for nm, p in zip(names, leaves)
                if p.ndim - (1 if nm.startswith("blocks.") else 0) >= 2]
    check(all(np.isfinite(losses)), f"lm training losses {losses}")
    check(all(changed[nm] for nm in matrices), "lm training steps 2-4 left "
          + ", ".join(nm for nm in matrices if not changed[nm])
          + " unchanged")
    check(all(f == n and bw == n for f, bw in launches),
          f"lm training attention launches a step {launches}, not {n} "
          f"forward and {n} backward")
    loss_err = abs(losses[0] - plain_loss) / abs(plain_loss)
    check(loss_err <= TRAIN_LOSS_RTOL, f"lm training step 1 loss "
          f"{losses[0]} against the plain attention's {plain_loss}")
    check(peak_gb <= TRAIN_PEAK_GB, f"lm training peaked at {peak_gb:.1f} "
          f"GB, above {TRAIN_PEAK_GB}")
    steady = sorted(step_s[1:-1])
    step_med = steady[len(steady) // 2]
    del params, opt, snap, leaves, model, out, loss
    torch.cuda.empty_cache()

    # every leaf's gradient: kernels against the plain attention, 2 layers,
    # in float32 (max error over the leaf's largest) and in the model's
    # bfloat16 (error norm over the leaf's norm)
    grad_check = {}
    for dtype, tol in (("float32", TRAIN_GRAD_TOL),
                       (cfg.dtype, TRAIN_GRAD_TOL_BF16)):
        model = build(dataclasses.replace(cfg, num_layers=TRAIN_GRAD_LAYERS,
                                          dtype=dtype))
        params = model.init_params(torch.Generator(device=dev).manual_seed(1))
        leaves = tree_flatten(params)[0]
        for p in leaves:
            p.requires_grad_()
        before = flash_attention_backward.launches
        model.loss_fn(params, batches[0]).backward()
        grad_launches = flash_attention_backward.launches - before
        got = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        with plain_attention():
            model.loss_fn(params, batches[0]).backward()
        grad_err = {}
        for nm, a, p in zip(names, got, leaves):
            a, b = a.float(), p.grad.float()
            if dtype == "float32":
                e = (a - b).abs().max() / b.abs().max().clamp_min(1e-30)
            else:
                e = (a - b).norm() / b.norm().clamp_min(1e-30)
            grad_err[nm] = e.item()
        check(grad_launches == TRAIN_GRAD_LAYERS, f"the 2-layer {dtype} "
              f"backward launched the backward kernels {grad_launches} "
              f"times")
        bad = {nm: e for nm, e in grad_err.items() if not e <= tol}
        check(not bad, f"2-layer {dtype} gradients through the kernels "
              f"differ from the plain attention's: {bad}")
        grad_check[dtype] = {"layers": TRAIN_GRAD_LAYERS, "tol": tol,
                             "max_rel_err": max(grad_err.values()),
                             "worst_leaf": max(grad_err, key=grad_err.get)}
        del params, leaves, got, model, a, b, p
        torch.cuda.empty_cache()

    # the witness of the bf16 loss curve: the same steps at full width and
    # depth through the kernels and through the plain attention
    stream = synthetic_token_stream(B, TRAIN_WITNESS_SEQ, cfg.vocab_size,
                                    seed=0)
    wbatches = [{k: torch.from_numpy(v).to(dev) for k, v in
                 next(stream).items()} for _ in range(TRAIN_STEPS)]
    model = build(cfg)
    curves, wlaunches, held_gb = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for path in ("kernels", "plain"):
        # what the earlier runs left allocated (the model's own state is
        # freed once its names are: no reference cycle holds it)
        held_gb[path] = torch.cuda.memory_allocated() / 1e9
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        opt = adamw_init(params)
        for p in tree_flatten(params)[0]:
            p.requires_grad_()
        before = flash_attention_backward.launches
        with (plain_attention() if path == "plain"
              else contextlib.nullcontext()):
            curve = []
            for b in wbatches:
                loss, params, opt = lm_train_step(model, params, opt, b,
                                                  total_steps=TRAIN_STEPS)
                curve.append(loss.item())
        curves[path] = curve
        wlaunches[path] = flash_attention_backward.launches - before
        del params, opt, loss, p
        torch.cuda.empty_cache()
    witness_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del model
    torch.cuda.empty_cache()
    wrel = [abs(a - b) / abs(b) for a, b in zip(curves["kernels"],
                                                 curves["plain"])]
    check(wlaunches == {"kernels": n * TRAIN_STEPS, "plain": 0},
          f"the witness's backward launches {wlaunches}")
    check(all(np.isfinite(curves["kernels"] + curves["plain"]))
          and all(r <= TRAIN_WITNESS_RTOL for r in wrel),
          f"the bf16 loss curves through the kernels {curves['kernels']} "
          f"and the plain attention {curves['plain']} part by {wrel}")

    rec = {"arch": cfg.name, "layers": n, "dtype": cfg.dtype, "batch": B,
           "seq": S, "steps": TRAIN_STEPS, "losses": losses,
           "plain_attention_loss_step1": plain_loss,
           "loss_rel_err_step1": loss_err, "step_s": step_s,
           "step_s_median_steady": step_med,
           "tokens_per_s": B * S / step_med, "peak_gb": peak_gb,
           "attention_launches_per_step": launches,
           "forward_launches": sum(f for f, _ in launches),
           "backward_launches": sum(bw for _, bw in launches),
           "init_params_s": init_s, "host_snapshot_s": snap_s,
           "matrices_changed": sum(changed[nm] for nm in matrices),
           "matrices": len(matrices),
           "norm_leaves_changed": sorted(nm for nm in changed
                                         if changed[nm]
                                         and nm not in matrices),
           "grad_check": grad_check,
           "witness": {"seq": TRAIN_WITNESS_SEQ, **curves,
                       "rel_err": wrel, "peak_gb": witness_peak_gb,
                       "held_gb_before": held_gb},
           "profiled_step": profiled,
           "phase_s": time.perf_counter() - t_phase}
    print("lm training " + json.dumps(rec))
    report["lm_training"] = rec


def _tree_paths(tree, prefix=()):
    """Key paths of a nested dict's leaves, in ``tree_flatten``'s order
    (keys sorted)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _tree_paths(tree[k], prefix + (k,))
        return out
    return [prefix]


def lm_cli_phase(report):
    """The LM CLIs on the card, each in a process of its own (the kernels
    this run built are loaded, not rebuilt): ``launch.serve --arch
    granite-8b --gen-tokens 8``; ``launch.train --arch granite-8b --steps
    12 --ckpt-every 5``, whose loss must fall, then ``--resume --steps 14``
    from its workdir, which must resume from step 10; and
    ``examples/torch/train_lm.py --quick``.  Each must exit 0.  The serve
    CLI and the example share no files with the train runs and run beside
    them (each run's seconds are its own process's wall time, taken while
    the others share the card)."""
    import os
    import re

    import numpy as np

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    wd = ROOT / "build" / "chip_smoke_lm_cli"
    shutil.rmtree(wd, ignore_errors=True)
    runs, procs = {}, {}

    def start(name, args):
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, *args], cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env))

    def finish(name):
        t0, proc = procs[name]
        out, err = proc.communicate(timeout=600)
        del procs[name]
        check(proc.returncode == 0, f"lm cli {name} exited "
              f"{proc.returncode}: {out[-2000:]}{err[-2000:]}")
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "last_line": out.strip().splitlines()[-1]}
        return out

    def run(name, args):
        start(name, args)
        return finish(name)

    def losses(out):
        return [float(x) for x in re.findall(r"loss=\s*(\S+)", out)]

    train = ["-m", "repro_torch.launch.train", "--arch", LM_CLI_ARCH,
             "--ckpt-every", "5", "--workdir", str(wd / "train")]
    try:
        start("serve", ["-m", "repro_torch.launch.serve", "--arch",
                        LM_CLI_ARCH, "--gen-tokens", "8"])
        start("example", [str(ROOT / "examples" / "torch" / "train_lm.py"),
                          "--quick", "--workdir", str(wd / "example")])
        first = losses(run("train", train + ["--steps", "12"]))
        check(len(first) == 12 and all(np.isfinite(first))
              and first[-1] < first[0],
              f"lm cli train: 12 losses that fall, got {first}")
        out = run("resume", train + ["--steps", "14", "--resume"])
        check("[resume] from step 10" in out and len(losses(out)) == 4,
              f"lm cli resume printed {out[-500:]}")
        out = finish("serve")
        check("generated 8×64 tokens" in out and "tok/s" in out,
              f"lm cli serve printed {out[-500:]}")
        ex = losses(finish("example"))
        check(len(ex) == 6 and all(np.isfinite(ex)),
              f"lm cli example losses {ex}")
    finally:
        for _, proc in procs.values():      # a failed check: stop the rest
            proc.kill()
            proc.communicate()
        shutil.rmtree(wd, ignore_errors=True)
    rec = {"arch": LM_CLI_ARCH, "train_losses": first, "runs": runs}
    print("lm cli " + json.dumps(rec))
    report["lm_cli"] = rec


class RoutingRecorder:
    """While active, keeps each ``models.moe.route`` call's experts (T, k)
    and each token's gap between its k-th and (k+1)-th probability, on the
    card.  (The script's instrument; the port is not changed.)"""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._moe, real = moe, moe.route
        self._real = real

        def recording(router, xt, k, norm=True):
            topv, topi = real(router, xt, k, norm)
            with torch.no_grad():
                top = torch.softmax(xt.float() @ router, dim=-1).topk(
                    k + 1, dim=-1).values
            self.calls.append((topi.detach(), top[:, k - 1] - top[:, k]))
            return topv, topi

        moe.route = recording
        return self

    def __exit__(self, *exc):
        self._moe.route = self._real


def _moe_share(torch, model, params, batch) -> tuple:
    """Device ms of one prefill and of its MoE layers: CUDA events around
    the prefill and around each ``moe_apply`` call (its host sync for the
    group sizes included)."""
    from repro_torch.models import moe

    real, spans = moe.moe_apply, []

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*a, **kw)
        ev[1].record()
        spans.append(ev)
        return out

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    moe.moe_apply = timed
    try:
        start.record()
        model.prefill(params, batch)
        end.record()
        end.synchronize()
    finally:
        moe.moe_apply = real
    return (start.elapsed_time(end),
            sum(a.elapsed_time(b) for a, b in spans), len(spans))


def _arch_line(cfg) -> str:
    """An LM config's widths, for the serving and training lines."""
    ssm = (f"d_inner {cfg.d_inner} ssm heads {cfg.ssm_heads} x "
           f"{cfg.ssm_head_dim} state {cfg.ssm_state} chunk {cfg.ssm_chunk}")
    if cfg.family == "ssm":
        return (f"d_model {cfg.d_model} {ssm} vocab {cfg.vocab_size} "
                f"{cfg.dtype}")
    line = (f"d_model {cfg.d_model} heads {cfg.num_heads}/"
            f"{cfg.num_kv_heads} hd {cfg.hd} experts {cfg.num_experts} top-"
            f"{cfg.experts_per_token} d_ff {cfg.d_ff} shared "
            f"{cfg.num_shared_experts} x {cfg.shared_expert_ff} vocab "
            f"{cfg.vocab_size} {cfg.dtype}")
    if cfg.attn_every:
        line += (f"; attention every {cfg.attn_every} (at "
                 f"{cfg.attn_offset}), Mamba2 elsewhere: {ssm}")
    if cfg.cross_attn_every:
        line += (f"; cross-attention every {cfg.cross_attn_every} to "
                 f"{cfg.image_tokens} image tokens")
    if cfg.frontend == "audio_frames":
        line += "; frame-embedding inputs"
    return line


def _lm_inputs(torch, dev, cfg, B, S, steps, seed) -> dict:
    """A serving run's seeded inputs on the card: the prompts' ``tokens``
    (B, S) — an audio config's frame ``embeds`` (B, S + steps, d_model)
    instead, the decode steps fed frames, not tokens —, and a VLM's
    ``image_embeds`` (B, image_tokens, d_model) float32 beside them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    if cfg.frontend == "audio_frames":
        out["embeds"] = torch.randn((B, S + steps, cfg.d_model), generator=g,
                                    device=dev)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (B, S),
                                      generator=g, device=dev)
    if cfg.frontend == "image_patches":
        out["image_embeds"] = torch.randn((B, cfg.image_tokens, cfg.d_model),
                                          generator=g, device=dev)
    return out


def _prompt(inputs, S) -> dict:
    """The prefill batch of the first S positions (the image whole)."""
    return {k: (v if k == "image_embeds" else v[:, :S])
            for k, v in inputs.items()}


def _step_batch(inputs, t, nxt) -> dict:
    """Decode step t's batch: the greedy tokens ``nxt`` (B,) — an audio
    config's frame t instead — and a VLM's image, every step."""
    b = {k: v for k, v in inputs.items() if k == "image_embeds"}
    if "embeds" in inputs:
        b["embeds"] = inputs["embeds"][:, t:t + 1]
    else:
        b["tokens"] = nxt[:, None]
    return b


def _attention_calls(cfg) -> int:
    """Attention kernel launches of one forward: a self-attention and a
    cross-attention layer launch it once each."""
    return sum(cfg.is_attn_layer(i) + cfg.is_cross_attn_layer(i)
               for i in range(cfg.num_layers))


def _lm_serve_run(torch, dev, model, params, B, S, steps, seed,
                  routing=False) -> tuple:
    """One LM's serving path on the card: a warm-up prefill of B prompts of
    S random tokens (an audio config's frames; a VLM's with seeded image
    embeddings, ``_lm_inputs``), SERVE_PREFILL_REPS timed prefills of the
    same size (the median reported; each frees the last one's outputs
    first), ``steps`` greedy decode steps from the last one's caches (an
    audio config fed the next frames), one more step under
    ``torch.profiler`` and a profiled prefill.  The attention-kernel count
    is set to 0 before the timed prefills and read after the decode steps:
    each call must launch it once a self-attention and once a
    cross-attention layer.  With ``routing`` (an MoE layer in the arch), a
    separate prefill under ``RoutingRecorder`` gives each MoE layer's
    largest and smallest expert group, and one under CUDA events the MoE
    layers' share.  Returns (record, inputs)."""
    import statistics

    from repro_torch.kernels.flash_attention import flash_attention

    cfg = model.cfg
    n_attn = _attention_calls(cfg)
    inputs = _lm_inputs(torch, dev, cfg, B, S, steps, seed)
    batch = _prompt(inputs, S)
    with torch.no_grad():
        model.prefill(params, batch)                    # warm-up, full size
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        prefill_ms, logits, pre = [], None, None
        for _ in range(SERVE_PREFILL_REPS):
            logits = pre = None
            t0 = time.perf_counter()
            logits, pre = model.prefill(params, batch)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        prefill_launches = flash_attention.launches
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name} prefill: non-finite logits")
        cache = model.init_cache(B, S + steps)
        _place(cache, pre)
        nxt = logits[:, -1].argmax(-1)
        del pre, logits
        step_ms = []
        for t in range(steps):
            t0 = time.perf_counter()
            lg, cache = model.decode_step(
                params, cache, _step_batch(inputs, S + t, nxt), S + t)
            nxt = lg[:, -1].argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(lg).all()),
                  f"{cfg.name} decode step {t}: non-finite logits")
        launches = flash_attention.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(prefill_launches == n_attn * SERVE_PREFILL_REPS,
              f"{cfg.name}: {SERVE_PREFILL_REPS} prefills launched the "
              f"attention kernel {prefill_launches} times, not "
              f"{n_attn * SERVE_PREFILL_REPS}")
        check(launches - prefill_launches == n_attn * steps,
              f"{cfg.name}: {steps} decode steps launched the attention "
              f"kernel {launches - prefill_launches} times, not "
              f"{n_attn * steps}")
        cache_bytes = sum(t.numel() * t.element_size()
                          for c in cache.values() for t in c.values()) // B

        def one_step():
            out = model.decode_step(
                params, cache, _step_batch(inputs, S + steps - 1, nxt),
                S + steps - 1)
            torch.cuda.synchronize()        # the wall clock sees it all
            return out

        def one_prefill():
            out = model.prefill(params, batch)[0][:, -1]
            torch.cuda.synchronize()
            return out

        _, wall_ms, by_op, busy_ms = device_profile(torch, one_step)
        step_ops = device_ops(torch, one_step)[0]
        del cache, lg
        torch.cuda.empty_cache()
        _, pwall, pby_op, pbusy = device_profile(torch, one_prefill)
        moe_rec = {}
        if routing:
            with RoutingRecorder() as rr:
                model.prefill(params, batch)
            groups = []
            for topi, _ in rr.calls:
                c = torch.bincount(topi.reshape(-1),
                                   minlength=cfg.num_experts)
                groups.append([int(c.max()), int(c.min())])
            n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
            check(len(groups) == n_moe,
                  f"{cfg.name} prefill routed {len(groups)} layers")
            del rr
            total_ms, moe_ms, moe_calls = _moe_share(torch, model, params,
                                                     batch)
            moe_rec = {"expert_groups_max_min_by_layer": groups,
                       "moe_share_of_prefill": moe_ms / total_ms,
                       "prefill_event_ms": total_ms,
                       "moe_layers_event_ms": moe_ms,
                       "moe_calls": moe_calls}
    ms_sorted = sorted(step_ms)
    med = ms_sorted[len(ms_sorted) // 2]
    pre_med = statistics.median(prefill_ms)
    rec = {"batch": B, "prompt": S, "steps": steps,
           "inputs": {k: list(v.shape) for k, v in inputs.items()},
           "attention_calls_per_forward": n_attn,
           "prefill_ms": pre_med, "prefill_ms_all": prefill_ms,
           "prefill_tokens_per_s": B * S / pre_med * 1e3,
           "decode_ms_median": med, "decode_ms_min": ms_sorted[0],
           "decode_ms_max": ms_sorted[-1],
           "decode_tokens_per_s": B * 1e3 / med,
           "decode_step_device_busy_ms": busy_ms,
           "decode_step_profiled_wall_ms": wall_ms,
           "decode_idle_share": 1 - busy_ms / wall_ms,
           "decode_step_device_ops": step_ops,
           "decode_top_ops_ms": top_ops(by_op, 5),
           "peak_gb": peak_gb, "cache_bytes_per_sequence": cache_bytes,
           "attention_launches": launches,
           "prefill_launches": prefill_launches,
           **moe_rec,
           "profiled_prefill": {"wall_ms": pwall, "busy_ms": pbusy,
                                "busy_share": pbusy / pwall,
                                "top_ops_ms": top_ops(pby_op, 6)}}
    return rec, inputs


def _lm_continuity(torch, dev, cfg, inputs, steps, routing=False) -> dict:
    """A float32 model's decode continues one prefill: prefill the prompts
    of ``inputs`` (``_lm_inputs``'s), ``steps`` greedy decode steps (an
    audio config fed the next frames), then one prefill over all the
    positions; the decode logits within LM_TOL of the long prefill's and
    the greedy tokens equal.  With ``routing`` (an MoE arch) the experts of
    each decoded position are compared with the long prefill's: a flip must
    be a near-tie (gap < MOE_FLIP_GAP), and a row is compared no further
    from its first flip."""
    import contextlib

    from repro_torch.models import build

    model = build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    S = (inputs["tokens"].shape[1] if "tokens" in inputs
         else inputs["embeds"].shape[1] - steps)
    B = next(iter(inputs.values())).shape[0]

    def recorder():
        return RoutingRecorder() if routing else contextlib.nullcontext()

    with torch.no_grad():
        logits, pre = model.prefill(params, _prompt(inputs, S))
        cache = model.init_cache(B, S + steps)
        _place(cache, pre)
        del pre
        fed = [logits[:, -1].argmax(-1)]
        last_prefill = logits[:, -1].clone()
        del logits
        dec, dec_routes = [], []
        for t in range(steps):
            with recorder() as rec:
                lg, cache = model.decode_step(
                    params, cache, _step_batch(inputs, S + t, fed[-1]),
                    S + t)
            if routing:
                dec_routes.append([c[0] for c in rec.calls])
            dec.append(lg[:, 0])
            fed.append(lg[:, 0].argmax(-1))
        del cache
        torch.cuda.empty_cache()
        dec = torch.stack(dec, 1)                           # (B, steps, V)
        whole = dict(inputs)
        if "tokens" in inputs:
            whole["tokens"] = torch.cat([inputs["tokens"],
                                         torch.stack(fed[:-1], 1)], 1)
        with recorder() as rec:
            full = model.prefill(params, whole)[0]
    flip = torch.zeros((B, steps), dtype=torch.bool, device=dev)
    flip_gaps = []
    for layer, (topi, gap) in enumerate(rec.calls if routing else ()):
        want = topi.view(B, S + steps, -1)[:, S:].sort(-1).values
        got = torch.stack([r[layer] for r in dec_routes], 1).sort(-1).values
        diff = (got != want).any(-1)
        flip |= diff
        flip_gaps += gap.view(B, S + steps)[:, S:][diff].tolist()
    check(all(g < MOE_FLIP_GAP for g in flip_gaps), f"{cfg.name} float32: "
          f"decode routed other experts than the prefill at gaps "
          f"{flip_gaps}, not near-ties (< {MOE_FLIP_GAP})")
    keep = torch.cumsum(flip.int(), 1) == 0          # rows up to a flip
    ref = full[:, S:]
    err = _check_close(f"{cfg.name} float32 decode", "logits vs prefill",
                       dec[keep], ref[keep], LM_TOL)
    last_err = _check_close(f"{cfg.name} float32 prefill", "last logits vs "
                            "the longer prefill", last_prefill,
                            full[:, S - 1], LM_TOL)
    same = torch.equal(dec.argmax(-1)[keep], ref.argmax(-1)[keep])
    check(same, f"{cfg.name} float32: decode's greedy tokens differ from "
          f"the prefill's")
    rec32 = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": "float32",
             "batch": B, "tokens": S + steps, "logits_err": err,
             "last_prefill_logits_err": last_err, "greedy_equal": same,
             "positions_compared": int(keep.sum()), "positions": B * steps}
    if routing:
        rec32.update(routing_flips=len(flip_gaps), flip_gaps=flip_gaps)
    del params, model, full, ref, dec
    torch.cuda.empty_cache()
    return rec32


def _serve_arch(torch, dev, cfg, runs, seed, note="", probe=None) -> tuple:
    """``cfg`` at full width on the card (seeded random weights): one
    ``_lm_serve_run`` for each (B, S, steps) of ``runs``; then ``probe(model,
    params, inputs)``, if given, adds its record's keys on the first run's
    inputs.  Returns the record and the first run's inputs."""
    from repro_torch.checkpoint.ckpt import tree_flatten
    from repro_torch.models import build

    shapes = ", ".join(f"{B} x {S} + {st} steps" for B, S, st in runs)
    print(f"{cfg.family} serving: {cfg.name} {cfg.num_layers} layers "
          f"{_arch_line(cfg)}; {shapes}{note}")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in tree_flatten(params)[0]),
           "init_params_s": init_s, "runs": []}
    first = None
    for B, S, steps in runs:
        run, inputs = _lm_serve_run(torch, dev, model, params, B, S, steps,
                                    seed + S, routing=cfg.num_experts > 0)
        rec["runs"].append(run)
        first = inputs if first is None else first
    if probe is not None:
        with torch.no_grad():
            rec.update(probe(model, params, first))
    del params, model
    torch.cuda.empty_cache()
    return rec, first


def moe_serving_phase(torch, dev, report):
    """The MoE LM's serving path on the card at full width: qwen2-moe (24
    layers, bf16) prefills 8 prompts of 2,048 random tokens and takes 32
    greedy decode steps; a float32 copy on 4 layers continues one prefill;
    qwen3-moe at full width on 4 of its 94 layers prefills 2 prompts of
    2,048 and decodes 8 steps."""
    from repro_torch.configs.registry import ARCHS

    cfg = ARCHS[MOE_ARCH]
    rec, inputs = _serve_arch(torch, dev, cfg,
                              [(MOE_BATCH, MOE_PROMPT, MOE_STEPS)], 0)
    print("moe serving " + json.dumps(rec))
    report["moe_serving"] = rec
    print(f"moe continuity tolerance (rtol, atol): {LM_TOL}: "
          f"{LM_TOL_REASON}; routing flips must be near-ties (gap < "
          f"{MOE_FLIP_GAP})")
    rec32 = _lm_continuity(
        torch, dev, dataclasses.replace(cfg, num_layers=MOE_CONT_LAYERS,
                                        dtype="float32"),
        inputs, MOE_STEPS, routing=True)
    print("moe continuity " + json.dumps(rec32))
    report["moe_continuity"] = rec32
    cfg3 = dataclasses.replace(ARCHS[QWEN3_ARCH], num_layers=QWEN3_LAYERS)
    rec3, _ = _serve_arch(torch, dev, cfg3,
                          [(QWEN3_BATCH, QWEN3_PROMPT, QWEN3_STEPS)], 2,
                          "; depth cut from 94 layers, full width")
    print("moe serving (qwen3) " + json.dumps(rec3))
    report["moe_serving_qwen3"] = rec3


def _ep_rank(mesh, seed):
    """One rank of the EP phase: the qwen2-moe layer (the same seeded
    weights and tokens on every rank), the TP form on the global tokens,
    and the EP form dropless and at cf 2.0, with this rank's drops and
    routing flips (its shard's routing against the full batch's)."""
    import statistics

    import torch

    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import moe
    from repro_torch.parallel.moe_ep import (
        capacity, dispatch_slots, moe_apply_ep, token_shard,
    )

    cfg = ARCHS[MOE_ARCH]
    dev, D, k = mesh.device, cfg.d_model, cfg.experts_per_token
    g = torch.Generator(device=dev).manual_seed(seed)
    p = moe.moe_init(g, D, cfg.d_ff, cfg.num_experts, cfg.num_shared_experts,
                     cfg.shared_expert_ff, torch.bfloat16)
    B, S = EP_BATCH, EP_SEQ
    x = torch.randn((B, S, D), generator=g, device=dev).to(torch.bfloat16)
    E_pad = p["w_gate"].shape[0]
    out = {"rank": mesh.rank}
    with torch.no_grad():
        tp = moe.moe_apply(p, x, experts_per_token=k)
        b0, Bl, s0, Sl = token_shard(mesh, B, S)
        T = Bl * Sl
        xt = x[b0:b0 + Bl, s0:s0 + Sl].reshape(T, D)
        _, topi = moe.route(p["router"], xt, k)
        _, topi_all = moe.route(p["router"], x.reshape(-1, D), k)
        mine = topi_all.view(B, S, k)[b0:b0 + Bl, s0:s0 + Sl].reshape(T, k)
        flips = (topi.sort(-1).values != mine.sort(-1).values).any(-1)
        order, _ = moe.sort_pairs(topi)
        tp_loc = tp[b0:b0 + Bl, s0:s0 + Sl].reshape(T, D).float()
        rms = float(tp_loc.pow(2).mean().sqrt())
        for name, cf in (("dropless", cfg.num_experts / k),
                         ("cf2", cfg.moe_capacity_factor)):
            C = capacity(cf, T, k, cfg.num_experts)
            _, _, keep = dispatch_slots(topi, order, E_pad, C)
            kept = torch.empty_like(keep)
            kept[order] = keep
            whole = kept.view(T, k).all(-1) & ~flips   # tokens to compare
            y = moe_apply_ep(p, x, experts_per_token=k, mesh=mesh,
                             capacity_factor=cf)
            ms = []
            for _ in range(EP_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                moe_apply_ep(p, x, experts_per_token=k, mesh=mesh,
                             capacity_factor=cf)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            y_loc = y[b0:b0 + Bl, s0:s0 + Sl].reshape(T, D).float()
            diff = (y_loc - tp_loc).abs()
            bad = diff > EP_RTOL * tp_loc.abs() + EP_ATOL_RMS * rms
            out[name] = {
                "capacity_factor": cf, "capacity": C,
                "pairs": T * k, "dropped_pairs": int((~keep).sum()),
                "tokens_with_a_drop": int((~kept.view(T, k).all(-1)).sum()),
                "tokens_compared": int(whole.sum()),
                "violations": int(bad[whole].sum()),
                "max_abs_err": float(diff[whole].max()),
                "tp_rms": rms, "ms": statistics.median(ms), "ms_all": ms,
                # each rank's dispatch buffer, sent out and back
                "a2a_bytes_per_exchange": E_pad * C * D * 2,
                "finite": bool(torch.isfinite(y).all())}
        out["routing_flips"] = int(flips.sum())
        out["tokens"] = T
    return out


def moe_ep_phase(torch, report):
    """The expert-parallel MoE on a (1, 4) mesh of ranks sharing the card
    (gloo): one qwen2-moe MoE layer at full width, 8 x 2,048 tokens, against
    the TP form, dropless and at the config's capacity factor."""
    from repro_torch.launch.mesh import spawn_mesh

    t0 = time.perf_counter()
    print(f"moe ep: {MOE_ARCH} one MoE layer at full width on a "
          f"{EP_MESH} mesh (ranks share the card over gloo), "
          f"{EP_BATCH} x {EP_SEQ} tokens; tolerance |ep - tp| <= "
          f"{EP_RTOL} |tp| + {EP_ATOL_RMS} rms(tp) on tokens with no dropped "
          f"pair and no routing flip between the shard's and the batch's "
          f"router products")
    ranks = spawn_mesh(_ep_rank, *EP_MESH, device="cuda", args=(5,),
                       timeout=600)
    rec = {"mesh": list(EP_MESH), "batch": EP_BATCH, "seq": EP_SEQ,
           "routing_flips": sum(r["routing_flips"] for r in ranks),
           "phase_s": time.perf_counter() - t0}
    for name in ("dropless", "cf2"):
        rows = [r[name] for r in ranks]
        pairs = sum(x["pairs"] for x in rows)
        rec[name] = {
            "capacity_factor": rows[0]["capacity_factor"],
            "capacity": rows[0]["capacity"],
            "dropped_pairs": sum(x["dropped_pairs"] for x in rows),
            "dropped_share": sum(x["dropped_pairs"] for x in rows) / pairs,
            "tokens_with_a_drop": sum(x["tokens_with_a_drop"] for x in rows),
            "tokens_compared": sum(x["tokens_compared"] for x in rows),
            "violations": sum(x["violations"] for x in rows),
            "max_abs_err": max(x["max_abs_err"] for x in rows),
            "tp_rms": rows[0]["tp_rms"],
            "ms_per_layer_by_rank": [x["ms"] for x in rows],
            "a2a_bytes_per_rank": 2 * rows[0]["a2a_bytes_per_exchange"],
            "a2a_bytes_all_ranks": 2 * sum(x["a2a_bytes_per_exchange"]
                                           for x in rows)}
        check(all(x["finite"] for x in rows), f"moe ep {name}: non-finite")
        check(rec[name]["violations"] == 0, f"moe ep {name}: "
              f"{rec[name]['violations']} elements differ from the TP form "
              f"(max {rec[name]['max_abs_err']})")
    check(rec["dropless"]["dropped_pairs"] == 0,
          "moe ep: the dropless capacity dropped pairs")
    check(rec["routing_flips"] <= EP_BATCH * EP_SEQ // 500,
          f"moe ep: {rec['routing_flips']} routing flips")
    print("moe ep " + json.dumps(rec))
    report["moe_ep"] = rec


def ssm_serving_phase(torch, dev, report):
    """The Mamba2 LM's serving path at full width and depth: 8 prompts of
    2,048 tokens with 32 decode steps, then one prompt of 32,768 tokens with
    64 steps (the state of a sequence must not grow with its length); then
    a float32 copy's decode continues one prefill of the first run's first
    SSM_CONT_BATCH prompts."""
    from repro_torch.configs.registry import ARCHS

    cfg = ARCHS[SSM_ARCH]
    rec, inputs = _serve_arch(torch, dev, cfg,
                              [(SSM_BATCH, SSM_PROMPT, SSM_STEPS),
                               (1, SSM_LONG, SSM_LONG_STEPS)], 0,
                              "; prefill_32k's batch of 32 cut to 1")
    state = [r["cache_bytes_per_sequence"] for r in rec["runs"]]
    check(state[0] == state[1], f"mamba2: the state of a sequence grew with "
          f"its length: {state} bytes")
    print("ssm serving " + json.dumps(rec))
    report["ssm_serving"] = rec
    rec32 = _lm_continuity(torch, dev,
                           dataclasses.replace(cfg, dtype="float32"),
                           {k: v[:SSM_CONT_BATCH] for k, v in inputs.items()},
                           SSM_STEPS)
    print("ssm continuity " + json.dumps(rec32))
    report["ssm_continuity"] = rec32


def vlm_serving_phase(torch, dev, report):
    """The VLM's serving path at full width and depth: llama-3.2-vision-11b
    (40 layers, 8 of them cross-attending to 1,601 seeded image
    embeddings a prompt; bf16) prefills 8 prompts of 2,048 tokens and takes
    32 greedy decode steps, each recomputing the cross layers' keys and
    values from the image embeddings (no cross cache, as in the JAX
    package); then a float32 copy on one super-block (5 layers, one cross
    layer) continues one prefill of CONT_BATCH prompts."""
    from repro_torch.configs.registry import ARCHS

    cfg = ARCHS[VLM_ARCH]

    def cross_kv(model, params, inputs):
        """What a decode step recomputes that a cross K/V cache would hold:
        every cross layer's K and V projections of the image embeddings,
        timed alone by CUDA events, and the bytes such a cache would
        take."""
        img = model.image_embeds(inputs)
        xs = [params["blocks"][f"l{j}"]["xattn"] for j in range(model.period)
              if cfg.is_cross_attn_layer(j)]

        def recompute():
            for p in xs:
                for b in range(model.nblocks):
                    img @ p["wk"][b]
                    img @ p["wv"][b]
        n = len(xs) * model.nblocks
        kv = img.shape[0] * img.shape[1] * cfg.num_kv_heads * cfg.hd
        return {"cross_kv_recompute_ms_per_step": cuda_time_ms(recompute, 5),
                "cross_kv_cache_bytes": 2 * n * kv * img.element_size()}

    rec, inputs = _serve_arch(
        torch, dev, cfg, [(VLM_BATCH, VLM_PROMPT, VLM_STEPS)], 0,
        f"; {VLM_BATCH} x {cfg.image_tokens} seeded image embeddings "
        f"(decode_32k's batch and cache cut to one card)", probe=cross_kv)
    run = rec["runs"][0]
    rec["cross_kv_recompute_share_of_decode_busy"] = (
        rec["cross_kv_recompute_ms_per_step"]
        / run["decode_step_device_busy_ms"])
    n_self = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
    n_cross = sum(cfg.is_cross_attn_layer(i) for i in range(cfg.num_layers))
    rec.update(self_attention_layers=n_self, cross_attention_layers=n_cross)
    check(run["attention_calls_per_forward"] == n_self + n_cross,
          f"vlm: {run['attention_calls_per_forward']} attention calls a "
          f"forward, not {n_self} self + {n_cross} cross")
    print("vlm serving " + json.dumps(rec))
    report["vlm_serving"] = rec
    print(f"vlm continuity tolerance (rtol, atol): {LM_TOL}: "
          f"{LM_TOL_REASON}")
    rec32 = _lm_continuity(
        torch, dev, dataclasses.replace(cfg, num_layers=VLM_CONT_LAYERS,
                                        dtype="float32"),
        {k: v[:CONT_BATCH] for k, v in inputs.items()}, VLM_STEPS)
    print("vlm continuity " + json.dumps(rec32))
    report["vlm_continuity"] = rec32


def audio_serving_phase(torch, dev, report):
    """The audio LM's serving path at full width and depth: musicgen-medium
    (48 layers, MHA: 24 heads of 64 over 24; bf16) prefills 8 x 2,048 seeded
    frame embeddings and takes 32 decode steps, each fed the next seeded
    frame; then a float32 copy at full depth continues one prefill of
    CONT_BATCH sequences over the same frames."""
    from repro_torch.configs.registry import ARCHS

    cfg = ARCHS[AUDIO_ARCH]
    rec, inputs = _serve_arch(
        torch, dev, cfg, [(AUDIO_BATCH, AUDIO_PROMPT, AUDIO_STEPS)], 0,
        "; decode fed seeded frames (the EnCodec frontend is a stub in both "
        "packages)")
    print("audio serving " + json.dumps(rec))
    report["audio_serving"] = rec
    rec32 = _lm_continuity(torch, dev,
                           dataclasses.replace(cfg, dtype="float32"),
                           {k: v[:CONT_BATCH] for k, v in inputs.items()},
                           AUDIO_STEPS)
    print("audio continuity " + json.dumps(rec32))
    report["audio_continuity"] = rec32


def hybrid_serving_phase(torch, dev, report):
    """The hybrid stack's serving path: jamba on one super-block of 8 layers
    (attention at j = 4, Mamba2 elsewhere, MoE on odd j) at its attention
    and SSM widths with 16 experts top-2 and d_ff cut to HYBRID_FF, bf16:
    2 prompts of 2,048, 8 decode steps writing K/V and SSM state in place in
    one block's caches; then a float32 copy at d_ff HYBRID_CONT_FF
    continues one prefill (routing flips between decode and prefill must
    be near-ties)."""
    from repro_torch.configs.registry import ARCHS

    full = ARCHS[HYBRID_ARCH]
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS, d_ff=HYBRID_FF)
    cut = (f"; cut: depth {full.num_layers} -> {HYBRID_LAYERS} layers (one "
           f"super-block), d_ff {full.d_ff} -> {HYBRID_FF} (the MLP and each "
           f"expert; {full.num_experts} experts kept: pad_experts rounds any "
           f"fewer up to 16)")
    rec, inputs = _serve_arch(
        torch, dev, cfg, [(HYBRID_BATCH, HYBRID_PROMPT, HYBRID_STEPS)], 0, cut)
    rec["cut"] = cut[2:]
    check(rec["runs"][0]["attention_calls_per_forward"] == 1,
          "hybrid: one attention layer in 8 must launch the kernel")
    print("hybrid serving " + json.dumps(rec))
    report["hybrid_serving"] = rec
    print(f"hybrid continuity tolerance (rtol, atol): {LM_TOL}; routing "
          f"flips must be near-ties (gap < {MOE_FLIP_GAP})")
    rec32 = _lm_continuity(
        torch, dev, dataclasses.replace(cfg, d_ff=HYBRID_CONT_FF,
                                        dtype="float32"),
        inputs, HYBRID_STEPS, routing=True)
    print("hybrid continuity " + json.dumps(rec32))
    report["hybrid_continuity"] = rec32


def dense_moe(forced):
    """A context in which ``moe.moe_apply`` — the LM's MoE layer — is a
    dense MoE: every logical expert's SwiGLU on every token, weighted by its
    routing weight (zero where the expert is not among the token's k), plus
    the shared expert; no sort, no groups, no combine.  The experts are
    ``forced``'s, call by call (another path's float32 sums may break a
    near-tie the other way); the gaps of the tokens whose own top-k differs
    go into the list the context yields."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from repro_torch.models import moe

    @contextlib.contextmanager
    def swapped():
        real, calls, gaps = moe.moe_apply, iter(forced), []

        def apply(p, x, *, experts_per_token, router_weights_norm=True):
            B, S, D = x.shape
            k = experts_per_token
            xt = x.reshape(B * S, D)
            probs = torch.softmax(xt.float() @ p["router"], dim=-1)
            top = probs.topk(k + 1, dim=-1)
            topi = next(calls)
            diff = (top.indices[:, :k].sort(-1).values
                    != topi.sort(-1).values).any(-1)
            gaps.extend((top.values[:, k - 1] - top.values[:, k])[diff]
                        .tolist())
            w = probs.gather(1, topi)
            if router_weights_norm:
                w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
            dense = torch.zeros_like(probs).scatter(1, topi, w)
            wg, wu, wd = (p[n].unbind(0) for n in ("w_gate", "w_up",
                                                  "w_down"))
            y = torch.zeros((B * S, D), dtype=torch.float32, device=x.device)
            for e in range(probs.shape[1]):
                a = F.silu(xt @ wg[e]) * (xt @ wu[e])
                y = y + dense[:, e:e + 1] * (a @ wd[e]).float()
            if "shared" in p:
                s = p["shared"]
                y = y + ((F.silu(xt @ s["gate"]) * (xt @ s["up"]))
                         @ s["down"]).float()
            return y.reshape(B, S, D).to(x.dtype)

        moe.moe_apply = apply
        try:
            yield gaps
        finally:
            moe.moe_apply = real
    return swapped()


def sequential_ssd():
    """A context in which ``ssm.ssd_chunked`` — the Mamba2 layer's SSD — is
    the plain recurrence, one position at a time: h_t = exp(dA_t) h_{t-1} +
    x_t B_tᵀ, y_t = h_t C_t (the JAX package's naive test,
    tests/test_models_smoke.py:160)."""
    import contextlib

    import torch

    from repro_torch.models import ssm

    def naive(x, dA, Bm, Cm, chunk, initial_state=None):
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
        ys = []
        for t in range(S):
            h = (h * torch.exp(dA[:, t].float())[..., None, None]
                 + x[:, t].float()[..., None]
                 * Bm[:, t].float()[:, None, None, :])
            ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t].float()))
        return torch.stack(ys, 1).to(x.dtype), h

    @contextlib.contextmanager
    def swapped():
        real = ssm.ssd_chunked
        ssm.ssd_chunked = naive
        try:
            yield
        finally:
            ssm.ssd_chunked = real
    return swapped()


def _moe_slots(model):
    """The (block, sublayer) of each MoE layer of an LM in the order its
    forward pass routes them."""
    return [(b, j) for b in range(model.nblocks)
            for j in range(model.period) if model.cfg.is_moe_layer(j)]


def moe_ssm_training_phase(torch, dev, report):
    """The MoE and SSM training paths: 4 AdamW steps of ``lm_train_step`` on
    one 4,096-token sequence a step, mamba2 at full width and depth and
    qwen2-moe at full width with 4 layers.  Checks: finite losses; every
    weight matrix but the routed experts' moved by step 4; the routed
    experts through their moments, since weight decay moves every slice
    (``RoutingRecorder`` on every step): after step 1 a logical expert's
    first-moment slice is non-zero exactly where it received a token in
    step 1, after step 4 its second-moment slice exactly where it received
    one in any step, and a padded expert's weights and moments stay zero;
    qwen2's step-1 loss within TRAIN_LOSS_RTOL of the same forward through
    the plain attention; qwen2's attention forward and backward launches
    equal to its attention layers a step.  Then, on 2-layer float32 copies
    at full width, the loss and every gradient leaf against the plain path
    (TRAIN_GRAD_TOL of each leaf's largest, the loss within F32_LOSS_RTOL):
    qwen2-moe's kernels and grouped experts against the plain attention and
    ``dense_moe`` on the same 4,096 tokens, mamba2's chunked SSD against
    ``sequential_ssd`` on the first SSM_GRAD_SEQ tokens."""
    import contextlib

    import numpy as np

    from repro_torch.checkpoint.ckpt import tree_flatten
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.synthetic import synthetic_token_stream
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
    )
    from repro_torch.launch.train import lm_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw_init

    S, steps = MOESSM_TRAIN_SEQ, MOESSM_TRAIN_STEPS
    print(f"moe/ssm training tolerances: qwen2 step-1 loss against the plain "
          f"attention rtol {TRAIN_LOSS_RTOL}; 2-layer float32 loss rtol "
          f"{F32_LOSS_RTOL}, gradients {TRAIN_GRAD_TOL} of each leaf's "
          f"largest against the plain path")
    runs, fwd_total, bwd_total, first_batch = {}, 0, 0, {}
    for arch, layers in ((SSM_ARCH, None), (MOE_ARCH, MOE_TRAIN_LAYERS)):
        cfg = ARCHS[arch]
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        is_moe = cfg.family == "moe"
        n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        print(f"moe/ssm training: {cfg.name} {cfg.num_layers} layers "
              f"{_arch_line(cfg)}; 1 x {S} tokens a step, {steps} steps")
        stream = synthetic_token_stream(1, S, cfg.vocab_size, seed=0)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    next(stream).items()} for _ in range(steps)]
        first_batch[arch] = batches[0]
        model = build(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        leaves = tree_flatten(params)[0]
        names = [".".join(map(str, path)) for path in _tree_paths(params)]
        plain = {}
        if n_attn:
            with (torch.no_grad(), plain_attention(),
                  RoutingRecorder() as rr):
                plain["loss"] = model.loss_fn(params, batches[0]).item()
            plain["routes"] = [c[0] for c in rr.calls]
            del rr
            torch.cuda.empty_cache()
        opt = adamw_init(params)
        for p in leaves:
            p.requires_grad_()
        snap = [p.detach().to("cpu", copy=True) for p in leaves]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the tokens each expert received: (nblocks, E_pad) a sublayer, for
        # step 1 and for all steps
        slots = _moe_slots(model) if is_moe else []
        E = cfg.num_experts
        E_pad = (params["blocks"]["l0"]["moe"]["w_gate"].shape[1]
                 if is_moe else 0)
        recv = {j: torch.zeros((model.nblocks, E_pad), dtype=torch.bool,
                               device=dev) for _, j in slots}
        recv1, expert_check, step1_routes = None, {}, None
        flash_attention.launches = 0
        flash_attention_backward.launches = 0
        losses, step_s, launches = [], [], []
        for i, b in enumerate(batches):
            f0, b0 = flash_attention.launches, flash_attention_backward.launches
            t0 = time.perf_counter()
            with (RoutingRecorder() if is_moe
                  else contextlib.nullcontext()) as rr:
                loss, params, opt = lm_train_step(model, params, opt, b,
                                                  total_steps=steps)
                torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
            launches.append([flash_attention.launches - f0,
                             flash_attention_backward.launches - b0])
            if not is_moe:
                continue
            check(len(rr.calls) == len(slots), f"{arch} step {i + 1} routed "
                  f"{len(rr.calls)} layers, not {len(slots)}")
            for (blk, j), (topi, _) in zip(slots, rr.calls):
                got = torch.bincount(topi.reshape(-1), minlength=E_pad) > 0
                recv[j][blk] |= got
            if i == 0:
                step1_routes = [c[0] for c in rr.calls]
                recv1 = {j: r.clone() for j, r in recv.items()}
                expert_check["step1_mu"] = _expert_moments(
                    names, tree_flatten(opt.mu)[0], recv1, E)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fwd_total += flash_attention.launches
        bwd_total += flash_attention_backward.launches
        if is_moe:
            expert_check["step4_nu"] = _expert_moments(
                names, tree_flatten(opt.nu)[0], recv, E)
            expert_check["experts_received_tokens"] = {
                f"l{j}": r[:, :E].sum(1).tolist() for j, r in recv.items()}
            expert_check["experts_received_tokens_step1"] = {
                f"l{j}": r[:, :E].sum(1).tolist() for j, r in recv1.items()}
            for what, res in expert_check.items():
                if what.startswith("step"):
                    check(res["mismatches"] == 0 and res["padded_nonzero"] == 0,
                          f"{arch} training: the expert {what} slices do "
                          f"not follow the routing: {res}")
        unmoved, matrices, padded_nonzero, expert_moved = [], 0, [], {}
        for nm, p, s0 in zip(names, leaves, snap):
            now = p.detach().cpu()
            if nm.endswith(("w_gate", "w_up", "w_down")):
                moved = (now[:, :E] != s0[:, :E]).flatten(2).any(-1)
                expert_moved[nm] = int(moved.sum())
                if now[:, E:].any():
                    padded_nonzero.append(nm)
                continue
            if p.ndim - (1 if nm.startswith("blocks.") else 0) >= 2:
                matrices += 1
                if torch.equal(now, s0):
                    unmoved.append(nm)
        check(all(np.isfinite(losses)), f"{arch} training losses {losses}")
        check(not unmoved, f"{arch} training left {unmoved} unchanged")
        check(not padded_nonzero, f"{arch} training moved the padded "
              f"experts of {padded_nonzero}")
        check(all(f == n_attn and bw == n_attn for f, bw in launches),
              f"{arch} training attention launches a step {launches}, not "
              f"{n_attn} forward and {n_attn} backward")
        steady = sorted(step_s[1:])
        med = steady[len(steady) // 2]
        runs[arch] = {"layers": cfg.num_layers, "dtype": cfg.dtype,
                      "params": sum(p.numel() for p in leaves),
                      "batch": 1, "seq": S, "steps": steps,
                      "losses": losses, "step_s": step_s,
                      "step_s_median_steady": med, "tokens_per_s": S / med,
                      "peak_gb": peak_gb,
                      "attention_launches_per_step": launches,
                      "matrices_moved": matrices - len(unmoved),
                      "matrices": matrices}
        if n_attn:
            err = abs(losses[0] - plain["loss"]) / abs(plain["loss"])
            flips = sum(int((a.sort(-1).values != b.sort(-1).values)
                            .any(-1).sum())
                        for a, b in zip(plain["routes"], step1_routes or []))
            runs[arch].update(plain_attention_loss_step1=plain["loss"],
                              loss_rel_err_step1=err,
                              routing_flips_vs_plain_step1=flips)
            check(err <= TRAIN_LOSS_RTOL, f"{arch} step 1 loss {losses[0]} "
                  f"against the plain attention's {plain['loss']}")
        if is_moe:
            runs[arch].update(expert_slices_moved_by_step4=expert_moved,
                              expert_moments=expert_check)
        del params, opt, snap, leaves, model, loss, batches, plain
        torch.cuda.empty_cache()

    # the loss and every gradient leaf of 2-layer float32 copies against the
    # plain path
    grad_check = {}
    for arch in (SSM_ARCH, MOE_ARCH):
        cfg = dataclasses.replace(ARCHS[arch], num_layers=TRAIN_GRAD_LAYERS,
                                  dtype="float32")
        batch = first_batch[arch]
        if arch == SSM_ARCH:
            batch = {k: v[:, :SSM_GRAD_SEQ] for k, v in batch.items()}
        model = build(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(1))
        leaves = tree_flatten(params)[0]
        names = [".".join(map(str, path)) for path in _tree_paths(params)]
        for p in leaves:
            p.requires_grad_()
        before = flash_attention_backward.launches
        with RoutingRecorder() as rr:
            loss = model.loss_fn(params, batch)
            loss.backward()
        grad_launches = flash_attention_backward.launches - before
        loss_k = loss.item()
        got = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        gaps = []
        if arch == SSM_ARCH:
            ctx = sequential_ssd()
        else:
            ctx = contextlib.ExitStack()
            ctx.enter_context(plain_attention())
            gaps = ctx.enter_context(dense_moe([c[0] for c in rr.calls]))
        with ctx:
            loss = model.loss_fn(params, batch)
            loss.backward()
        loss_p = loss.item()
        grad_err = {}
        for nm, a, p in zip(names, got, leaves):
            a, b = a.float(), p.grad.float()
            grad_err[nm] = ((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30)).item()
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        check(grad_launches == n_attn, f"the 2-layer {arch} backward "
              f"launched the backward kernels {grad_launches} times, not "
              f"{n_attn}")
        check(all(g < MOE_FLIP_GAP for g in gaps), f"the 2-layer {arch}: "
              f"the plain path's own routing differs at gaps {gaps}, not "
              f"near-ties (< {MOE_FLIP_GAP})")
        check(loss_err <= F32_LOSS_RTOL, f"the 2-layer float32 {arch} loss "
              f"{loss_k} against the plain path's {loss_p}")
        bad = {nm: e for nm, e in grad_err.items() if not e <= TRAIN_GRAD_TOL}
        check(not bad, f"2-layer float32 {arch} gradients differ from the "
              f"plain path's: {bad}")
        grad_check[arch] = {
            "layers": TRAIN_GRAD_LAYERS, "seq": batch["tokens"].shape[1],
            "plain_path": ("sequential_ssd" if arch == SSM_ARCH
                           else "plain attention + dense_moe"),
            "loss": loss_k, "plain_loss": loss_p, "loss_rel_err": loss_err,
            "tol": TRAIN_GRAD_TOL, "max_rel_err": max(grad_err.values()),
            "worst_leaf": max(grad_err, key=grad_err.get),
            "leaves": len(grad_err), "routing_near_ties_forced": len(gaps)}
        del params, leaves, got, model, loss, a, b, p, rr
        torch.cuda.empty_cache()
    rec = {"runs": runs, "grad_check": grad_check,
           "forward_launches": fwd_total, "backward_launches": bwd_total}
    print("moe/ssm training " + json.dumps(rec))
    report["moe_ssm_training"] = rec


def vlm_audio_training_phase(torch, dev, report):
    """The audio and VLM training paths: 4 AdamW steps of ``lm_train_step``
    on one 4,096-position sequence a step — musicgen whole on the one-hot
    frames of the JAX ``train_lm`` (``launch.train.lm_batch``), the VLM on
    one super-block (5 of its 40 layers) with seeded image embeddings.
    Checks: finite losses; step 1 (lr 0) leaves every parameter's bits;
    every weight matrix moved by step 4; forward and backward attention
    launches a step equal to the self- plus cross-attention layers; step
    1's loss within TRAIN_LOSS_RTOL of the same forward through the plain
    attention.  Then the loss (F32_LOSS_RTOL) and every gradient leaf
    (TRAIN_GRAD_TOL of its largest) of float32 copies through the kernels
    against the plain attention's autograd: musicgen on AUDIO_GRAD_LAYERS
    layers, the VLM on its super-block (a 2-layer VLM has no cross
    layer)."""
    import numpy as np

    from repro_torch.checkpoint.ckpt import tree_flatten
    from repro_torch.configs.registry import ARCHS
    from repro_torch.data.synthetic import synthetic_token_stream
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward,
    )
    from repro_torch.launch.train import lm_batch, lm_train_step
    from repro_torch.models import build
    from repro_torch.optim import adamw_init

    S, steps = MOESSM_TRAIN_SEQ, MOESSM_TRAIN_STEPS
    print(f"vlm/audio training tolerances: step-1 loss against the plain "
          f"attention rtol {TRAIN_LOSS_RTOL}; float32 loss rtol "
          f"{F32_LOSS_RTOL}, gradients {TRAIN_GRAD_TOL} of each leaf's "
          f"largest against the plain attention")

    def batches_of(cfg, n, seed):
        stream = synthetic_token_stream(1, S, cfg.vocab_size, seed=seed)
        g = torch.Generator(device=dev).manual_seed(seed)
        out = []
        for _ in range(n):
            b = {k: v.to(dev) for k, v in lm_batch(
                cfg, {k: torch.from_numpy(v)
                      for k, v in next(stream).items()}).items()}
            if "image_embeds" in b:         # seeded, not the CLI's 0.01s
                b["image_embeds"] = torch.randn(b["image_embeds"].shape,
                                                generator=g, device=dev)
            out.append(b)
        return out

    runs, fwd_total, bwd_total = {}, 0, 0
    for arch, layers in ((AUDIO_ARCH, None), (VLM_ARCH, VLM_TRAIN_LAYERS)):
        cfg = ARCHS[arch]
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        n_attn = _attention_calls(cfg)
        print(f"vlm/audio training: {cfg.name} {cfg.num_layers} layers "
              f"{_arch_line(cfg)}; 1 x {S} positions a step, {steps} steps")
        batches = batches_of(cfg, steps, 0)
        model = build(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        leaves = tree_flatten(params)[0]
        names = [".".join(map(str, path)) for path in _tree_paths(params)]
        with torch.no_grad(), plain_attention():
            plain_loss = model.loss_fn(params, batches[0]).item()
        torch.cuda.empty_cache()
        opt = adamw_init(params)
        for p in leaves:
            p.requires_grad_()
        snap = [p.detach().to("cpu", copy=True) for p in leaves]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        flash_attention_backward.launches = 0
        losses, step_s, launches = [], [], []
        for i, b in enumerate(batches):
            f0, b0 = flash_attention.launches, flash_attention_backward.launches
            t0 = time.perf_counter()
            loss, params, opt = lm_train_step(model, params, opt, b,
                                              total_steps=steps)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss.item())
            launches.append([flash_attention.launches - f0,
                             flash_attention_backward.launches - b0])
            if i == 0:
                same = [torch.equal(p.detach().cpu(), s0)
                        for p, s0 in zip(leaves, snap)]
                check(all(same), f"{arch} training step 1 (lr 0) changed "
                      + ", ".join(nm for nm, ok in zip(names, same)
                                  if not ok))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        fwd_total += flash_attention.launches
        bwd_total += flash_attention_backward.launches
        unmoved, matrices = [], 0
        for nm, p, s0 in zip(names, leaves, snap):
            if p.ndim - (1 if nm.startswith("blocks.") else 0) >= 2:
                matrices += 1
                if torch.equal(p.detach().cpu(), s0):
                    unmoved.append(nm)
        check(all(np.isfinite(losses)), f"{arch} training losses {losses}")
        check(not unmoved, f"{arch} training left {unmoved} unchanged")
        check(all(f == n_attn and bw == n_attn for f, bw in launches),
              f"{arch} training attention launches a step {launches}, not "
              f"{n_attn} forward and {n_attn} backward")
        err = abs(losses[0] - plain_loss) / abs(plain_loss)
        check(err <= TRAIN_LOSS_RTOL, f"{arch} step 1 loss {losses[0]} "
              f"against the plain attention's {plain_loss}")
        steady = sorted(step_s[1:])
        med = steady[len(steady) // 2]
        runs[arch] = {"layers": cfg.num_layers, "dtype": cfg.dtype,
                      "params": sum(p.numel() for p in leaves),
                      "batch": 1, "seq": S, "steps": steps,
                      "inputs": {k: list(v.shape)
                                 for k, v in batches[0].items()},
                      "losses": losses, "step_s": step_s,
                      "step_s_median_steady": med, "tokens_per_s": S / med,
                      "peak_gb": peak_gb,
                      "attention_launches_per_step": launches,
                      "attention_calls_per_forward": n_attn,
                      "matrices_moved": matrices - len(unmoved),
                      "matrices": matrices,
                      "plain_attention_loss_step1": plain_loss,
                      "loss_rel_err_step1": err}
        del params, opt, snap, leaves, model, loss, batches
        torch.cuda.empty_cache()

    # the loss and every gradient leaf of float32 copies against the plain
    # attention
    grad_check = {}
    for arch, layers in ((AUDIO_ARCH, AUDIO_GRAD_LAYERS),
                         (VLM_ARCH, VLM_TRAIN_LAYERS)):
        cfg = dataclasses.replace(ARCHS[arch], num_layers=layers,
                                  dtype="float32")
        batch = batches_of(cfg, 1, 1)[0]
        model = build(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(1))
        leaves = tree_flatten(params)[0]
        names = [".".join(map(str, path)) for path in _tree_paths(params)]
        for p in leaves:
            p.requires_grad_()
        before = flash_attention_backward.launches
        loss = model.loss_fn(params, batch)
        loss.backward()
        grad_launches = flash_attention_backward.launches - before
        loss_k = loss.item()
        got = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        with plain_attention():
            loss = model.loss_fn(params, batch)
            loss.backward()
        loss_p = loss.item()
        grad_err = {}
        for nm, a, p in zip(names, got, leaves):
            a, b = a.float(), p.grad.float()
            grad_err[nm] = ((a - b).abs().max()
                            / b.abs().max().clamp_min(1e-30)).item()
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        n_attn = _attention_calls(cfg)
        check(grad_launches == n_attn, f"the {layers}-layer {arch} backward "
              f"launched the backward kernels {grad_launches} times, not "
              f"{n_attn}")
        check(loss_err <= F32_LOSS_RTOL, f"the {layers}-layer float32 {arch} "
              f"loss {loss_k} against the plain attention's {loss_p}")
        bad = {nm: e for nm, e in grad_err.items() if not e <= TRAIN_GRAD_TOL}
        check(not bad, f"{layers}-layer float32 {arch} gradients differ from "
              f"the plain attention's: {bad}")
        grad_check[arch] = {
            "layers": layers, "seq": S, "attention_calls": n_attn,
            "loss": loss_k, "plain_loss": loss_p, "loss_rel_err": loss_err,
            "tol": TRAIN_GRAD_TOL, "max_rel_err": max(grad_err.values()),
            "worst_leaf": max(grad_err, key=grad_err.get),
            "leaves": len(grad_err),
            "cross_leaves_max_rel_err": max(
                (e for nm, e in grad_err.items() if "xattn" in nm),
                default=None)}
        del params, leaves, got, model, loss, a, b, p
        torch.cuda.empty_cache()
    rec = {"runs": runs, "grad_check": grad_check,
           "forward_launches": fwd_total, "backward_launches": bwd_total}
    print("vlm/audio training " + json.dumps(rec))
    report["vlm_audio_training"] = rec


def _expert_moments(names, moments, received, E) -> dict:
    """Each routed-expert leaf's moment slices (one an expert a block)
    against the experts that received a token: a logical expert's slice
    must be non-zero exactly where it did, a padded expert's zero."""
    mismatches, padded, nonzero = 0, 0, 0
    for nm, m in zip(names, moments):
        if not nm.endswith(("w_gate", "w_up", "w_down")):
            continue
        j = nm.split(".")[1]
        nz = m.detach().flatten(2).ne(0).any(-1)          # (nblocks, E_pad)
        want = received[int(j[1:])]
        mismatches += int((nz[:, :E] != want[:, :E]).sum())
        padded += int(nz[:, E:].sum())
        nonzero += int(nz[:, :E].sum())
    return {"mismatches": mismatches, "padded_nonzero": padded,
            "nonzero_slices": nonzero}


def sanitized_phase(torch, store, report):
    """``debug_checks=True`` on the card, through the CUDA kernels: one
    dense sweep of the training corpus's first minibatch on the stream_1k
    store, one ``FOEMTrainer.step`` on it and one served held-out batch,
    each beside the same call without checks (every failed invariant is
    recorded and held to ``SANITIZER_OPEN`` at the end of the run, and a
    raise of it to the rows' rounding, ``phi_gap``); then the planted
    faults, at a small shape, must each raise ``SanitizerError`` with its
    message (``SANITIZER_FAULTS``)."""
    import numpy as np

    from repro_torch.analysis import SanitizerError
    from repro_torch.analysis import sanitizer as san
    from repro_torch.configs import lda_config, lda_shape
    from repro_torch.core import em
    from repro_torch.core.trainer import FOEMTrainer
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import TopicServer
    from repro_torch.sparse import MinibatchStream

    t_phase = time.perf_counter()
    cfg = lda_config(lda_shape("stream_1k"))
    mb = next(iter(MinibatchStream(report["training_corpus"], D_TRAIN,
                                   bucket_len=L_TRAIN, seed=0)))
    rec = {"card": report["card"]}
    # one dense sweep of the minibatch, its uniform μ folded into the
    # store's rows and float32 total as foem_minibatch's first sweep has
    # it, plain and checked: a checked sweep's cost, and how far the
    # kernels' float32 φ̂(k) moves from the rows' column sums (the φ̂
    # totals invariant's two sides) at the store's magnitude
    dev = torch.device("cuda")
    rows = torch.from_numpy(store.fetch_rows(mb.local_vocab)).to(dev)
    ptot = torch.from_numpy(np.asarray(store.phi_k, np.float32)).to(dev)
    wid_b = torch.from_numpy(mb.local_word_ids.astype(np.int32)).to(dev)
    cnt_b = torch.from_numpy(mb.counts.astype(np.float32)).to(dev)
    mu_b = torch.full(tuple(cnt_b.shape) + (K_FULL,), 1.0 / K_FULL,
                      device=dev)
    th_b = em.fold_theta(mu_b, cnt_b).contiguous()
    d_wk, d_k = em.fold_phi(mu_b, cnt_b, wid_b, rows.shape[0])
    rows, ptot = rows + d_wk, ptot + d_k
    del d_wk, d_k
    sargs = (wid_b, cnt_b, mu_b, th_b, rows, ptot)
    skw = dict(alpha_m1=cfg.alpha_m1, beta_m1=cfg.beta_m1,
               wb=cfg.W * cfg.beta_m1, device=dev)
    ops.sweep(*sargs, **skw)                             # warm
    gaps = PhiGaps(torch, every=True)   # the checked sweep, raise or not
    for checks in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with gaps:
            try:
                r = ops.sweep(*sargs, debug_checks=checks, **skw)
                failed = []
            except SanitizerError as e:
                failed = e.failed
        torch.cuda.synchronize()
        tag = "checked" if checks else "plain"
        rec[f"sweep_ms_{tag}"] = (time.perf_counter() - t0) * 1e3
        rec[f"sweep_peak_gb_{tag}"] = torch.cuda.max_memory_allocated() / 1e9
    rec["sweep_failed"] = failed
    # r is the plain sweep's result: the checked one has the same bits
    same = [torch.equal(a, b) for a, b in zip(r, gaps.held[0])
            if a is not None]
    check(all(same), "sanitized phase: a float32 output of the checked "
          f"sweep differs from the plain sweep's ({same})")
    rec["sweep_checked_bitwise"] = all(same)
    rec["phi_gap"] = gaps.take()
    del rows, ptot, wid_b, cnt_b, mu_b, th_b, sargs, r
    torch.cuda.empty_cache()
    for checks in (False, True):
        c = dataclasses.replace(cfg, debug_checks=checks)
        trainer = FOEMTrainer(c, store, seed=0, prefetch_depth=0,
                              device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tag = "checked" if checks else "plain"
        gaps = PhiGaps(torch)               # the sweep that raised, if any
        t0 = time.perf_counter()
        failed = []
        with gaps:
            try:
                m = trainer.step(mb)
            except SanitizerError as e:
                # held to SANITIZER_OPEN and the rows' rounding at the end
                # of the run; a raise stops the step at that sweep, before
                # it writes the store
                failed, m = e.failed, None
        torch.cuda.synchronize()
        rec[f"step_s_{tag}"] = time.perf_counter() - t0
        rec[f"step_peak_gb_{tag}"] = torch.cuda.max_memory_allocated() / 1e9
        if checks:
            rec["step_failed"] = failed
            rec["step_phi_gap"] = gaps.take()
        if m is not None:
            rec[f"step_sweeps_{tag}"] = m.sweeps
            check(np.isfinite(m.train_ppl),
                  f"sanitized phase: a {tag} step's perplexity is not finite")
        del trainer
    w, est, ev = report["heldout"]
    for checks in (False, True):
        srv = TopicServer(store, dataclasses.replace(cfg, debug_checks=checks),
                          device="cuda")
        srv.evaluate(w, est, ev)                         # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ppl = srv.evaluate(w, est, ev)
        torch.cuda.synchronize()
        tag = "checked" if checks else "plain"
        rec[f"batch_ms_{tag}"] = (time.perf_counter() - t0) * 1e3
        check(np.isfinite(ppl), f"sanitized phase: {tag} batch perplexity")
    rec["batch_docs"] = int(w.shape[0])
    # the sweep kernels write μ into new buffers: μ_old is the caller's
    # input and the sanitizer keeps no copy of μ or φ̂
    rec["mu_old_bytes"] = 0
    rec["mu_bytes"] = D_TRAIN * L_TRAIN * K_FULL * 4

    # the planted faults, at a small shape, through the kernels
    rng = np.random.default_rng(5)
    D, L, K, W = 8, 10, 64, 40
    wid = rng.integers(0, W, (D, L)).astype(np.int32)
    cnt = rng.integers(0, 5, (D, L)).astype(np.float32)
    mu = rng.dirichlet(np.ones(K), (D, L)).astype(np.float32)
    theta = np.einsum("dlk,dl->dk", mu, cnt).astype(np.float32)
    phi = np.zeros((W, K), np.float32)
    np.add.at(phi, wid.reshape(-1), (cnt[..., None] * mu).reshape(-1, K))
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    wid_t, cnt_t, mu_t, th_t, phi_t = map(t, (wid, cnt, mu, theta, phi))
    ptot_t = phi_t.sum(0)
    kw = dict(alpha_m1=0.01, beta_m1=0.01, wb=W * 0.01, device=dev)
    got = {}

    def fault(name, fn):
        try:
            fn()
        except SanitizerError as e:
            got[name] = str(e)
        check(got.get(name) == SANITIZER_FAULTS[name],
              f"sanitized phase: the {name} fault raised "
              f"{got.get(name)!r}, not {SANITIZER_FAULTS[name]!r}")

    phin = phi_t / phi_t.sum(0, keepdim=True).clamp_min(1e-30)
    phin[int(wid[0, 0])] = float("nan")
    fault("nan_phi_row", lambda: ops.infer(
        wid_t, cnt_t, th_t, phin, alpha_m1=0.01, ev_counts=cnt_t,
        max_sweeps=10, check_every=5, debug_checks=True, device=dev))
    bad = cnt_t.clone()
    bad[0, 0] = -1.0
    fault("negative_count", lambda: ops.sweep(
        wid_t, bad, mu_t, th_t, phi_t, ptot_t, debug_checks=True, **kw))
    r = ops.sweep(wid_t, cnt_t, mu_t, th_t, phi_t, ptot_t, **kw)
    fault("perturbed_phi_k", lambda: san.sweep_invariants(
        r._replace(phi_k=r.phi_k + 1.0), counts=cnt_t, mu_before=mu_t,
        phi_wk_before=phi_t, phi_k_before=ptot_t))
    # the kernel's float64 total short of 0.5 token a topic (no flag in the
    # kernel: the wrapper's caller takes it off the total it got back)
    kernel = ops.gs_sweep

    def dropping(*args, **kwargs):
        out = kernel(*args, **kwargs)
        kwargs["phi_k64"] -= 0.5
        return out

    # the float32 φ̂(k) that the kernel hands back short of 0.5 token a
    # topic, its float64 total intact: the port's own float32 check
    def short(*args, **kwargs):
        out = list(kernel(*args, **kwargs))
        out[4] = out[4] - 0.5
        return tuple(out)

    for name, engine in (("dropped_total64", dropping),
                         ("short_phi_k32", short)):
        ops.gs_sweep = engine
        try:
            fault(name, lambda: ops.sweep(
                wid_t, cnt_t, mu_t, th_t, phi_t, ptot_t, debug_checks=True,
                **kw))
        finally:
            ops.gs_sweep = kernel
    rec["faults"] = got
    rec["seconds"] = time.perf_counter() - t_phase
    print("sanitized " + json.dumps(rec))
    report["sanitized"] = rec


def phi_gap(torch, result, kw) -> dict:
    """The φ̂ lockstep check's two sides in one checked ``ops.sweep``:
    ``result`` and the keywords it handed ``sanitizer.sweep_invariants``
    (the sweep's inputs and the float64 φ̂(k) total its engine carried).
    Δ of the rows' float64 column sums against Δφ̂(k) read from that total
    and from the float32 φ̂(k), each as its worst ratio to the check's
    bound, 10⁻³·(|Δcol| + |Δφ̂(k)| + 1), with the topic, its largest row
    entry, φ̂(k) and row-rounding bound.  That bound, a topic's, is how far
    float32 arithmetic alone can part the two sides: each live token of
    word w adds its Δ to the float32 row φ̂_w once (one add more under a
    model axis, phase D's), and an add rounds by at most a half-ulp, ≤
    2⁻²⁴·M_wk, with M_wk ≥ the entry's magnitude over the sweep (before or
    after, plus the Δ the word moved there, from the eq. 36 residual);
    summed over the words' adds, plus a column increment's other float32
    summation order over the D documents (``sanitizer.sum_order_bound``).
    ``topics_over_bound_and_row_rounding`` counts the topics whose gap is
    over the check's bound and that one together."""
    from repro_torch.analysis.sanitizer import DEFAULT_TOL, sum_order_bound
    from repro_torch.kernels.gs_sweep import segment_sum

    f64 = torch.float64  # lint: host-f64
    rows, ptot = kw["phi_wk_before"], kw["phi_k_before"]
    wid, cnt, total = kw["word_ids"], kw["counts"], kw["phi_k_total"]
    W, K = rows.shape
    d_col = col_sum64(torch, result.phi_wk) - col_sum64(torch, rows)
    adds = torch.bincount(wid[cnt > 0].long(), minlength=W).float()
    if kw.get("axis_name") is not None:
        adds += (adds > 0).float()
    res = result.residual.reshape(-1, K)
    ids = wid.reshape(-1)
    row_bound = torch.empty(K, dtype=f64, device=rows.device)
    for lo in range(0, K, GAP_TOPICS):
        c = slice(lo, min(K, lo + GAP_TOPICS))
        mag = segment_sum(res[:, c].contiguous(), ids, W)
        mag.add_(torch.maximum(rows[:, c].abs(), result.phi_wk[:, c].abs()))
        row_bound[c] = mag.mul_(adds[:, None]).sum(0, dtype=f64)
        del mag
    row_bound.mul_(2.0 ** -24).add_(
        sum_order_bound(cnt.shape[0], res.sum(0, dtype=f64)))
    phi_k64 = ptot.to(f64)
    rec = {"phi_k_mean": float(phi_k64.mean()),
           "phi_k_max": float(phi_k64.max()),
           "phi_row_max": float(rows.max())}
    for name, d_k in (("float64_total", total - phi_k64),
                      ("float32_phi_k", result.phi_k.to(f64) - phi_k64)):
        gap = (d_col - d_k).abs()
        bound = DEFAULT_TOL * (d_col.abs() + d_k.abs() + 1.0)
        ratio = gap / bound
        k = int(ratio.argmax())
        rec[name] = {
            "max_ratio_to_bound": float(ratio[k]), "topic": k,
            "gap_tokens": float(gap[k]), "d_col": float(d_col[k]),
            "topic_phi_k": float(phi_k64[k]),
            "topic_row_max": float(rows[:, k].max()),
            "topic_row_rounding_bound": float(row_bound[k]),
            "topics_over_bound": int((ratio > 1).sum()),
            "topics_over_bound_and_row_rounding": int(
                (gap > bound + row_bound).sum()),
            "max_share_of_row_rounding": float(
                ((gap - bound).clamp_min(0) / row_bound).max()),
            "max_abs_gap": float(gap.max())}
    rec["row_rounding_bound_max"] = float(row_bound.max())
    # the port's float32 check's two sides (sanitizer.check_phi_k_float32)
    rec["phi_k32_minus_total_max_abs"] = float(
        (result.phi_k.to(f64) - total).abs().max())
    return rec


class PhiGaps:
    """``sanitizer.sweep_invariants`` wrapped, inside a ``with``, to hold
    the last checked ``ops.sweep`` that raised (with ``every``, the last
    one at all): its result and the keywords it handed the sanitizer.
    Whatever the sanitizer raises goes on to the caller.  :meth:`take`
    gives the held sweep's :func:`phi_gap` record, or None, and lets the
    sweep go."""

    def __init__(self, torch, every=False):
        from repro_torch.analysis import sanitizer

        self.torch, self.every, self.san = torch, every, sanitizer
        self.held = None

    def __enter__(self):
        real = self.real = self.san.sweep_invariants

        def held(result, **kw):
            passed = False
            try:
                real(result, **kw)
                passed = True
            finally:
                if self.every or not passed:
                    self.held = (result, kw)

        self.san.sweep_invariants = held
        return self

    def __exit__(self, *exc):
        self.san.sweep_invariants = self.real
        return False

    def take(self):
        if self.held is None:
            return None
        result, kw = self.held
        self.held = None
        return phi_gap(self.torch, result, kw)


def analysis_phase(torch, report):
    """The launch contracts against the card: every launch the wrappers
    noted since the start, rebuilt from its contract with the card's
    registers, must equal a configuration the libraries recorded, and
    back; every predicted occupancy must equal the runtime's.  Prints the
    ``analysis`` line: per kernel variant its registers, static and dynamic
    shared memory, spill bytes (the compiler's report), CTAs an SM
    (predicted, card) and grids, with the static check of the reference
    cells."""
    from repro_torch.analysis import card, launches
    from repro_torch.analysis.checks import (
        REFERENCE_CELLS, check_all, summarize,
    )
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    launches.enable(False)
    res = card.check_against_card()
    compiled = card.compiler_report(build.KERNELS)
    for row in res["kernels"]:
        row["spill_bytes"] = compiled.get(row["kernel"], {}).get(
            "spill_bytes")
    for m in res["mismatches"][:40]:
        print(f"analysis mismatch: {m}")
    reference = summarize(check_all(REFERENCE_CELLS))
    rec = {"card": report["card"], "kernels": res["kernels"],
           "noted_launch_configs": res["noted"],
           "recorded_launch_configs": res["recorded"],
           "mismatches": len(res["mismatches"]),
           "reference_cells": reference,
           "compiler_spill_bytes": {k: v["spill_bytes"]
                                    for k, v in compiled.items()},
           "seconds": time.perf_counter() - t0}
    print("analysis " + json.dumps(rec))
    check(not res["mismatches"], f"{len(res['mismatches'])} launch(es) "
          "disagree with their contracts or the card's occupancy")
    check(reference["fail"] == 0, f"reference cells: {reference}")
    sanitized = report["sanitized"]
    sharded = report["sharded_training"]["checked_step"]
    # each checked path at stream_1k: what it raised, and the phi_gap
    # records of the sweeps that raised it (the dense sweep's whatever it
    # raised); the elastic checked run raised nothing, or the run stopped
    paths = {"sweep": (sanitized["sweep_failed"], [sanitized["phi_gap"]]),
             "step": (sanitized["step_failed"], [sanitized["step_phi_gap"]]),
             "sharded step": (sharded["failed"], sharded["phi_gap_by_rank"])}
    for key, (failed, gaps) in paths.items():
        check(set(failed) <= set(SANITIZER_OPEN),
              f"the sanitized stream_1k run ({key}) raised {failed}")
        if not failed:
            continue
        # the open finding (PERF.md §7): what the float64 total still
        # misses must lie, topic by topic, within the float32 rows' own
        # rounding, in every sweep that raised it
        check(all(g is not None for g in gaps),
              f"{key}: a raise with no phi_gap record")
        over = [g["float64_total"]["topics_over_bound_and_row_rounding"]
                for g in gaps]
        check(not any(over), f"{key}: the float64 total misses the phi "
              "lockstep bound by more than the float32 rows' rounding in "
              f"{over} topics: " + json.dumps(gaps))
    for key, (failed, gaps) in paths.items():
        for g in gaps:
            if g is None:
                continue
            t64, t32 = g["float64_total"], g["float32_phi_k"]
            print(f"sanitized ({key}): worst ratio to the phi lockstep "
                  f"bound {t64['max_ratio_to_bound']:.4g} from the float64 "
                  f"total (topic {t64['topic']}, gap {t64['gap_tokens']:.4g} "
                  f"tokens, its rows' rounding bound "
                  f"{t64['topic_row_rounding_bound']:.4g}; "
                  f"{t64['topics_over_bound']} topics over the bound, "
                  f"{t64['topics_over_bound_and_row_rounding']} over it and "
                  "the rows' rounding), "
                  f"{t32['max_ratio_to_bound']:.4g} read from the float32 "
                  f"phi_k ({t32['topics_over_bound']} topics over); "
                  f"failed: {json.dumps(failed)}")
    total = report["sanitized"]["seconds"] + rec["seconds"]
    print(f"analysis phase {total:.1f} s (sanitized runs "
          f"{report['sanitized']['seconds']:.1f} s, contract check "
          f"{rec['seconds']:.1f} s)")
    check(total <= ANALYSIS_BUDGET_S, f"the analysis phase took {total:.1f} "
          f"s, over its {ANALYSIS_BUDGET_S} s")
    report["analysis"] = rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from repro_torch.analysis import launches
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False    # plain version in fp32
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    launches.enable()           # every launch from here is checked at the end
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          + json.dumps(built))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for lib in ("flash_attention", "flash_attention_bwd"):
        sass = attention_sass_counts(lib)
        print(f"attention kernel sass ({lib}; tensor-core instructions): "
              + json.dumps(sass))
        check(sass["HGMMA"] > 0, f"the {lib} library has no HGMMA (wgmma) "
              "instruction: its bf16 path is not on the tensor cores")

    dev = torch.device("cuda")
    report = {"card": card}
    t_start = time.perf_counter()
    kernel_phase(torch, dev, report)
    store_dir = ROOT / "build" / "chip_smoke_store"
    try:
        store, gen = make_store(store_dir, report)
        serving_phase(torch, store, gen, report)
        serving_engine_phase(torch, store, report)
        replica_pool_phase(torch, store, store_dir, report)
        sweep_kernel_phase(torch, dev, store, report)
        training_phase(torch, store, report)
        elastic_phase(torch, report)
        cap = report["store_capacity"]
        sharded_kernel_phase(torch, dev, cap, report)
        sharded_training_phase(torch, cap, report)
        estep_kernel_phase(torch, dev, store, report)
        blocked_training_phase(torch, store, report)
        baselines_kernel_phase(torch, dev, store, report)
        baselines_step_phase(torch, report)
        sanitized_phase(torch, store, report)
        del store
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    dryrun_phase(torch, report)
    torch.cuda.empty_cache()
    lm_dryrun_phase(torch, report)
    parallel_phase(torch, report)
    print(f"lm dryrun phase {report['lm_dryrun']['seconds']:.1f} s, "
          f"parallel phase {report['parallel']['seconds']:.1f} s")
    quickstart_phase(report)
    torch.cuda.empty_cache()
    try:
        lifelong_phase(torch, report)
    finally:
        shutil.rmtree(ROOT / "build" / "chip_smoke_lifelong",
                      ignore_errors=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    attention_kernel_phase(torch, dev, report)
    t1 = time.perf_counter()
    lm_serving_phase(torch, dev, report)
    print(f"attention kernel phase {t1 - t0:.1f} s, lm serving phase "
          f"{time.perf_counter() - t1:.1f} s")
    t0 = time.perf_counter()
    attention_backward_phase(torch, dev, report)
    t1 = time.perf_counter()
    lm_training_phase(torch, dev, report)
    t2 = time.perf_counter()
    lm_cli_phase(report)
    print(f"attention backward phase {t1 - t0:.1f} s, lm training phase "
          f"{t2 - t1:.1f} s, lm cli phase {time.perf_counter() - t2:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_serving_phase(torch, dev, report)
    t1 = time.perf_counter()
    moe_ep_phase(torch, report)
    t2 = time.perf_counter()
    ssm_serving_phase(torch, dev, report)
    t3 = time.perf_counter()
    moe_ssm_training_phase(torch, dev, report)
    print(f"moe serving phase {t1 - t0:.1f} s, moe ep phase {t2 - t1:.1f} "
          f"s, ssm serving phase {t3 - t2:.1f} s, moe/ssm training phase "
          f"{time.perf_counter() - t3:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vlm_serving_phase(torch, dev, report)
    t1 = time.perf_counter()
    audio_serving_phase(torch, dev, report)
    t2 = time.perf_counter()
    hybrid_serving_phase(torch, dev, report)
    t3 = time.perf_counter()
    vlm_audio_training_phase(torch, dev, report)
    print(f"vlm serving phase {t1 - t0:.1f} s, audio serving phase "
          f"{t2 - t1:.1f} s, hybrid serving phase {t3 - t2:.1f} s, vlm/audio "
          f"training phase {time.perf_counter() - t3:.1f} s")
    analysis_phase(torch, report)
    print(f"phases took {time.perf_counter() - t_start:.1f} s")

    f32 = report["variants"][0]
    # the lifelong path's launches (replica and live runs), the replica
    # pool's and the elastic runtime's join the serving and training paths'
    # counts of the same kernels
    life = report["lifelong"]
    life_launches = {k: life["launches"][k] + life["replica_launches"][k]
                     for k in life["launches"]}
    max_err = max(e["max_abs"] for v in report["variants"]
                  for e in v["errors"].values())
    entries = [{
        "name": "theta_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/theta_sweep.cu",
        "replaces": "src/repro/kernels/theta_sweep.py:262",
        # the replica pool's workers report theirs with each batch
        "launches": (report["serving"]["launches"]
                     + life_launches["theta_sweep"]
                     + report["replica_pool"]["theta_sweep_launches"]),
        "max_abs_err": max_err,
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": None,
    }]
    for name, source, replaces in (
            ("gs_sweep", "src/repro_torch/kernels/csrc/gs_sweep.cu",
             "src/repro/kernels/gs_sweep.py:231"),
            ("scheduled_sweep",
             "src/repro_torch/kernels/csrc/scheduled_sweep.cu",
             "src/repro/kernels/scheduled_sweep.py:178")):
        mine = [v for v in report["sweep_variants"] if v["kernel"] == name]
        base = mine[0]                     # the call without the stop rule
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": (report["training"]["launches"][name]
                         + life_launches[name]
                         + report["elastic"]["launches"][name]
                         + report["dryrun"]["launches"][name]),
            # μ_new, the sweep's per-token output (all outputs are in the
            # "sweep kernel" lines)
            "max_abs_err": max(v["errors"]["mu"]["max_abs"] for v in mine),
            "ms": base["ms"],
            "plain_ms": base["plain_ms"],
            "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"],
            "library_ms": None,
        })
    for name, source, replaces in (
            ("sharded_probe", "src/repro_torch/kernels/csrc/sharded_sweep.cu",
             "src/repro/kernels/sharded_sweep.py:174"),
            ("sharded_fold", "src/repro_torch/kernels/csrc/sharded_sweep.cu",
             "src/repro/kernels/sharded_sweep.py:414")):
        mine = [v for v in report["sharded_variants"] if v["kernel"] == name]
        # the scheduled call without the stop rule: 18 of a step's ~20
        # sweeps are scheduled (all variants are in the "sharded kernel"
        # lines)
        base = [v for v in mine if "scheduled" in v["variant"]][0]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": report["sharded_training"]["launches"][name],
            # the probe's (D, L) sums; the fold's μ_new, its per-token
            # output, as for the unsharded sweeps
            "max_abs_err": max(max(e["max_abs"] for e in v["errors"].values())
                               if name == "sharded_probe"
                               else v["errors"]["mu"]["max_abs"]
                               for v in mine),
            "ms": base["ms"],
            "plain_ms": base["plain_ms"],
            "bound_ms": base["bound_ms"],
            "bound_by": base["bound_by"],
            "library_ms": None,
        })
    main = report["estep_main"]      # the blocked sweep's call, T = 16,384
    entries.append({
        "name": "fused_estep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_estep.cu",
        "replaces": "src/repro/kernels/foem_estep.py:64",
        "launches": report["blocked_training"]["launches"]["fused_estep"],
        # μ's error over every call (all are in the "estep kernel" lines)
        "max_abs_err": max(v["errors"]["mu"]["max_abs"]
                           for v in report["estep_lines"]
                           if v["kernel"] == "fused_estep"),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    })
    # topk_estep.cu on the main path is the block loop, one launch a
    # blocked or scan sweep: its B = 8 sweep (both sweeps are in the "topk
    # loop kernel" lines, the slab kernel in the "topk kernel" lines); the
    # error is μ's over both
    loop = report["topk_loop_lines"]
    entries.append({
        "name": "topk_estep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_estep.cu",
        "replaces": "src/repro/kernels/topk_estep.py:53",
        "launches": report["blocked_training"]["launches"]["topk_loop"],
        "max_abs_err": max(v["errors"]["mu"]["max_abs"] for v in loop),
        "ms": loop[0]["ms"],
        "plain_ms": loop[0]["plain_ms"],
        "bound_ms": loop[0]["bound_ms"],
        "bound_by": loop[0]["bound_by"],
        "library_ms": None,
    })
    # the granite prefill call (all calls are in the "attention kernel"
    # lines); the error is the largest of every checked call; the dense,
    # MoE, VLM, audio and hybrid serving and training paths' launches
    main = report["attention_main"]
    entries.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:89",
        "launches": (report["lm_serving"]["attention_launches"]
                     + report["lm_training"]["forward_launches"]
                     + sum(r["attention_launches"] for key in
                           ("moe_serving", "moe_serving_qwen3",
                            "vlm_serving", "audio_serving",
                            "hybrid_serving")
                           for r in report[key]["runs"])
                     + report["moe_ssm_training"]["forward_launches"]
                     + report["vlm_audio_training"]["forward_launches"]
                     + report["lm_dryrun"]["launches"]["flash_attention"]),
        "max_abs_err": max(max(e["max_abs"] for e in v["errors"].values())
                           for v in report["attention_lines"]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    })
    # the attention backward at danube's training shape (every call is in
    # the "attention backward kernel" lines); no TPU kernel: the JAX
    # package's training step lets XLA differentiate its chunked attention
    # under jax.checkpoint; the library call is SDPA's backward
    main = report["attention_backward_main"]
    entries.append({
        "name": "flash_attention_bwd (flash_attention_bwd_delta_kernel, "
                "flash_attention_bwd_dkdv_bf16_kernel, "
                "flash_attention_bwd_dq_bf16_kernel)",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: no TPU kernel (XLA differentiates "
                    "src/repro/models/layers.py:198)",
        "launches": (report["lm_training"]["backward_launches"]
                     + report["moe_ssm_training"]["backward_launches"]
                     + report["vlm_audio_training"]["backward_launches"]
                     + report["lm_dryrun"]["launches"][
                         "flash_attention_backward"]),
        "max_abs_err": max(max(e["max_abs"] for e in v["errors"].values())
                           for v in report["attention_backward_lines"]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
    })
    kernels = {"kernels": entries}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
