"""Drive repro_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero before the result lines):

1. device: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/kernels/csrc`` and the contract checker's fixture
   kernels from ``src/repro_torch/analysis/csrc`` (one nvcc per source,
   in parallel).
1b. the contract checker (``repro_torch.analysis``, ~1 min): its four
   broken fixture kernels (B8 ``clip_gather``, B9 ``lane_cast``, B10
   ``batch_loop``, ``f64_upcast``) bit-equal to their plain versions
   (``batch_loop`` at 1, 33 and 4,096 queries); the self-test, whose
   launches are the fixtures' launch window (all six fixtures caught at
   a ``fixtures.cu`` or ``fixtures.py`` line); every contract over the
   real serving entries in process: host syncs per entry, the recorder
   against ``torch.cuda.set_sync_debug_mode``; each launch's grid, block,
   shared memory and registers; the shared-memory model against ptxas
   and against every profiled launch (the streamed kernel over a 2^25-row
   pool included); the PTX lints of every source.  Fails on a missed
   fixture, a blocking finding past ``analysis/allow.txt``, a model
   drift, or a recorder count below the debug mode's; then each fixture
   kernel timed cold and warm beside its plain version and bound.
2. ``longlat`` at 2^24 keys, half (2^23) bulk-loaded through
   ``NFL(NFLConfig(backend="flat"))`` with the default flow config, its
   training cut from three epochs over a tenth of the loaded keys to one
   epoch over a hundredth (``FLOW_TRAIN``: flow training is host-bound,
   and the smoke must fit its time limit on a slow host), and AutoSwitch
   deciding (rerun with ``force_flow=True`` if it declines the flow, so
   the in-kernel NF serves):
   a. reads: the paper's read-only workload (zipf 0.99), 64 batches of
      65,536, plus one batch of unloaded keys;
   b. writes: the paper's ``write_heavy`` mix (20% reads, 80% inserts of
      unloaded keys), 32 batches of 65,536, below the fold trigger;
      every read checked, then every inserted key read back;
   c. updates and deletes: 65,536 loaded keys updated, 65,536 others
      deleted, then 1,024 more of each and 1,024 inserts, which stay in
      the delta; deleted keys must miss, updated keys read new payloads;
   d. range scans after YCSB workload E: 16 batches of 16,384 ranges,
      lengths uniform in 1-100, start ranks zipfian (0.99) over the live
      keys in positioning (z) order, each range ``[k_r, k_{r+L})``; every
      untruncated range equals the live payloads with z in
      ``[z(k_r), z(k_{r+L}))`` as a multiset;
   e. ``rebuild()`` folds everything; the reads, the deleted-key misses
      and one scan batch are checked again.
   The streamed rung (``pool_budget=0`` on the built index, switched
   with ``dataclasses.replace`` and back):
   s1. after 2a, the 64 read batches and the miss batch again through
       the streamed rung, every read checked; then each read batch
       through both rungs: payloads and z bit-equal; then the root node
       probed with each batch's z through ``ops.index_probe``: where the
       root entry is DATA, its payload is the fused rung's;
   s2. after 2c, the inserted, updated and deleted keys read back through
       the streamed rung;
   s3. after 2e, the router was rebuilt for the folded scan pool, and s1
       again with the deleted keys in place of the misses.
   f. the SLO front end (``serve.frontend.FrontEnd``, ``FE_CFG``: batches
      of up to 4,096, a 1 ms fill timeout, two read batches in flight)
      over the same index: C, the requests/s of a standing burst of
      65,536 point requests (slack deadlines, admission off); P, 131,072
      point requests (zipf 0.99 over the live keys, 1% unloaded keys)
      with Poisson arrivals at 0.5 C and a 20 ms deadline, then the same
      trace at 0.25 C; O, the trace at 2 C with admission on (something
      shed or expired, every completed read on time) and off; M, 1,024
      requests 70% point, 10% range (2d's), 15% insert, 5% delete; F,
      a mixed trace of 1,024 under device and fold stalls over a fold
      started just before it (its write calls tick the fold: every tick
      stalled), and two point-only traces of 4,096 under a transient
      error every 3rd dispatch (retried) and every dispatch (every
      request shed ``"error"``, 1,024 live keys read the same before and
      after).  The JAX plan's ``force_oracle`` has no counterpart.  M and
      F's stall leg are cut to fit the time limit (PERF.md §4).  Each
      leg's batches are logged by ``on_batch_dispatched`` and replayed in
      that order against the live keys with the trace's writes applied
      where they dispatched: 0 wrong results, exact accounting, and P's
      and O's windows launch ``fused_lookup`` once a point batch and
      nothing else.
3. ``lognormal`` at 2^22 keys, 2^21 loaded, ``force_flow=False``: reads
   as in 2a; ``write_heavy`` batches until a fold starts and completes
   in-stream, the rung alternating per batch (even batches fused, odd
   batches streamed), every read checked, those served mid-fold
   included: the phase fails unless streamed reads were served while the
   fold ran and the streamed launches equal the odd batches' read calls
   (no fold verify streamed); 1,024 deletes; one scan batch.
3r. drift and re-flow: phase 3's load again, the flow forced on and
   ``DriftConfig(**DRIFT_KNOBS)`` (``rebuild_frac=1.0``): two plain write
   batches, then 786,432 micro-cluster inserts in ``write_heavy``
   batches and settle batches until a re-flow swaps, an async read in
   flight across every write call of its fold; every live key on both
   rungs and a scan batch in the new z order after it.
4m. boundary migration: phase 3's load through ``NFL(shards=4)``, the
   flow forced on, ``ReshardConfig(**MIGRATE_KNOBS)``; reads of 65,536,
   60% aimed at shard 0, in turns with 786,432 jittered shard-0 inserts
   in batches of 65,536, until the reshard manager migrates ``[0, 1]``;
   an async read in flight across every call; each call inside the
   episode launches exactly one ``fused_lookup`` a verify chunk plus one
   a shard its reads reach; ``B[1]``, ``B[2]`` bit-identical across the
   swap, shards 2 and 3 the same objects with no repack or upload; the
   router's shard ids after the splice equal the host's route of the
   ground-truth z; 1,024 ranges straddling ``B[0]`` before, during and
   after; then a migration whose folds fault (``faults.inject`` of
   ``FaultPlan(fail_reshard="fold")``), rolled back; the card test's swap and freeze under reads
   held on the old shards' streams, in a child process with 32 hardware
   queues (``swap_under_reads_check``: in this process the legacy
   default stream and shared queues would let the reads finish first,
   so the in-flight checks of 4m and 4r cannot see a stream-ordering
   fault); every live key read back.
4r. cross-shard re-flow: phase 3r's drift stream through
   ``NFL(shards=4)``, the flow forced on, ``DriftConfig(**DRIFT_KNOBS)``
   at the default ``rebuild_frac`` (the shards fold on their own; the
   freeze drops those folds), until the re-key swaps; an async read in
   flight across every write call of the episode; the three boundaries
   equal ``choose_boundaries`` of the freeze's live keys under the
   accepted flow (one ``ops.nf_transform_keys`` call), the router's z
   bit-equal to ``nf_forward`` under the new weights, each shard an
   AutoSwitch verdict, every live key read and a scan batch in the new
   z order.  4m and 4r are a cut in depth: 2^21 keys, not phase 4's
   2^23, so the smoke fits its time limit.
4. sharded serving, with the single indexes' tensors freed: phase 2's
   longlat load (same keys, seed and loaded half) through
   ``NFL(NFLConfig(backend="flat", shards=4))``, the four shards on the
   one card, its flow trained as phase 2's (``FLOW_TRAIN``),
   AutoSwitch deciding as in 2 (each shard's
   verdict, key count, depth and pool bytes printed, and the sharded
   verify's repaired keys):
   a. reads: 2a's 64 batches, each in its own launch window (one router
      ``nf_forward``, one ``fused_lookup`` per shard the batch reaches),
      every payload equal to the single index's in 2a, and its misses;
      the router's z bit-equal to the fused rung's on every batch; two
      batches through ``lookup_batch_async``, both in flight before
      either finishes; one batch split into its host steps and one under
      ``torch.profiler`` (do the shards' kernels overlap on the card?);
   b. busy-shard writes: batches of 65,536, 80% inserts of unloaded keys
      that route to shard 1 and 20% reads over all shards, until shard
      1's fold starts and completes in-stream; every read checked, those
      served mid-fold included; no other shard folds; every inserted key
      read back;
   c. 65,536 updates and 65,536 deletes across the shards;
   d. 2d's YCSB-E scans, then one batch of 1,024 ranges per boundary
      starting within 100 ranks below it and ending past it (at least
      3,072 must straddle and merge right);
   e. ``rebuild()``, then the reads, the deleted keys, the misses and one
      scan batch again;
   f. 2f's C, P (65,536 requests, at 0.5 C and 0.25 C) and M (2,048)
      over the four shards:
      P's window launches the router's ``nf_forward`` once a point batch
      and ``fused_lookup`` once for each shard a batch reaches by the
      host route of its ground-truth z; M's ``fused_range_scan`` once
      for each shard a range batch reaches.
   Then ``launch.serve.main(["--mode", "index"])``, plain and with
   ``--fault errors``, in process on the card: each prints its goodput
   line.
5. kernels against their plain PyTorch versions on the card, at the
   main path's shapes: ``nf_forward`` on the bulk-load keys (and beside
   its dense PyTorch equivalent, both cold L2) and on the inserts of
   each ``write_heavy`` batch, bounded by the largest of its bytes, its
   FP32 issue and its SFU operations (counted per key in the SASS of the
   built kernel), its launches on the main path counted by batch size;
   ``fused_lookup`` and ``streamed_lookup`` on the read batches of the
   fresh index, flow on (longlat) and off (lognormal), each timed launch
   by launch over the same 64 distinct batches, each after an L2 flush
   (cold) or after an idle spin (warm), its host issue time apart,
   bounded by the distinct 32-byte sectors its reads touch (the
   streamed kernel by those of its first design's reads, the least the
   work needs, with its own count beside), their ratio printed; both on
   a batch taken while the run and delta hold data and tombstones;
   ``fused_lookup`` also at the fold verify's 4,096 keys (16 chunks in
   key order, no tiers) and, after 2b, both over every read-back
   batch with the run and the delta populated;
   ``index_probe`` on longlat's root node with the read batches' z,
   timed and bounded the same way; ``fused_range_scan`` flow on and off
   on scan batches taken in that state (longlat's 16 batches timed the
   same way, bounded by the sectors of the endpoint searches, the pool
   spans and the probe windows, plus its inputs and output rows).
6. LM serving, falcon-mamba-7b at its full published width, its depth
   cut to 32 of its 64 layers (``LM_DEPTH``; d_model 4096, vocab 65,024,
   bf16) with ``use_scan_kernel=True``,
   random weights on the card from the seed, after the index phases'
   tensors are freed: 16 requests (prompts of 256-2,048 tokens uniform
   over the vocabulary, 32 new tokens each) through the port's
   ``ContinuousBatcher`` with 8 slots until drained; every request must
   finish with 32 tokens, no logit may be NaN or inf, and ``mamba_scan``
   must launch once per layer in every prefill.  Then a teacher-forced replay of 4
   requests at batch 1 (each of the batcher's tokens within 4 bf16 ulps
   of the replay's maximum logit), and the kernel path against the
   chunked path on one 2,048-token prompt: one ``mamba_block`` with
   layer 0's weights in f32 (within 2e-3), and the full model's bf16
   prefill logits (relative L2 under ``LM_LOGIT_REL_L2``, same argmax).
   One decode step of 8 slots runs under ``torch.profiler`` (its device
   operations and device time; informational, it fails nothing).
6d. qwen3-14b at its full published config (40 layers, d_model 5,120,
   40/8 heads of 128, d_ff 17,408, vocab 151,936, bf16, 29.5 GB of
   random weights from the seed), phase 6's tensors freed: phase 6's 16
   requests (prompts of 256-2,048 tokens, 32 new tokens, 8 slots) through
   ``ContinuousBatcher``; every request 32 tokens, no NaN or inf, and
   ``flash_decode`` launched 40 times in every decode step and never in
   a prefill (read around each call); the batch-1 replay of 4 requests
   (4 bf16 ulps, as phase 6); layer 0's decode attention on the kernel
   route against the plain einsum route on the served cache, in f32
   (``FD_TOL``); one decode step on the served cache under
   ``torch.profiler`` (device time and ``flash_decode``'s share,
   informational).
m. the mesh, within ``MESH_BUDGET_S`` (90 s): on 6d's model, m1
   qwen3-14b on the launched (1, 1) mesh against the unsharded route
   (bit-equal, 40 ``flash_decode`` a step), m2 rank 0 of (16, k) under
   fake process groups against the mesh dry run (peak, collective
   bytes, ``flash_decode`` at the rank's heads vs plain), m3 the mesh
   launcher's losses; then, 6d's model freed, m4 granite-moe-1b-a400m,
   falcon-mamba-7b (a prefill, then decode) and zamba2-2.7b on the
   (1, 1) mesh (bit-equal, exact windows), m5 rank 0 of arctic-480b's
   ``decode_32k`` on (16, 16) and of falcon-mamba-7b's ``prefill_32k``
   on (16, k) as m2 (``mamba_scan`` at the rank's channels vs plain),
   m6 as m3 on granite-moe-1b-a400m.  Then, within ``MESH2_BUDGET_S``
   (120 s) of their own, m7 llama-3.2-vision-11b and whisper-medium at
   full width and depth on the (1, 1) mesh against the unsharded route
   (a prefill with stub patches or frames, then 4 decode steps:
   bit-equal, 0 ``flash_decode`` in the prefill and 48 a step), m8 rank
   0 of each one's ``decode_32k`` on (16, 16) as m2 (``flash_decode``
   at the rank's heads over the self and the cross cache vs plain,
   timed beside its bound and SDPA), m9 m5's falcon-mamba-7b leg under
   ``SSMConfig.batch_tp`` on (16, 2) (``mamba_scan`` at the rank's row
   on all 8,192 channels), m10 a ``Trainer`` whose batches carry the
   stub inputs on (1, 1) against none (llama-3.2-vision-11b at 5
   layers, whisper-medium at 2 + 2; losses within 1e-4).
6m. every other architecture at its published widths, one at a time,
   its depth cut (``FAMILY_DEPTH``: gemma2-9b 2 layers, one local and
   one global; phi4-mini and internlm2 2; granite-moe all 24; arctic-480b
   1; zamba2 12, two shared-attention groups; llama-3.2-vision 10, two
   cross groups over 1,601 stub patches; whisper-medium all 24 + 24 over
   1,500 stub frames): the text families serve 4 requests (prompts of
   64-256 tokens, 8 new) through the batcher, vlm and encdec run a
   prefill of 2 prompts of 128 tokens with their stub inputs and 8
   decode steps; finite logits, the token counts, and ``flash_decode``
   launched in each decode step once for every attention on the kernel
   route (gemma2: none, its softcap and local windows take the plain
   route), never in a prefill.
   Then ``ops.flash_decode`` is driven at qwen3-14b's attention shape
   (40 q heads, 8 kv heads, head dim 128) over a 32,768-position bf16
   cache for 16 rows with ragged lengths (0, 1 and S among them).
7. the LM kernels against their plain versions: ``mamba_scan`` on the
   scan inputs of the first layers of the 2,048-token prompt and on a
   ragged L of 1,000, bounded by its bytes or its exponentials (both
   kernels' bounds come from their work functions, ``scan_work`` and
   ``decode_work``, the counts the dry run takes on meta);
   ``flash_decode`` with the bf16 cache and an f32 one, timed beside
   ``scaled_dot_product_attention`` (the library yardstick only), and
   again at B 1 over the cache's row of length S, where the split plan
   matters most; then at every family's decode shape of 6d and 6m (head
   dims 64, 80 and 128, groups 1-7, the vlm and encdec cross caches of
   1,601 and 1,500 positions), and timed beside SDPA at 6d's (B 8, S
   2,080): the kernel table's row; each kernel's plan printed.
8. the paper's backend, the baselines and the page table, after the LM
   phases' tensors are freed:
   q. ``examples/quickstart.py`` steps 1-4 on the port, on the card:
      ``NFL(NFLConfig())`` over 50,000 of 100,000 longlat keys, 10,000
      reads and 10,000 inserts read back, a B-Tree beside it;
   a. ``NFL(NFLConfig())``, the paper's AFLI backend with the default
      flow and training (AutoSwitch deciding; rerun with
      ``force_flow=True`` if it declines), over longlat at 2^20 keys,
      half (2^19) bulk-loaded: 16 ``read_only`` batches of 65,536 (zipf
      0.99) and one of unloaded keys; 4 ``write_heavy`` batches, every
      read checked and every insert read back; 16,384 updates and
      16,384 deletes of loaded keys and updates of absent keys (False);
      ``scan_batch`` must raise; every window launches no kernel (the
      tree is host-side Python, its flow plain PyTorch on the card);
   b. each baseline of ``index.REGISTRY`` (B-Tree, RMI, PGM, ALEX,
      LIPP) on 8a's loaded keys: 8a's first 4 read batches, 16,384
      unloaded keys (misses), 16,384 inserts read back and 4,096
      deletes that miss (RMI is static: its insert must raise; PGM's
      static runs refuse deletes, as in the reference, so its deleted
      keys still read and only the keys in its insert buffer miss);
   c. ``NFLPageTable()`` over ``composite_key`` of 4,096 sessions by
      256 blocks (2^20 keys): every key in lookup calls of 65,536, each
      call's window exactly one ``fused_lookup`` and no ``nf_forward``;
      64 new sessions inserted in calls of 1,024 and read back, the old
      keys again; then a table over 65,536 ``prefix_hash`` keys (16
      random tokens each), whose flow AutoSwitch must decline, every
      key read back.
   8a and 8b are cut in depth (2^19 loaded keys, not the paper's 200 M;
   at 2^20 the phase ran past its 90 s budget on an H100).
t. LM training (budget ``TRAIN_BUDGET_S``, 90 s, printed with the card's
   name and power limit; phase 8's tensors freed first).  No kernel is
   on the training path, so every one of its windows must launch none:
   t1. internlm2-1.8b at its full published config (24 layers, d_model
      2,048, 16/8 heads of 128, d_ff 8,192, vocab 92,544, bf16,
      ``remat="full"``, ``loss_chunk`` 256; 1.89 B parameters) through
      ``Trainer.run``: ``SyntheticTokens`` at 8 x 4,096 tokens as 2
      microbatches of 4, AdamW with a cosine warmup, ``TRAIN_STEPS``
      steps, one window a step; every loss and grad norm finite, the
      first loss within 1 nat of ln 92,544; step ms (median, max),
      tokens/s, 6 N tokens/s against the bf16 dense peak, peak memory,
      stragglers; then one layer's f32 chunked attention at the
      microbatch's shape timed alone, forward and forward + backward,
      and its share of the step extrapolated from that one layer (not
      measured inside the step);
   t2. every architecture's smoke config: ``train_loss`` and each
      gradient leaf on the card against the port on the CPU, f32
      (``TRAIN_CARD_TOL`` of each leaf's scale); ``use_scan_kernel``
      under autograd raises on the card;
   t3. internlm2-1.8b's smoke config: 10 steps, a checkpoint every 5; a
      fresh ``Trainer`` restores step 10 bit for bit and continues to
      16, its losses within ``RESTART_TOL`` of an uninterrupted run's; a
      SIGTERM at step 3 leaves a committed checkpoint of step 4;
      Adafactor 10 steps, its ``vr``/``vc`` of JAX's shapes;
   t4. the port's ``examples/train_lm.py``: 300 steps, the loss down by
      more than 1 nat;
   t5. ``compressed_psum``, ``flash_decode_combine``, ``pipeline_apply``
      and a (1, 1) ``DeviceMesh`` over an NCCL group of world size 1,
      against their plain oracles.
r. three cells on the card beside their own one-card dry run (budget
   ``R_BUDGET_S``, 60 s, printed with the card's name and power limit).
   The dry runs (``python -m repro_torch.launch.dryrun``, counted on the
   meta device) run in processes of their own on the host's CPU beside
   the kernels' build and phase 1b's checks, and are waited for before
   1b's timings, so no phase timed on the host's clock shares the CPU
   with them:
   r1. qwen3-14b ``decode_32k`` at the dry run's per-card batch, on 6d's
      parameters: a zero cache of 32,768 positions, ``cache_len``
      32,767, ``R_DECODE_STEPS`` decode steps (``flash_decode`` once an
      attention a step), one more under ``torch.profiler``; host and
      device ms beside the dry run's ``memory_s``;
   r2. falcon-mamba-7b ``prefill_32k`` at batch 1 on phase 6's model (32
      layers, ``mamba_scan`` once a layer), its ms beside the bound and
      the dry run's per-card batch;
   r3. one more t1 step under ``torch.profiler``, its device time split
      into the f32 attention's ops, the products and the rest (measured
      inside the step), beside the dry run's compute (bf16 and f32
      apart) and memory terms, t1's median step and peak.
   Each cell prints its predicted and measured peaks and their ratio; a
   fit verdict that the card contradicts (predicted to fit and out of
   memory, or not to fit and run) fails, and a cell out of memory as
   predicted records that and measures nothing.  Phase r adds no kernel.
   ``python3 src/repro_torch/smoke_phase.py ROOT r`` runs phase r alone.
9. result lines: the kernel table as JSON, then the final JSON object
   ``{"ok": true, "device": {...}}``.

The launch counters are zeroed just before each driven step (each
front-end leg included) of phases 2, 3, 4, 6, 6d, m, 6m, 8 and t (and the fixtures' before the self-test of 1b) and read
just after; the kernels' launches in phases 1b's contract run, 5 and 7
and those that compute ground truth, replay or compare fall between
those windows and do not count.  Phase t's windows (each driven train step,
the restarts, the example) must launch no kernel.  Every window outside the streamed steps must
launch ``streamed_lookup`` 0 times (``pool_budget`` is None there).

Exits non-zero, printing no result, without a CUDA device or when the
repository's sources are missing.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))
# one set of the card's figures: NVIDIA's H100 SXM5 80GB data sheet and
# the CUDA guide's per-clock rates, beside the dry run's roofline
from repro_torch.utils.roofline import (  # noqa: E402
    FP32_PER_SM_PER_CLOCK, SFU_PER_SM_PER_CLOCK)
from repro_torch.utils.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.utils.roofline import PEAK_BF16 as BF16_PEAK  # noqa: E402

SECTOR = 32                    # bytes per device-memory sector
BATCH = 65536
N_READ_BATCHES = 64
N_WRITE_BATCHES = 32           # longlat write_heavy batches
MAX_FOLD_BATCHES = 64          # lognormal: write batches allowed for a fold
TAIL = 1024                    # writes left in the delta before the scans
VERIFY_CHUNK = 4096            # FlatAFLIConfig.fold_step_keys
N_VERIFY_CHUNKS = 16
SCAN_BATCH = 16384
N_SCAN_BATCHES = 16
SCAN_CAP = 128
LONGLAT_KEYS = 1 << 24         # half bulk-loaded
N_SHARDS = 4                   # phase 4: key-space shards on one card
# phases 2, 3 and 4 train their flows one epoch over a hundredth of the
# loaded keys, not the default three over a tenth: flow training is
# host-bound, and the smoke must fit its time limit on a slow host.  On
# longlat's loaded half AutoSwitch sees the same tails either way (25 ->
# 4 at 2^22, 2^23 and 2^24 loaded keys, on the CPU's plain versions)
FLOW_TRAIN = dict(epochs=1, sample_frac=0.01)
BUSY_SHARD = 1                 # the shard phase 4's inserts aim at
MAX_SHARD_WRITE_BATCHES = 96   # write batches allowed for its fold
STRADDLE = 1024                # phase 4: ranges straddling each boundary
LOGNORMAL_KEYS = 1 << 22
# phase 3r: bench_drift.py's DriftConfig (benchmarks/bench_drift.py:148-151,
# batches of 256 against a 32,768-key load) scaled to write calls of 52,428
# inserts against 2^21 loaded keys: a check every write call, the
# reservoir's time constant and the cooldown a third of the drift (as
# 4,096 of 12,288 there), the retrain as there (2 epochs of 256-key
# minibatches over the 1,024-key reservoir, 4 a write call).  The score
# divides a 1,024-key reservoir's tail by the tail of all 2^21 loaded keys;
# threshold and min_tail sit above what plain lognormal inserts give and
# below what 16 micro-clusters give (PERF.md section 4)
DRIFT_KNOBS = dict(reflow=True, threshold=3.0, min_tail=8, check_every=49_152,
                   window_keys=262_144, cooldown_keys=262_144, train_epochs=2,
                   train_batch=256, steps_per_tick=4, seed=7)
# no regular fold during phase 3r: at the default 0.25 one starts after
# ~10 of these write calls, runs ~20 more, and the delta it leaves
# restarts it at once, so a re-flow would be refused throughout (PERF.md
# section 7)
DRIFT_REBUILD_FRAC = 1.0
DRIFT_CONTROL_BATCHES = 2      # plain lognormal write batches first
DRIFT_MAX_SETTLE = 48          # settle write batches allowed for the swap
DRIFT_READ_BATCHES = 16        # read-only batches timed before the drift
DRIFT_INFLIGHT = 4096          # the async batch in flight across a write
# phase 4m: bench_resharding.py's ReshardConfig (benchmarks/
# bench_resharding.py:62-70, batches of 256 against a 32,768-key load)
# with its spans scaled by 256 to batches of 65,536: checks, the load
# floor, the gauges' decay window and the cooldown (PERF.md section 4)
MIGRATE_KNOBS = dict(enabled=True, migrate=True, hot_frac=2.0, neighbors=1,
                     min_keys=1024, check_every=131_072, min_load=65_536.0,
                     load_window_keys=1_048_576, cooldown_keys=2_097_152)
HOT_READ_FRAC = 0.6            # phase 4m: reads aimed at shard 0, as there
MAX_MIGRATE_CALLS = 96         # phase 4m: calls allowed for the swap
MIGRATE_AFTER = 8              # phase 4m: read calls after the swap
L2_FLUSH_BYTES = 512 << 20     # ten times the H100's 50 MB L2
# phases 2f and 4f: the SLO front end (bench_service.py's frontend
# benchmark, cut to the smoke's time limit)
FE_CFG = dict(max_batch=4096, batch_timeout_s=1e-3, max_inflight=2)
FE_CALIBRATE = 65_536          # the standing burst that measures C
FE_POINTS = 131_072            # 2f: P and O
FE_POINTS_SHARDED = 65_536     # 4f: P
# the mixed traces are cut from 16,384 requests (2f M), 8,192 (4f M) and
# 4,096 (2f's mixed F legs) to fit the time limit: a mixed trace's
# batches are ~2 requests, each write batch pays the write path's host
# cost (11 ms a request on an H100 host), and a forced fallback runs the
# plain versions (51 ms a request; PERF.md §4, §6)
FE_MIXED = 1_024               # 2f: M
FE_MIXED_SHARDED = 2_048       # 4f: M
FE_FAULT = 4_096               # 2f: each error leg of the fault ladder
# 2f: the stall leg, cut from 4,096 (88.8-93.1 s of the smoke on an H100
# host; mixed batches of ~2 requests, each write call a stalled fold tick)
FE_STALL = 1_024
FE_DEADLINE = 0.02             # P and O: 20 ms
FE_SLACK = 600.0               # "no deadline pressure"
FE_MIX = (0.7, 0.1, 0.15, 0.05)  # point, range, insert, delete
FE_MISS = 0.01                 # reads of unloaded keys (they must miss)
FE_OWN_READS = 0.1             # mixed reads of keys the trace inserted
FE_POOL = 1 << 19              # zipf ranks and unloaded keys drawn at once
FE_READBACK = 1024             # live keys read before and after exhaustion
SPIN_CYCLES = 400_000          # ~0.2 ms idle spin, longer than a host call
LM_ARCH = "falcon-mamba-7b"
# phase 6's depth: 32 of falcon-mamba-7b's 64 layers, cut so the smoke
# keeps its limit with phases 6d and 6m
LM_DEPTH = 32
LM_REQUESTS = 16
LM_PROMPT = (256, 2048)        # prompt lengths, uniform, inclusive
LM_NEW = 32                    # new tokens per request
LM_SLOTS = 8
LM_REPLAYS = 4                 # requests replayed at batch 1
LM_CHECK_LEN = 2048            # kernel-vs-chunked prompt
LM_SCAN_LAYERS = 8             # layers whose scan inputs phase 7 times
LM_LOGIT_REL_L2 = 0.1          # kernel vs chunked bf16 prefill logits
# phase 6d: qwen3-14b at full width and depth, served as phase 6 serves
# falcon-mamba-7b (LM_REQUESTS, LM_PROMPT, LM_NEW, LM_SLOTS, LM_REPLAYS)
DENSE_ARCH = "qwen3-14b"
LM_DEVICE = "cuda"
# phase 6m: every other architecture at its published widths, depth cut
# (None: all layers); the text families through the batcher, vlm and
# encdec through prefill/decode_step with their stub inputs
FAMILY_DEPTH = {
    "gemma2-9b": 2,                # one local layer, one global
    "phi4-mini-3.8b": 2,
    "internlm2-1.8b": 2,
    "granite-moe-1b-a400m": None,  # all 24
    "arctic-480b": 1,
    "zamba2-2.7b": 12,             # 2 shared-attention groups of 6
    "llama-3.2-vision-11b": 10,    # 2 cross-attention groups of 5
    "whisper-medium": None,        # all 24 + 24
}
FAM_REQUESTS = 4
FAM_PROMPT = (64, 256)         # prompt lengths, uniform, inclusive
FAM_NEW = 8
FAM_EXTRA_BATCH, FAM_EXTRA_PROMPT = 2, 128   # vlm and encdec
SCAN_TOL = 1e-4                # mamba_scan vs plain (rtol and atol)
BRANCH_TOL = 2e-3              # f32 mamba_block, kernel vs chunked
FD_ATTN_ARCH = "qwen3-14b"     # flash_decode's attention shape
FD_BATCH, FD_SEQ = 16, 32768   # decode_32k's length; batch cut from 128
FD_F32_BATCH = 4
FD_STEPS = 4                   # ops.flash_decode calls in its window
# flash_decode vs plain, for every cache dtype: both widen k and v to f32
# exactly and compute in f32, so only the order of the sums differs (the
# JAX tests' 2e-2 for bf16 covers XLA rounding bf16 inputs, which neither
# side here does; outputs are a few hundredths in size, so 2e-2 would
# pass a kernel that returned zeros)
FD_TOL = 2e-5
# phase 8: the paper's AFLI backend, the baselines and the page table.
# longlat at 2^20 keys, half bulk-loaded: a cut in depth from the paper's
# 200M keys (the trees are host-side Python, probed key by key; at 2^20
# loaded keys phase 8 took 105.6 s of its 90 s budget on an H100 80GB
# HBM3 at 700 W, LIPP's bulk load 23.3 s of it)
MESH_BUDGET_S = 90.0           # phase m: m1-m3, then m4-m6
M1_STEPS = 4                   # m1: decode steps on the (1, 1) mesh
MESH_ULPS = 4                  # m1 on more cards: 6d's bf16-ulp rule
M2_DATA = 16                   # m2: the meshes (M2_DATA, k), rank 0 alone
M2_MODELS = (2, 4, 8)
M2_STEPS = 3                   # m2: decode steps over the full cache
# m2: measured / dry-run per-card peak, stated before the first chip call
M2_PEAK_BOUND = (0.95, 1.10)
M3_LAYERS = 2                  # m3: internlm2-1.8b at full width
M3_STEPS = 4
M3_SEQ = 1024
M3_BATCH = 8
# m4: the (1, 1) mesh against the unsharded route, three more families
M4_MOE_ARCH = "granite-moe-1b-a400m"    # full config
M4_HYBRID_ARCH = "zamba2-2.7b"          # full depth
M4_BATCH = 8                   # decode rows over a 2,080-position cache
M4_CACHE = LM_PROMPT[1] + LM_NEW
M4_PREFILL = (2, 1024)         # falcon-mamba-7b's prefill rows x tokens
# m5: one rank under a fake group against the mesh dry run
M5_MOE = ("arctic-480b", "decode_32k", (16, 16))
M5_SSM_MODELS = (2, 4, 8)      # falcon-mamba-7b prefill_32k on (16, k)
M5_STEPS = 2
M5_SCAN_LEN = 2048             # positions of the scan's kernel-vs-plain check
# m6: launch.train on granite-moe-1b-a400m at full width, depth cut
M6_ARCH = "granite-moe-1b-a400m"
M6_LAYERS = 2
# m7-m10 (the vlm and encdec families and batch_tp), a budget of their own
MESH2_BUDGET_S = 120.0
# m7: the (1, 1) mesh against the unsharded route (None: every layer)
M7_DEPTH = {"llama-3.2-vision-11b": None, "whisper-medium": None}
# m8: rank 0 of decode_32k on (16, 16) under a fake group
M8_ARCHS = ("llama-3.2-vision-11b", "whisper-medium")
M8_MESH = (16, 16)
M9_MESH = (16, 2)              # m9: falcon-mamba-7b prefill_32k, batch_tp
# m10: a Trainer on (1, 1) against none, M3_STEPS steps; llama-3.2-vision-
# 11b at 5 layers (one cross group: 2 layers would run no layer at all,
# the vlm forward running whole groups of cross_attn_every), whisper-
# medium at 2 decoder and 2 encoder layers
M10_LAYERS = {"llama-3.2-vision-11b": 5, "whisper-medium": 2}
M10_BATCH, M10_SEQ = 4, 512
TRAIN_ARCH = "internlm2-1.8b"  # phase t: trained at its full config
TRAIN_SEQ = 4096
TRAIN_BATCH = 8                # as TRAIN_MICRO microbatches
TRAIN_MICRO = 2
TRAIN_STEPS = 3                # cut from 5: the whole smoke ran past 1,000 s
TRAIN_SMOKE_LEN = 64           # t2: tokens per row at the smoke configs
TRAIN_CARD_TOL = 1e-4          # t2: card vs CPU, max |d| / max |g| per leaf
RESTART_TOL = 1e-4             # t3: resumed vs uninterrupted losses, rel
TRAIN_BUDGET_S = 90.0
# phase r: three cells on the card beside their own dry run (counted on
# meta in a worker process started after the build)
R_BUDGET_S = 60.0
R_DECODE_STEPS = 5             # r1: decode steps over the full cache
R_PREFILLS = 2                 # r2: prefills of 32,768 tokens (first warms)
ATTN_TAG = "r3.f32_attention"  # r3: the profiler range around the attention
PAPER_KEYS = 1 << 20
PAPER_READ_BATCHES = 16        # read_only batches of BATCH
PAPER_WRITE_BATCHES = 4        # write_heavy batches of BATCH
PAPER_WRITES = 16_384          # updates, and deletes, of loaded keys
BASELINES = ("btree", "rmi", "pgm", "alex", "lipp")
BASE_READ_BATCHES = 4          # 8a's first read batches
BASE_PROBES = 16_384           # unloaded keys: misses, and inserts
BASE_DELETES = 4_096
BASE_PGM_BUFFERED = 64         # keys in PGM's insert buffer when deleting
PT_SESSIONS = 4_096            # 8c: sessions x blocks = 2^20 keys
PT_BLOCKS = 256
PT_NEW_SESSIONS = 64
PT_INSERT_CALL = 1_024
PH_KEYS = 65_536               # 8c: prefix-hash keys of PH_TOKENS tokens
PH_TOKENS = 16


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in f32 ulps (monotone integer image of the floats)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated ``arange(s, s + c)`` over the (start, count) pairs."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    excl = np.cumsum(counts) - counts
    return np.repeat(np.asarray(starts, np.int64) - excl, counts) \
        + np.arange(total)


class Windows:
    """Launch counts of the main path: zeroed just before each driven
    step and read just after, summed per kernel."""

    def __init__(self, ops):
        self.ops = ops
        self.total = collections.Counter()
        self.lookup_sizes = collections.Counter()   # batch size -> launches
        self.nf_sizes = collections.Counter()

    def run(self, fn, streamed: bool = False):
        """Drive ``fn`` in a window; outside the streamed steps
        (``streamed`` False) the streamed kernel must not launch."""
        self.ops.reset_launch_counts()
        out = fn()
        counts = self.ops.launch_counts()
        counts["scan_truncated"] = self.ops.fused_range_scan.truncated
        self.total.update(counts)
        self.lookup_sizes.update(self.ops.fused_lookup_launch_sizes())
        self.nf_sizes.update(self.ops.nf_forward_launch_sizes())
        if not streamed and counts["streamed_lookup"]:
            fail(f"streamed_lookup launched {counts['streamed_lookup']} "
                 "times with pool_budget None")
        return out, counts


def size_buckets(sizes) -> dict:
    """Launches per batch size, gathered into power-of-two buckets
    ("<=65536": launches of 32,769 to 65,536 keys)."""
    out = collections.Counter()
    for size, n in sizes.items():
        out["<=" + str(1 << max(size - 1, 0).bit_length())] += n
    return dict(sorted(out.items(), key=lambda kv: int(kv[0][2:])))


def set_rung(nfl, budget) -> None:
    """Select the point-read rung of the built index: ``pool_budget=0``
    streams every live read, None never streams."""
    idx = nfl.index
    idx.cfg = dataclasses.replace(idx.cfg, pool_budget=budget)


class Truth:
    """Ground truth of the live keys: sorted keys and their payloads."""

    def __init__(self, keys, pv):
        order = np.argsort(keys, kind="stable")
        self.keys = np.asarray(keys, np.float64)[order]
        self.pv = np.asarray(pv, np.int64)[order]

    def _at(self, keys):
        j = np.minimum(np.searchsorted(self.keys, keys),
                       self.keys.shape[0] - 1)
        return j, self.keys[j] == keys

    def lookup(self, keys):
        j, hit = self._at(keys)
        return np.where(hit, self.pv[j], -1)

    def insert(self, keys, pv):
        keys = np.asarray(keys, np.float64)
        pv = np.asarray(pv, np.int64)
        j, hit = self._at(keys)
        self.pv[j[hit]] = pv[hit]
        # a key inserted twice in one call keeps its last payload
        new, last = np.unique(keys[~hit][::-1], return_index=True)
        self.__init__(np.concatenate([self.keys, new]),
                      np.concatenate([self.pv, pv[~hit][::-1][last]]))

    def update(self, keys, pv):
        j, hit = self._at(keys)
        if not hit.all():
            fail("update of an absent key in the ground truth")
        self.pv[j] = pv

    def delete(self, keys):
        j, hit = self._at(keys)
        keep = np.ones(self.keys.shape[0], bool)
        keep[j[hit]] = False
        self.keys, self.pv = self.keys[keep], self.pv[keep]


# ---------------------------------------------------------------- phases
def phase_build(build):
    t0 = time.perf_counter()
    info = build.build_all()
    secs = time.perf_counter() - t0
    for name, rec in info.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln]
        log(f"built {name}: {rec['path']} ({rec['seconds']:.1f} s); "
            + "; ".join(regs))
    log(f"kernel build wall time: {secs:.1f} s")
    return secs


# ------------------------------------------------- the contract checker
# fixture kernel -> the operations of its work on its inputs (its bytes
# are those of its inputs and output)
FIXTURE_OPS = {
    "clip_gather": lambda idx, table: 0,
    "lane_cast": lambda hi, lo: 0,
    "batch_loop": lambda q, pool: 2 * q.numel() * pool.numel(),
    "f64_upcast": lambda pk: 5 * 8 * pk.numel(),
}
FP32_FLOPS = 67e12             # H100 SXM, outside the tensor cores


def analysis_checks():
    """Phase 1b's checks: the contract checker (``repro_torch.analysis``)
    on the card, timing nothing.  The fixture kernels against their
    plain versions bit for bit (``batch_loop`` at 1, 33 and 4,096
    queries); the self-test in a launch window (every fixture caught at
    a ``fixtures.cu`` or ``fixtures.py`` line, each kernel fixture
    launched); then every contract over the real entries in process
    (host syncs per entry, recorder against the sync debug mode; launch
    facts; the shared-memory model against ptxas and every profiled
    launch, the 2^25-row streamed pool included).  Fails on a missed
    fixture, a blocking finding, a model drift, a recorder count below
    the debug mode's, or a fixture kernel that differs from its plain
    version.  Returns (the kernel fixtures, their max |d| from plain,
    the self-test's launches) for ``fixture_timings``."""
    from repro_torch.analysis import fixtures as fx
    from repro_torch.analysis.__main__ import (DEFAULT_ALLOWLIST, run_all,
                                               run_fixture_selftest,
                                               _render_facts)
    from repro_torch.analysis.findings import Report, load_allowlist

    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    for b in (1, 33, 4096):
        q = torch.from_numpy(rng.standard_normal(b).astype(np.float32))
        pool = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
        got = fx.batch_loop(q.to(dev), pool.to(dev)).cpu()
        if not torch.equal(got, fx.batch_loop_plain(q, pool)):
            fail(f"batch_loop disagrees with its plain version at B {b}")
    errs = {}
    kernel_fixtures = {n: f for n, f in fx.FIXTURES.items() if f.call}
    for name, f in kernel_fixtures.items():
        call = f.call
        args = fx.fixture_inputs(name, dev)
        got = call(*args).cpu()
        want = call(*(a.cpu() for a in args))
        eq = bit_equal(got, want)
        errs[name] = float((got.double() - want.double()).abs().max())
        log(f"[analysis] {name}: kernel vs plain bit-equal {eq}")
        if not eq:
            fail(f"{name}: the fixture kernel disagrees with its plain "
                 "version")
    fx.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_fixture_selftest(dev)
    launches = fx.launch_counts()
    for line in buf.getvalue().splitlines():
        log(f"[analysis] self-test {line.strip()}")
    if rc != 0 or buf.getvalue().count("caught  fixture:") != len(
            fx.FIXTURES):
        fail("the contract checker missed a fixture")
    report = Report(allowlist=load_allowlist(DEFAULT_ALLOWLIST))
    t0 = time.perf_counter()
    facts = run_all(report, dev)
    for line in _render_facts(facts).splitlines():
        log(f"[analysis] {line.strip()}")
    drift = [f for f in report.findings if f.contract == "smem:model-drift"]
    under = [n for n, st in facts["syncs"].items()
             if st["syncs"] < st["debug_syncs"]]
    log(f"[analysis] python -m repro_torch.analysis in process: "
        f"{time.perf_counter() - t0:.1f} s; {len(report.blocking())} "
        f"blocking, {len(report.allowed())} allowlisted, "
        f"{len(report.advisory())} advisory; model drift {len(drift)}; "
        f"smem limit {facts['smem_limit']} B; entries where the recorder "
        f"counts below the debug mode: {under}")
    for f in report.advisory():
        log(f"[analysis] info [{f.contract}] {f.entry} @ {f.location}: "
            f"{f.message}")
    for f in report.blocking():
        log(f"[analysis] FAIL [{f.contract}] {f.entry} @ {f.location}: "
            f"{f.message}")
    if report.blocking() or drift or under:
        fail("the contract checker found blocking findings on the real "
             "entries")
    del facts
    gc.collect()
    torch.cuda.empty_cache()
    return kernel_fixtures, errs, launches


def fixture_timings(checked, flush_buf):
    """Phase 1b's timings: each fixture kernel that ``analysis_checks``
    held to its plain version, timed cold and warm beside its plain
    version and its bound; their rows of the kernel table."""
    from repro_torch.analysis import fixtures as fx

    dev = torch.device("cuda")
    kernel_fixtures, errs, launches = checked
    rows = {}
    for name, f in kernel_fixtures.items():
        call, row = f.call, f.call.__name__
        args = fx.fixture_inputs(name, dev)
        nbytes = sum(a.numel() * a.element_size()
                     for a in (*args, call(*args)))
        nops = FIXTURE_OPS[row](*args)
        fns = [lambda a=args: call(*a)] * 16
        cold, warm, host = timed_launches(fns, flush_buf)
        plain = getattr(fx, f"{row}_plain")
        plain_ms = time_ms(lambda: plain(*args), 5, 1)
        lib = None
        if row == "f64_upcast":
            table = fx.f64_table(8).to(dev)
            lib = time_ms(lambda: torch.searchsorted(table, args[0]), 5, 1)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / FP32_FLOPS * 1e3
        rows[row] = {
            "name": row, "route": "cuda",
            "source": "src/repro_torch/analysis/csrc/fixtures.cu",
            "replaces": f.replaces, "launches": launches[row],
            "max_abs_err": errs[name], "ms": statistics.median(cold),
            "plain_ms": plain_ms, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops > by_bytes else "bytes",
            "library_ms": lib, "ms_warm_l2": statistics.median(warm),
            "host_ms_per_call": host}
        log(f"[analysis] {row}: {rows[row]['ms']:.5f} ms cold, "
            f"{rows[row]['ms_warm_l2']:.5f} warm, host {host:.5f} ms/call; "
            f"plain {plain_ms:.4f} ms; library {lib}; bound "
            f"{rows[row]['bound_ms']:.2e} ms ({rows[row]['bound_by']}); "
            f"self-test launches {launches[row]}")
    return rows


def touched_sectors(pools, q, qhi, qlo, kw, tiers):
    """Distinct 32-byte sectors that the fused kernel's reads touch for
    one batch, replayed from ``csrc/fused_lookup.cu`` branch for branch
    (short-circuit reads included), and the mean traversal depth.  A
    sector that many queries read (the root's fields, the hot keys of a
    skewed batch) counts once.  Returns (sectors, reads, mean depth)."""
    from repro_torch.kernels.fused_lookup import (BUCKET, CHILD, DATA,
                                                  KIND_DENSE, _slot_index)
    reads = collections.defaultdict(list)      # pool -> element indices

    def read(pool, idx):
        reads[pool].append(idx.reshape(-1).to(torch.int64))

    dev = q.device
    n_entries = pools.ekey.shape[0]
    cap = pools.bhi.shape[1]
    node = torch.zeros(q.shape[0], dtype=torch.int64, device=dev)
    qq, hh, ll = q, qhi, qlo
    levels = 0
    for _ in range(kw["max_depth"]):
        if node.numel() == 0:
            break
        levels += node.numel()
        for f in ("node_kind", "node_offset", "node_size"):
            read(f, node)
        kind = pools.node_kind[node]
        off = pools.node_offset[node].to(torch.int64)
        size = pools.node_size[node].to(torch.int64)
        d = kind == KIND_DENSE
        # dense: the fixed-round search, then the window up to its
        # first full match
        qd, hd, ld = qq[d], hh[d], ll[d]
        l, h = off[d], off[d] + size[d]
        for _ in range(kw["dense_iters"]):
            mid = (l + h) // 2
            m = torch.clamp(mid, max=n_entries - 1)
            read("ekey", m)
            go = pools.ekey[m] < qd
            l, h = torch.where(go, mid + 1, l), torch.where(go, h, mid)
        last = off[d] + size[d] - 1
        e = torch.minimum(torch.maximum(l, off[d]), last)
        win = kw["dense_window"]
        j = torch.minimum(e[:, None] + torch.arange(win, device=dev),
                          last[:, None])
        km = pools.ekey[j] == qd[:, None]
        hm = km & (pools.ehi[j] == hd[:, None])
        full = hm & (pools.elo[j] == ld[:, None])
        found = full.any(dim=1)
        first = torch.where(found, torch.argmax(full.to(torch.int8), dim=1),
                            win - 1)
        seen = torch.arange(win, device=dev)[None, :] <= first[:, None]
        read("ekey", j[seen])
        read("ehi", j[seen & km])
        read("elo", j[seen & hm])
        read("epayload", j.gather(1, first[:, None])[:, 0][found])
        # model: slot, entry type, then the entry's own reads
        mo = ~d
        nm, qm, hm_, lm = node[mo], qq[mo], hh[mo], ll[mo]
        read("node_slope", nm)
        read("node_intercept", nm)
        slot = _slot_index(pools.node_slope[nm] * qm
                           + pools.node_intercept[nm])
        slot = torch.minimum(torch.clamp(slot, min=0), size[mo] - 1)
        e = off[mo] + slot
        read("etype", e)
        et = pools.etype[e]
        dt = et == DATA
        hit_hi = dt & (pools.ehi[e] == hm_)
        read("ehi", e[dt])
        read("elo", e[hit_hi])
        read("epayload", e[hit_hi & (pools.elo[e] == lm)])
        bk = et == BUCKET
        read("echild", e[bk])
        bid = torch.clamp(pools.echild[e[bk]], min=0).to(torch.int64)
        read("blen", bid)
        flat = bid[:, None] * cap + torch.arange(cap, device=dev)
        live = (torch.arange(cap, device=dev)[None, :]
                < pools.blen[bid][:, None])
        bh = live & (pools.bhi.reshape(-1)[flat] == hm_[bk][:, None])
        bl = bh & (pools.blo.reshape(-1)[flat] == lm[bk][:, None])
        read("bhi", flat[live])
        read("blo", flat[bh])
        read("bpayload", flat[bl])
        ch = et == CHILD
        read("echild", e[ch])
        node = pools.echild[e[ch]].to(torch.int64)
        qq, hh, ll = qm[ch], hm_[ch], lm[ch]
    tier_reads(tiers, q, qhi, qlo, read)
    return count_sectors(reads), sum(
        int(x.numel()) for v in reads.values() for x in v), \
        levels / q.shape[0]


def tier_reads(tiers, q, qhi, qlo, read) -> None:
    """The reads of the delta and run probes (``probe_tier`` of
    csrc/tier_device.cuh), which both point-read kernels end with."""
    if tiers is None:
        return
    t = tiers.pools
    zero = torch.zeros(1, dtype=torch.int64, device=q.device)
    for tag, iters, window in (("run", tiers.run_iters, tiers.run_window),
                               ("dl", tiers.delta_iters,
                                tiers.delta_window)):
        read(f"{tag}_len", zero)
        n = int(getattr(t, f"{tag}_len").item())
        if n <= 0:
            continue
        pk, hi, lo, pv = (getattr(t, f"{tag}_{f}")
                          for f in ("pk", "hi", "lo", "pv"))
        l = searched(pk, n, iters, q, lambda m, tag=tag:
                     read(f"{tag}_pk", m))
        probe_window(hi, lo, n, window, l, qhi, qlo,
                     lambda f, idx, tag=tag: read(f"{tag}_{f}", idx))


def streamed_sectors(sp, tiers, q, qhi, qlo):
    """Distinct 32-byte sectors that the streamed kernel's reads touch for
    one batch, replayed from ``csrc/streamed_lookup.cu``: the router's
    binary search and the walk down the bracket, each probed tile's
    11-round search and identity window (hi at every live position, lo
    where hi matched, pv at the match), then the tier probes.  Returns
    (sectors, mean tiles probed per query)."""
    from repro_torch.kernels.streamed_lookup import (STREAM_ALIGN,
                                                     TILE_ITERS, _wrap32,
                                                     ord_f32)
    reads = collections.defaultdict(list)

    def read(pool, idx):
        reads[pool].append(idx.reshape(-1).to(torch.int64))

    dev = q.device
    b = q.shape[0]
    pool, w = sp.pool, sp.window
    cap = pool.pk.shape[0]
    plen = int(pool.plen.item())
    read("slen", torch.zeros(1, dtype=torch.int64, device=dev))
    oz = ord_f32(q)
    lo_k = _wrap32(ord_f32(sp.router) - 2)
    hi_k = _wrap32(ord_f32(sp.router) + 2)
    l = torch.zeros(b, dtype=torch.int64, device=dev)
    h = torch.full((b,), (plen + STREAM_ALIGN - 1) // STREAM_ALIGN,
                   dtype=torch.int64, device=dev)
    while bool((l < h).any()):
        act = l < h
        mid = (l + h) // 2
        read("router", mid[act])
        go = act & (lo_k[torch.clamp(mid, max=lo_k.shape[0] - 1)] <= oz)
        l, h = torch.where(go, mid + 1, l), torch.where(act & ~go, mid, h)
    t = l - 1
    done = t < 0
    probed = 0
    cols = torch.arange(4 * w, device=dev)
    while not bool(done.all()):
        act = ~done
        read("router", (t + 1)[act])
        qs = act & (hi_k[torch.clamp(t + 1, 0)] >= oz)
        done = done | (act & ~qs)
        if bool(qs.any()):
            base = t[qs] * STREAM_ALIGN
            live = torch.clamp(plen - base, max=STREAM_ALIGN)
            last = base + torch.clamp(cap - base, max=STREAM_ALIGN) - 1
            zq, hq, lq = q[qs], qhi[qs], qlo[qs]
            tl_ = torch.zeros_like(base)
            th_ = live.clone()
            for _ in range(TILE_ITERS):
                mid = (tl_ + th_) // 2
                m = torch.minimum(base + mid, last)
                read("pk", m)
                go = pool.pk[m] < zq
                tl_ = torch.where(go, mid + 1, tl_)
                th_ = torch.where(go, th_, mid)
            j = (tl_ - w)[:, None] + cols
            inside = (j >= 0) & (j < live[:, None])
            g = torch.clamp(base[:, None] + j, 0, cap - 1)
            mh = inside & (pool.hi[g] == hq[:, None])
            ml = mh & (pool.lo[g] == lq[:, None])
            read("hi", g[inside])
            read("lo", g[mh])
            found = ml.any(dim=1)
            best = torch.max(torch.where(ml, g, -1), dim=1).values
            read("pv", best[found])
            hit = torch.zeros_like(done)
            hit[qs.nonzero()[:, 0][found]] = True
            done = done | hit
            probed += int(qs.sum())
        t = t - 1
        done = done | (t < 0)
    tier_reads(tiers, q, qhi, qlo, read)
    return count_sectors(reads), probed / b


ISEARCH_ROWS, ISEARCH_NARROW, ISEARCH_GUESSES = 8, 4096, 4  # tier_device.cuh


def isearch_reads(pk, base, n, q, kl, kh, read):
    """``Isearch`` of csrc/tier_device.cuh over the rows ``base + [0,
    n)`` (``base``, ``n`` and the steering keys ``kl``, ``kh`` per query
    or one for all), replayed: each round's aligned block at its guess,
    four rows a load, goes to ``read`` (the first row of each load).
    Returns the bounds (searchsorted-left)."""
    dev = q.device
    b = q.shape[0]
    base = torch.as_tensor(base, device=dev).to(torch.int64).expand(b)
    l = torch.zeros(b, dtype=torch.int64, device=dev)
    h = torch.as_tensor(n, device=dev).to(torch.int64).expand(b).clone()
    kl = torch.as_tensor(kl, dtype=torch.float32, device=dev).expand(b) \
        .clone()
    kh = torch.as_tensor(kh, dtype=torch.float32, device=dev).expand(b) \
        .clone()
    h = torch.where(q <= kl, 0, h)
    l = torch.where((q > kl) & (q > kh), h, l)
    rows = torch.arange(ISEARCH_ROWS, device=dev)
    loads = torch.arange(0, ISEARCH_ROWS, 4, device=dev)
    guesses = torch.zeros(b, dtype=torch.int64, device=dev)
    while True:
        o = l < h
        if not bool(o.any()):
            break
        lo_, ho, ql, qh, qo, bo = l[o], h[o], kl[o], kh[o], q[o], base[o]
        span = qh - ql
        guess = lo_ + ((qo - ql) / span * (ho - lo_).to(torch.float32)
                       ).nan_to_num(0.0).clamp(-2e9, 2e9).to(torch.int64)
        use = (ho - lo_ <= ISEARCH_NARROW) & (guesses[o] < ISEARCH_GUESSES) \
            & (ql < qo) & (qo < qh) & (span < float("inf"))
        guesses[o] += use.to(torch.int64)
        g = torch.where(use, guess, (lo_ + ho) // 2)
        st = torch.minimum(torch.maximum(g - ISEARCH_ROWS // 2, lo_),
                           torch.maximum(ho - ISEARCH_ROWS, lo_))
        bb = st & ~7
        r = bb[:, None] + loads
        read((bo[:, None] + r)[(r < ho[:, None]) & (r + 3 >= lo_[:, None])])
        f = torch.maximum(bb, lo_)
        e = torch.minimum(bb + ISEARCH_ROWS, ho)
        j = bb[:, None] + rows
        x = pk[(bo[:, None] + j).clamp(0, pk.shape[0] - 1)]
        below = ((j >= f[:, None]) & (j < e[:, None])
                 & (x < qo[:, None])).sum(1)
        none, every = below == 0, below == e - f
        kh[o] = torch.where(none, pk[bo + f], qh)
        kl[o] = torch.where(every, pk[(bo + e - 1).clamp(min=0)], ql)
        l[o] = torch.where(none, lo_, torch.where(every, e, f + below))
        h[o] = torch.where(none, f, torch.where(every, ho, f + below))
    return l


def window_reads(hi, lo, base, n, window, l, qhi, qlo, read):
    """``window_newest`` of csrc/tier_device.cuh around the bounds ``l``
    (rows ``base + [0, n)``), replayed: hi in aligned four-row loads over
    the window (row by row above WINDOW_VEC_MAX), then lo and pv at the hi
    matches, newest first, up to the first full match.  ``read(f, idx)``.
    Returns the matched rows (-1: none)."""
    dev = l.device
    base = torch.as_tensor(base, device=dev).to(torch.int64).expand(l.shape)
    n = torch.as_tensor(n, device=dev).to(torch.int64).expand(l.shape)
    j = (l - window)[:, None] + torch.arange(4 * window, device=dev)
    inside = (j >= 0) & (j < n[:, None])
    g = (base[:, None] + j).clamp(0, hi.shape[0] - 1)
    hm = inside & (hi[g] == qhi[:, None])
    full = hm & (lo[g] == qlo[:, None])
    newest = torch.max(torch.where(full, j, -1), dim=1).values
    if window > 8:
        read("hi", g[inside])
        read("lo", g[hm])
    else:
        first = torch.where(inside, j, 1 << 40).min(1).values
        last = torch.where(inside, j, -1).max(1).values
        k = (first >> 2)[:, None] + torch.arange(window + 1, device=dev)
        ok = (last >= 0)[:, None] & (k <= (last >> 2)[:, None])
        read("hi", (base[:, None] + 4 * k)[ok])
        seen = hm & (j >= newest[:, None])
        read("lo", g[seen])
        read("pv", g[seen])
    hit = newest >= 0
    if window > 8:
        read("pv", (base + newest)[hit])
    return torch.where(hit, base + newest, -1)


def streamed_kernel_sectors(sp, tiers, q, qhi, qlo):
    """Distinct 32-byte sectors that the redesigned streamed kernel's reads
    touch for one batch, replayed from ``csrc/streamed_lookup.cu``: the
    router's live entries staged once (16-byte copies), each probed
    tile's block search and identity window, then the tiers' block
    searches (after their first and last keys) and windows.  Returns the
    sector count."""
    from repro_torch.kernels.streamed_lookup import (STREAM_ALIGN, _wrap32,
                                                     ord_f32)
    reads = collections.defaultdict(list)

    def read(pool, idx):
        reads[pool].append(idx.reshape(-1).to(torch.int64))

    dev = q.device
    pool, w = sp.pool, sp.window
    cap = pool.pk.shape[0]
    plen = int(pool.plen.item())
    n_tiles = -(-plen // STREAM_ALIGN)
    read("slen", torch.zeros(1, dtype=torch.int64, device=dev))
    read("router", torch.arange(-(-(n_tiles + 1) // 4) * 4, device=dev))
    oz = ord_f32(q)
    lo_k = _wrap32(ord_f32(sp.router) - 2)
    hi_k = _wrap32(ord_f32(sp.router) + 2)
    t = torch.searchsorted(lo_k[:n_tiles].contiguous(), oz, right=True) - 1
    done = t < 0
    while not bool(done.all()):
        act = ~done & (hi_k[(t + 1).clamp(min=0)] >= oz)
        done = done | ~act
        if bool(act.any()):
            base = t[act] * STREAM_ALIGN
            live = torch.clamp(plen - base, max=STREAM_ALIGN)
            rows = torch.clamp(cap - base, max=STREAM_ALIGN)
            zq = q[act]
            lb = isearch_reads(pool.pk, base, live, zq, sp.router[t[act]],
                               sp.router[t[act] + 1],
                               lambda i: read("pk", i))
            lb = lb + ((lb == live) & (live == rows)).to(torch.int64)
            got = window_reads(pool.hi, pool.lo, base, live, w, lb,
                               qhi[act], qlo[act],
                               lambda f, i: read(f, i))
            hit = torch.zeros_like(done)
            hit[act.nonzero()[:, 0][got >= 0]] = True
            done = done | hit
        t = t - 1
        done = done | (t < 0)
    if tiers is not None:
        tp = tiers.pools
        for tag, window in (("dl", tiers.delta_window),
                            ("run", tiers.run_window)):
            n = int(getattr(tp, f"{tag}_len").item())
            read(f"{tag}_len", torch.zeros(1, dtype=torch.int64, device=dev))
            pk, hi, lo = (getattr(tp, f"{tag}_{f}") for f in ("pk", "hi",
                                                              "lo"))
            ends = torch.tensor([0, max(n - 1, 0)], device=dev)
            read(f"{tag}_pk", ends)
            lb = isearch_reads(pk, 0, n, q, pk[ends[0]], pk[ends[1]],
                               lambda i, tag=tag: read(f"{tag}_pk", i))
            window_reads(hi, lo, 0, n, window, lb, qhi, qlo,
                         lambda f, i, tag=tag: read(f"{tag}_{f}", i))
    return count_sectors(reads)


def probe_sectors(q, qhi, qlo, slope, intercept, entries, kernel=False):
    """Distinct sectors of one batch's entry gathers in ``index_probe``:
    the least the probe needs (etype and echild at each slot, ehi where
    the entry is DATA, elo where ehi matched, epay at a hit), or with
    ``kernel`` the reads of ``csrc/index_probe.cu``: etype and echild at
    each slot, then ehi, elo and epay together where the entry is DATA."""
    from repro_torch.kernels.fused_lookup import DATA, _slot_index
    etype, ehi, elo, epay, echild = entries
    sl = torch.tensor(np.float32(slope), device=q.device)
    ic = torch.tensor(np.float32(intercept), device=q.device)
    slot = torch.clamp(_slot_index(sl * q + ic), 0, etype.shape[0] - 1)
    d = etype[slot] == DATA
    if kernel:
        return count_sectors({"etype": [slot], "echild": [slot],
                              **{f: [slot[d]] for f in ("ehi", "elo",
                                                        "epay")}})
    mh = d & (ehi[slot] == qhi)
    ml = mh & (elo[slot] == qlo)
    return count_sectors({"etype": [slot], "echild": [slot],
                          "ehi": [slot[d]], "elo": [slot[mh]],
                          "epay": [slot[ml]]})


def searched(pk, n, iters, q, read):
    """``lower_bound`` of csrc/tier_device.cuh over the live length
    ``n`` (an int or a per-query tensor), replayed: each round's clamped
    index goes to ``read``.  Returns the bounds."""
    l = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    h = (torch.as_tensor(n, device=q.device).to(torch.int64)
         .expand(q.shape[0]).clone())
    for _ in range(iters):
        mid = (l + h) // 2
        m = torch.clamp(mid, max=pk.shape[0] - 1)
        read(m)
        go = pk[m] < q
        l, h = torch.where(go, mid + 1, l), torch.where(go, h, mid)
    return l


def probe_window(hi, lo, n, window, l, qhi, qlo, read):
    """The window reads of ``probe_tier`` around the bounds ``l``: hi at
    every live position, lo where hi matched, pv at the newest match.
    Returns which queries matched."""
    dev = l.device
    j = (l - window)[:, None] + torch.arange(4 * window, device=dev)
    inside = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, max(n - 1, 0))
    th = inside & (hi[jc] == qhi[:, None])
    tl = th & (lo[jc] == qlo[:, None])
    read("hi", j[inside])
    read("lo", j[th])
    hit = tl.any(dim=1)
    read("pv", torch.max(torch.where(tl, j, -1), dim=1).values[hit])
    return hit


def count_sectors(reads) -> int:
    """Distinct sectors over every pool's element reads (every pool is
    4-byte)."""
    per_sector = SECTOR // 4
    return sum(int(torch.unique(torch.cat(v) // per_sector).numel())
               for v in reads.values() if v)


def range_sectors(sp, tiers, zlo, zhi, scan_cap):
    """Sectors that one range batch must read, replayed from
    ``csrc/range_scan.cu``: each endpoint's search in the three pools,
    the span of candidates of each pool (at most ``scan_cap`` of each;
    all of it for an untruncated query), and the identity probes'
    windows into the newer tiers.  Returns (bound sectors, sectors of
    the probes' own binary searches, which the bound leaves out)."""
    reads = collections.defaultdict(list)
    probe_reads = collections.defaultdict(list)

    def reader(store, key):
        return lambda idx: store[key].append(idx.reshape(-1).to(torch.int64))

    pools = [("s", sp.pool.pk, sp.pool.hi, sp.pool.lo, sp.pool.pv,
              int(sp.pool.plen.item()), sp.iters, 1)]
    if tiers is not None:
        t = tiers.pools
        pools += [("r", t.run_pk, t.run_hi, t.run_lo, t.run_pv,
                   int(t.run_len.item()), tiers.run_iters, tiers.run_window),
                  ("d", t.dl_pk, t.dl_hi, t.dl_lo, t.dl_pv,
                   int(t.dl_len.item()), tiers.delta_iters,
                   tiers.delta_window)]
    spans = {}
    for tag, pk, hi, lo, pv, n, iters, _w in pools:
        a = searched(pk, n, iters, zlo, reader(reads, f"{tag}_pk"))
        b = searched(pk, n, iters, zhi, reader(reads, f"{tag}_pk"))
        cnt = torch.clamp(b - a, 0, scan_cap)
        idx = torch.from_numpy(ranges(a.cpu().numpy(), cnt.cpu().numpy())
                               ).to(zlo.device)
        for f in ("pk", "hi", "lo", "pv"):
            reads[f"{tag}_{f}"].append(idx)
        spans[tag] = idx
    for cand, newer in (("s", ("d", "r")), ("r", ("d",))):
        if cand not in spans or tiers is None:
            continue
        _, cpk, chi, clo, _, _, _, _ = next(p for p in pools if p[0] == cand)
        idx = spans[cand]
        m, qh, ql = cpk[idx], chi[idx], clo[idx]
        for tag in newer:
            _, pk, hi, lo, pv, n, iters, window = next(
                p for p in pools if p[0] == tag)
            if n <= 0 or not m.numel():
                continue
            l = searched(pk, n, iters, m, reader(probe_reads, f"{tag}_pk"))
            hit = probe_window(hi, lo, n, window, l, qh, ql,
                               lambda f, x, tag=tag:
                               reads[f"{tag}_{f}"].append(x.reshape(-1)))
            # the run is probed only after the delta missed
            m, qh, ql = m[~hit], qh[~hit], ql[~hit]
    return count_sectors(reads), count_sectors(probe_reads)


def launch_times_ms(fns, before) -> list:
    """Device time of each ``fn`` in turn: ``before()`` enqueues device
    work longer than a host call (an L2 flush or an idle spin), so each
    launch is queued before its start event fires and the events bracket
    the kernel alone."""
    ev = []
    for fn in fns:
        before()
        s_ev = torch.cuda.Event(enable_timing=True)
        e_ev = torch.cuda.Event(enable_timing=True)
        s_ev.record()
        fn()
        e_ev.record()
        ev.append((s_ev, e_ev))
    torch.cuda.synchronize()
    return [s_ev.elapsed_time(e_ev) for s_ev, e_ev in ev]


def host_ms_per_call(fns) -> float:
    """Host time to issue one call (the wrapper's Python and ctypes
    work), over the calls in turn, without waiting for the device."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for fn in fns:
        fn()
    host = (time.perf_counter() - t) / len(fns) * 1e3
    torch.cuda.synchronize()
    return host


def timed_launches(fns, flush_buf):
    for fn in fns[:4]:
        fn()
    cold = launch_times_ms(fns, flush_buf.zero_)
    warm = launch_times_ms(fns, lambda: torch.cuda._sleep(SPIN_CYCLES))
    host = host_ms_per_call(fns)
    return cold, warm, host


# ------------------------------------------------------ the main path
def bulkload_and_read(name, n_keys, force_flow, seed, m, win, train=None):
    """Phase 2a / 3a: bulk load (the flow trained with the
    ``FlowTrainConfig`` fields in ``train``, or the default), the
    read-only batches and one batch of unloaded keys, all checked."""
    t0 = time.perf_counter()
    keys = m.make_dataset(name, n_keys)
    wl = m.make_workload(keys, m.WorkloadConfig(
        mix="read_only", n_ops=N_READ_BATCHES * BATCH, batch_size=BATCH,
        zipf_s=0.99, seed=seed))
    unloaded = np.setdiff1d(keys, wl.load_keys, assume_unique=True)
    miss_keys = np.random.default_rng(seed).choice(unloaded, BATCH,
                                                   replace=False)
    log(f"[{name}] {keys.shape[0]} keys, {wl.load_keys.shape[0]} "
        f"bulk-loaded; data {time.perf_counter() - t0:.1f} s")

    def bulkload(force):
        torch.cuda.reset_peak_memory_stats()
        nfl = m.NFL(m.NFLConfig(backend="flat", force_flow=force,
                                flow_train=m.FlowTrainConfig(**(train or {}))))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    def drive():
        nfl, t_bulk = bulkload(force_flow)
        if force_flow is None and not nfl.use_flow:
            log(f"[{name}] AutoSwitch declined the flow (tails "
                f"{nfl.metrics['tail_conflict_original']:.0f} -> "
                f"{nfl.metrics['tail_conflict_transformed']:.0f}); "
                "rerunning with force_flow=True")
            m.ops.reset_launch_counts()
            nfl, t_bulk = bulkload(True)
        wrong = n_reads = 0
        pays = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _op, k, p in wl.batches:
            pays.append(nfl.lookup_batch(k))
            wrong += int((pays[-1] != p).sum())
            n_reads += k.shape[0]
        t_reads = time.perf_counter() - t
        wrong_miss = int((nfl.lookup_batch(miss_keys) != -1).sum())
        return nfl, t_bulk, wrong, n_reads, t_reads, wrong_miss, pays

    (nfl, t_bulk, wrong, n_reads, t_reads, wrong_miss, pays), counts = \
        win.run(drive)
    peak = torch.cuda.max_memory_allocated()
    mt = nfl.metrics
    stats = nfl.index.stats()
    log(f"[{name}] use_flow={nfl.use_flow} tail_conflict "
        f"original={mt['tail_conflict_original']:.0f} "
        f"transformed={mt['tail_conflict_transformed']:.0f} "
        f"shadowed={stats['n_shadowed']}")
    log(f"[{name}] bulkload {t_bulk:.2f} s = train "
        f"{mt['flow_train_s']:.2f} s ({mt['flow_n_steps']:.0f} steps) + "
        f"transform {mt['transform_s']:.2f} s + build "
        f"{mt['index_build_s']:.2f} s (+ AutoSwitch and packing)")
    log(f"[{name}] reads: {n_reads} in {N_READ_BATCHES} batches, "
        f"wrong={wrong}; misses: {BATCH} unloaded keys, wrong={wrong_miss}")
    log(f"[{name}] lookups/s end to end (host feature expansion, copies, "
        f"kernel): {n_reads / t_reads:.0f}")
    log(f"[{name}] launches: {counts}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; pool bytes "
        f"{stats['serving']['pool_bytes']} ({stats['n_nodes']} nodes, "
        f"{stats['n_entries']} entries, {stats['n_buckets']} buckets, "
        f"depth {stats['max_depth']})")
    if wrong or wrong_miss:
        fail(f"{name}: {wrong} wrong reads, {wrong_miss} wrong misses")
    if counts["fused_lookup"] == 0:
        fail(f"{name}: fused_lookup never launched on the main path")
    if nfl.use_flow and counts["nf_forward"] == 0:
        fail(f"{name}: nf_forward never launched on the main path")
    return {"name": name, "nfl": nfl, "keys": keys, "wl": wl,
            "unloaded": unloaded, "seed": seed, "miss_keys": miss_keys,
            "truth": Truth(wl.load_keys, wl.load_payloads),
            "batches": [k for _op, k, _p in wl.batches], "read_pay": pays,
            "use_flow": nfl.use_flow, "lookups_per_s": n_reads / t_reads,
            "peak_bytes": peak, "bulkload_s": t_bulk}


def rung_read(nfl, keys, budget, split_key_bits):
    """(payloads, z) of one batch through the index's own point-read
    dispatch with the rung that ``pool_budget=budget`` selects."""
    set_rung(nfl, budget)
    idx = nfl.index
    hi, lo = split_key_bits(keys)
    if nfl.use_flow:
        out = idx._flow_device_lookup(nfl._feats(keys), hi, lo,
                                      nfl._packed_w, nfl._shapes)
    else:
        out = idx._dispatch(keys.astype(np.float32).reshape(-1, 1), hi, lo,
                            None, True)
    path = idx.last_dispatch["path"]
    set_rung(nfl, None)
    if path != ("fused" if budget is None else "streamed"):
        fail(f"pool_budget={budget} served on the {path} rung")
    return out


def streamed_reads(res, win, split_key_bits, what, extra):
    """s1 / s3: the read batches and ``extra`` (name -> keys) through
    ``NFL.lookup_batch`` on the streamed rung, every read against the
    ground truth; then each read batch through both rungs, payloads and z
    bit-equal.  Returns the fused rung's (z, payloads) per batch."""
    name, nfl = res["name"], res["nfl"]
    truth = res["truth"]
    batches = res["batches"]
    want = [truth.lookup(k) for k in batches]
    extra = {n: (k, truth.lookup(k)) for n, k in extra.items()}
    set_rung(nfl, 0)

    def drive():
        wrong = n = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        for k, w in zip(batches, want):
            wrong += int((nfl.lookup_batch(k) != w).sum())
            n += k.shape[0]
        secs = time.perf_counter() - t
        bad = {}
        for n_, (k, w) in extra.items():
            got = np.concatenate([nfl.lookup_batch(k[i:i + BATCH])
                                  for i in range(0, k.shape[0], BATCH)])
            bad[n_] = int((got != w).sum())
        return wrong, n, secs, bad

    (wrong, n, secs, bad), counts = win.run(drive, streamed=True)
    set_rung(nfl, None)
    n_calls = len(batches) + sum(-(-k.shape[0] // BATCH)
                                 for k, _w in extra.values())
    log(f"[{name}] streamed rung ({what}): {n} reads in {len(batches)} "
        f"batches, wrong={wrong}; {bad}; {n / secs:.0f} lookups/s end to "
        f"end (fused rung in 2a: {res['lookups_per_s']:.0f}); launches "
        f"{counts}; serving {nfl.index.stats()['serving']}")
    if wrong or any(bad.values()):
        fail(f"{name}: wrong reads on the streamed rung ({what})")
    if counts["streamed_lookup"] != n_calls or counts["fused_lookup"]:
        fail(f"{name}: {n_calls} reads on the streamed rung launched "
             f"{counts['streamed_lookup']} streamed and "
             f"{counts['fused_lookup']} fused kernels")
    diff_pay = diff_z = 0
    fused = []
    for k in batches:
        fp, fz = rung_read(nfl, k, None, split_key_bits)
        sp_, sz = rung_read(nfl, k, 0, split_key_bits)
        diff_pay += int((fp != sp_).sum())
        diff_z += int((fz.view(np.int32) != sz.view(np.int32)).sum())
        fused.append((fz, fp))
    log(f"[{name}] both rungs on the {len(batches)} read batches ({what}): "
        f"payloads differ in {diff_pay}, z in {diff_z} (bound 0)")
    if diff_pay or diff_z:
        fail(f"{name}: the streamed rung disagrees with the fused rung")
    return dict(lookups_per_s=n / secs, fused=fused)


def root_probe(res, m, win, fused, split_key_bits):
    """s1: ``ops.index_probe`` on the root node of the fresh index with
    each read batch's z (driven, counted): where the root entry is DATA,
    its payload must be the one the fused rung served.  Returns the
    probe's device arguments per batch."""
    from repro_torch.kernels.fused_lookup import DATA, KIND_MODEL
    name, nfl = res["name"], res["nfl"]
    idx = nfl.index
    a = idx.arrays
    if int(a.node_kind[0]) != KIND_MODEL:
        fail(f"{name}: the root is not a model node; nothing to probe")
    if idx._tier_pack() is not None:
        fail(f"{name}: the fresh index holds shadows; the root's DATA hits "
             "are not the served payloads")
    size = int(a.node_size[0])
    pools = idx._kernel_pools()
    node = (float(a.node_slope[0]), float(a.node_intercept[0]),
            *(getattr(pools, f)[:size]
              for f in ("etype", "ehi", "elo", "epayload", "echild")))
    dev = torch.device("cuda")
    args = []
    for k, (fz, _fp) in zip(res["batches"], fused):
        hi, lo = split_key_bits(k)
        args.append((torch.from_numpy(fz).to(dev),
                     torch.from_numpy(hi.view(np.int32)).to(dev),
                     torch.from_numpy(lo.view(np.int32)).to(dev), *node))

    def drive():
        return [m.ops.index_probe(*x) for x in args]

    outs, counts = win.run(drive)
    wrong = n_data = n_hit = 0
    for (pay, code, _child), (_fz, fp) in zip(outs, fused):
        d = code.cpu().numpy() == DATA
        p = pay.cpu().numpy()
        wrong += int((p[d] != fp[d]).sum())
        n_data += int(d.sum())
        n_hit += int((p >= 0).sum())
    log(f"[{name}] root probe (ops.index_probe, {size} slots): "
        f"{len(args) * BATCH} queries, {n_data} land on DATA at the root, "
        f"{n_hit} hits, {wrong} disagree with the fused rung; launches "
        f"{counts}")
    if wrong or n_data == 0:
        fail(f"{name}: index_probe disagrees with the fused rung at the root")
    if counts["index_probe"] != len(args):
        fail(f"{name}: index_probe launched {counts['index_probe']} times "
             f"for {len(args)} batches")
    return args


def timed_checks(nfl):
    """Time the drift checks of ``nfl``'s re-flow manager (the reservoir's
    tail under the serving transform, which the default telemetry
    measures every ``check_every`` inserted keys); returns the list of
    check ms it fills."""
    mgr = nfl._reflow
    real = mgr.serving_tail
    ms = []

    def timed(sample):
        t = time.perf_counter()
        out = real(sample)
        ms.append((time.perf_counter() - t) * 1e3)
        return out

    mgr.serving_tail = timed
    return ms


def write_stream(res, m, win, n_batches, until_fold, alternate=False):
    """Phase 2b / 3b: ``write_heavy`` batches from the read phase's seed
    (so the load split is the one bulk-loaded).  Every read is checked;
    with ``until_fold`` the stream stops after the batch in which a fold
    that it started completes.  With ``alternate`` the odd batches read
    through the streamed rung."""
    name, nfl = res["name"], res["nfl"]
    idx = nfl.index
    wl = m.make_workload(res["keys"], m.WorkloadConfig(
        mix="write_heavy", n_ops=n_batches * BATCH, batch_size=BATCH,
        zipf_s=0.99, seed=res["seed"]))
    if not np.array_equal(wl.load_keys, res["wl"].load_keys):
        fail(f"{name}: the write workload's load split differs")
    folds0 = idx.n_rebuilds
    checks0 = nfl.dispatch_stats()["drift"]["checks"]
    check_ms = timed_checks(nfl)
    rec = collections.Counter()
    ins_k, ins_p, ins_ms = [], [], []
    fold_batches = []

    def drive():
        t = time.perf_counter()
        for b, (op, k, p) in enumerate(wl.batches):
            mid = idx._fold is not None
            r = op == 0
            streamed = alternate and b % 2 == 1
            set_rung(nfl, 0 if streamed else None)
            got = nfl.lookup_batch(k[r])
            set_rung(nfl, None)
            rec["wrong"] += int((got != p[r]).sum())
            rec["reads"] += int(r.sum())
            rec["mid_fold_reads"] += int(r.sum()) if mid else 0
            rec["streamed_calls"] += int(streamed)
            rec["mid_fold_streamed_reads"] += (int(r.sum())
                                               if mid and streamed else 0)
            t1 = time.perf_counter()
            nfl.insert_batch(k[~r], p[~r])
            ins_ms.append((time.perf_counter() - t1) * 1e3)
            rec["inserts"] += int((~r).sum())
            ins_k.append(k[~r])
            ins_p.append(p[~r])
            if mid or idx._fold is not None:
                fold_batches.append(b)
            if until_fold and idx.n_rebuilds > folds0:
                break
        return time.perf_counter() - t

    secs, counts = win.run(drive, streamed=alternate)
    res["truth"].insert(np.concatenate(ins_k), np.concatenate(ins_p))
    st = idx.stats()
    log(f"[{name}] writes: {len(ins_ms)} write_heavy batches of {BATCH}, "
        f"{rec['reads']} reads (wrong={rec['wrong']}), {rec['inserts']} "
        f"inserts in {secs:.2f} s = {rec['inserts'] / secs:.0f} inserts/s "
        f"with the reads; insert_batch ms median "
        f"{statistics.median(ins_ms):.1f} max {max(ins_ms):.1f}; run "
        f"{st['run_len']} delta {st['delta_len']}; folds "
        f"{idx.n_rebuilds - folds0}; batches with a fold in flight "
        f"{fold_batches}; reads served mid-fold {rec['mid_fold_reads']} "
        f"({rec['mid_fold_streamed_reads']} on the streamed rung, in "
        f"{rec['streamed_calls']} streamed read calls); launches {counts}")
    if idx.n_rebuilds > folds0:
        log(f"[{name}] in-stream fold: {st['last_fold']}")
    if rec["wrong"]:
        fail(f"{name}: {rec['wrong']} wrong reads during writes")
    if counts["fused_lookup"] == 0 or (nfl.use_flow
                                       and counts["nf_forward"] == 0):
        fail(f"{name}: the write path skipped a kernel")
    # NF launches: one a flow-on insert batch (its positioning keys) and
    # one a drift check of the reservoir under the serving flow (the
    # default telemetry); the reads run the NF inside the point kernels
    checks = nfl.dispatch_stats()["drift"]["checks"] - checks0
    want_nf = (len(ins_ms) + checks) if nfl.use_flow else 0
    log(f"[{name}] drift checks in the write window {checks} (ms median "
        f"{statistics.median(check_ms) if check_ms else 0:.2f}, max "
        f"{max(check_ms, default=0):.2f}); nf_forward launches "
        f"{counts['nf_forward']} (expected {want_nf})")
    if counts["nf_forward"] != want_nf:
        fail(f"{name}: nf_forward launched {counts['nf_forward']} times in "
             f"the write window, expected {want_nf}")
    if until_fold and (idx.n_rebuilds == folds0
                       or rec["mid_fold_reads"] == 0):
        fail(f"{name}: no fold started and completed in-stream with reads "
             "served while it ran")
    if not until_fold and idx.n_rebuilds != folds0:
        fail(f"{name}: a fold ran during the write phase")
    if alternate and (rec["mid_fold_streamed_reads"] == 0
                      or counts["streamed_lookup"] != rec["streamed_calls"]):
        fail(f"{name}: {counts['streamed_lookup']} streamed launches for "
             f"{rec['streamed_calls']} streamed read calls, "
             f"{rec['mid_fold_streamed_reads']} streamed reads mid-fold")
    res["write"] = dict(rec, seconds=secs, batches=len(ins_ms),
                        insert_ms_median=statistics.median(ins_ms),
                        insert_ms_max=max(ins_ms),
                        fold_batches=fold_batches,
                        drift_check_ms=statistics.median(check_ms)
                        if check_ms else None)
    res["write_batches"] = ins_k
    return np.concatenate(ins_k), np.concatenate(ins_p)


def readback(res, keys, win, what, streamed=False):
    """Look up ``keys`` in batches of 65,536 against the ground truth, on
    the streamed rung if ``streamed``."""
    nfl = res["nfl"]
    want = res["truth"].lookup(keys)
    set_rung(nfl, 0 if streamed else None)

    def drive():
        return [nfl.lookup_batch(keys[i:i + BATCH])
                for i in range(0, keys.shape[0], BATCH)]

    got, counts = win.run(drive, streamed=streamed)
    set_rung(nfl, None)
    wrong = int((np.concatenate(got) != want).sum())
    rung = "streamed" if streamed else "fused"
    log(f"[{res['name']}] {what} ({rung} rung): {keys.shape[0]} keys, "
        f"wrong={wrong}; launches {counts}")
    if wrong:
        fail(f"{res['name']}: {wrong} wrong lookups ({what}, {rung})")
    if streamed and (counts["streamed_lookup"] != len(got)
                     or counts["fused_lookup"]):
        fail(f"{res['name']}: {what} did not all take the streamed rung")


def update_and_delete(res, win, ins_keys):
    """Phase 2c: updates and deletes of loaded keys, then a tail of
    deletes, updates and inserts small enough to stay in the delta."""
    name, nfl = res["name"], res["nfl"]
    wl = res["wl"]
    rng = np.random.default_rng(res["seed"] + 100)
    pick = rng.choice(wl.load_keys.shape[0], 2 * BATCH + 2 * TAIL,
                      replace=False)
    upd = wl.load_keys[pick[:BATCH]]
    dele = wl.load_keys[pick[BATCH:2 * BATCH]]
    t_del = wl.load_keys[pick[2 * BATCH:2 * BATCH + TAIL]]
    t_upd = wl.load_keys[pick[2 * BATCH + TAIL:]]
    fresh = np.setdiff1d(res["unloaded"], ins_keys, assume_unique=True)
    t_ins = rng.choice(fresh, TAIL, replace=False)
    upd_pv = wl.load_payloads[pick[:BATCH]] + (1 << 28)
    t_upd_pv = wl.load_payloads[pick[2 * BATCH + TAIL:]] + (1 << 28)
    t_ins_pv = (1 << 29) + np.arange(TAIL)

    def drive():
        t = time.perf_counter()
        ok_u = nfl.update_batch(upd, upd_pv)
        ok_d = nfl.delete_batch(dele)
        secs = time.perf_counter() - t
        got_d = nfl.lookup_batch(dele)
        got_u = nfl.lookup_batch(upd)
        ok_t = nfl.delete_batch(t_del)
        ok_tu = nfl.update_batch(t_upd, t_upd_pv)
        nfl.insert_batch(t_ins, t_ins_pv)
        got_t = [nfl.lookup_batch(k) for k in (t_del, t_upd, t_ins)]
        return secs, ok_u, ok_d, got_d, got_u, ok_t, ok_tu, got_t

    (secs, ok_u, ok_d, got_d, got_u, ok_t, ok_tu, got_t), counts = win.run(
        drive)
    truth = res["truth"]
    truth.update(upd, upd_pv)
    truth.delete(dele)
    truth.delete(t_del)
    truth.update(t_upd, t_upd_pv)
    truth.insert(t_ins, t_ins_pv)
    wrong = {"update_ok": int((~ok_u).sum()) + int((~ok_tu).sum()),
             "delete_ok": int((~ok_d).sum()) + int((~ok_t).sum()),
             "deleted_hits": int((got_d != -1).sum())
             + int((got_t[0] != -1).sum()),
             "updated_reads": int((got_u != upd_pv).sum())
             + int((got_t[1] != t_upd_pv).sum()),
             "tail_inserts": int((got_t[2] != t_ins_pv).sum())}
    st = nfl.index.stats()
    log(f"[{name}] updates {BATCH}+{TAIL}, deletes {BATCH}+{TAIL}, tail "
        f"inserts {TAIL}: {2 * BATCH / secs:.0f} writes/s (update+delete); "
        f"wrong {wrong}; n_keys {st['n_keys']} (truth "
        f"{truth.keys.shape[0]}); run {st['run_len']} delta "
        f"{st['delta_len']}; launches {counts}")
    if any(wrong.values()) or st["n_keys"] != truth.keys.shape[0]:
        fail(f"{name}: wrong updates or deletes: {wrong}")
    if not (st["run_len"] and st["delta_len"]) or st["fold_active"]:
        fail(f"{name}: the tiers do not both hold data before the scans")
    res["deleted"] = np.concatenate([dele, t_del])
    res["updated"] = (upd, upd_pv)


def scan_truth(res, m, dev):
    """Live keys in positioning order (z from the NF kernel with the flow
    on, the f32 key without) and their payloads."""
    nfl, truth = res["nfl"], res["truth"]
    keys = truth.keys
    if nfl.use_flow:
        z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys,
                                    nfl.cfg.flow, dev).astype(np.float32)
    else:
        z = keys.astype(np.float32)
    order = np.argsort(z, kind="stable")
    return keys[order], z[order], truth.pv[order]


def scan_queries(res, m, sorted_keys, n_batches):
    """YCSB workload E ranges: start ranks zipfian (0.99) over the live
    keys in positioning order, lengths uniform in 1-100."""
    rng = np.random.default_rng(res["seed"] + 200)
    n = sorted_keys.shape[0]
    total = n_batches * SCAN_BATCH
    start = m.zipf_indices(rng, n - 101, total, 0.99)
    length = rng.integers(1, 101, total)
    return [(start[i:i + SCAN_BATCH], length[i:i + SCAN_BATCH])
            for i in range(0, total, SCAN_BATCH)]


def run_scans(res, win, sk, zs, ps, queries, what):
    """Drive ``scan_batch`` per batch (counted), then hold each
    untruncated range to the z-space ground truth as a multiset."""
    nfl = res["nfl"]
    sharded = hasattr(nfl.index, "shards")

    def drive():
        out = []
        t = time.perf_counter()
        for r, ln in queries:
            out.append(nfl.scan_batch(sk[r], sk[r + ln]))
        return out, time.perf_counter() - t

    (outs, secs), counts = win.run(drive)
    wrong = truncated = n_rows = 0
    for (r, ln), (pv, cnt, tot) in zip(queries, outs):
        a = np.searchsorted(zs, zs[r], side="left")
        b = np.searchsorted(zs, zs[r + ln], side="left")
        q = np.flatnonzero(tot <= SCAN_CAP)
        truncated += r.shape[0] - q.shape[0]
        bad = cnt[q] != b[q] - a[q]
        ok = q[~bad]
        want = ps[ranges(a[ok], b[ok] - a[ok])]
        wq = np.repeat(np.arange(ok.shape[0]), b[ok] - a[ok])
        got_mask = np.arange(SCAN_CAP)[None, :] < cnt[ok][:, None]
        got = pv[ok][got_mask]
        gq = np.repeat(np.arange(ok.shape[0]), cnt[ok])
        w_o, g_o = np.lexsort((want, wq)), np.lexsort((got, gq))
        diff = want[w_o] != got[g_o]
        wrong += int(bad.sum()) + int(np.unique(wq[w_o][diff]).shape[0])
        n_rows += int(cnt.sum())
    n_q = sum(r.shape[0] for r, _ln in queries)
    log(f"[{res['name']}] scans ({what}): {len(queries)} batches, {n_q} "
        f"ranges, {n_rows} rows, wrong={wrong}, truncated="
        f"{truncated} (counter {counts['scan_truncated']}); {n_q / secs:.0f} "
        f"scans/s end to end, {n_rows / secs:.0f} rows/s; launches {counts}")
    if wrong:
        fail(f"{res['name']}: {wrong} wrong range scans ({what})")
    # one launch a batch; sharded, one a shard that the batch's ranges
    # reach by their ground-truth z, and one router NF launch a batch
    # with the flow on
    want = (sum(shards_reached(nfl.index.boundaries, zs[r], zs[r + ln])
                for r, ln in queries) if sharded else len(queries))
    want_nf = len(queries) if sharded and nfl.use_flow else 0
    if counts["fused_range_scan"] != want or counts["nf_forward"] != want_nf:
        fail(f"{res['name']}: fused_range_scan launched "
             f"{counts['fused_range_scan']} times (expected {want}) and "
             f"nf_forward {counts['nf_forward']} (expected {want_nf}) for "
             f"{len(queries)} scan batches")
    return dict(scans_per_s=n_q / secs, rows_per_s=n_rows / secs,
                truncated=truncated, seconds=secs)


def shards_reached(boundaries, zlo, zhi) -> int:
    """How many shards a batch of ``[zlo, zhi)`` ranges reaches: shard
    ``s`` owns ``[B[s-1], B[s])``, so a non-empty range reaches every
    shard from the one that holds ``zlo`` to the one below the first
    boundary at or past ``zhi``."""
    b = np.asarray(boundaries, np.float32)
    ne = zhi > zlo
    cover = np.zeros(b.shape[0] + 2, np.int64)
    np.add.at(cover, np.searchsorted(b, zlo[ne], side="right"), 1)
    np.add.at(cover, np.searchsorted(b, zhi[ne], side="left") + 1, -1)
    return int((np.cumsum(cover)[:b.shape[0] + 1] > 0).sum())


def batch_shards(res, m, keys) -> int:
    """How many shards a point batch reaches: its ground-truth z (the
    bulk transform) binned at the boundaries here, apart from the
    router's own counters."""
    nfl = res["nfl"]
    z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys,
                                nfl.cfg.flow).astype(np.float32)
    return int(np.unique(np.searchsorted(nfl.index.boundaries, z,
                                         side="right")).shape[0])


def scan_args(nfl, sk, queries, dev):
    """Device arguments of the range kernel for each scan batch, on the
    index's current pools and tiers."""
    idx = nfl.index

    def feats(k):
        if nfl.use_flow:
            f = nfl._feats(k)
        else:
            f = k.astype(np.float32).reshape(-1, 1)
        return torch.from_numpy(np.ascontiguousarray(f)).to(dev)

    sp, tp = idx._serving.scan_pack(), idx._tier_pack()
    return [(feats(sk[r]), feats(sk[r + ln]), nfl._packed_w, sp, tp)
            for r, ln in queries]


def lookup_args(nfl, keys, dev, split_key_bits):
    hi, lo = split_key_bits(keys)
    if nfl.use_flow:
        f = nfl._feats(keys)
    else:
        f = keys.astype(np.float32).reshape(-1, 1)
    idx = nfl.index
    return (torch.from_numpy(np.ascontiguousarray(f)).to(dev),
            torch.from_numpy(hi.view(np.int32)).to(dev),
            torch.from_numpy(lo.view(np.int32)).to(dev),
            nfl._packed_w, idx._kernel_pools(), idx._tier_pack())


def lookup_kw(nfl):
    idx = nfl.index
    return dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                max_depth=idx.max_depth,
                dense_iters=idx.cfg.dense_search_iters,
                bucket_cap=idx.cfg.max_bucket,
                dense_window=idx.dense_window, use_flow=nfl.use_flow)


# ------------------------------------------------- drift and re-flow
def drift_keys(base, n, seed):
    """``bench_drift.py``'s drifting inserts at the card's scale: 16
    micro-clusters at the base's q0.80-q0.999, each key ``c * (1 +
    U(0, 1e-4))``, absent from the base, shuffled."""
    rng = np.random.default_rng(seed)
    centers = np.quantile(base, np.linspace(0.80, 0.999, 16))
    k = np.unique(np.concatenate(
        [c * (1 + rng.uniform(0, 1e-4, n // 16)) for c in centers]))
    k = k[~np.isin(k, base)]
    return rng.permutation(k)


class Live:
    """Live keys and payloads of phase 3r as appended arrays (every key
    is written once), sampled for reads: three quarters loaded keys, a
    quarter among the keys inserted so far."""

    def __init__(self, keys, pv):
        self.base_k, self.base_p = keys, pv
        self.ins_k, self.ins_p = [], []
        self.n_ins = 0

    def add(self, k, p):
        self.ins_k.append(k)
        self.ins_p.append(p)
        self.n_ins += k.shape[0]

    def sample(self, rng, n):
        n_new = n // 4 if self.n_ins else 0
        j = rng.integers(0, self.base_k.shape[0], n - n_new)
        k, p = [self.base_k[j]], [self.base_p[j]]
        if n_new:
            ik, ip = np.concatenate(self.ins_k), np.concatenate(self.ins_p)
            j = rng.integers(0, ik.shape[0], n_new)
            k.append(ik[j])
            p.append(ip[j])
        return np.concatenate(k), np.concatenate(p)

    def all(self):
        return (np.concatenate([self.base_k, *self.ins_k]),
                np.concatenate([self.base_p, *self.ins_p]))


def drift_phase(ln, m, win, dev, card):
    """Phase 3r: drift and re-flow on phase 3's lognormal load, the flow
    forced on and the re-flow enabled (``DRIFT_KNOBS``)."""
    name = "drift"
    wl = ln["wl"]
    load_k, load_p = wl.load_keys, wl.load_payloads
    rng = np.random.default_rng(ln["seed"] + 600)
    unloaded = rng.permutation(np.setdiff1d(ln["keys"], load_k,
                                            assume_unique=True))
    n_ins = BATCH * 4 // 5
    n_read = BATCH - n_ins
    plain = unloaded[:DRIFT_CONTROL_BATCHES * n_ins]
    miss = unloaded[DRIFT_CONTROL_BATCHES * n_ins:][:BATCH]
    n_drift = 3 * load_k.shape[0] // 8
    pool = drift_keys(load_k, n_drift + DRIFT_MAX_SETTLE * n_ins,
                      ln["seed"] + 700)
    pool = pool[~np.isin(pool, unloaded)]
    drift, settle = pool[:n_drift], pool[n_drift:]
    t_phase = time.perf_counter()

    def bulk():
        nfl = m.NFL(m.NFLConfig(
            backend="flat", force_flow=True,
            flow_train=m.FlowTrainConfig(epochs=1),
            flat_index=m.FlatAFLIConfig(rebuild_frac=DRIFT_REBUILD_FRAC),
            drift=m.DriftConfig(**DRIFT_KNOBS)))
        t = time.perf_counter()
        nfl.bulkload(load_k, load_p)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    (nfl, t_bulk), counts = win.run(bulk)
    idx, mgr = nfl.index, nfl._reflow
    check_ms = timed_checks(nfl)
    mt = nfl.metrics
    baseline = mgr.baseline_tail
    log(f"[{name}] {load_k.shape[0]} lognormal keys bulk-loaded (phase 3's "
        f"load) with the flow forced on, drift {DRIFT_KNOBS}: "
        f"{t_bulk:.2f} s (train {mt['flow_train_s']:.2f} s, build "
        f"{mt['index_build_s']:.2f} s); tails original "
        f"{mt['tail_conflict_original']:.0f}, transformed (the baseline, "
        f"over all {load_k.shape[0]} keys) {baseline}; shadowed "
        f"{idx.n_shadowed}; launches {counts}")
    live = Live(load_k, load_p)
    rec = collections.Counter()
    lps = {}

    def read(k, want, streamed, what):
        set_rung(nfl, 0 if streamed else None)
        t = time.perf_counter()
        got, c = win.run(lambda: nfl.lookup_batch(k), streamed=streamed)
        secs = time.perf_counter() - t
        set_rung(nfl, None)
        bad = int((got != want).sum())
        rec[f"wrong_{what}"] += bad
        rec["reads"] += k.shape[0]
        if streamed and c["streamed_lookup"] != 1:
            fail(f"{name}: a streamed read launched {c}")
        return secs

    # reads before the drift, and the misses
    secs = sum(read(k, p, False, "before") for _op, k, p in
               wl.batches[:DRIFT_READ_BATCHES])
    lps["before"] = DRIFT_READ_BATCHES * BATCH / secs
    read(miss, np.full(miss.shape[0], -1), False, "misses")
    read(miss, np.full(miss.shape[0], -1), True, "misses")

    ins_ms = {"control": [], "drift": [], "settle": []}
    trace = []          # per write call: what the manager and the fold did
    swap = {}
    fold_read = [0, 0.0]

    def write_call(b, kind, k, p):
        """One ``write_heavy`` batch: reads over the live keys (odd
        batches on the streamed rung), then ``insert_batch``, with an
        async read batch in flight across it while a re-flow runs."""
        st0 = mgr.stats()
        fold0 = idx._fold
        active = fold0 is not None and fold0.reflow is not None
        q, want = live.sample(rng, n_read)
        s = read(q, want, b % 2 == 1, "during")
        if active:
            fold_read[0] += q.shape[0]
            fold_read[1] += s
        qi = wi = None
        if active:
            qi, wi = live.sample(rng, DRIFT_INFLIGHT - 1024)
            qi = np.concatenate([qi, miss[:1024]])
            wi = np.concatenate([wi, np.full(1024, -1)])
        chunks0 = fold0.report["verify_chunks"] if active else 0
        phase0 = fold0.phase if active else None
        reflows0 = idx.n_reflows

        def drive():
            # the async batch reads the state at its dispatch, whatever
            # the write call does while it is in flight
            finish = nfl.lookup_batch_async(qi) if active else None
            t = time.perf_counter()
            nfl.insert_batch(k, p)
            return finish, (time.perf_counter() - t) * 1e3

        (finish, ms), c = win.run(drive)
        ins_ms[kind].append(ms)
        live.add(k, p)
        if finish is not None:
            rec["wrong_inflight"] += int((finish() != wi).sum())
            rec["inflight_batches"] += 1
        st1 = mgr.stats()
        row = {"b": b, "kind": kind, "ms": round(ms, 1),
               "state": f"{st0['state']}->{st1['state']}",
               "checks": st1["checks"] - st0["checks"],
               "launches": {key: c[key] for key in ("nf_forward",
                                                    "fused_lookup")}}
        if st1["triggers"] > st0["triggers"]:
            row["trigger"] = {"serving_tail": st1["last_serving_tail"],
                              "score": st1["last_score"]}
        if st1["reflows_started"] > st0["reflows_started"]:
            row["applied"] = True
            swap["t_apply"] = time.perf_counter() - ms / 1e3
            swap["apply_ms"] = ms
            swap["apply_b"] = b
        if active:
            fold1 = idx._fold
            row["fold"] = f"{phase0}->{fold1.phase if fold1 else 'swapped'}"
            row["verify_chunks"] = (fold1.report if fold1 is not None
                                    else idx.last_fold)["verify_chunks"] \
                - chunks0
        if idx.n_reflows > reflows0:
            row["swapped"] = True
            swap["t_swap"] = time.perf_counter()
            swap["swap_b"] = b
            swap["swap_inflight"] = finish is not None
        if c["streamed_lookup"]:
            fail(f"{name}: a write call launched streamed_lookup ({c})")
        trace.append(row)
        return row, c

    # plain lognormal inserts first (phase 3's traffic): no trigger
    b = 0
    for i in range(DRIFT_CONTROL_BATCHES):
        k = plain[i * n_ins:(i + 1) * n_ins]
        write_call(b, "control", k, (1 << 26) + b * n_ins
                   + np.arange(k.shape[0]))
        b += 1
    control = mgr.stats()
    log(f"[{name}] {DRIFT_CONTROL_BATCHES} batches of plain lognormal "
        f"inserts: reservoir tail {control['last_serving_tail']} (score "
        f"{control['last_score']:.2f}, {control['checks']} checks), "
        f"triggers {control['triggers']}")
    if control["triggers"] or not control["checks"]:
        fail(f"{name}: plain lognormal inserts triggered the re-flow (or "
             "no check ran)")
    window_checked = None
    for kind, keys in (("drift", drift), ("settle", settle)):
        for i in range(0, keys.shape[0], n_ins):
            if kind == "settle" and idx.n_reflows:
                break
            k = keys[i:i + n_ins]
            row, c = write_call(b, kind, k, (1 << 27) + b * n_ins
                                + np.arange(k.shape[0]))
            b += 1
            # one write call that only advances the fold's verify: its
            # launches are its insert's NF and one fused_lookup a chunk
            if (window_checked is None and row.get("fold") == "verify->verify"
                    and row["verify_chunks"] > 0):
                window_checked = dict(row)
                # one more fused_lookup: the batch in flight
                want = {"nf_forward": 1,
                        "fused_lookup": row["verify_chunks"] + 1}
                if row["launches"] != want:
                    fail(f"{name}: a write call advancing the verify "
                         f"launched {row['launches']}, expected {want}")
        if idx.n_reflows:
            break
    st = mgr.stats()
    if not idx.n_reflows or st["reflows_completed"] < 1:
        fail(f"{name}: no re-flow completed ({st}); trace {trace}")
    if window_checked is None:
        fail(f"{name}: no write call advanced the verify alone")
    if not swap.get("swap_inflight") or not rec["inflight_batches"]:
        fail(f"{name}: no read was in flight across the swap")
    reflow_s = swap["t_swap"] - swap["t_apply"]
    n_calls = swap["swap_b"] - swap["apply_b"] + 1
    fold = dict(idx.last_fold)
    sig = idx.drift_signals()
    trig = next(r for r in trace if "trigger" in r)
    train_ticks = sum(1 for r in trace if r["state"].startswith("training"))
    log(f"[{name}] trace of the write calls: {json.dumps(trace)}")
    log(f"[{name}] baseline tail {baseline}; serving tail at the trigger "
        f"{trig['trigger']['serving_tail']} (score "
        f"{trig['trigger']['score']:.2f}, batch {trig['b']}); accepted "
        f"tail {st['baseline_tail']}; training ticks {train_ticks}; "
        f"identity switches {st['identity_switches']}; AutoSwitch over the "
        f"re-keyed snapshot {sig['autoswitch']}")
    log(f"[{name}] re-flow: {reflow_s:.2f} s from apply (batch "
        f"{swap['apply_b']}, the call that takes the snapshot and re-keys "
        f"all of it: {swap['apply_ms']:.1f} ms) to swap (batch "
        f"{swap['swap_b']}), {n_calls} write calls; last_fold {fold}; "
        f"shadowed {idx.n_shadowed}; drift signals {sig} ({card})")
    log(f"[{name}] insert_batch ms median / max: plain "
        f"{statistics.median(ins_ms['control']):.1f} / "
        f"{max(ins_ms['control']):.1f}; drift and settle "
        f"{statistics.median(ins_ms['drift'] + ins_ms['settle']):.1f} / "
        f"{max(ins_ms['drift'] + ins_ms['settle']):.1f}; drift checks "
        f"{len(check_ms)}, ms median {statistics.median(check_ms):.2f} max "
        f"{max(check_ms):.2f} ({card})")
    lps["during_fold"] = fold_read[0] / fold_read[1]

    # after the swap: every live key on both rungs, the misses, a scan
    keys, pv = live.all()
    res = {"name": name, "nfl": nfl, "seed": ln["seed"],
           "truth": Truth(keys, pv)}
    for streamed in (False, True):
        secs = sum(read(keys[i:i + BATCH], pv[i:i + BATCH], streamed,
                        "after") for i in range(0, keys.shape[0], BATCH))
        if not streamed:
            lps["after"] = keys.shape[0] / secs
        read(miss, np.full(miss.shape[0], -1), streamed, "misses")
    sk, zs, ps = scan_truth(res, m, dev)
    queries = scan_queries(res, m, sk, 1)
    scan = run_scans(res, win, sk, zs, ps, queries, "after the re-flow")
    wrong = {key: v for key, v in rec.items() if key.startswith("wrong")}
    secs = time.perf_counter() - t_phase
    log(f"[{name}] reads {rec['reads']} wrong {wrong}; in flight across "
        f"write calls {rec['inflight_batches']} batches; lookups/s before "
        f"the drift {lps['before']:.0f}, during the fold "
        f"{lps['during_fold']:.0f}, after the swap {lps['after']:.0f}; "
        f"{keys.shape[0]} live keys; phase {secs:.1f} s ({card})")
    if any(wrong.values()):
        fail(f"{name}: wrong reads {wrong}")
    return {"baseline_tail": baseline,
            "trigger": trig, "accepted_tail": st["baseline_tail"],
            "training_ticks": train_ticks, "reflow_s": reflow_s,
            "reflow_write_calls": n_calls, "apply_ms": swap["apply_ms"],
            "last_fold": fold, "shadowed": idx.n_shadowed,
            "insert_ms": {kind: (statistics.median(v), max(v))
                          for kind, v in ins_ms.items() if v},
            "check_ms": (statistics.median(check_ms), max(check_ms)),
            "lookups_per_s": lps, "scan": scan, "seconds": secs,
            "wrong": wrong, "drift_keys": int(drift.shape[0]),
            "write_calls": len(trace), "stats": st}


# ------------------------------------- sharded migration and re-flow
def inflight_batch(rng, load_k, load_p, z_load, miss, z_miss):
    """The async batch kept in flight across a call: ``DRIFT_INFLIGHT``
    keys, a quarter of them misses; returns keys, payloads and z."""
    j = rng.integers(0, load_k.shape[0], DRIFT_INFLIGHT - 1024)
    return (np.concatenate([load_k[j], miss[:1024]]),
            np.concatenate([load_p[j], np.full(1024, -1)]),
            np.concatenate([z_load[j], z_miss[:1024]]))


def watch_freeze(idx, method):
    """Record, at each call of the sharded index's ``method`` (the start
    of an episode), which shards had a fold of their own in flight (the
    freeze drops them); returns the list it appends to."""
    seen = []
    real = getattr(idx, method)

    def start(*a, **k):
        seen.append([sh._fold is not None for sh in idx.shards])
        return real(*a, **k)

    setattr(idx, method, start)
    return seen


def swap_under_reads_check() -> str:
    """The card test's ``swap_under_reads`` (tests/test_torch_kernels_cuda
    .py) in a child process with ``CUDA_DEVICE_MAX_CONNECTIONS=32``: a
    migration swap, and then a freeze that reallocates a shard's run
    tier, each while the window's reads are held on their streams, the
    freed blocks overwritten at once from the caller's stream.  In this process the hazard cannot show: the driven calls
    run on the legacy default stream, and with the default 8 hardware
    queues a stream can wait for another that shares its queue, so the
    reads finish before the swap frees anything.  Returns the child's
    summary line."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS="32",
               PYTHONPATH=os.pathsep.join([str(root / "tests"),
                                           str(root / "src")]))
    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-c", "import test_torch_kernels_cuda as t; "
         "t.swap_under_reads(100_000)"], env=env, capture_output=True,
        text=True, timeout=600)
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith(("swap under reads", "freeze under reads"))]
    line = "; ".join(lines) or "no output"
    log(f"[migrate] {line} (child process, {time.perf_counter() - t:.1f} "
        f"s, rc {out.returncode})")
    if out.returncode:
        fail(f"migrate: the swap under reads in flight failed: "
             f"{out.stderr[-2000:]}")
    return line


def reached(z, boundaries) -> int:
    """How many shards a point batch with ground-truth z reaches."""
    from repro_torch.kernels.shard_dispatch import route
    return int(np.unique(route(z, boundaries)).shape[0])


def fold_chunks(ep) -> int:
    """Verify chunks the candidate folds of a sharded episode have run."""
    if ep is None:
        return 0
    return sum(f.report["verify_chunks"] if f is not None
               else c.last_fold.get("verify_chunks", 0)
               for f, c in zip(ep.folds, ep.candidates))


def shard_counters(sh) -> tuple:
    """A shard's repack and upload counters (pools, tiers, scan pool)."""
    s = sh._serving.stats()
    return tuple(s[k] for k in ("tree_packs", "tier_uploads", "tier_repacks",
                                "scan_uploads", "scan_repacks"))


def straddle_scan(nfl, win, keys, pv, z, bnd, seed, what):
    """``STRADDLE`` ranges over the live keys in z order, each starting
    within 100 ranks below ``bnd`` and ending 2-29 ranks past it, through
    ``NFL.scan_batch`` and held to the ground truth (``run_scans``);
    fails unless every one of them was split at a boundary."""
    order = np.argsort(z, kind="stable")
    sk, zs, ps = keys[order], z[order], pv[order]
    q = straddling_queries({"nfl": nfl}, zs, [bnd], seed)
    before = nfl.index._router["straddling_ranges"]
    run_scans({"name": "migrate", "nfl": nfl}, win, sk, zs, ps, q, what)
    n = nfl.index._router["straddling_ranges"] - before
    if n < STRADDLE:
        fail(f"migrate: {n} of {STRADDLE} ranges straddled B[0] ({what})")
    return n


def migration_phase(ln, m, win, dev, card):
    """Phase 4m: ``bench_resharding.py``'s pathology on phase 3's
    lognormal load through ``NFL(shards=4)``, flow forced on: reads aimed
    60% at shard 0 and an insert storm of jittered shard-0 keys, until the
    reshard manager migrates the window [0, 1]; then a migration whose
    folds fault, rolled back."""
    from repro_torch.kernels.shard_dispatch import route
    name = "migrate"
    wl = ln["wl"]
    load_k, load_p = wl.load_keys, wl.load_payloads
    t_phase = time.perf_counter()

    def bulk():
        nfl = m.NFL(m.NFLConfig(
            backend="flat", shards=N_SHARDS, force_flow=True,
            flow_train=m.FlowTrainConfig(epochs=1),
            reshard=m.ReshardConfig(**MIGRATE_KNOBS)))
        t = time.perf_counter()
        nfl.bulkload(load_k, load_p)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    (nfl, t_bulk), counts = win.run(bulk)
    idx, mgr = nfl.index, nfl._reshard
    b0 = idx.boundaries.copy()
    freeze = watch_freeze(idx, "start_reshard")

    def z_of(k):
        return m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, k,
                                       nfl.cfg.flow, dev).astype(np.float32)

    z_load = z_of(load_k)
    miss = ln["miss_keys"]
    z_miss = z_of(miss)
    hot = np.flatnonzero(z_load < b0[0])
    cold = np.flatnonzero(z_load >= b0[0])
    rng = np.random.default_rng(ln["seed"] + 800)
    n_storm = 3 * load_k.shape[0] // 8
    storm = np.unique(rng.choice(load_k[hot], n_storm)
                      * (1.0 + rng.uniform(1e-6, 1e-4, n_storm)))
    storm = rng.permutation(storm[~np.isin(storm, ln["keys"])])
    storm_p = (1 << 28) + np.arange(storm.shape[0], dtype=np.int64)
    z_storm = z_of(storm)
    log(f"[{name}] {load_k.shape[0]} lognormal keys bulk-loaded (phase 3's "
        f"load) on {N_SHARDS} shards, flow forced on, reshard "
        f"{MIGRATE_KNOBS}: {t_bulk:.2f} s; boundaries {b0.tolist()}; shard 0 "
        f"holds {hot.shape[0]} loaded keys; storm {storm.shape[0]} keys, "
        f"{int((z_storm < b0[0]).sum())} of them below B[0]; launches "
        f"{counts}")
    n_ins = [0]

    def live():
        k = storm[:n_ins[0]]
        return (np.concatenate([load_k, k]),
                np.concatenate([load_p, storm_p[:n_ins[0]]]),
                np.concatenate([z_load, z_storm[:n_ins[0]]]))

    straddled = {"before": straddle_scan(nfl, win, *live(), b0[0],
                                         ln["seed"] + 810, "straddling B[0] "
                                         "before the episode")}
    rec = collections.Counter()
    trace, lps, share = [], collections.defaultdict(list), {}
    ep_ref, swap, frozen = [None], {}, {}
    router = idx._router

    def call(kind, k, p, z, regime):
        """One call of ``kind`` ("read": a batch of 65,536 reads; "write":
        a storm batch) with an async read batch in flight across it, in
        its own launch window."""
        qi, wi, zi = inflight_batch(rng, load_k, load_p, z_load, miss,
                                    z_miss)
        bnd = idx.boundaries.copy()
        ep0 = idx._reshard
        v0 = fold_chunks(ep0)
        checks0 = nfl._reflow.checks
        eps0, done0 = mgr.resharding_episodes, idx.n_reshards
        pts0 = list(router["per_shard_points"])

        def drive():
            t0 = time.perf_counter()
            fin = nfl.lookup_batch_async(qi)
            mid = idx.boundaries.copy()
            t = time.perf_counter()
            if kind == "read":
                got = nfl.lookup_batch(k)
            else:
                nfl.insert_batch(k, p)
                got = None
            t1 = time.perf_counter()
            return fin, got, t1 - t, t1 - t0, mid

        (fin, got, secs, total, mid), c = win.run(drive)
        rec["wrong_inflight"] += int((fin() != wi).sum())
        rec["inflight_batches"] += 1
        if mgr.resharding_episodes > eps0 and regime == "before":
            regime = "apply"        # the call that freezes the window
        if got is not None:
            rec[f"wrong_{regime}"] += int((got != p).sum())
            rec["reads"] += k.shape[0]
            lps[regime].append((k.shape[0], secs))
            share.setdefault(regime, np.zeros(N_SHARDS))
            share[regime] += np.asarray(router["per_shard_points"]) \
                - np.asarray(pts0)
        ep1 = idx._reshard
        if ep1 is not None and ep_ref[0] is None:
            ep_ref[0] = ep1
        row = {"b": len(trace), "kind": kind, "ms": round(total * 1e3, 1),
               "launches": {key: c[key] for key in ("nf_forward",
                                                    "fused_lookup")}}
        if mgr.resharding_episodes > eps0:
            row["trigger"] = {"hot_shard": mgr.last_hot_shard,
                              "share": round(mgr.last_hot_share, 4),
                              "window": list(mgr.last_window),
                              "shard_folds_at_freeze": freeze[-1]}
            swap.update(t_apply=time.perf_counter() - total,
                        apply_ms=total * 1e3, apply_b=row["b"])
            frozen.update(bnd=bnd.copy(), ids=[id(sh) for sh in idx.shards],
                          counters=[shard_counters(sh)
                                    for sh in idx.shards[2:]])
        ep = ep1 or ep0 or ep_ref[0]
        if ep0 is not None or ep1 is not None:
            dv = fold_chunks(ep) - v0
            row["verify_chunks"] = dv
            if ep0 is not None:
                # a call inside the episode: its launches are exact
                # the main read fans out over the boundaries left by
                # the batch in flight (a swap may come in its call)
                want_l = (reached(zi, bnd) + dv + (reached(z, mid)
                                                   if kind == "read" else 0))
                want_n = 1 + (1 if kind == "read" else
                              1 + nfl._reflow.checks - checks0)
                if (c["fused_lookup"], c["nf_forward"],
                        c["streamed_lookup"], c["fused_range_scan"]) \
                        != (want_l, want_n, 0, 0):
                    rec["windows_off"] += 1
                    row["want"] = {"fused_lookup": want_l,
                                   "nf_forward": want_n}
        if idx.n_reshards > done0:
            row["swapped"] = True
            swap.update(t_swap=time.perf_counter(), swap_b=row["b"])
        trace.append(row)

    def read_call(regime):
        n_hot = int(BATCH * HOT_READ_FRAC)
        j = np.concatenate([rng.choice(hot, n_hot),
                            rng.choice(cold, BATCH - n_hot)])
        call("read", load_k[j], load_p[j], z_load[j], regime)

    # before: reads and storm writes in turns until the trigger
    i = 0
    during_scan = None
    while len(trace) < MAX_MIGRATE_CALLS and not idx.n_reshards:
        regime = "before" if ep_ref[0] is None else "during"
        if i < storm.shape[0]:
            k = storm[i:i + BATCH]
            call("write", k, storm_p[i:i + BATCH], z_storm[i:i + BATCH],
                 regime)
            n_ins[0] = i = i + k.shape[0]
        if idx.n_reshards:
            break
        if ep_ref[0] is not None and during_scan is None:
            straddled["during"] = straddle_scan(
                nfl, win, *live(), frozen["bnd"][0], ln["seed"] + 811,
                "straddling B[0] during the episode")
            during_scan = True
        read_call("before" if ep_ref[0] is None else "during")
    if not idx.n_reshards or ep_ref[0] is None:
        fail(f"{name}: no migration swapped in {len(trace)} calls; trace "
             f"{json.dumps(trace)}")
    ep = ep_ref[0]
    b1 = idx.boundaries.copy()
    trig = next(r for r in trace if "trigger" in r)
    log(f"[{name}] trace of the calls: {json.dumps(trace)}")
    # the splice moved B[0] only; shards 2 and 3 untouched
    same = [id(sh) for sh in idx.shards[2:]] == frozen["ids"][2:]
    untouched = [shard_counters(sh) for sh in idx.shards[2:]] \
        == frozen["counters"]
    log(f"[{name}] boundaries at the freeze {frozen['bnd'].tolist()} -> "
        f"{b1.tolist()} (interior {ep.interior.tolist()}); B[1], B[2] "
        f"bit-identical {np.array_equal(b1[1:].view(np.int32), frozen['bnd'][1:].view(np.int32))}; "
        f"shards 2 and 3 the same objects {same}, no repack or upload "
        f"{untouched}; candidates {[c.n_keys for c in ep.candidates]} keys, "
        f"d_tail {[c.d_tail for c in ep.candidates]}, AutoSwitch "
        f"{[c.autoswitch for c in ep.candidates]}, last_fold "
        f"{[c.last_fold for c in ep.candidates]}")
    if not np.array_equal(b1[1:].view(np.int32),
                          frozen["bnd"][1:].view(np.int32)) \
            or b1[0] == frozen["bnd"][0]:
        fail(f"{name}: the splice did not move B[0] alone")
    if not (same and untouched):
        fail(f"{name}: the migration touched shard 2 or 3")
    if rec["windows_off"]:
        fail(f"{name}: {rec['windows_off']} calls of the episode launched "
             "other than one fused_lookup a verify chunk plus the reads")
    # after the splice: the router's shard ids are the host's route of
    # the ground-truth z, its z bit-equal to it
    off = 0
    for _ in range(MIGRATE_AFTER):
        read_call("after")
        j = rng.integers(0, load_k.shape[0], BATCH)
        zr, sids = idx._route_flow(nfl._feats(load_k[j]), nfl._packed_w,
                                   nfl._shapes)
        off += int((sids != route(z_load[j], idx.boundaries)).sum()) \
            + int((zr.view(np.int32) != z_load[j].view(np.int32)).sum())
    if off:
        fail(f"{name}: the router disagrees with the host route after the "
             f"splice ({off} keys)")
    straddled["after"] = straddle_scan(nfl, win, *live(), b1[0],
                                       ln["seed"] + 812,
                                       "straddling the new B[0]")
    # a migration whose folds fault: rolled back, the old boundaries serve
    aborts, swaps = [], []
    (ok, c_start) = win.run(lambda: idx.start_reshard(
        0, 1, on_swap=lambda: swaps.append(1),
        on_abort=lambda: aborts.append(1)))
    with m.faults.inject(m.faults.FaultPlan(fail_reshard="fold"), nfl=nfl):
        read_call("fault")
    held = [sh._tier_hold for sh in idx.shards]
    log(f"[{name}] injected fold fault: started {ok}, aborted {aborts}, "
        f"swapped {swaps}, n_reshard_aborts {idx.n_reshard_aborts}, "
        f"boundaries {idx.boundaries.tolist()}, holds {held}")
    if not ok or aborts != [1] or swaps or idx.n_reshard_aborts != 1 \
            or idx._reshard is not None or any(held) \
            or not np.array_equal(idx.boundaries, b1):
        fail(f"{name}: the faulted migration did not roll back")
    for _ in range(2):
        read_call("fault")
    hazard = swap_under_reads_check()
    keys, pv, _z = live()
    res = {"name": name, "nfl": nfl, "truth": Truth(keys, pv)}
    readback(res, keys, win, "every live key after the episodes")
    wrong = {key: v for key, v in rec.items() if key.startswith("wrong")}
    rates = {g: sum(n for n, _s in v) / sum(s for _n, s in v)
             for g, v in lps.items()}
    shares = {g: (v / max(v.sum(), 1)).round(4).tolist()
              for g, v in share.items()}
    secs = time.perf_counter() - t_phase
    st = mgr.stats()
    out = {"bulkload_s": t_bulk, "trigger_call": trig["b"],
           "trigger": trig["trigger"], "apply_ms": swap["apply_ms"],
           "apply_to_swap_s": swap["t_swap"] - swap["t_apply"],
           "apply_to_swap_calls": swap["swap_b"] - swap["apply_b"] + 1,
           "lookups_per_s": rates, "shard_shares": shares,
           "straddled": straddled, "boundaries": [b0.tolist(),
                                                  b1.tolist()],
           "manager": st, "wrong": wrong, "calls": len(trace),
           "swap_under_reads": hazard, "seconds": secs}
    log(f"[{name}] trigger at call {trig['b']} ({trig['kind']}, hot shard "
        f"{trig['trigger']['hot_shard']} at share "
        f"{trig['trigger']['share']}), apply call {swap['apply_ms']:.1f} "
        f"ms, {out['apply_to_swap_s']:.2f} s and "
        f"{out['apply_to_swap_calls']} calls from apply to swap; lookups/s "
        f"{json.dumps({g: round(v) for g, v in rates.items()})}; routed "
        f"shares per shard {shares}; reads {rec['reads']} wrong {wrong}, "
        f"{rec['inflight_batches']} batches in flight across calls; "
        f"manager {st}; phase {secs:.1f} s ({card})")
    if any(wrong.values()):
        fail(f"{name}: wrong reads {wrong}")
    return out


def sharded_reflow_phase(ln, m, win, dev, card, single):
    """Phase 4r: phase 3r's drift stream on phase 3's lognormal load
    through ``NFL(shards=4)``, flow forced on, ``DriftConfig(**
    DRIFT_KNOBS)`` at the default ``rebuild_frac`` (the shards fold on
    their own), until a cross-shard re-key swaps; ``single`` is phase
    3r's record, printed beside."""
    from repro_torch.kernels.shard_dispatch import choose_boundaries, route
    name = "sharded re-flow"
    wl = ln["wl"]
    load_k, load_p = wl.load_keys, wl.load_payloads
    rng = np.random.default_rng(ln["seed"] + 600)
    unloaded = rng.permutation(np.setdiff1d(ln["keys"], load_k,
                                            assume_unique=True))
    n_ins = BATCH * 4 // 5
    n_read = BATCH - n_ins
    plain = unloaded[:DRIFT_CONTROL_BATCHES * n_ins]
    miss = unloaded[DRIFT_CONTROL_BATCHES * n_ins:][:BATCH]
    n_drift = 3 * load_k.shape[0] // 8
    pool = drift_keys(load_k, n_drift + DRIFT_MAX_SETTLE * n_ins,
                      ln["seed"] + 700)
    pool = pool[~np.isin(pool, unloaded)]
    drift, settle = pool[:n_drift], pool[n_drift:]
    t_phase = time.perf_counter()

    def bulk():
        nfl = m.NFL(m.NFLConfig(
            backend="flat", shards=N_SHARDS, force_flow=True,
            flow_train=m.FlowTrainConfig(epochs=1),
            drift=m.DriftConfig(**DRIFT_KNOBS)))
        t = time.perf_counter()
        nfl.bulkload(load_k, load_p)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    (nfl, t_bulk), counts = win.run(bulk)
    idx, mgr = nfl.index, nfl._reflow
    b0 = idx.boundaries.copy()
    freeze = watch_freeze(idx, "start_reflow")
    baseline = mgr.baseline_tail
    log(f"[{name}] {load_k.shape[0]} lognormal keys bulk-loaded on "
        f"{N_SHARDS} shards, flow forced on, drift {DRIFT_KNOBS}, "
        f"rebuild_frac {idx.cfg.rebuild_frac}: {t_bulk:.2f} s; baseline "
        f"tail {baseline}; boundaries {b0.tolist()}; launches {counts}")
    live = Live(load_k, load_p)
    rec = collections.Counter()
    lps = {}

    def read(k, want, what):
        t = time.perf_counter()
        got, _c = win.run(lambda: nfl.lookup_batch(k))
        secs = time.perf_counter() - t
        rec[f"wrong_{what}"] += int((got != want).sum())
        rec["reads"] += k.shape[0]
        return secs

    secs = sum(read(k, p, "before") for _op, k, p in
               wl.batches[:DRIFT_READ_BATCHES])
    lps["before"] = DRIFT_READ_BATCHES * BATCH / secs
    read(miss, np.full(miss.shape[0], -1), "misses")
    ins_ms = {"control": [], "drift": [], "settle": []}
    trace, swap, at_apply = [], {}, {}
    fold_read = [0, 0.0]

    def write_call(b, kind, k, p):
        st0 = mgr.stats()
        active = idx._reflow is not None
        q, want = live.sample(rng, n_read)
        s = read(q, want, "during" if active else "writes")
        if active:
            fold_read[0] += q.shape[0]
            fold_read[1] += s
        qi = wi = None
        if active:
            qi, wi = live.sample(rng, DRIFT_INFLIGHT - 1024)
            qi = np.concatenate([qi, miss[:1024]])
            wi = np.concatenate([wi, np.full(1024, -1)])
        reflows0 = idx.n_reflows

        def drive():
            finish = nfl.lookup_batch_async(qi) if active else None
            t = time.perf_counter()
            nfl.insert_batch(k, p)
            return finish, (time.perf_counter() - t) * 1e3

        (finish, ms), c = win.run(drive)
        ins_ms[kind].append(ms)
        live.add(k, p)
        if finish is not None:
            rec["wrong_inflight"] += int((finish() != wi).sum())
            rec["inflight_batches"] += 1
        st1 = mgr.stats()
        row = {"b": b, "kind": kind, "ms": round(ms, 1),
               "state": f"{st0['state']}->{st1['state']}",
               "launches": {key: c[key] for key in ("nf_forward",
                                                    "fused_lookup")}}
        if st1["triggers"] > st0["triggers"]:
            row["trigger"] = {"serving_tail": st1["last_serving_tail"],
                              "score": st1["last_score"]}
        if st1["reflows_started"] > st0["reflows_started"]:
            row["applied"] = {"shard_folds_at_freeze": freeze[-1]}
            swap.update(t_apply=time.perf_counter() - ms / 1e3,
                        apply_ms=ms, apply_b=b)
            # the freeze's live keys: every key written so far, this
            # call's batch included (the tick follows its inserts)
            at_apply["keys"] = live.all()[0]
        if idx.n_reflows > reflows0:
            row["swapped"] = True
            swap.update(t_swap=time.perf_counter(), swap_b=b,
                        swap_inflight=finish is not None)
        if c["streamed_lookup"]:
            fail(f"{name}: a write call launched streamed_lookup ({c})")
        trace.append(row)

    b = 0
    for i in range(DRIFT_CONTROL_BATCHES):
        k = plain[i * n_ins:(i + 1) * n_ins]
        write_call(b, "control", k, (1 << 26) + b * n_ins
                   + np.arange(k.shape[0]))
        b += 1
    if mgr.triggers:
        fail(f"{name}: plain lognormal inserts triggered the re-flow")
    for kind, keys in (("drift", drift), ("settle", settle)):
        for i in range(0, keys.shape[0], n_ins):
            if kind == "settle" and idx.n_reflows:
                break
            k = keys[i:i + n_ins]
            write_call(b, kind, k, (1 << 27) + b * n_ins
                       + np.arange(k.shape[0]))
            b += 1
        if idx.n_reflows:
            break
    st = mgr.stats()
    log(f"[{name}] trace of the write calls: {json.dumps(trace)}")
    if not idx.n_reflows or st["reflows_completed"] < 1:
        fail(f"{name}: no sharded re-flow completed ({st})")
    if not swap.get("swap_inflight") or not rec["inflight_batches"]:
        fail(f"{name}: no read was in flight across the swap")
    trig = next(r for r in trace if "trigger" in r)
    b1 = idx.boundaries.copy()
    # the boundaries: the equal-mass quantiles of the freeze's live keys
    # under the accepted transform, one ops.nf_transform_keys call
    zk = (m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer,
                                  at_apply["keys"], nfl.cfg.flow, dev)
          if nfl.use_flow else at_apply["keys"]).astype(np.float32)
    want_b = choose_boundaries(np.sort(zk, kind="stable"), N_SHARDS)
    keys, pv = live.all()
    j = rng.integers(0, keys.shape[0], BATCH)
    zr, sids = idx._route_flow(nfl._feats(keys[j]), nfl._packed_w,
                               nfl._shapes)
    zt = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys[j],
                                 nfl.cfg.flow, dev).astype(np.float32)
    z_off = int((zr.view(np.int32) != zt.view(np.int32)).sum())
    sid_off = int((sids != route(zt, b1)).sum())
    verdicts = [sh.autoswitch for sh in idx.shards]
    log(f"[{name}] boundaries {b0.tolist()} -> {b1.tolist()}; the freeze's "
        f"{at_apply['keys'].shape[0]} live keys under the accepted flow "
        f"give {want_b.tolist()} (bit-equal "
        f"{np.array_equal(b1.view(np.int32), want_b.view(np.int32))}); "
        f"router z vs nf_forward under the new weights: {z_off} of {BATCH} "
        f"differ, shard ids vs the host route: {sid_off}; use_flow "
        f"{nfl.use_flow}; shards' keys {[sh.n_keys for sh in idx.shards]}, "
        f"AutoSwitch {verdicts}, last_fold "
        f"{[sh.last_fold for sh in idx.shards]}")
    if not np.array_equal(b1.view(np.int32), want_b.view(np.int32)) \
            or np.array_equal(b1, b0):
        fail(f"{name}: the boundaries were not re-derived from the new "
             "flow's z")
    if z_off or sid_off:
        fail(f"{name}: the router disagrees with nf_forward after the swap")
    if any(v.get("use_flow") is None for v in verdicts):
        fail(f"{name}: a shard carries no AutoSwitch verdict")
    reflow_s = swap["t_swap"] - swap["t_apply"]
    n_calls = swap["swap_b"] - swap["apply_b"] + 1
    lps["during_episode"] = fold_read[0] / fold_read[1]
    secs = sum(read(keys[i:i + BATCH], pv[i:i + BATCH], "after")
               for i in range(0, keys.shape[0], BATCH))
    lps["after"] = keys.shape[0] / secs
    read(miss, np.full(miss.shape[0], -1), "misses")
    res = {"name": name, "nfl": nfl, "seed": ln["seed"],
           "truth": Truth(keys, pv)}
    sk, zs, ps = scan_truth(res, m, dev)
    scan = run_scans(res, win, sk, zs, ps, scan_queries(res, m, sk, 1),
                     "after the sharded re-flow")
    wrong = {key: v for key, v in rec.items() if key.startswith("wrong")}
    secs = time.perf_counter() - t_phase
    med = statistics.median(ins_ms["drift"] + ins_ms["settle"])
    out = {"bulkload_s": t_bulk, "baseline_tail": baseline,
           "trigger": trig, "ticks_trigger_to_apply":
           swap["apply_b"] - trig["b"], "accepted_tail": st["baseline_tail"],
           "reflow_s": reflow_s, "reflow_write_calls": n_calls,
           "apply_ms": swap["apply_ms"],
           "insert_ms": {kind: (statistics.median(v), max(v))
                         for kind, v in ins_ms.items() if v},
           "lookups_per_s": lps, "scan": scan, "seconds": secs,
           "wrong": wrong, "boundaries": [b0.tolist(), b1.tolist()],
           "write_calls": len(trace), "stats": st}
    log(f"[{name}] trigger on batch {trig['b']} (serving tail "
        f"{trig['trigger']['serving_tail']}, score "
        f"{trig['trigger']['score']:.2f}; baseline {baseline}), applied "
        f"{out['ticks_trigger_to_apply']} ticks later (batch "
        f"{swap['apply_b']}, {swap['apply_ms']:.1f} ms), accepted tail "
        f"{st['baseline_tail']}; {reflow_s:.2f} s and {n_calls} write calls "
        f"from apply to swap (single index, phase 3r: "
        f"{single['reflow_s']:.2f} s, {single['reflow_write_calls']} calls, "
        f"apply {single['apply_ms']:.1f} ms); insert_batch ms median "
        f"{med:.1f} (phase 3r {single['insert_ms']['drift'][0]:.1f}); "
        f"lookups/s {json.dumps({g: round(v) for g, v in lps.items()})} "
        f"(phase 3r {json.dumps({g: round(v) for g, v in single['lookups_per_s'].items()})}); "
        f"reads {rec['reads']} wrong {wrong}, {rec['inflight_batches']} "
        f"batches in flight across write calls; phase {secs:.1f} s ({card})")
    if any(wrong.values()):
        fail(f"{name}: wrong reads {wrong}")
    return out


# ------------------------------------------------------ sharded serving
def sharded_load_and_read(base, m, win):
    """Phase 4a: the longlat load of phase 2 (same keys, seed and loaded
    half) through ``NFL(NFLConfig(backend="flat", shards=4))`` on the
    card, AutoSwitch deciding (rerun with ``force_flow=True`` if it
    declines)."""
    wl = base["wl"]

    def bulkload(force):
        torch.cuda.reset_peak_memory_stats()
        nfl = m.NFL(m.NFLConfig(
            backend="flat", shards=N_SHARDS, force_flow=force,
            flow_train=m.FlowTrainConfig(**FLOW_TRAIN)))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        torch.cuda.synchronize()
        return nfl, time.perf_counter() - t

    def load():
        nfl, t_bulk = bulkload(None)
        if not nfl.use_flow:
            log(f"[sharded] AutoSwitch declined the flow (tails "
                f"{nfl.metrics['tail_conflict_original']:.0f} -> "
                f"{nfl.metrics['tail_conflict_transformed']:.0f}); "
                "rerunning with force_flow=True")
            m.ops.reset_launch_counts()
            nfl, t_bulk = bulkload(True)
        return nfl, t_bulk

    (nfl, t_bulk), counts = win.run(load)
    peak = torch.cuda.max_memory_allocated()
    idx = nfl.index
    st = nfl.stats()
    mt = nfl.metrics
    log(f"[sharded] {N_SHARDS} shards on {st['devices']}, boundaries "
        f"{st['boundaries']}; use_flow={nfl.use_flow}")
    for s, sh in enumerate(st["shards"]):
        log(f"[sharded] shard {s}: {sh['n_keys']} keys, depth "
            f"{sh['max_depth']}, pool bytes {sh['serving']['pool_bytes']} "
            f"({sh['n_nodes']} nodes), shadowed {sh['n_shadowed']}, "
            f"AutoSwitch {sh['autoswitch']}")
    log(f"[sharded] bulkload {t_bulk:.2f} s = train {mt['flow_train_s']:.2f} "
        f"s + transform {mt['transform_s']:.2f} s + build and verify "
        f"{mt['index_build_s']:.2f} s (single index, phase 2: "
        f"{base['bulkload_s']:.2f} s); sharded verify repaired "
        f"{mt['serve_verify_shadowed']:.0f} keys (expected 0); launches "
        f"{counts}; max_memory_allocated {peak / 2**30:.2f} GiB (single "
        f"index after its bulkload and reads: "
        f"{base['peak_bytes'] / 2**30:.2f} GiB)")
    if not nfl.use_flow:
        fail("sharded: the flow is off")
    if st["n_keys"] != wl.load_keys.shape[0]:
        fail(f"sharded: {st['n_keys']} keys indexed of "
             f"{wl.load_keys.shape[0]}")
    return {"name": "sharded", "nfl": nfl, "keys": base["keys"], "wl": wl,
            "unloaded": base["unloaded"], "seed": base["seed"],
            "miss_keys": base["miss_keys"], "batches": base["batches"],
            "truth": Truth(wl.load_keys, wl.load_payloads), "use_flow": True,
            "bulkload_s": t_bulk, "peak_bytes": peak}


def sharded_reads(res, win, what, single=None):
    """The 64 read batches through ``NFL.lookup_batch``, each in its own
    launch window: one router ``nf_forward`` and one ``fused_lookup``
    per shard that its keys reach (``res["batch_shards"]``); every read
    against the ground truth and, on the fresh index, against the single
    index's payloads of phase 2a."""
    nfl = res["nfl"]
    truth = res["truth"]
    wrong = diff = n = 0
    bad = []
    secs = 0.0
    for b, (k, segs) in enumerate(zip(res["batches"],
                                      res["batch_shards"])):
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, c = win.run(lambda k=k: nfl.lookup_batch(k))
        secs += time.perf_counter() - t
        if (c["nf_forward"], c["fused_lookup"], c["streamed_lookup"],
                c["index_probe"]) != (1, segs, 0, 0):
            bad.append((b, segs, c))
        wrong += int((got != truth.lookup(k)).sum())
        if single is not None:
            diff += int((got != single[b]).sum())
        n += k.shape[0]
    log(f"[sharded] reads ({what}): {n} in {len(res['batches'])} batches, "
        f"wrong={wrong}, differ from the single index's (phase 2a) "
        f"{diff if single is not None else 'not compared'}; "
        f"{n / secs:.0f} lookups/s end to end; launch windows off "
        f"{bad[:3]} ({len(bad)} batches)")
    if wrong or diff or bad:
        fail(f"sharded: {wrong} wrong reads, {diff} differ from the single "
             f"index, {len(bad)} batches with wrong launch windows")
    return n / secs


def router_z_check(res, split_key_bits):
    """The router's z (``route_flow``: the NF kernel) against the fused
    rung's z (NF in ``fused_lookup``) on every read batch: bit-equal.
    Compare-only launches, outside the windows."""
    nfl = res["nfl"]
    idx = nfl.index
    diff = 0
    for k in res["batches"]:
        feats = nfl._feats(k)
        z, _sid = idx._route_flow(feats, nfl._packed_w, nfl._shapes)
        hi, lo = split_key_bits(k)
        _p, zf = idx.shards[0]._flow_device_lookup(feats, hi, lo,
                                                   nfl._packed_w, nfl._shapes)
        diff += int((z.view(np.int32) != zf.view(np.int32)).sum())
    log(f"[sharded] router z against the fused rung's z on "
        f"{len(res['batches'])} read batches: {diff} differ (bound 0)")
    if diff:
        fail("sharded: the router's z differs from the fused rung's")


def sharded_async(res, win, single):
    """Two read batches through ``NFL.lookup_batch_async``, both in flight
    before either finishes (finished in reverse order)."""
    nfl = res["nfl"]
    b0, b1 = res["batches"][:2]

    def drive():
        f0 = nfl.lookup_batch_async(b0)
        f1 = nfl.lookup_batch_async(b1)
        return f1(), f0()

    (r1, r0), c = win.run(drive)
    diff = int((r0 != single[0]).sum()) + int((r1 != single[1]).sum())
    log(f"[sharded] two batches in flight through lookup_batch_async: "
        f"{diff} reads differ from the single index's; launches {c}")
    if diff or c["nf_forward"] != 2:
        fail("sharded: wrong async reads")


def busy_shard_writes(res, m, win):
    """``write_heavy`` batches of 65,536 aimed at one shard: 80% inserts
    of unloaded keys whose z routes to shard ``BUSY_SHARD``, 20% reads of
    live keys over all shards (a quarter of them among the keys inserted
    so far), until that shard's fold starts and completes in-stream.
    Every read is checked, those served mid-fold included; the other
    shards must not fold.  Then every inserted key is read back."""
    from repro_torch.kernels.shard_dispatch import route
    nfl = res["nfl"]
    idx = nfl.index
    busy = idx.shards[BUSY_SHARD]
    truth = res["truth"]
    rng = np.random.default_rng(res["seed"] + 400)
    z = m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer,
                                res["unloaded"], nfl.cfg.flow)
    pool = res["unloaded"][route(z.astype(np.float32), idx.boundaries)
                           == BUSY_SHARD]
    del z
    # the miss batch stays unloaded
    pool = rng.permutation(pool[~np.isin(pool, res["miss_keys"])])
    n_ins = BATCH * 4 // 5
    loaded, loaded_pv = truth.keys, truth.pv
    rebuilds0 = [sh.n_rebuilds for sh in idx.shards]
    writes0 = list(idx._router["per_shard_writes"])
    rec = collections.Counter()
    ins_ms, fold_batches = [], []
    ins_k = np.empty(0, np.float64)
    ins_p = np.empty(0, np.int64)

    def drive():
        nonlocal ins_k, ins_p
        t = time.perf_counter()
        for b in range(MAX_SHARD_WRITE_BATCHES):
            mid = busy._fold is not None
            n_old = BATCH - n_ins
            if ins_k.shape[0]:
                n_new = n_old // 4
                j = rng.integers(0, ins_k.shape[0], n_new)
                qk, qp = ins_k[j], ins_p[j]
            else:
                n_new = 0
                qk = qp = np.empty(0)
            j = rng.integers(0, loaded.shape[0], n_old - n_new)
            q = np.concatenate([loaded[j], qk])
            want = np.concatenate([loaded_pv[j], qp])
            got = nfl.lookup_batch(q)
            rec["wrong"] += int((got != want).sum())
            rec["reads"] += q.shape[0]
            rec["mid_fold_reads"] += q.shape[0] if mid else 0
            k = pool[b * n_ins:(b + 1) * n_ins]
            if not k.shape[0]:
                fail(f"sharded: the unloaded keys of shard {BUSY_SHARD} ran "
                     f"out after {b} batches with its fold unfinished")
            p = (1 << 27) + b * n_ins + np.arange(k.shape[0])
            t1 = time.perf_counter()
            nfl.insert_batch(k, p)
            ins_ms.append((time.perf_counter() - t1) * 1e3)
            ins_k = np.concatenate([ins_k, k])
            ins_p = np.concatenate([ins_p, p])
            if mid or busy._fold is not None:
                fold_batches.append(b)
            if busy.n_rebuilds > rebuilds0[BUSY_SHARD]:
                break
        return time.perf_counter() - t

    secs, counts = win.run(drive)
    truth.insert(ins_k, ins_p)
    rebuilds = [sh.n_rebuilds for sh in idx.shards]
    writes = [a - b for a, b in zip(idx._router["per_shard_writes"], writes0)]
    log(f"[sharded] busy-shard writes: {len(ins_ms)} batches of {BATCH}, "
        f"{rec['reads']} reads (wrong={rec['wrong']}), {ins_k.shape[0]} "
        f"inserts routed {writes} in {secs:.2f} s = "
        f"{ins_k.shape[0] / secs:.0f} inserts/s with the reads; "
        f"insert_batch ms median {statistics.median(ins_ms):.1f} max "
        f"{max(ins_ms):.1f}; n_rebuilds {rebuilds0} -> {rebuilds}; batches "
        f"with the fold in flight {fold_batches}; reads served mid-fold "
        f"{rec['mid_fold_reads']}; launches {counts}")
    log(f"[sharded] shard {BUSY_SHARD} in-stream fold: {busy.last_fold}")
    others = [s for s in range(N_SHARDS) if s != BUSY_SHARD]
    if rec["wrong"]:
        fail(f"sharded: {rec['wrong']} wrong reads during the writes")
    if rebuilds[BUSY_SHARD] == rebuilds0[BUSY_SHARD] \
            or rec["mid_fold_reads"] == 0:
        fail("sharded: the busy shard did not fold in-stream with reads "
             "served while it ran")
    if any(rebuilds[s] != rebuilds0[s] or writes[s] for s in others):
        fail("sharded: writes or a fold reached the other shards")
    if counts["streamed_lookup"] or counts["index_probe"]:
        fail("sharded: the write phase launched an unexpected kernel")
    res["write"] = dict(rec, seconds=secs, batches=len(ins_ms),
                        inserts=int(ins_k.shape[0]),
                        inserts_per_s=ins_k.shape[0] / secs,
                        insert_ms_median=statistics.median(ins_ms),
                        insert_ms_max=max(ins_ms), fold=busy.last_fold)
    return ins_k


def sharded_update_delete(res, win):
    """65,536 updates and 65,536 deletes of loaded keys across all shards:
    deleted keys miss, updated keys read their new payloads."""
    nfl = res["nfl"]
    wl = res["wl"]
    rng = np.random.default_rng(res["seed"] + 500)
    pick = rng.choice(wl.load_keys.shape[0], 2 * BATCH, replace=False)
    upd, dele = wl.load_keys[pick[:BATCH]], wl.load_keys[pick[BATCH:]]
    upd_pv = wl.load_payloads[pick[:BATCH]] + (1 << 28)

    def drive():
        t = time.perf_counter()
        ok_u = nfl.update_batch(upd, upd_pv)
        ok_d = nfl.delete_batch(dele)
        secs = time.perf_counter() - t
        return secs, ok_u, ok_d, nfl.lookup_batch(dele), nfl.lookup_batch(upd)

    (secs, ok_u, ok_d, got_d, got_u), counts = win.run(drive)
    truth = res["truth"]
    truth.update(upd, upd_pv)
    truth.delete(dele)
    wrong = {"update_ok": int((~ok_u).sum()), "delete_ok": int((~ok_d).sum()),
             "deleted_hits": int((got_d != -1).sum()),
             "updated_reads": int((got_u != upd_pv).sum())}
    st = nfl.stats()
    log(f"[sharded] updates {BATCH}, deletes {BATCH}: "
        f"{2 * BATCH / secs:.0f} writes/s; wrong {wrong}; n_keys "
        f"{st['n_keys']} (truth {truth.keys.shape[0]}); run {st['run_len']} "
        f"delta {st['delta_len']}; launches {counts}")
    if any(wrong.values()) or st["n_keys"] != truth.keys.shape[0]:
        fail(f"sharded: wrong updates or deletes: {wrong}")
    res["deleted"] = dele
    res["writes_per_s"] = 2 * BATCH / secs


def straddling_queries(res, zs, boundaries=None, seed=None):
    """One batch of ``STRADDLE`` ranges per boundary (by default the
    index's), each starting within 100 ranks below the boundary (in z
    order of the live keys) and ending 2-29 ranks past it."""
    rng = np.random.default_rng(res["seed"] + 600 if seed is None else seed)
    rs, lns = [], []
    for bnd in (res["nfl"].index.boundaries if boundaries is None
                else boundaries):
        b = int(np.searchsorted(zs, bnd, side="left"))
        r = b - rng.integers(1, 101, STRADDLE)
        rs.append(r)
        lns.append(np.minimum(b - r + rng.integers(2, 30, STRADDLE),
                              zs.shape[0] - 1 - r))
    return [(np.concatenate(rs), np.concatenate(lns))]


def sharded_profile(res, split_key_bits):
    """One read batch split into its host steps (feature expansion, the
    route, the plan, the per-shard issue, the wait for the shards'
    kernels and copies, the gather), the median over the 64 batches; and
    one batch under ``torch.profiler``: the kernels' device time, and
    whether the shards' ``fused_lookup`` launches overlap on the card.
    Informational: nothing here fails the smoke but a wrong read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.shard_dispatch import fanout_plan
    nfl = res["nfl"]
    idx = nfl.index
    truth = res["truth"]
    parts = collections.defaultdict(list)
    for k in res["batches"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = nfl._feats(k)
        t1 = time.perf_counter()
        z, sids = idx._route_flow(feats, nfl._packed_w, nfl._shapes)
        t2 = time.perf_counter()
        segs, inv = fanout_plan(sids, idx.n_shards)
        t3 = time.perf_counter()
        fins = [sh.lookup_batch_async(z[seg], ikeys=k[seg], stream=st)
                for sh, st, seg in zip(idx.shards, idx.streams, segs)
                if seg.shape[0]]
        t4 = time.perf_counter()
        got = [f() for f in fins]
        t5 = time.perf_counter()
        out = np.concatenate(got)[inv]
        t6 = time.perf_counter()
        if not np.array_equal(out, truth.lookup(k)):
            fail("sharded: the profiled read batch is wrong")
        for name, a, b in (("features", t0, t1), ("route", t1, t2),
                           ("plan", t2, t3), ("issue", t3, t4),
                           ("wait", t4, t5), ("gather", t5, t6),
                           ("total", t0, t6)):
            parts[name].append((b - a) * 1e3)
    split = {name: statistics.median(v) for name, v in parts.items()}
    k = res["batches"][0]
    prof_out = {"split_ms": split}
    try:
        nfl.lookup_batch(k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            nfl.lookup_batch(k)
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    except Exception as exc:          # informational: never fails the smoke
        log(f"[sharded] read batch profile: not measured ({exc!r})")
        evs = []
    if evs:
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in evs)
        busy, end = 0.0, None
        for a, b, _n in spans:
            if end is None or a >= end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        look = [(a, b) for a, b, n in spans if "fused_lookup_kernel" in n]
        overlap = sum(1 for i in range(len(look)) for j in range(i)
                      if look[j][1] > look[i][0])
        prof_out.update(
            device_ops=len(evs),
            device_busy_ms=busy / 1e3,
            window_ms=(spans[-1][1] - spans[0][0]) / 1e3,
            kernels_ms={n[:48]: (b - a) / 1e3 for a, b, n in spans
                        if "kernel" in n or "vec4" in n},
            lookup_kernels=len(look), overlapping_pairs=overlap)
    log(f"[sharded] read batch of {BATCH}, host ms (median of "
        f"{len(res['batches'])}): "
        + ", ".join(f"{n_} {v:.3f}" for n_, v in split.items())
        + f"; under torch.profiler: {json.dumps(prof_out.get('kernels_ms', 'not measured'))}, "
        f"{prof_out.get('device_ops', 'not measured')} device operations, "
        f"device busy {prof_out.get('device_busy_ms', 'not measured')} ms "
        f"of a {prof_out.get('window_ms', 'not measured')} ms window; "
        f"fused_lookup launches {prof_out.get('lookup_kernels')}, "
        f"overlapping pairs {prof_out.get('overlapping_pairs')}")
    return prof_out


def sharded_phase(base, m, win, split_key_bits, dev, card, fronted, wall):
    """Phase 4: sharded serving, ``NFL(shards=4)`` on one card, then 4f,
    the front end over it (into ``fronted["4f"]``)."""
    res = sharded_load_and_read(base, m, win)
    nfl = res["nfl"]
    res["batch_shards"] = [batch_shards(res, m, k) for k in res["batches"]]
    single = base["read_pay"]
    res["lookups_per_s"] = sharded_reads(res, win, "fresh index", single)
    readback(res, res["miss_keys"], win, "misses (unloaded keys)")
    router_z_check(res, split_key_bits)
    sharded_async(res, win, single)
    res["profile"] = sharded_profile(res, split_key_bits)
    ins_k = busy_shard_writes(res, m, win)
    readback(res, ins_k, win, "inserted keys read back")
    del ins_k
    sharded_update_delete(res, win)
    sk, zs, ps = scan_truth(res, m, dev)
    queries = scan_queries(res, m, sk, N_SCAN_BATCHES)
    res["scan"] = run_scans(res, win, sk, zs, ps, queries, "YCSB E")
    router = nfl.index._router
    straddled = router["straddling_ranges"]
    st_q = straddling_queries(res, zs)
    run_scans(res, win, sk, zs, ps, st_q, "straddling every boundary")
    straddled = router["straddling_ranges"] - straddled
    log(f"[sharded] straddling ranges merged: {straddled} of "
        f"{st_q[0][0].shape[0]} (need {STRADDLE * (N_SHARDS - 1)})")
    if straddled < STRADDLE * (N_SHARDS - 1):
        fail(f"sharded: only {straddled} ranges straddled a boundary")
    t0 = time.perf_counter()
    rebuilds0 = [sh.n_rebuilds for sh in nfl.index.shards]
    _none, counts = win.run(nfl.index.rebuild)
    st = nfl.stats()
    log(f"[sharded] rebuild(): {time.perf_counter() - t0:.2f} s; "
        f"n_rebuilds {rebuilds0} -> "
        f"{[sh['n_rebuilds'] for sh in st['shards']]}; folds "
        f"{[sh['last_fold'] for sh in st['shards']]}; launches {counts}")
    if any(sh["n_rebuilds"] <= r0 or sh["run_len"] != sh["n_shadowed"]
           for sh, r0 in zip(st["shards"], rebuilds0)):
        fail("sharded: rebuild did not fold every shard's tiers")
    sharded_reads(res, win, "after rebuild")
    readback(res, res["deleted"], win, "deleted keys after rebuild")
    readback(res, res["miss_keys"], win, "misses after rebuild")
    run_scans(res, win, sk, zs, ps, queries[:1], "after rebuild")
    t0 = time.perf_counter()
    fronted["4f"] = frontend_phase(res, m, win, sk, zs, ps, card,
                                   sharded=True)
    wall("sharded front end (4f)", t0)
    log(f"[sharded] router counters {json.dumps(st['router'])}")
    log(f"[sharded] end to end against the single index (phase 2): "
        f"lookups/s {res['lookups_per_s']:.0f} vs {base['lookups_per_s']:.0f};"
        f" inserts/s {res['write']['inserts_per_s']:.0f} (busy shard) vs "
        f"{base['write']['inserts'] / base['write']['seconds']:.0f}; "
        f"scans/s {res['scan']['scans_per_s']:.0f} vs "
        f"{base['scan']['scans_per_s']:.0f}; max_memory_allocated since the "
        f"bulkload {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {key: res[key] for key in ("lookups_per_s", "write", "scan",
                                      "profile", "bulkload_s",
                                      "writes_per_s")}


# ------------------------------------------------------ the SLO front end
def zkeys(nfl, m, keys):
    """Ground-truth positioning keys: z from the NF kernel (the bulk
    transform) with the flow on, the f32 key without."""
    if nfl.use_flow:
        return m.ops.nf_transform_keys(nfl.flow_params, nfl.normalizer, keys,
                                       nfl.cfg.flow, nfl.device
                                       ).astype(np.float32)
    return keys.astype(np.float32)


class FrontTruth:
    """Ground truth of a front-end phase: the live keys in positioning
    order with their z and payloads (``scan_truth``), and an overlay of
    the phase's own writes as they dispatched (deleted base ranks;
    inserted keys with payload and z).  Also the phase's draws: zipf
    ranks over the live keys, unloaded keys with their z (misses for
    reads, fresh keys for inserts) and the base ranks to delete, each
    used once across the phase's legs."""

    def __init__(self, res, m, sk, zs, ps, seed):
        self.m, self.nfl, self.name = m, res["nfl"], res["name"]
        self.sk, self.zs, self.ps = sk, zs, ps
        self.n = sk.shape[0]
        self.deleted = set()
        self.ins = {}                   # key -> (payload, z)
        rng = np.random.default_rng(seed)
        cand = rng.choice(res["unloaded"],
                          min(2 * FE_POOL, res["unloaded"].shape[0]),
                          replace=False)
        cand = np.unique(cand[res["truth"].lookup(cand) == -1])
        rng.shuffle(cand)
        z = zkeys(self.nfl, m, cand)
        half = cand.shape[0] // 2
        self.miss_k, self.miss_z = cand[:half], z[:half]
        self.fresh_k, self.fresh_z = cand[half:], z[half:]
        self.zipf = m.zipf_indices(rng, self.n, FE_POOL, 0.99)
        self.zipf_start = m.zipf_indices(rng, self.n - 101, FE_POOL, 0.99)
        self.del_order = rng.choice(self.n, FE_POOL, replace=False)
        self.used = collections.Counter()
        self.payload = 1_500_000_000

    def _take(self, name, pool, n):
        i = self.used[name]
        if i + n > pool.shape[0]:
            fail(f"front end: the {name} pool ran out")
        self.used[name] += n
        return pool[i:i + n]

    def _req(self, rid, op, key, deadline, hi=0.0, payload=0, rank=-1,
             z=0.0, a=0, b=0, zlo=0.0, zhi=0.0):
        """A request with its ground truth: the base rank of its key (-1:
        not a base key), the key's z, a range's base ranks ``[a, b)`` and
        z bounds."""
        r = self.m.ServiceRequest(rid, op, float(key), hi=float(hi),
                                  payload=payload, deadline_s=deadline)
        r.rank, r.z, r.a, r.b, r.zlo, r.zhi = rank, z, a, b, zlo, zhi
        return r

    def points(self, rng, n, deadline):
        """Point requests: zipf 0.99 over the live keys, ``FE_MISS`` of
        them unloaded keys."""
        ranks = self._take("zipf", self.zipf, n).copy()
        miss = rng.random(n) < FE_MISS
        nm = int(miss.sum())
        keys, z = self.sk[ranks], self.zs[ranks]
        keys[miss] = self._take("miss", self.miss_k, nm)
        z[miss] = self.miss_z[self.used["miss"] - nm:self.used["miss"]]
        ranks[miss] = -1
        return [self._req(i, "point", k, deadline, rank=r, z=zz)
                for i, (k, r, zz) in enumerate(zip(
                    keys.tolist(), ranks.tolist(), z.tolist()))]

    def mixed(self, rng, n, deadline, p=FE_MIX):
        """``p`` = (point, range, insert, delete) shares: points as in
        ``points`` (``FE_OWN_READS`` of them, once there are any, keys the
        trace inserted), ranges ``[k_r, k_{r+L})`` with zipf start ranks
        over the live keys in z order and L uniform in 1-100 (2d's),
        inserts of unloaded keys, deletes of live keys."""
        reqs, mine = [], []
        u = rng.random(n)
        for rid in range(n):
            if u[rid] < p[0]:
                if mine and rng.random() < FE_OWN_READS:
                    k, z = mine[int(rng.integers(len(mine)))]
                    reqs.append(self._req(rid, "point", k, deadline, z=z))
                else:
                    q = self.points(rng, 1, deadline)[0]
                    q.rid = rid
                    reqs.append(q)
            elif u[rid] < p[0] + p[1]:
                r = int(self._take("start", self.zipf_start, 1)[0])
                ln = int(rng.integers(1, 101))
                zlo, zhi = self.zs[r], self.zs[r + ln]
                reqs.append(self._req(
                    rid, "range", self.sk[r], deadline, hi=self.sk[r + ln],
                    a=int(np.searchsorted(self.zs, zlo, side="left")),
                    b=int(np.searchsorted(self.zs, zhi, side="left")),
                    zlo=float(zlo), zhi=float(zhi)))
            elif u[rid] < p[0] + p[1] + p[2]:
                k = self._take("fresh", self.fresh_k, 1)[0]
                z = float(self.fresh_z[self.used["fresh"] - 1])
                self.payload += 1
                reqs.append(self._req(rid, "insert", k, deadline,
                                      payload=self.payload, z=z))
                mine.append((k, z))
            else:
                rank = int(self._take("delete", self.del_order, 1)[0])
                reqs.append(self._req(rid, "delete", self.sk[rank],
                                      deadline, rank=rank))
        return reqs

    def expect(self, r) -> int:
        hit = self.ins.get(r.key)
        if hit is not None:
            return hit[0]
        if r.rank < 0 or r.rank in self.deleted:
            return -1
        return int(self.ps[r.rank])

    def live_keys(self, rng, n):
        """``n`` live base keys (none deleted so far) and their payloads."""
        ranks = rng.choice(self.n, 4 * n, replace=False)
        ranks = np.array([r for r in ranks.tolist()
                          if r not in self.deleted][:n])
        return self.sk[ranks], self.ps[ranks]

    def check(self, log):
        """Replay the dispatch log (the hook's order) against the ground
        truth, applying each write batch where it dispatched; returns
        (served results that differ, truncated ranges).  A served result
        is a completed one or a read that came back late."""
        wrong = trunc = 0
        for op, batch in log:
            if op == "insert":
                for r in batch:
                    self.ins[r.key] = (r.payload, r.z)
                    wrong += int(r.result is not True)
            elif op == "delete":
                for r in batch:
                    want = r.rank not in self.deleted
                    self.deleted.add(r.rank)
                    wrong += int(r.result != want)
            elif op == "point":
                for r in batch:
                    if r.result is not None:
                        wrong += int(r.result != self.expect(r))
            else:
                vals = list(self.ins.values())
                ins_p = np.array([v[0] for v in vals], np.int64)
                ins_z = np.array([v[1] for v in vals], np.float32)
                dele = np.array(sorted(self.deleted), np.int64)
                for r in batch:
                    if r.result is None:
                        continue
                    got, tot = r.result
                    if tot > SCAN_CAP:
                        trunc += 1
                        continue
                    keep = np.arange(r.a, r.b)
                    keep = keep[~np.isin(keep, dele)]
                    inz = (ins_z >= np.float32(r.zlo)) & \
                        (ins_z < np.float32(r.zhi))
                    want = np.concatenate([self.ps[keep], ins_p[inz]])
                    wrong += int(sorted(got) != sorted(want.tolist()))
        return wrong, trunc


def fe_leg(st, win, what, reqs, arrivals=None, plan=None, **cfg):
    """One front-end leg in a launch window: ``reqs`` through a fresh
    ``FrontEnd`` over the phase's index (``run_trace`` at ``arrivals``,
    or, with None, all submitted at once and drained), under ``plan``;
    every served result checked against the dispatch-time truth."""
    m, nfl = st.m, st.nfl
    fe = m.FrontEnd(nfl, m.FrontEndConfig(**{**FE_CFG, **cfg}))
    dlog = []
    fe.on_batch_dispatched = lambda op, batch: dlog.append((op, batch))
    m.faults.injection_stats(reset=True)
    m.ops.reset_fused_lookup_stats()
    folds0 = fold_progress(nfl.index)
    # the trace is the harness's: frozen out of the collector, so that a
    # collection during the leg scans only what the loop allocates
    gc.collect()
    gc.freeze()

    def drive():
        with m.faults.inject(plan or m.faults.FaultPlan()):
            if arrivals is not None:
                return fe.run_trace(reqs, arrivals)
            t = time.perf_counter()
            for r in reqs:
                fe.submit(r)
            fe.drain()
            return time.perf_counter() - t

    secs, counts = win.run(drive)
    gc.unfreeze()
    folds1 = fold_progress(nfl.index)
    wrong, trunc = st.check(dlog)
    s = fe.stats()
    lat = s["latency_ontime"]
    batches = collections.Counter(op for op, _b in dlog)
    row = {"leg": what, "requests": len(reqs), "seconds": secs,
           "goodput": s["completed"] - s["completed_late"],
           "goodput_per_s": (s["completed"] - s["completed_late"]) / secs,
           "completed": s["completed"], "shed": s["shed"],
           "expired": s["expired"], "reasons": s["reasons"],
           "p50_ms": lat["p50_ns"] / 1e6, "p99_ms": lat["p99_ns"] / 1e6,
           "p999_ms": lat["p999_ns"] / 1e6,
           "batches": s["batches"], "batches_by_op": dict(batches),
           "mean_batch": s["dispatched_requests"] / max(s["batches"], 1),
           "retries": s["retries"], "retry_giveups": s["retry_giveups"],
           "svc_batch_ms": {k: v * 1e3 for k, v in s["svc_batch_s"].items()},
           "wrong": wrong, "truncated": trunc, "launches": counts,
           "folds_swapped": folds1[0] - folds0[0],
           "fold_ticks": folds1[1] - folds0[1] if folds1[0] == folds0[0]
           else None,
           "faults": m.faults.injection_stats(),
           "dispatch": m.ops.fused_lookup_stats()}
    log_line = {k: v for k, v in row.items()
                if k not in ("dispatch", "reasons")}
    log(f"[{st.name}] front end, {what}: "
        + json.dumps(log_line, default=str))
    if wrong:
        fail(f"{st.name}: front end {what}: {wrong} wrong results")
    return row, dlog


def fe_point_launches(st, log, row):
    """P's launch window: the single index launches ``fused_lookup`` once
    a point batch (NF in the kernel); the sharded one launches the
    router's ``nf_forward`` once a batch and ``fused_lookup`` once for
    each shard the batch reaches by the host route of its ground-truth
    z."""
    c, nb = row["launches"], row["batches_by_op"].get("point", 0)
    idx = st.nfl.index
    if hasattr(idx, "shards"):
        b = idx.boundaries
        want = (sum(int(np.unique(np.searchsorted(
            b, np.array([r.z for r in batch], np.float32),
            side="right")).shape[0]) for op, batch in log if op == "point"),
            nb)
    else:
        want = (nb, 0)
    got = (c["fused_lookup"], c["nf_forward"])
    if got != want or c["streamed_lookup"] or c["fused_range_scan"] \
            or nb != row["batches"]:
        fail(f"{st.name}: front end {row['leg']}: launches (fused_lookup, "
             f"nf_forward) {got}, expected {want} for {nb} point batches; "
             f"window {c}")


def fe_mixed_launches(st, log, row, folds0):
    """M's range launches (one a batch; sharded, one a shard each batch's
    ranges reach) and, when no fold ran, its point launches as in P."""
    idx = st.nfl.index
    c = row["launches"]
    sharded = hasattr(idx, "shards")
    ranges = [batch for op, batch in log if op == "range"]
    if sharded:
        want = sum(shards_reached(idx.boundaries,
                                  np.array([r.zlo for r in b], np.float32),
                                  np.array([r.zhi for r in b], np.float32))
                   for b in ranges)
    else:
        want = len(ranges)
    if c["fused_range_scan"] != want or c["streamed_lookup"]:
        fail(f"{st.name}: front end {row['leg']}: fused_range_scan "
             f"launched {c['fused_range_scan']} times, expected {want}")
    if idx.n_rebuilds == folds0 and not fold_active(idx):
        if not sharded and c["fused_lookup"] != \
                row["batches_by_op"].get("point", 0):
            fail(f"{st.name}: front end {row['leg']}: fused_lookup "
                 f"launched {c['fused_lookup']} times for "
                 f"{row['batches_by_op'].get('point', 0)} point batches")


def fold_progress(idx) -> tuple:
    """(folds swapped so far, ticks of the folds in flight), over the
    index's shards: a leg's fold ticks are the second's growth while the
    first stays put."""
    shards = getattr(idx, "shards", [idx])
    return (sum(sh.n_rebuilds for sh in shards),
            sum(sh._fold.report["ticks"] for sh in shards
                if sh._fold is not None))


def fold_active(idx) -> bool:
    shards = getattr(idx, "shards", [idx])
    return any(sh._fold is not None for sh in shards)


def frontend_phase(res, m, win, sk, zs, ps, card, sharded=False):
    """Phase 2f (single index) or 4f (``sharded``): the SLO front end over
    the phase's index.  Calibrate C with a standing burst, then P at 0.5 C
    (Poisson, 20 ms deadline), and for the single index O at 2 C with
    admission on and off, M (mixed, slack), and the fault ladder F."""
    t_phase = time.perf_counter()
    st = FrontTruth(res, m, sk, zs, ps, res["seed"] + (900 if sharded
                                                        else 700))
    rng = np.random.default_rng(res["seed"] + (901 if sharded else 701))
    out = {}
    slack = dict(admission=False)
    row, _log = fe_leg(st, win, "calibrate",
                            st.points(rng, FE_CALIBRATE, FE_SLACK), **slack)
    cap = FE_CALIBRATE / row["seconds"]
    out["capacity_per_s"] = cap
    out["calibrate"] = row
    n_p = FE_POINTS_SHARDED if sharded else FE_POINTS
    gaps = rng.exponential(1.0, n_p)
    keys_p = st.points(rng, n_p, FE_DEADLINE)
    arr_p = np.cumsum(gaps) / (0.5 * cap)
    row, log_p = fe_leg(st, win, "P at 0.5 C", keys_p, arr_p)
    fe_point_launches(st, log_p, row)
    out["P"] = row

    def again():
        return [st._req(r.rid, "point", r.key, FE_DEADLINE, rank=r.rank,
                        z=r.z) for r in keys_p]

    # the same trace at half the rate: the open loop's own ceiling
    row, log_q = fe_leg(st, win, "P at 0.25 C", again(), arr_p * 2.0)
    fe_point_launches(st, log_q, row)
    out["P_quarter"] = row
    if not sharded:

        row, log_o = fe_leg(st, win, "O at 2 C, admission on", again(),
                                arr_p * 0.25)
        fe_point_launches(st, log_o, row)
        if row["shed"] + row["expired"] == 0:
            fail(f"{st.name}: front end O: nothing shed or expired at 2 C")
        late = [r for _op, b in log_o for r in b
                if r.state == "completed" and r.latency_s > r.deadline_s]
        if late:
            fail(f"{st.name}: front end O: {len(late)} completed reads "
                 "missed their deadline")
        out["O_admission"] = row
        row, log_o = fe_leg(st, win, "O at 2 C, admission off", again(),
                                arr_p * 0.25, admission=False)
        fe_point_launches(st, log_o, row)
        out["O_no_admission"] = row
    del keys_p
    n_m = FE_MIXED_SHARDED if sharded else FE_MIXED
    folds0 = res["nfl"].index.n_rebuilds
    row, log_m = fe_leg(st, win, "M mixed", st.mixed(rng, n_m, FE_SLACK),
                            **slack)
    fe_mixed_launches(st, log_m, row, folds0)
    if row["completed"] != n_m:
        fail(f"{st.name}: front end M: {row['completed']} of {n_m} completed")
    out["M"] = row
    if not sharded:
        out.update(fault_ladder(st, win, rng, cap))
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    q = out["P_quarter"]
    log(f"[{st.name}] front end: C {cap:.0f} requests/s; P p50/p99/p999 "
        f"{out['P']['p50_ms']:.3f}/{out['P']['p99_ms']:.3f}/"
        f"{out['P']['p999_ms']:.3f} ms, goodput {out['P']['goodput']} of "
        f"{n_p}; at 0.25 C {q['p50_ms']:.3f}/{q['p99_ms']:.3f}/"
        f"{q['p999_ms']:.3f} ms, goodput {q['goodput']}; "
        + ("" if sharded else
           f"O p999 {out['O_admission']['p999_ms']:.3f} ms admission on "
           f"(goodput {out['O_admission']['goodput']}), "
           f"{out['O_no_admission']['p999_ms']:.3f} ms off (goodput "
           f"{out['O_no_admission']['goodput']}); ")
        + f"phase {secs:.1f} s ({card})")
    return out


def fault_ladder(st, win, rng, cap):
    """2f's F: three traces, slack deadlines and admission off.  The stall
    leg, ``FE_STALL`` requests, is mixed as M (submitted at once) over
    a fold started just before it, so that its write calls tick the fold
    under ``fold_stall_s`` (at 2^23 keys no leg's writes start one: a
    fold starts past a run of ``rebuild_frac`` of the live keys).  The
    error legs, ``FE_FAULT`` requests each, are point-only (as the JAX tests inject errors only into
    point traces: an error in a fold's verify chunk is raised after the
    write was applied) with Poisson arrivals at 0.5 C, so that they
    dispatch many batches.  The JAX plan's ``force_oracle`` has no
    counterpart (``faults.inject`` refuses it)."""
    m, nfl = st.m, st.nfl

    def arrivals():
        return np.cumsum(rng.exponential(1.0 / (0.5 * cap), FE_FAULT))

    out = {}
    slack = dict(admission=False, expire_queued=False)
    idx = nfl.index
    if idx._fold is not None:
        fail(f"{st.name}: a fold was already in flight before the stall leg")
    t0 = time.perf_counter()
    idx._fold_start()
    snapshot_s = time.perf_counter() - t0
    row, _log = fe_leg(st, win, "F stall",
                       st.mixed(rng, FE_STALL, FE_SLACK),
                       plan=m.faults.FaultPlan(device_stall_s=1e-3,
                                               stall_every=4,
                                               fold_stall_s=1e-3),
                       **slack)
    row["fold_snapshot_s"] = snapshot_s
    f = row["faults"]
    log(f"[{st.name}] F stall: the fold's snapshot {snapshot_s:.2f} s; "
        f"{row['fold_ticks']} fold ticks in the leg, {f['fold_stalls']} "
        f"of them stalled; {f['stalls']} dispatch stalls")
    if not f["stalls"] or not f["fold_stalls"] \
            or row["completed"] != FE_STALL:
        fail(f"{st.name}: stall leg: {f}, fold ticks {row['fold_ticks']}, "
             f"{row['completed']} of {FE_STALL} completed")
    out["F_stall"] = row
    row, _log = fe_leg(st, win, "F errors every 3",
                       st.points(rng, FE_FAULT, FE_SLACK), arrivals(),
                       plan=m.faults.FaultPlan(dispatch_error_every=3),
                       retry_backoff_s=1e-4, **slack)
    if not row["retries"] or row["retry_giveups"] \
            or row["completed"] != FE_FAULT:
        fail(f"{st.name}: transient errors were not retried: {row}")
    out["F_errors"] = row
    q, p = st.live_keys(rng, FE_READBACK)
    before = nfl.lookup_batch(q)
    reqs = st.points(rng, FE_FAULT, FE_SLACK)
    row, _log = fe_leg(st, win, "F errors every 1", reqs, arrivals(),
                       plan=m.faults.FaultPlan(dispatch_error_every=1),
                       max_retries=2, **slack)
    after = nfl.lookup_batch(q)
    if row["shed"] != FE_FAULT or any(r.reason != "error" for r in reqs) \
            or not np.array_equal(before, after) \
            or not np.array_equal(after, p):
        fail(f"{st.name}: retry exhaustion: shed {row['shed']} of "
             f"{FE_FAULT}, read-back equal {np.array_equal(before, after)}")
    out["F_exhaustion"] = row
    return out


def launcher_check(card):
    """``repro_torch.launch.serve --mode index``, in process, on the card
    (no ``--device``), plain and with ``--fault errors``: each prints its
    goodput and latency lines."""
    from repro_torch.launch import serve

    out = {}
    for argv in (["--mode", "index"], ["--mode", "index", "--fault",
                                       "errors"]):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(argv)
        text = buf.getvalue()
        for line in text.splitlines():
            log(f"[launcher {' '.join(argv)}] {line}")
        if "  goodput " not in text or "on cuda" not in text \
                or "on-time latency p50=" not in text:
            fail(f"launcher {argv} printed no goodput line")
        good = text.split("  goodput ")[1].split()[0]
        out[" ".join(argv)] = {"goodput": good,
                               "seconds": time.perf_counter() - t}
    log(f"[launcher] {json.dumps(out)} ({card})")
    return out


# ------------------------------------------------- kernels vs plain
def nf_sass_per_key(shapes):
    """FP32 and SFU instructions per key of the default flow's
    ``nf_forward`` kernel, counted in the SASS of the built library
    (``cuobjdump -sass``): its FADD, FMUL, FFMA, FSETP, FSEL and FMNMX
    (one FP32 issue slot each) and its MUFU, over the keys its code
    evaluates (one MUFU.EX2 per accurate tanhf, one tanhf per hidden unit
    of every layer but the last)."""
    import re
    import shutil

    from repro_torch.kernels import build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build._lib_path("nf_forward"))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f.startswith("_Z15nf_forward_vec4"))
    ops = collections.Counter(op.split(".")[0] for op in re.findall(
        r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body))
    ex2 = len(re.findall(r"MUFU\.EX2", body))
    tanh = sum(o for o, _ in shapes[:-1])
    keys = ex2 / tanh
    fp32 = sum(ops[o] for o in ("FADD", "FMUL", "FFMA", "FSETP", "FSEL",
                                "FMNMX"))
    return fp32 / keys, ops["MUFU"] / keys, keys


def nf_forward_row(res, k, flush_buf, write_batches):
    """nf_forward against plain on the bulk load's keys, timed there and
    at the write batches' size (their inserts' positioning keys), with
    its bound the largest of its bytes, its FP32 issue and its SFU
    operations (counted in its SASS)."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    cfg = nfl.cfg.flow
    feats = torch.from_numpy(nfl._feats(res["wl"].load_keys)).to(dev)
    packed, shapes = nfl._packed_w, nfl._shapes
    zk = k.nf_forward(feats, packed, shapes, cfg.dim)
    zp = k.nf_forward_plain(feats, packed, shapes, cfg.dim)
    torch.cuda.synchronize()
    ulps = ulp_diff(zk, zp)
    err = float((zk - zp).abs().max().item())
    log(f"nf_forward vs plain on {feats.shape[0]} keys: max |dz| {err}, "
        f"max ulp diff {ulps} (bound 0: same op order, one rounding each, "
        "both on the card's tanhf)")
    if ulps != 0:
        fail("nf_forward disagrees with its plain version")
    w = packed.reshape(-1).to(dev)
    d = cfg.dim
    weights = []
    i = 2 * d
    for n_out, n_in in shapes:
        weights.append((w[i:i + n_out * n_in].reshape(n_out, n_in),
                        w[i + n_out * n_in:i + n_out * n_in + n_out]))
        i += n_out * n_in + n_out
    mu, sd_inv, scale = w[:d], w[d:2 * d], w[i:i + d]

    def library():
        # the same function as dense PyTorch ops (cuBLAS products)
        h = (feats - mu) * sd_inv
        for li, (wt, b) in enumerate(weights):
            h = torch.addmm(b, h, wt.T)
            if li < len(weights) - 1:
                h = torch.tanh(h)
        return (h * scale).sum(dim=1)

    b = feats.shape[0]
    fp32_key, sfu_key, sass_keys = nf_sass_per_key(shapes)
    fp32_s, sfu_s = sm_rates()
    times = {"bytes": b * (4 * d + 4) / HBM_BYTES_PER_S,
             "operations (FP32 issue)": b * fp32_key / fp32_s,
             "operations (SFU)": b * sfu_key / sfu_s}
    bound_by = max(times, key=times.get)
    bound_ms = times[bound_by] * 1e3

    def kernel():
        return k.nf_forward(feats, packed, shapes, d)

    # cold L2: each call alone after a flush, the median of 5
    cold = launch_times_ms([kernel] * 5, flush_buf.zero_)
    lib_cold = launch_times_ms([library] * 5, flush_buf.zero_)
    host = host_ms_per_call([kernel] * 20)
    wfeats = [torch.from_numpy(nfl._feats(x)).to(dev) for x in write_batches]
    for f in wfeats[:2]:
        if not bit_equal(k.nf_forward(f, packed, shapes, d),
                         k.nf_forward_plain(f, packed, shapes, d)):
            fail("nf_forward disagrees with plain on a write batch")
    wcold, wwarm, whost = timed_launches(
        [lambda f=f: k.nf_forward(f, packed, shapes, d) for f in wfeats],
        flush_buf)
    wb = statistics.median(f.shape[0] for f in wfeats)
    # the same three bounds at the median write batch's keys
    wtimes = {key: v * wb / b for key, v in times.items()}
    wbound_by = max(wtimes, key=wtimes.get)
    row = {
        "name": "nf_forward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nf_forward.cu",
        "replaces": "src/repro/kernels/nf_forward.py:113",
        "launches": None, "max_abs_err": err,
        "ms": statistics.median(cold),
        "plain_ms": time_ms(lambda: k.nf_forward_plain(feats, packed, shapes,
                                                       d), 5, 1),
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_by == "bytes" else "operations",
        "library_ms": statistics.median(lib_cold),
        "ms_back_to_back": time_ms(kernel, 20),
        "library_ms_back_to_back": time_ms(library, 5, 1),
        "host_ms_per_call": host,
        "bound_ms_by": {key: v * 1e3 for key, v in times.items()},
        "fp32_per_key": fp32_key, "sfu_per_key": sfu_key,
        "write_batch_keys": wb,
        "bound_ms_write_batch": wtimes[wbound_by] * 1e3,
        "bound_by_write_batch": wbound_by,
        "ms_write_batch": statistics.median(wcold),
        "ms_warm_l2_write_batch": statistics.median(wwarm),
        "host_ms_per_call_write_batch": whost,
    }
    log(f"nf_forward: {b} keys {row['ms']:.5f} ms cold L2 (back to back "
        f"{row['ms_back_to_back']:.5f}), host issue {host:.5f} ms/call; "
        f"the write batches ({len(wfeats)}, median {wb:.0f} keys) "
        f"{row['ms_write_batch']:.5f} ms cold, {row['ms_warm_l2_write_batch']:.5f} "
        f"warm, host {whost:.5f}, bound {wtimes[wbound_by] * 1e3:.6f} ms "
        f"by {wbound_by}; per key {fp32_key:.1f} FP32 and "
        f"{sfu_key:.1f} SFU instructions (SASS, {sass_keys:.0f} keys of "
        f"code); bound {bound_ms:.5f} ms by {bound_by} "
        f"({ {key: round(v * 1e3, 5) for key, v in times.items()} }); "
        f"library {row['library_ms']:.4f} ms")
    return row


def compare_lookup(res, args, kw, k, what):
    """fused_lookup against its plain version on one batch: payloads and
    z bit-equal, and z equal to nf_forward's with the flow on."""
    nfl = res["nfl"]
    pk, zk = k.fused_lookup(*args, **kw)
    pp, zp = k.fused_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    pay_eq, z_eq = bit_equal(pk, pp), bit_equal(zk, zp)
    err = max(float((pk - pp).abs().max().item()),
              float((zk - zp).abs().max().item()))
    log(f"fused_lookup vs plain, {res['name']} ({what}), "
        f"{args[0].shape[0]} queries: payloads bit-equal {pay_eq}, z "
        f"bit-equal {z_eq}")
    if not (pay_eq and z_eq):
        fail(f"fused_lookup disagrees with its plain version ({what})")
    if nfl.use_flow:
        zf = k.nf_forward(args[0], nfl._packed_w, nfl._shapes,
                          nfl.cfg.flow.dim)
        if not bit_equal(zk, zf):
            fail("in-kernel NF z differs from nf_forward z")
        log("fused_lookup z equals nf_forward z bit for bit: True")
    return pk, zk, err


def time_lookup(res, k, split_key_bits, flush_buf):
    """Phase 5, on the fresh index: fused_lookup against plain on the
    first read batch, then timed launch by launch over all 64."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    kw = lookup_kw(nfl)
    batches = [lookup_args(nfl, b, dev, split_key_bits)
               for b in res["batches"]]
    args = batches[0]
    _pk, zk, err = compare_lookup(res, args, kw, k, "fresh index")
    sectors, n_reads, mean_depth = touched_sectors(
        args[4], zk, args[1], args[2], kw, args[5])
    io = BATCH * (4 * args[0].shape[1] + 8 + 8)
    bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.fused_lookup(*a, **kw) for a in batches]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.fused_lookup_plain(*args, **kw), 3, 1)
    flow = "on" if nfl.use_flow else "off"
    log(f"fused_lookup flow={flow}: median over {len(fns)} distinct "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; plain {plain_ms:.3f} ms; mean depth "
        f"{mean_depth:.3f}; {n_reads / BATCH:.2f} reads/query in "
        f"{sectors} distinct sectors ({sectors / BATCH:.3f}/query); "
        f"bound {bound:.6f} ms")
    # the fold verify's launches: VERIFY_CHUNK keys in key order, no tiers
    srt = np.sort(res["wl"].load_keys)
    step = srt.shape[0] // N_VERIFY_CHUNKS
    chunks = [lookup_args(nfl, srt[i * step:i * step + VERIFY_CHUNK], dev,
                          split_key_bits)[:5] + (None,)
              for i in range(N_VERIFY_CHUNKS)]
    compare_lookup(res, chunks[0], kw, k, "verify chunk")
    vcold, vwarm, vhost = timed_launches(
        [lambda a=a: k.fused_lookup(*a, **kw) for a in chunks], flush_buf)
    vms = statistics.median(vcold)
    log(f"fused_lookup flow={flow} at the verify chunk ({VERIFY_CHUNK} "
        f"keys in key order, no tiers): median over {len(chunks)} chunks "
        f"{vms:.5f} ms cold L2 (min {min(vcold):.5f}, max "
        f"{max(vcold):.5f}), {statistics.median(vwarm):.5f} ms warm L2; "
        f"host issue {vhost:.5f} ms/call")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, ms_warm_l2=ms_warm,
                host_ms_per_call=host, max_abs_err=err, ms_verify_chunk=vms,
                ms_warm_l2_verify_chunk=statistics.median(vwarm))


def time_lookup_tiers(res, k, keys, split_key_bits, flush_buf):
    """fused_lookup with the run and the delta populated, over the
    read-back batches of the inserted keys: against plain on the first
    (bit-equal), then timed launch by launch like ``time_lookup`` and
    bounded by the sectors its reads touch, the tier searches' included.
    """
    dev = torch.device("cuda")
    nfl = res["nfl"]
    kw = lookup_kw(nfl)
    batches = [lookup_args(nfl, keys[i:i + BATCH], dev, split_key_bits)
               for i in range(0, keys.shape[0], BATCH)]
    if batches[0][5] is None:
        fail(f"{res['name']}: no write tier holds data for the tier timing")
    _pk, zk, err = compare_lookup(res, batches[0], kw, k,
                                  "read-back batch, tiers populated")
    a0 = batches[0]
    sectors, _n, _d = touched_sectors(a0[4], zk, a0[1], a0[2], kw, a0[5])
    b0 = a0[0].shape[0]
    bound = (sectors * SECTOR + b0 * (4 * a0[0].shape[1] + 16)) \
        / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.fused_lookup(*a, **kw) for a in batches]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    t = a0[5].pools
    log(f"fused_lookup with tiers (run {int(t.run_len.item())}, delta "
        f"{int(t.dl_len.item())}): median over {len(fns)} read-back "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; {sectors} distinct sectors on the first; "
        f"bound {bound:.6f} ms")
    return dict(ms_tiers=ms, ms_warm_l2_tiers=ms_warm, bound_ms_tiers=bound,
                host_ms_per_call_tiers=host, max_abs_err_tiers=err)


def compare_streamed(res, args, kw, k, what, fused):
    """streamed_lookup against its plain version on one batch (args as
    ``lookup_args``, the stream pack in place of the tree pools):
    payloads and z bit-equal, and equal to the fused kernel's ``fused``
    (payloads, z)."""
    pk, zk = k.streamed_lookup(*args, **kw)
    pp, zp = k.streamed_lookup_plain(*args, **kw)
    torch.cuda.synchronize()
    eq = {"payloads": bit_equal(pk, pp), "z": bit_equal(zk, zp),
          "payloads = fused": bit_equal(pk, fused[0]),
          "z = fused": bit_equal(zk, fused[1])}
    err = max(float((pk - pp).abs().max().item()),
              float((zk - zp).abs().max().item()))
    log(f"streamed_lookup vs plain, {res['name']} ({what}), "
        f"{args[0].shape[0]} queries, window {args[4].window}: bit-equal "
        f"{eq}")
    if not all(eq.values()):
        fail(f"streamed_lookup disagrees with its plain version or the "
             f"fused kernel ({what})")
    return err


def stream_kw(nfl):
    return dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes,
                use_flow=nfl.use_flow)


def time_streamed(res, k, split_key_bits, flush_buf, look):
    """Phase 5, on the fresh index: streamed_lookup against plain and the
    fused kernel on the first read batch, against the fused kernel on
    all 64, then timed launch by launch over the same 64 batches as
    ``fused_lookup`` (``look``)."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    sp = nfl.index._serving.stream_pack()
    kw = stream_kw(nfl)
    batches = [lookup_args(nfl, b, dev, split_key_bits)
               for b in res["batches"]]
    sargs = [(*a[:4], sp, a[5]) for a in batches]
    err = compare_streamed(res, sargs[0], kw, k, "fresh index",
                           k.fused_lookup(*batches[0], **lookup_kw(nfl)))
    diff = 0
    for a, f in zip(sargs, batches):
        ps, zs_ = k.streamed_lookup(*a, **kw)
        pf, zf = k.fused_lookup(*f, **lookup_kw(nfl))
        diff += int((ps != pf).sum()) + int((zs_.view(torch.int32)
                                             != zf.view(torch.int32)).sum())
    if diff:
        fail(f"streamed_lookup differs from fused_lookup in {diff} outputs")
    a0 = sargs[0]
    _p, z0 = k.streamed_lookup(*a0, **kw)
    sectors, tiles = streamed_sectors(sp, a0[5], z0, a0[1], a0[2])
    ksectors = streamed_kernel_sectors(sp, a0[5], z0, a0[1], a0[2])
    io = BATCH * (4 * a0[0].shape[1] + 8 + 8)
    bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.streamed_lookup(*a, **kw) for a in sargs]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.streamed_lookup_plain(*a0, **kw), 3, 1)
    flow = "on" if nfl.use_flow else "off"
    log(f"streamed_lookup flow={flow}: median over {len(fns)} distinct "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; plain {plain_ms:.3f} ms; scan pool "
        f"{int(sp.pool.plen.item())} rows (capacity {sp.pool.pk.shape[0]}, "
        f"router {sp.router.shape[0]}, window {sp.window}); "
        f"{tiles:.3f} tiles probed/query; {sectors} distinct sectors "
        f"({sectors / BATCH:.3f}/query; the kernel's own reads touch "
        f"{ksectors}, {ksectors / BATCH:.3f}/query); bound {bound:.6f} ms; same "
        f"batches, fused_lookup {look['ms']:.5f} ms cold, "
        f"{look['ms_warm_l2']:.5f} ms warm: streamed/fused "
        f"{ms / look['ms']:.2f} cold, {ms_warm / look['ms_warm_l2']:.2f} "
        "warm")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, ms_warm_l2=ms_warm,
                host_ms_per_call=host, max_abs_err=err,
                tiles_per_query=tiles, sectors=sectors,
                sectors_kernel=ksectors, fused_ms=look["ms"],
                fused_ms_warm_l2=look["ms_warm_l2"],
                streamed_over_fused=ms / look["ms"])


def time_streamed_tiers(res, k, keys, split_key_bits, flush_buf, look_tiers):
    """streamed_lookup with the run and the delta populated, over the
    read-back batches of ``time_lookup_tiers``: against plain (bit-equal)
    and the fused kernel (payloads and z) on the first, then timed launch
    by launch beside the fused kernel's time on the same batches."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    sp = nfl.index._serving.stream_pack()
    kw = stream_kw(nfl)
    batches = [lookup_args(nfl, keys[i:i + BATCH], dev, split_key_bits)
               for i in range(0, keys.shape[0], BATCH)]
    sargs = [(*a[:4], sp, a[5]) for a in batches]
    err = compare_streamed(res, sargs[0], kw, k,
                           "read-back batch, tiers populated",
                           k.fused_lookup(*batches[0], **lookup_kw(nfl)))
    a0 = sargs[0]
    _p, z0 = k.streamed_lookup(*a0, **kw)
    sectors, _tiles = streamed_sectors(sp, a0[5], z0, a0[1], a0[2])
    ksectors = streamed_kernel_sectors(sp, a0[5], z0, a0[1], a0[2])
    b0 = a0[0].shape[0]
    bound = (sectors * SECTOR + b0 * (4 * a0[0].shape[1] + 16)) \
        / HBM_BYTES_PER_S * 1e3
    cold, warm, host = timed_launches(
        [lambda a=a: k.streamed_lookup(*a, **kw) for a in sargs], flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    fms = look_tiers["ms_tiers"]
    log(f"streamed_lookup with tiers: median over {len(sargs)} read-back "
        f"batches {ms:.5f} ms cold L2 (min {min(cold):.5f}, max "
        f"{max(cold):.5f}), {ms_warm:.5f} ms warm L2; host issue "
        f"{host:.5f} ms/call; {sectors} distinct sectors on the first (the "
        f"kernel's own reads {ksectors}); bound {bound:.6f} ms; same "
        f"batches, fused_lookup {fms:.5f} ms cold: streamed/fused "
        f"{ms / fms:.2f}")
    return dict(ms_tiers=ms, ms_warm_l2_tiers=ms_warm, bound_ms_tiers=bound,
                host_ms_per_call_tiers=host, sectors_kernel_tiers=ksectors,
                fused_ms_tiers=fms, streamed_over_fused_tiers=ms / fms,
                max_abs_err_tiers=err)


def time_probe(res, k, probe_args, flush_buf):
    """Phase 5: index_probe against plain on all 64 root-probe batches of
    s1 (bit-equal), timed launch by launch over them and bounded by the
    sectors its gathers touch plus its inputs and outputs."""
    want = [k.index_probe_plain(*a) for a in probe_args]
    got = [k.index_probe(*a) for a in probe_args]
    torch.cuda.synchronize()
    eq = all(bit_equal(g, w) for gs, ws in zip(got, want)
             for g, w in zip(gs, ws))
    err = max(float((g - w).abs().max().item())
              for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    log(f"index_probe vs plain, {res['name']} root node, "
        f"{len(probe_args)} batches of {BATCH}: payload, code and child "
        f"bit-equal {eq}")
    if not eq:
        fail("index_probe disagrees with its plain version")
    a0 = probe_args[0]
    sectors = probe_sectors(*a0[:5], a0[5:])
    ksectors = probe_sectors(*a0[:5], a0[5:], kernel=True)
    io = BATCH * (12 + 12)
    bound = (sectors * SECTOR + io) / HBM_BYTES_PER_S * 1e3
    fns = [lambda a=a: k.index_probe(*a) for a in probe_args]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.index_probe_plain(*a0), 5, 1)
    log(f"index_probe: median over {len(fns)} distinct batches {ms:.5f} ms "
        f"cold L2 (min {min(cold):.5f}, max {max(cold):.5f}), "
        f"{ms_warm:.5f} ms warm L2; host issue {host:.5f} ms/call; plain "
        f"{plain_ms:.3f} ms; {sectors} distinct sectors + {io} B of inputs "
        f"and outputs (the kernel's own gathers touch {ksectors}); bound "
        f"{bound:.6f} ms")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, ms_warm_l2=ms_warm,
                host_ms_per_call=host, max_abs_err=err,
                sectors_kernel=ksectors)


def compare_lookup_tiers(res, k, split_key_bits):
    """fused_lookup and streamed_lookup against their plain versions (and
    each other) while the run and the delta hold data and tombstones: a
    batch of deleted, updated, inserted, loaded and unloaded keys, also
    held to the ground truth."""
    dev = torch.device("cuda")
    nfl = res["nfl"]
    rng = np.random.default_rng(res["seed"] + 300)
    parts = [res["deleted"], res["truth"].keys, res["unloaded"]]
    if "updated" in res:
        parts.append(res["updated"][0])
    keys = np.concatenate([rng.choice(p, BATCH // len(parts))
                           for p in parts])
    args = lookup_args(nfl, keys, dev, split_key_bits)
    if args[5] is None:
        fail(f"{res['name']}: no write tier holds data for the comparison")
    what = "run and delta populated, tombstones"
    pk, zk, err = compare_lookup(res, args, lookup_kw(nfl), k, what)
    wrong = int((pk.cpu().numpy() != res["truth"].lookup(keys)).sum())
    log(f"fused_lookup with populated tiers against ground truth: "
        f"wrong={wrong}")
    if wrong:
        fail(f"{res['name']}: fused_lookup wrong with populated tiers")
    sargs = (*args[:4], nfl.index._serving.stream_pack(), args[5])
    err_s = compare_streamed(res, sargs, stream_kw(nfl), k, what, (pk, zk))
    return err, err_s


def compare_range(res, args, k):
    """fused_range_scan against plain on one batch: pv, cnt, tot, zlo,
    zhi bit-equal, and zlo equal to nf_forward's z with the flow on."""
    nfl = res["nfl"]
    kw = dict(dim=nfl.cfg.flow.dim, shapes=nfl._shapes, scan_cap=SCAN_CAP,
              use_flow=nfl.use_flow)
    got = k.fused_range_scan(*args, **kw)
    want = k.fused_range_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    eq = {n: bit_equal(g, w) for n, g, w in
          zip(("pv", "cnt", "tot", "zlo", "zhi"), got, want)}
    err = max(float((g.to(torch.float64) - w.to(torch.float64))
                    .abs().max().item()) for g, w in zip(got, want))
    tp = args[4]
    log(f"fused_range_scan vs plain, {res['name']} "
        f"(flow {'on' if nfl.use_flow else 'off'}; run "
        f"{int(tp.pools.run_len.item()) if tp else 0}, delta "
        f"{int(tp.pools.dl_len.item()) if tp else 0}), "
        f"{args[0].shape[0]} ranges: bit-equal {eq}")
    if not all(eq.values()):
        fail("fused_range_scan disagrees with its plain version")
    if nfl.use_flow:
        zf = k.nf_forward(args[0], nfl._packed_w, nfl._shapes,
                          nfl.cfg.flow.dim)
        if not bit_equal(got[3], zf):
            fail("range kernel zlo differs from nf_forward z")
        log("fused_range_scan zlo equals nf_forward z bit for bit: True")
    return got, err, kw


def time_range(res, batches, k, flush_buf):
    """The range kernel over its distinct batches, each launch timed
    alone, cold and warm, with its bound from the sectors it must read
    plus its inputs and output rows."""
    _got, err, kw = compare_range(res, batches[0], k)
    got = [k.fused_range_scan(*a, **kw) for a in batches]
    sectors, probe = [], []
    for a, g in zip(batches, got):
        s, p = range_sectors(a[3], a[4], g[3], g[4], SCAN_CAP)
        sectors.append(s)
        probe.append(p)
    b = batches[0][0].shape[0]
    io = b * (2 * 4 * batches[0][0].shape[1] + (SCAN_CAP + 4) * 4)
    bounds = [(s * SECTOR + io) / HBM_BYTES_PER_S * 1e3 for s in sectors]
    fns = [lambda a=a: k.fused_range_scan(*a, **kw) for a in batches]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    bound = statistics.median(bounds)
    plain_ms = time_ms(lambda: k.fused_range_scan_plain(*batches[0], **kw),
                       2, 1)
    rows = sum(int(g[1].sum().item()) for g in got) / len(got)
    log(f"fused_range_scan flow={'on' if kw['use_flow'] else 'off'}: "
        f"median over {len(fns)} distinct batches of {b} ranges "
        f"{ms:.5f} ms cold L2 (min {min(cold):.5f}, max {max(cold):.5f}), "
        f"{ms_warm:.5f} ms warm L2; host issue {host:.5f} ms/call; plain "
        f"{plain_ms:.3f} ms; {rows:.0f} rows/batch; bound {bound:.6f} ms "
        f"(median {statistics.median(sectors):.0f} sectors of searches, "
        f"spans and probe windows + {io} B of inputs and output rows; the "
        f"probes' own binary searches touch {statistics.median(probe):.0f} "
        f"more, not counted); ms/bound {ms / bound:.1f} cold, "
        f"{ms_warm / bound:.1f} warm")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                ms_warm_l2=ms_warm, host_ms_per_call=host, max_abs_err=err,
                ratio_to_bound=ms / bound)


# ------------------------------------------------------- LM serving path
def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values (8 significant bits) at |x|."""
    return 2.0 ** (int(np.floor(np.log2(max(abs(x), 2.0 ** -126)))) - 7)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def lm_device() -> torch.device:
    """The LM phases' device: the card (``LM_DEVICE``; a rehearsal of
    phases 6d and 6m on the CPU at smoke configs sets "cpu")."""
    return torch.device(LM_DEVICE)


def lm_config(arch):
    """An architecture's published config (a CPU rehearsal swaps in the
    smoke config)."""
    from repro_torch.configs import get_config

    return get_config(arch)


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib(dev):
    return (torch.cuda.max_memory_allocated() / 2**30
            if dev.type == "cuda" else None)


def serve_requests(win, ops, model, params, prompts, new, slots, max_len,
                   extra=None):
    """Drive ``prompts`` through the port's ``ContinuousBatcher`` (``slots``
    slots, ``new`` tokens each) until drained, in one counted window.
    Every prefill and decode step is timed on the host (each ends in the
    host reading its logits' finiteness) and its launches read from the
    counters around it (no reset inside the window).  Returns (requests,
    metrics, window counts, per-call launch counts)."""
    from repro_torch.serve.scheduler import (ContinuousBatcher, Request,
                                             ServeConfig)

    pre_s, dec_ms, bad = [], [], collections.Counter()
    calls = {"prefill": [], "decode": []}

    def counted(kind, fn):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = fn()
        logits = out[1] if kind == "prefill" else out[0]
        bad[kind] += int((~torch.isfinite(logits)).sum())
        secs = time.perf_counter() - t
        after = ops.launch_counts()
        calls[kind].append({key: after[key] - before[key] for key in after})
        (pre_s if kind == "prefill" else dec_ms).append(
            secs if kind == "prefill" else secs * 1e3)
        return out

    timed = dataclasses.replace(
        model,
        prefill=lambda p, tokens, max_len, extra=None: counted(
            "prefill", lambda: model.prefill(p, tokens, max_len, extra)),
        decode_step=lambda p, state, tokens, extra=None: counted(
            "decode", lambda: model.decode_step(p, state, tokens, extra)))
    batcher = ContinuousBatcher(timed, params, ServeConfig(
        batch_slots=slots, max_len=max_len))
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=new)
            for i, pr in enumerate(prompts)]

    def drive():
        sync(model.device)
        t = time.perf_counter()
        for r in reqs:
            batcher.submit(r)
        status = batcher.run_until_drained()
        return status, t, time.perf_counter() - t

    (status, t_sub, secs), counts = win.run(drive)
    n_prompt = int(sum(len(pr) for pr in prompts))
    n_new = sum(len(r.output) for r in reqs)
    ttft = [(r.t_first - t_sub) * 1e3 for r in reqs]
    met = dict(
        requests=len(reqs), prompt_tokens=n_prompt, new_tokens=n_new,
        decode_steps=batcher.steps, seconds=secs,
        prefill_tokens_per_s=n_prompt / sum(pre_s),
        prefill_ms_median=statistics.median(pre_s) * 1e3,
        prefill_ms_max=max(pre_s) * 1e3,
        ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
        decode_step_ms_median=statistics.median(dec_ms),
        decode_step_ms_max=max(dec_ms),
        decode_tokens_per_s=n_new / secs)
    if not status.drained or any(len(r.output) != new or not r.done
                                 for r in reqs):
        fail(f"{model.cfg.name}: a request did not finish with its "
             f"{new} tokens")
    if sum(bad.values()):
        fail(f"{model.cfg.name}: non-finite logits {dict(bad)}")
    met["non_finite"] = dict(bad)
    return reqs, met, counts, calls, batcher


def lm_serve(win, seed):
    """Phase 6: falcon-mamba-7b at full width and depth, random weights on
    the card, 16 requests through the continuous batcher until drained,
    in one counted window."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    # f32 products and convolutions in full f32 for the f32 comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    base = get_config(LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=LM_DEPTH,
                              ssm=dataclasses.replace(
                                  base.ssm, use_scan_kernel=True))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.param_dtype}; {n_params} parameters "
        f"({sum(t.numel() * t.element_size() for t in leaves(params)) / 2**30:.2f} "
        f"GiB) drawn in {init_s:.2f} s")
    rng = np.random.default_rng(seed + 400)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    reqs, met, counts, calls, batcher = serve_requests(
        win, ops, model, params, prompts, LM_NEW, LM_SLOTS,
        LM_PROMPT[1] + LM_NEW)
    met = dict(init_s=init_s, params=n_params, **met,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[lm] served {len(reqs)} requests ({met['prompt_tokens']} prompt "
        f"tokens, {met['new_tokens']} new) in {met['seconds']:.2f} s, "
        f"{batcher.steps} decode steps of "
        f"{LM_SLOTS} slots: prefill {met['prefill_tokens_per_s']:.0f} "
        f"tokens/s (ms per request median {met['prefill_ms_median']:.1f}, "
        f"max {met['prefill_ms_max']:.1f}); TTFT ms median "
        f"{met['ttft_ms_median']:.1f} max {met['ttft_ms_max']:.1f}; decode "
        f"step ms median {met['decode_step_ms_median']:.2f} max "
        f"{met['decode_step_ms_max']:.2f}; {met['decode_tokens_per_s']:.1f} "
        f"new tokens/s end to end; peak {met['peak_gib']:.2f} GiB; "
        f"non-finite logits {met['non_finite']}; launches {counts}")
    log("[lm] metrics " + json.dumps(met))
    if len(calls["prefill"]) != LM_REQUESTS \
            or counts["mamba_scan"] != cfg.n_layers * LM_REQUESTS \
            or any(c["mamba_scan"] != cfg.n_layers for c in calls["prefill"]):
        fail(f"lm: mamba_scan launched {counts['mamba_scan']} times for "
             f"{len(calls['prefill'])} prefills of {cfg.n_layers} layers")
    if counts["flash_decode"]:
        fail("lm: flash_decode launched on the ssm path")
    return dict(model=model, params=params, cfg=cfg, reqs=reqs, met=met,
                max_len=LM_PROMPT[1] + LM_NEW)


def leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def lm_replay(lm, tag="[lm]"):
    """Teacher-forced: replay the batcher's tokens of ``LM_REPLAYS``
    requests through a batch-1 prefill and decode loop; each token must
    score within 4 bf16 ulps of the replay's maximum logit (a batch of 8
    and a batch of 1 round apart in the products, so argmax may differ
    only on a near tie)."""
    model, params = lm["model"], lm["params"]
    dev = model.device
    worst = (0.0, 0.0)
    flips = 0
    for r in lm["reqs"][:LM_REPLAYS]:
        toks = torch.as_tensor(r.prompt[None].astype(np.int64), device=dev)
        state, logits = model.prefill(params, toks, lm["max_len"])
        for t, tok in enumerate(r.output):
            if t:
                logits, state = model.decode_step(
                    params, state, torch.tensor([[r.output[t - 1]]],
                                                device=dev))
            lg = logits[0].float()
            mx = float(lg.max())
            gap = mx - float(lg[tok])
            flips += int(gap > 0)
            if gap > 4 * bf16_ulp(mx):
                fail(f"{tag} replay: request {r.rid} token {t} ({tok}) scores "
                     f"{gap} below the replay's max logit {mx}")
            if gap >= worst[0]:
                worst = (gap, 4 * bf16_ulp(mx))
    log(f"{tag} teacher-forced replay of {LM_REPLAYS} requests x {LM_NEW} "
        f"tokens at batch 1: {flips} tokens not the replay's argmax; worst "
        f"gap to the max logit {worst[0]} (bound {worst[1]})")
    return dict(flips=flips, worst_gap=worst[0])


FD_KERNELS = ("decode_split_kernel", "decode_combine_kernel")


def decode_profile(lm, tag="[lm]", state=None):
    """One decode step of ``LM_SLOTS`` slots under ``torch.profiler``: the
    device operations it launches, their summed device time and
    ``flash_decode``'s share of it (its split and combine kernels),
    beside the step's host wall time; on ``state`` (kept as the step
    leaves it), else on a fresh state after two steps.  Informational:
    where the profiler sees no device events, the counts read "not
    measured" and nothing fails."""
    model, params = lm["model"], lm["params"]
    dev = torch.device("cuda")
    tokens = torch.zeros((LM_SLOTS, 1), dtype=torch.long, device=dev)
    if state is None:
        state = model.init_decode_state(LM_SLOTS, lm["max_len"])
        for _ in range(2):
            _lg, state = model.decode_step(params, state, tokens)
    out = dict(device_ops=None, device_ms=None, wall_ms=None,
               flash_decode_ms=None, flash_decode_share=None,
               cache_len=[int(n) for n in state["cache_len"].tolist()])
    prof, out["wall_ms"] = profile_call(
        lambda: model.decode_step(params, state, tokens))
    if prof is None:
        return out
    cuda = torch.autograd.DeviceType.CUDA
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and not e.is_user_annotation()]
    if evs:
        out["device_ops"] = len(evs)
        out["device_ms"] = device_ms(evs)
        out["flash_decode_ms"] = device_ms(evs, FD_KERNELS)
        out["flash_decode_share"] = (out["flash_decode_ms"]
                                     / max(out["device_ms"], 1e-9))
    log(f"{tag} decode step of {LM_SLOTS} slots under torch.profiler "
        f"(cache_len {out['cache_len']}): "
        f"{out['device_ops'] if evs else 'not measured'} device operations "
        f"(kernels, copies, fills), summed device time "
        f"{out['device_ms'] if evs else 'not measured'} ms, flash_decode "
        f"{out['flash_decode_ms'] if evs else 'not measured'} ms (share "
        f"{out['flash_decode_share'] if evs else 'not measured'}), host "
        f"wall {out['wall_ms']:.3f} ms with the profiler on (unprofiled "
        f"step median {lm['met']['decode_step_ms_median']:.3f} ms)")
    return out


def lm_branches(lm, seed):
    """The kernel path against the chunked path on one prompt of 2,048
    tokens: one mamba_block in f32 with layer 0's weights, and the full
    model's bf16 prefill logits.  Returns the scan inputs of the first
    ``LM_SCAN_LAYERS`` layers on that prompt (for phase 7)."""
    from repro_torch.models import ssm, transformer as tfm
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import build_model

    dev = torch.device("cuda")
    model, params, cfg = lm["model"], lm["params"], lm["cfg"]
    chunked = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, use_scan_kernel=False))
    rng = np.random.default_rng(seed + 401)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, LM_CHECK_LEN)),
                           device=dev)
    lp0 = tfm.layer_params(params, 0)
    p32 = {k: v.float() for k, v in lp0["ssm"].items()}
    h = rms_norm(params["embed"][toks].float(), lp0["ln"].float(),
                 cfg.norm_eps)
    yk = ssm.mamba_block(h, p32, cfg.d_model, cfg.ssm)
    yc = ssm.mamba_block(h, p32, cfg.d_model, chunked.ssm)
    err = float((yk - yc).abs().max())
    ok = bool(torch.allclose(yk, yc, rtol=BRANCH_TOL, atol=BRANCH_TOL))
    log(f"[lm] mamba_block layer 0 in f32, {LM_CHECK_LEN} tokens: kernel vs "
        f"chunked max |dy| {err} (max |y| {float(yc.abs().max())}); within "
        f"{BRANCH_TOL}: {ok}")
    if not ok:
        fail("lm: kernel and chunked mamba_block disagree in f32")
    del yk, yc, h, p32
    t = time.perf_counter()
    _, lk = model.prefill(params, toks, lm["max_len"])
    torch.cuda.synchronize()
    tk = time.perf_counter() - t
    t = time.perf_counter()
    _, lc = build_model(chunked).prefill(params, toks, lm["max_len"])
    torch.cuda.synchronize()
    tc = time.perf_counter() - t
    lk, lc = lk[0].float(), lc[0].float()
    rel = float((lk - lc).norm() / lc.norm())
    top = torch.topk(lc, 2).values
    same = int(lk.argmax()) == int(lc.argmax())
    log(f"[lm] full-model bf16 prefill logits, {LM_CHECK_LEN} tokens: "
        f"kernel vs chunked relative L2 {rel} (bound {LM_LOGIT_REL_L2}), "
        f"max |d| {float((lk - lc).abs().max())}, same argmax {same} "
        f"(chunked top-2 gap {float(top[0] - top[1])}); prefill s kernel "
        f"{tk:.3f}, chunked {tc:.3f}")
    if not rel < LM_LOGIT_REL_L2 or not same:
        fail("lm: kernel and chunked prefill logits disagree")
    caps = []
    x = params["embed"][toks]
    for i in range(LM_SCAN_LAYERS):
        lp = tfm.layer_params(params, i)
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        caps.append((*ssm.mamba_scan_inputs(h, lp["ssm"])[:4],
                     lp["ssm"]["A_log"].contiguous()))
        x = tfm._ssm_block(x, lp, cfg)
    return caps, dict(block_err=err, logit_rel_l2=rel, same_argmax=same,
                      prefill_s_kernel=tk, prefill_s_chunked=tc)


def kernel_attn_per_step(cfg) -> int:
    """Decode attentions a step runs on the kernel route (one
    ``flash_decode`` launch each): the self-attention layers whose route
    is the kernel's, the vlm cross layers, the hybrid's shared block
    once a group, encdec's self and cross attention a layer."""
    from repro_torch.models.attention import BIG_WINDOW, decode_route
    from repro_torch.models.transformer import _windows_for

    a = cfg.attn
    if a is None:
        return 0
    if cfg.family == "encdec":
        return 2 * cfg.n_layers * (decode_route(a) == "kernel")
    if cfg.family == "hybrid":
        return (cfg.n_layers // cfg.hybrid_attn_every
                * (decode_route(a, BIG_WINDOW) == "kernel"))
    n = sum(decode_route(a, w) == "kernel" for w in _windows_for(cfg))
    if cfg.family == "vlm":
        n += (cfg.n_layers // cfg.cross_attn_every) * (
            decode_route(a) == "kernel")
    return n


def per_call_launches(calls, kind, expect, what):
    """Every ``kind`` call launched ``flash_decode`` exactly ``expect``
    times."""
    got = collections.Counter(c["flash_decode"] for c in calls[kind])
    if set(got) != {expect}:
        fail(f"{what}: flash_decode launched {dict(got)} times per {kind} "
             f"call (expected {expect})")
    return dict(got)


def route_check(model, params, state, tag):
    """Layer 0's decode attention on the kernel route against the plain
    einsum route, on the served cache (``state``, bf16) and a random
    normed hidden state, in f32: the layer's weights widened to f32 and
    ``wo`` replaced by the identity, so both outputs are the attention
    itself in f32, from the same q.  The two routes differ only in the
    order of their f32 sums, so they are held to ``FD_TOL``, the kernel's
    bound against its plain version."""
    from repro_torch.models import attention, transformer as tfm
    from repro_torch.models.layers import rms_norm

    cfg = model.cfg
    a = cfg.attn
    lp = tfm.layer_params(params, 0)
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(600)
    x = torch.randn((state["cache_len"].shape[0], 1, cfg.d_model),
                    generator=g, device=dev)
    h = rms_norm(x, lp["ln1"].float(), cfg.norm_eps)
    p = {key: v.float() for key, v in lp["attn"].items()}
    p["wo"] = torch.eye(a.n_heads * a.head_dim, device=dev)
    args = (h, p, a, state["k_cache"][0], state["v_cache"][0],
            state["cache_len"])
    ker = attention.decode_attention(*args, route="kernel")
    pln = attention.decode_attention(*args, route="plain")
    err = float((ker - pln).abs().max())
    ok = bool(torch.allclose(ker, pln, rtol=FD_TOL, atol=FD_TOL))
    log(f"{tag} layer 0 decode attention in f32, kernel route vs plain "
        f"route on the served bf16 cache (cache_len "
        f"{state['cache_len'].tolist()}): max |d| {err} (max |o| "
        f"{float(pln.abs().max())}), within {FD_TOL}: {ok}")
    if not ok:
        fail(f"{tag} kernel and plain decode routes disagree")
    return err


def dense_phase(win, seed, card, r1_art=None, mesh=False):
    """Phase 6d: qwen3-14b at its full published config, random bf16
    weights on the card from the seed, served as phase 6 serves
    falcon-mamba-7b; 40 ``flash_decode`` launches a decode step, none in
    a prefill; the batcher against a batch-1 replay; layer 0's kernel
    route against the plain route on the served cache; one long-context
    decode step profiled.  Then, on the same parameters and served
    cache, phase m's dense legs (``mesh``: ``mesh_phase``; the caller
    runs its other legs, ``mesh_families_phase``), and phase r1 at
    ``r1_art``'s batch (``roofline_decode``)."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    dev = lm_device()
    cfg = lm_config(DENSE_ARCH)
    reset_peak(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    log(f"[dense] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.attn.n_heads}/{cfg.attn.kv_heads} heads of "
        f"{cfg.attn.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}; {n_params} parameters ({n_bytes / 1e9:.2f} GB) "
        f"drawn in {init_s:.2f} s")
    rng = np.random.default_rng(seed + 700)
    lens = rng.integers(LM_PROMPT[0], LM_PROMPT[1] + 1, LM_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    max_len = LM_PROMPT[1] + LM_NEW
    reqs, met, counts, calls, batcher = serve_requests(
        win, ops, model, params, prompts, LM_NEW, LM_SLOTS, max_len)
    # counters move for CUDA launches only (a CPU rehearsal counts none)
    expect = kernel_attn_per_step(cfg) if dev.type == "cuda" else 0
    per = {"decode": per_call_launches(calls, "decode", expect, "dense"),
           "prefill": per_call_launches(calls, "prefill", 0, "dense")}
    if counts["flash_decode"] != expect * batcher.steps:
        fail(f"dense: flash_decode launched {counts['flash_decode']} times "
             f"in {batcher.steps} decode steps of {expect} layers")
    met = dict(init_s=init_s, params=n_params, param_bytes=n_bytes, **met,
               peak_gib=peak_gib(dev), flash_decode_per_step=expect)
    log(f"[dense] served {len(reqs)} requests ({met['prompt_tokens']} prompt "
        f"tokens, {met['new_tokens']} new) in {met['seconds']:.2f} s, "
        f"{batcher.steps} decode steps of {LM_SLOTS} slots: prefill "
        f"{met['prefill_tokens_per_s']:.0f} tokens/s (ms per request "
        f"median {met['prefill_ms_median']:.1f}, max "
        f"{met['prefill_ms_max']:.1f}); TTFT ms median "
        f"{met['ttft_ms_median']:.1f} max {met['ttft_ms_max']:.1f}; decode "
        f"step ms median {met['decode_step_ms_median']:.2f} max "
        f"{met['decode_step_ms_max']:.2f}; {met['decode_tokens_per_s']:.1f} "
        f"new tokens/s end to end; peak {met['peak_gib']} GiB; "
        f"flash_decode launches per call {per}; window {counts}")
    log("[dense] metrics " + json.dumps(met))
    lm = dict(model=model, params=params, cfg=cfg, reqs=reqs, met=met,
              max_len=max_len)
    out = dict(met=met, replay=lm_replay(lm, "[dense]"))
    out["route_err"] = route_check(model, params, batcher.state, "[dense]")
    if dev.type == "cuda":
        out["decode_profile"] = decode_profile(lm, "[dense]", batcher.state)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[dense] phase 6d {out['seconds']:.1f} s ({card})")
    if mesh:
        out["m"] = mesh_phase(win, lm, batcher.state, card)
    if r1_art is not None:
        del batcher
        out["r1"] = roofline_decode(win, lm, r1_art, card)
    return out


# ------------------------------------------------------------- phase m
def mesh_decode_verdict(world, ref, got, ref_tok, got_tok, what):
    """m1's verdict on one decode step: on one card (a world of 1, the
    mesh (1, 1)) the mesh route's logits and tokens are bit-equal to the
    unsharded route's; on more cards each mesh token scores within
    ``MESH_ULPS`` bf16 ulps of the unsharded route's maximum logit of
    its row, and every logit within that of the unsharded one."""
    if world == 1:
        if not (bit_equal(ref, got) and torch.equal(ref_tok, got_tok)):
            fail(f"{what}: the (1, 1) mesh's logits or tokens are not "
                 "bit-equal to the unsharded decode route's")
        return 0.0
    worst = 0.0
    for r in range(ref.shape[0]):
        mx = float(ref[r].max())
        bound = MESH_ULPS * bf16_ulp(mx)
        gap = mx - float(ref[r, int(got_tok[r])])
        dev = float((ref[r] - got[r]).abs().max())
        if gap > bound or dev > bound:
            fail(f"{what}: row {r}: token gap {gap}, max |d| {dev} past "
                 f"{MESH_ULPS} bf16 ulps ({bound})")
        worst = max(worst, dev / bound)
    return worst


def state_verdict(world, ref, got, what):
    """m4's and m7's verdict on a state the mesh route wrote: on one
    card (a world of 1) every leaf bit-equal to the unsharded route's
    (the K/V, cross and recurrent caches, ``cache_len``)."""
    if world != 1:
        return
    if set(ref) != set(got):
        fail(f"{what}: the mesh route's state has leaves {sorted(got)}, "
             f"the unsharded route's {sorted(ref)}")
    for key in ref:
        if not bit_equal(ref[key], got[key]):
            fail(f"{what}: the mesh route's {key} is not bit-equal to the "
                 "unsharded route's")


def budget_verdict(what, seconds, budget):
    """A phase's time against its stated budget."""
    if seconds > budget:
        fail(f"{what} took {seconds:.1f} s, past its {budget} s budget")


def mesh_peak_verdict(tag, measured, predicted):
    """m2's memory verdict: the measured per-card peak over the mesh dry
    run's within ``M2_PEAK_BOUND``."""
    ratio = measured / predicted
    lo, hi = M2_PEAK_BOUND
    log(f"[{tag}] peak: mesh dry run {predicted / 1e9:.3f} GB, measured "
        f"{measured / 1e9:.3f} GB; measured/predicted {ratio:.4f} (bound "
        f"{lo}-{hi})")
    if not lo <= ratio <= hi:
        fail(f"{tag}: measured/predicted peak {ratio:.4f} outside "
             f"{M2_PEAK_BOUND}")
    return ratio


def per_step_launches(per, expect, what, kernel="flash_decode"):
    """Every step launched ``kernel`` ``expect`` times."""
    if set(per) != {expect}:
        fail(f"{what}: {kernel} launched {per} times in "
             f"{len(per)} steps (expected {expect} a step)")


def collective_verdict(tag, counted, dry):
    """m2's and m5's communication verdict: the bytes a step counted
    equal its mesh dry run's (to 1e-6 of them)."""
    if abs(counted - dry) > 1e-6 * dry:
        fail(f"{tag}: the step counted {counted} collective bytes, its dry "
             f"run {dry}")


def kernel_verdict(tag, name, got, want, tol):
    """A kernel's output against its plain version on the same inputs,
    within ``tol`` (rtol and atol); returns the max |d|."""
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"{tag}: {name} disagrees with its plain version (max |d| "
             f"{err}, tolerance {tol})")
    return err


def loss_verdict(tag, plain, meshed, steps, tol):
    """m3's and m6's verdict: ``steps`` losses each, the mesh launcher's
    within ``tol`` (relative) of the unsharded launcher's."""
    if len(plain) != steps or len(meshed) != steps:
        fail(f"{tag}: {len(plain)} and {len(meshed)} losses, expected "
             f"{steps} each")
    rel = max(abs(x - y) / abs(x) for x, y in zip(plain, meshed))
    if rel > tol:
        fail(f"{tag}: the mesh launcher's losses {meshed} are not the "
             f"unsharded trainer's {plain}")
    return rel


def _clone_state(state):
    return {k: v.clone() for k, v in state.items()}


def mesh_m1(win, lm, served, card):
    """m1: the launched mesh over this process's world (one process: a
    world of 1 and the mesh (1, 1), whatever ``device_count``): 6d's
    parameters placed by ``param_sharding`` (no copy: every leaf is its
    own block) decode 8 slots over copies of 6d's served cache, beside
    the unsharded route on another copy, ``M1_STEPS`` steps."""
    import torch.distributed as dist

    from repro_torch.dist.sharding import place
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import state_sharding

    model, params, cfg = lm["model"], lm["params"], lm["cfg"]
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    mesh = make_mesh_shape((1, 1), ("data", "model"), model.device.type)
    world = dist.get_world_size()
    mm = build_model(cfg, device=model.device, mesh=mesh)
    pm = mm.place(params)
    same = all(a is b for a, b in zip(leaves(pm), leaves(params)))
    b, s = served["k_cache"].shape[1], served["k_cache"].shape[2]
    ref = _clone_state(served)
    got = place(_clone_state(served), state_sharding(cfg, mesh, b, s))
    g = torch.Generator(device=model.device).manual_seed(800)
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=g,
                        device=model.device)
    rtok, per, worst = tok, [], 0.0
    # counters move for CUDA launches only (a CPU rehearsal counts none)
    expect = kernel_attn_per_step(cfg) if model.device.type == "cuda" else 0
    for i in range(M1_STEPS):
        rl, ref = model.decode_step(params, ref, rtok)
        (ml, got), counts = win.run(lambda: mm.decode_step(pm, got, tok))
        per.append(counts["flash_decode"])
        rtok, tok = rl.argmax(-1, keepdim=True), ml.argmax(-1, keepdim=True)
        worst = max(worst, mesh_decode_verdict(
            world, rl, ml, rtok, tok, f"m1 step {i}"))
    per_step_launches(per, expect, "m1")
    if not bit_equal(ref["k_cache"], got["k_cache"]) and world == 1:
        fail("m1: the mesh route wrote another K cache")
    del ref, got
    dist.destroy_process_group()
    out = dict(cards=cards, world=world, mesh=[1, 1], steps=M1_STEPS,
               flash_decode_per_step=per, bit_equal=world == 1,
               params_placed_without_copy=same, worst_ulp_share=worst,
               seconds=time.perf_counter() - t0)
    log(f"[m1] {cards} card(s) visible; world {world}, mesh (1, 1) "
        f"(data, model); {cfg.name} placed by param_sharding "
        f"(no copy: {same}), {M1_STEPS} decode steps of {b} slots over 6d's "
        f"served cache ({s} positions): logits and tokens bit-equal to "
        f"the unsharded route: {world == 1}; flash_decode {per} a step; "
        f"{out['seconds']:.1f} s; {card}")
    return out


def _rank_params(cfg, plan, dev, seed):
    """Random bf16 parameters in the shapes of the rank's blocks, drawn
    on the card (the norm weights zero, as ``init`` makes them)."""
    from repro_torch.models.model import build_model

    whole = build_model(cfg, device="meta").init(torch.Generator())
    g = torch.Generator(device=dev).manual_seed(seed)

    def walk(t, sh, key=""):
        if isinstance(t, dict):
            return {k: walk(v, sh[k], k) for k, v in t.items()}
        shape = sh.local_shape(t.shape)
        if key.startswith("ln") or key.endswith("norm"):
            return torch.zeros(shape, dtype=t.dtype, device=dev)
        return (torch.randn(shape, generator=g, device=dev) * 0.02).to(
            t.dtype)

    return walk(whole, plan.shardings)


def mesh_m2(win, card):
    """m2: one rank of a (``M2_DATA``, k) mesh, k in ``M2_MODELS``, under
    a fake process group of its size (every collective returns at once,
    moving nothing: communication is counted, not timed): qwen3-14b's
    ``decode_32k`` at the mesh dry run's per-card batch, only rank 0's
    blocks and cache on the card; the peak against the dry run's, a
    step's ms between CUDA events and its device ms under
    ``torch.profiler``, ``flash_decode`` at (40/k, 8/k) heads against its
    plain version and timed, and the counted collective bytes a step
    against the dry run's."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.dist import tensor_parallel as tp
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models.model import build_model

    cfg = lm_config(DENSE_ARCH)
    dev = lm_device()
    cuda = dev.type == "cuda"
    shape = SHAPES["decode_32k"]
    rows = []
    for k in M2_MODELS:
        t0 = time.perf_counter()
        mesh = make_mesh_shape((M2_DATA, k), ("data", "model"), dev.type,
                               fake=True)
        art = dryrun_cell(DENSE_ARCH, "decode_32k", cfg=cfg, mesh=mesh,
                          save=False)
        t_dry = time.perf_counter() - t0
        mm = build_model(cfg, device=dev, mesh=mesh)
        plan = mm.plan
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        params = _rank_params(cfg, plan, dev, 900 + k)
        state = mm.init_decode_state(shape.global_batch, shape.seq_len)
        state["cache_len"].fill_(shape.seq_len - 1)
        b = state["k_cache"].shape[1]
        tokens = torch.zeros((b, 1), dtype=torch.long, device=dev)
        per, ms, coll, peak = [], [], [], None
        for _ in range(M2_STEPS):
            tp.collective_counts(reset=True)
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            (_lg, state), counts = win.run(
                lambda: mm.decode_step(params, state, tokens))
            if cuda:
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            per.append(counts["flash_decode"])
            coll.append(tp.collective_counts()["total"])
        dev_ms = fd_ms = None   # not measured off the card
        if cuda:
            peak = torch.cuda.max_memory_allocated() - base
            prof, _wall = profile_call(
                lambda: mm.decode_step(params, state, tokens))
            if prof is not None:
                raw = prof.profiler.kineto_results.events()
                dev_ms, fd_ms = device_ms(raw), device_ms(raw, FD_KERNELS)
        per_step_launches(per, kernel_attn_per_step(cfg) if cuda else 0,
                          f"m2 k={k}")
        # flash_decode at the rank's heads, against its plain version
        kc, vc = state["k_cache"][0], state["v_cache"][0]
        kc.normal_(generator=torch.Generator(device=dev).manual_seed(k))
        vc.normal_(generator=torch.Generator(device=dev).manual_seed(k + 1))
        kvh = kc.shape[2]
        q = torch.randn((b, kvh * cfg.attn.n_heads // cfg.attn.kv_heads,
                         cfg.attn.head_dim), device=dev)
        kl = state["cache_len"]
        ker = ops.flash_decode(q, kc, vc, kl)
        pln = fdk.flash_decode_plain(q, kc, vc, kl)
        err = float((ker - pln).abs().max())
        if not torch.allclose(ker, pln, rtol=FD_TOL, atol=FD_TOL):
            fail(f"m2 k={k}: flash_decode at {q.shape[1]}/{kvh} heads "
                 f"disagrees with its plain version (max |d| {err})")
        dry = art["collective_bytes"]["total"]
        collective_verdict(f"m2 k={k}", coll[-1], dry)
        pred = art["counts"]["peak_bytes"]
        kern_ms = ratio = None   # not measured off the card
        if cuda:
            kern_ms = time_ms(lambda: ops.flash_decode(q, kc, vc, kl), 5)
            ratio = mesh_peak_verdict(f"m2 k={k}", peak, pred)
        ops.reset_launch_counts()   # the comparison's launches: not main path
        row = dict(k=k, mesh=[M2_DATA, k], world=M2_DATA * k, batch=b,
                   heads=[q.shape[1], kvh], head_split=art["head_split"],
                   peak_measured_gb=peak and peak / 1e9,
                   peak_predicted_gb=pred / 1e9,
                   peak_ratio=ratio, step_ms=ms, device_ms=dev_ms,
                   flash_decode_device_ms=fd_ms,
                   flash_decode_per_step=per, flash_decode_ms=kern_ms,
                   flash_decode_max_abs_err=err,
                   collective_bytes_per_step=coll[-1],
                   collective_bytes_dry_run=dry,
                   dry_run_s=t_dry)
        del params, state, kc, vc, q, ker, pln
        dist.destroy_process_group()
        row["seconds"] = time.perf_counter() - t0
        log(f"[m2] rank 0 of ({M2_DATA}, {k}) (world {M2_DATA * k}, fake "
            f"process group: collectives stubbed, counted not timed): "
            f"batch {b} a card over 32,768 positions, heads "
            f"{row['heads']}; step ms (CUDA events; the host issues it) "
            f"{[round(x, 3) for x in ms]}, device ms of one step under "
            f"torch.profiler {dev_ms} (flash_decode {fd_ms}); "
            f"flash_decode {per} a step, "
            f"{kern_ms} ms at {row['heads']} heads (max |d| vs plain "
            f"{err}); collective bytes a step {coll[-1]:.4g} (dry run "
            f"{row['collective_bytes_dry_run']:.4g}); {row['seconds']:.1f} s; "
            f"{card}")
        rows.append(row)
    return rows


def mesh_m3(card):
    """m3: ``launch.train --mesh 1x1:data,model --elastic-demo`` on
    internlm2-1.8b at full width and ``M3_LAYERS`` layers, and the same
    launch without a mesh: the losses agree within ``RESTART_TOL`` (the
    card's backward is not bit-deterministic: two unsharded runs differ
    too)."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    args = ["--arch", TRAIN_ARCH, "--layers", str(M3_LAYERS), "--steps",
            str(M3_STEPS), "--seq", str(M3_SEQ), "--batch", str(M3_BATCH),
            "--device", lm_device().type]
    plain = launch_train.main(args)
    meshed = launch_train.main(args + ["--mesh", "1x1:data,model",
                                       "--elastic-demo"])
    if dist.is_initialized():
        dist.destroy_process_group()
    a = [m["loss"] for m in plain.metrics_log]
    b = [m["loss"] for m in meshed.metrics_log]
    rel = loss_verdict("m3", a, b, M3_STEPS, RESTART_TOL)
    log(f"[m3] {TRAIN_ARCH} at full width, {M3_LAYERS} layers, "
        f"{M3_BATCH} x {M3_SEQ}: launch.train losses {a}; --mesh "
        f"1x1:data,model --elastic-demo {b}; max rel diff {rel} (bound "
        f"{RESTART_TOL}); {time.perf_counter() - t0:.1f} s; {card}")
    del plain, meshed
    return dict(losses=a, mesh_losses=b, max_rel=rel,
                seconds=time.perf_counter() - t0)


def _mesh_11(dev):
    """The launched (1, 1) mesh over this process's world."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh_shape

    mesh = make_mesh_shape((1, 1), ("data", "model"), dev.type)
    return mesh, dist.get_world_size()


def _random_state(cfg, b, s, dev, seed, lens):
    """A whole decode state of ``b`` rows over ``s`` positions: random
    K/V caches and recurrent state (std 0.5), ``cache_len`` ``lens``."""
    from repro_torch.models.transformer import _state_leaves

    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for key, (shape, dt) in _state_leaves(cfg, b, s).items():
        if key == "cache_len":
            out[key] = lens.to(device=dev, dtype=dt)
        else:
            out[key] = (torch.randn(shape, generator=g, device=dev)
                        * 0.5).to(dt)
    return out


def _m4_decode(win, world, model, params, mm, pm, mesh, state, tok, what):
    """``M1_STEPS`` decode steps on the unsharded route and on the (1, 1)
    mesh, each from its own copy of ``state``: per step the logits and
    tokens bit-equal, and the launches of the mesh step's window."""
    from repro_torch.dist.sharding import place
    from repro_torch.models.transformer import state_sharding

    cfg = model.cfg
    b = state["cache_len"].shape[0]
    s = state["k_cache"].shape[2] if "k_cache" in state else M4_CACHE
    ref = _clone_state(state)
    got = place(_clone_state(state), state_sharding(cfg, mesh, b, s))
    rtok, per = tok, []
    for i in range(M1_STEPS):
        rl, ref = model.decode_step(params, ref, rtok)
        (ml, got), counts = win.run(lambda: mm.decode_step(pm, got, tok))
        per.append(counts["flash_decode"])
        rtok, tok = rl.argmax(-1, keepdim=True), ml.argmax(-1, keepdim=True)
        mesh_decode_verdict(world, rl, ml, rtok, tok, f"{what} step {i}")
    state_verdict(world, ref, got, what)
    return per


def _m4_model(cfg, dev, seed, mesh):
    from repro_torch.models.model import build_model

    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    mm = build_model(cfg, device=dev, mesh=mesh)
    pm = mm.place(params)
    same = all(a is b for a, b in zip(leaves(pm), leaves(params)))
    if not same:
        fail(f"{cfg.name}: placing on the (1, 1) mesh copied a leaf")
    return model, params, mm, pm


def mesh_m4(win, card):
    """m4: the (1, 1) mesh against the unsharded route for the moe, ssm
    and hybrid families, each at its published widths: granite-moe-1b-
    a400m (full config) decodes ``M4_BATCH`` rows over a random
    ``M4_CACHE``-position cache, ``M1_STEPS`` steps; falcon-mamba-7b at
    phase 6's ``LM_DEPTH`` layers (through the scan kernel) prefills
    ``M4_PREFILL`` tokens, then decodes ``M1_STEPS`` steps from its
    state; zamba2-2.7b at full depth decodes ``M1_STEPS`` steps over a
    random cache and recurrent state.  Logits, tokens and the states
    written are bit-equal, and every step's (and the prefill's) launch
    window exact: ``flash_decode`` once per attention on the kernel
    route, ``mamba_scan`` once per Mamba1 layer.  A (1, 1) mesh splits
    nothing, so the MoE block gets no mesh context and the Mamba layers
    whole weights: m4 checks the mesh route's placement and dispatch,
    not the sharded numerics (those are held on 4 gloo ranks,
    ``tests/test_torch_mesh_families.py``; m5 runs the sharded code
    under fake groups)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    dev = lm_device()
    cuda = dev.type == "cuda"
    mesh, world = _mesh_11(dev)
    g = torch.Generator(device=dev).manual_seed(810)
    out = {"world": world, "mesh": [1, 1]}
    lens = torch.randint(M4_CACHE // 2, M4_CACHE - M1_STEPS, (M4_BATCH,),
                         generator=g, device=dev)

    # moe: granite-moe-1b-a400m
    t1 = time.perf_counter()
    cfg = lm_config(M4_MOE_ARCH)
    model, params, mm, pm = _m4_model(cfg, dev, 811, mesh)
    state = _random_state(cfg, M4_BATCH, M4_CACHE, dev, 812, lens)
    tok = torch.randint(0, cfg.vocab, (M4_BATCH, 1), generator=g,
                        device=dev)
    expect = kernel_attn_per_step(cfg) if cuda else 0
    per = _m4_decode(win, world, model, params, mm, pm, mesh, state, tok,
                     f"m4 {cfg.name}")
    per_step_launches(per, expect, f"m4 {cfg.name}")
    out["moe"] = dict(arch=cfg.name, layers=cfg.n_layers,
                      flash_decode_per_step=per,
                      seconds=time.perf_counter() - t1)
    del model, params, mm, pm, state

    # ssm: falcon-mamba-7b at phase 6's depth, prefill then decode
    t1 = time.perf_counter()
    base = lm_config(LM_ARCH)
    cfg = dataclasses.replace(
        base, n_layers=min(LM_DEPTH, base.n_layers),
        ssm=dataclasses.replace(base.ssm, use_scan_kernel=True))
    model, params, mm, pm = _m4_model(cfg, dev, 813, mesh)
    b, l = M4_PREFILL
    toks = torch.randint(0, cfg.vocab, (b, l), generator=g, device=dev)
    with torch.no_grad():
        ref_state, ref_logits = model.prefill(params, toks, l + M1_STEPS)
        (got_state, got_logits), counts = win.run(
            lambda: mm.prefill(pm, toks, l + M1_STEPS))
    scans = counts["mamba_scan"]
    per_step_launches([scans], cfg.n_layers if cuda else 0,
                      f"m4 {cfg.name} prefill", "mamba_scan")
    if counts["flash_decode"]:
        fail(f"m4 {cfg.name}: the prefill launched flash_decode")
    rt = ref_logits.argmax(-1, keepdim=True)
    mesh_decode_verdict(world, ref_logits, got_logits, rt,
                        got_logits.argmax(-1, keepdim=True),
                        f"m4 {cfg.name} prefill")
    state_verdict(world, ref_state, got_state, f"m4 {cfg.name} prefill")
    per = _m4_decode(win, world, model, params, mm, pm, mesh, ref_state,
                     rt, f"m4 {cfg.name}")
    per_step_launches(per, 0, f"m4 {cfg.name}")
    out["ssm"] = dict(arch=cfg.name, layers=cfg.n_layers, prefill=[b, l],
                      mamba_scan_per_prefill=scans,
                      flash_decode_per_step=per,
                      seconds=time.perf_counter() - t1)
    del model, params, mm, pm, ref_state, got_state

    # hybrid: zamba2-2.7b at full depth
    t1 = time.perf_counter()
    cfg = lm_config(M4_HYBRID_ARCH)
    model, params, mm, pm = _m4_model(cfg, dev, 814, mesh)
    state = _random_state(cfg, M4_BATCH, M4_CACHE, dev, 815, lens)
    state["ssm_h"].mul_(0.2)
    tok = torch.randint(0, cfg.vocab, (M4_BATCH, 1), generator=g,
                        device=dev)
    per = _m4_decode(win, world, model, params, mm, pm, mesh, state, tok,
                     f"m4 {cfg.name}")
    per_step_launches(per, kernel_attn_per_step(cfg) if cuda else 0,
                      f"m4 {cfg.name}")
    out["hybrid"] = dict(arch=cfg.name, layers=cfg.n_layers,
                         flash_decode_per_step=per,
                         seconds=time.perf_counter() - t1)
    del model, params, mm, pm, state
    dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["bit_equal"] = world == 1
    out["seconds"] = time.perf_counter() - t0
    log(f"[m4] world {world}, mesh (1, 1) (data, model), against the "
        f"unsharded route, logits, tokens and states bit-equal: "
        f"{world == 1}; {out['moe']['arch']} {out['moe']['layers']} "
        f"layers, {M1_STEPS} decode steps of {M4_BATCH} rows over "
        f"{M4_CACHE} positions, flash_decode "
        f"{out['moe']['flash_decode_per_step']} a step "
        f"({out['moe']['seconds']:.1f} s); {out['ssm']['arch']} "
        f"{out['ssm']['layers']} layers, a {b} x {l} prefill with "
        f"mamba_scan {scans} times, then {M1_STEPS} decode steps "
        f"({out['ssm']['seconds']:.1f} s); {out['hybrid']['arch']} "
        f"{out['hybrid']['layers']} layers, flash_decode "
        f"{out['hybrid']['flash_decode_per_step']} a step "
        f"({out['hybrid']['seconds']:.1f} s); {out['seconds']:.1f} s; "
        f"{card}")
    return out


def _fit_batch(arch, shape_name, cfg, mesh):
    """(artifact, note): the mesh dry run at the JAX per-card batch, or,
    where it says the rank does not fit, at the largest power of two
    below that does."""
    from repro_torch.launch.dryrun import dryrun_cell

    art = dryrun_cell(arch, shape_name, cfg=cfg, mesh=mesh, save=False)
    note = None
    b = art["batch"]
    while not art["fits"] and b > 1:
        b //= 2
        art = dryrun_cell(arch, shape_name, batch=b, cfg=cfg, mesh=mesh,
                          save=False)
        note = (f"the JAX per-card batch does not fit the dry run's "
                f"80 GB; batch {b} a card")
    return art, note


def _m5_run(win, tag, mm, step, cuda, kernel, expect):
    """``M5_STEPS`` steps of ``step`` in launch windows: the peak above
    the arguments' base, ms between CUDA events, device ms under the
    profiler, counted collective bytes."""
    from repro_torch.dist import tensor_parallel as tp

    per, ms, coll = [], [], []
    for _ in range(M5_STEPS):
        tp.collective_counts(reset=True)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        _out, counts = win.run(step)
        if cuda:
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        per.append(counts[kernel])
        coll.append(tp.collective_counts()["total"])
        del _out
    per_step_launches(per, expect if cuda else 0, tag, kernel)
    dev_ms = None   # not measured off the card
    if cuda:
        prof, _wall = profile_call(step)
        if prof is not None:
            dev_ms = device_ms(prof.profiler.kineto_results.events())
    return per, ms, coll, dev_ms


def _m5_row(tag, art, note, peak, per, ms, coll, dev_ms, kernel, err,
            kern_ms, t0, card):
    dry = art["collective_bytes"]["total"]
    collective_verdict(tag, coll[-1], dry)
    pred = art["counts"]["peak_bytes"]
    ratio = None   # not measured off the card
    if peak is not None:
        ratio = mesh_peak_verdict(tag, peak, pred)
    row = dict(mesh=list(art["mesh"].values()), batch=art["batch"],
               note=note, head_split=art["head_split"],
               experts_split=art["experts_split"],
               ssm_split=art["ssm_split"], rows_split=art["rows_split"],
               peak_measured_gb=peak and peak / 1e9,
               peak_predicted_gb=pred / 1e9, peak_ratio=ratio, step_ms=ms,
               device_ms=dev_ms, per_step={kernel: per},
               kernel_max_abs_err=err, kernel_ms=kern_ms,
               collective_bytes_per_step=coll[-1],
               collective_bytes_dry_run=dry,
               collective_bytes_by_kind={
                   k: v for k, v in art["collective_bytes"].items()
                   if not k.startswith("n_") and "@" not in k},
               seconds=time.perf_counter() - t0)
    log(f"[{tag}] rank 0 (fake process group: collectives stubbed, "
        f"counted not timed): batch {row['batch']} a card"
        f"{' (' + note + ')' if note else ''}; peak {row['peak_measured_gb']}"
        f" GB against the mesh dry run's {row['peak_predicted_gb']:.3f} "
        f"({ratio}); step ms (CUDA events) {[round(x, 3) for x in ms]}, "
        f"device ms {dev_ms}; {kernel} {per} a step, {kern_ms} ms at the "
        f"rank's shape (max |d| vs plain {err}); collective bytes a step "
        f"{coll[-1]:.6g} (dry run {dry:.6g}; by kind "
        f"{row['collective_bytes_by_kind']}); {row['seconds']:.1f} s; "
        f"{card}")
    return row


def _m5_base(cuda):
    gc.collect()
    if not cuda:
        return 0
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return base


def mesh_m5(win, card):
    """m5: one rank under a fake process group of its mesh's size (every
    collective returns at once, moving nothing: communication is
    counted, not timed), only its blocks on the card, against the mesh
    dry run of the same step: arctic-480b's ``decode_32k`` on (16, 16)
    (its share of the 953 GB model, the rank's rows' whole cache: 8 kv
    heads do not split 16 ways) and falcon-mamba-7b's ``prefill_32k`` at
    ``LM_DEPTH`` layers on (16, k), k in ``M5_SSM_MODELS`` (``d_inner``
    8192/k a rank).  The peak within ``M2_PEAK_BOUND`` of the dry run's,
    the counted collective bytes of a step equal to its (all-to-all
    included), and the kernel at the rank's shape against its plain
    version: ``flash_decode`` at the rank's heads, ``mamba_scan`` at its
    channels over the first ``M5_SCAN_LEN`` positions."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models.model import build_model

    dev = lm_device()
    cuda = dev.type == "cuda"
    rows = []

    # arctic-480b decode_32k on (16, 16)
    t0 = time.perf_counter()
    arch, shape_name, mshape = M5_MOE
    cfg = lm_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_mesh_shape(mshape, ("data", "model"), dev.type, fake=True)
    art, note = _fit_batch(arch, shape_name, cfg, mesh)
    mm = build_model(cfg, device=dev, mesh=mesh)
    base = _m5_base(cuda)
    params = _rank_params(cfg, mm.plan, dev, 950)
    dp = mshape[0]
    state = mm.init_decode_state(art["batch"] * dp, shape.seq_len)
    state["cache_len"].fill_(shape.seq_len - 1)
    b = state["cache_len"].shape[0]
    tokens = torch.zeros((b, 1), dtype=torch.long, device=dev)

    def step():
        with torch.no_grad():
            return mm.decode_step(params, state, tokens)[0]

    per, ms, coll, dev_ms = _m5_run(win, "m5 arctic", mm, step, cuda,
                                    "flash_decode",
                                    kernel_attn_per_step(cfg))
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    kc, vc = state["k_cache"][0], state["v_cache"][0]
    kc.normal_(generator=torch.Generator(device=dev).manual_seed(951))
    vc.normal_(generator=torch.Generator(device=dev).manual_seed(952))
    kvh = kc.shape[2]
    q = torch.randn((b, kvh * cfg.attn.n_heads // cfg.attn.kv_heads,
                     cfg.attn.head_dim), device=dev)
    kl = state["cache_len"]
    err = kernel_verdict("m5 arctic", "flash_decode",
                         ops.flash_decode(q, kc, vc, kl),
                         fdk.flash_decode_plain(q, kc, vc, kl), FD_TOL)
    kern_ms = (time_ms(lambda: ops.flash_decode(q, kc, vc, kl), 5)
               if cuda else None)
    ops.reset_launch_counts()   # the comparison's launches: not main path
    del params, state, kc, vc, q
    dist.destroy_process_group()
    rows.append(_m5_row(f"m5 {arch} {shape_name} {mshape}", art, note,
                        peak, per, ms, coll, dev_ms, "flash_decode", err,
                        kern_ms, t0, card))

    # falcon-mamba-7b prefill_32k at LM_DEPTH layers on (16, k)
    base_cfg = lm_config(LM_ARCH)
    cfg = dataclasses.replace(base_cfg,
                              n_layers=min(LM_DEPTH, base_cfg.n_layers))
    for k in M5_SSM_MODELS:
        rows.append(_falcon_prefill_rank(win, cfg, (16, k), "m5", 960 + k,
                                         card))
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rows


def _falcon_prefill_rank(win, cfg, mshape, tag, seed, card):
    """m5's and m9's leg: rank 0 of ``mshape`` under a fake process
    group, falcon-mamba-7b ``prefill_32k`` at ``cfg``'s depth through
    the scan kernel, against its mesh dry run; ``mamba_scan`` at the
    rank's shape (its ``d_inner`` block of every row, or under
    ``batch_tp`` its block of the rows on every channel) against plain
    over the first ``M5_SCAN_LEN`` positions."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.kernels import mamba_scan as msk
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models.model import build_model

    dev = lm_device()
    cuda = dev.type == "cuda"
    shape = SHAPES["prefill_32k"]
    t0 = time.perf_counter()
    k = mshape[1]
    what = f"{tag} falcon k={k}"
    mesh = make_mesh_shape(mshape, ("data", "model"), dev.type, fake=True)
    art, note = _fit_batch(LM_ARCH, "prefill_32k", cfg, mesh)
    run_cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, use_scan_kernel=True))     # as the dry run's cell
    mm = build_model(run_cfg, device=dev, mesh=mesh)
    base = _m5_base(cuda)
    params = _rank_params(run_cfg, mm.plan, dev, seed)
    tokens = torch.zeros((art["batch"], shape.seq_len),
                         dtype=torch.long, device=dev)

    def step():
        with torch.no_grad():
            return mm.prefill(params, tokens, shape.seq_len + 1)[1]

    per, ms, coll, dev_ms = _m5_run(win, what, mm, step, cuda,
                                    "mamba_scan", cfg.n_layers)
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    di = cfg.ssm.expand * cfg.d_model
    b = art["batch"]
    if mm.plan.rows:
        b //= k
    else:
        di //= k
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    shp = (b, M5_SCAN_LEN)
    dt = torch.nn.functional.softplus(
        torch.randn(shp + (di,), generator=g, device=dev) - 1.0)
    xi = torch.randn(shp + (di,), generator=g, device=dev)
    bb = torch.randn(shp + (cfg.ssm.state_dim,), generator=g, device=dev)
    cc = torch.randn(shp + (cfg.ssm.state_dim,), generator=g, device=dev)
    a_log = params["layers"]["ssm"]["A_log"][0].float().contiguous()
    if tuple(a_log.shape) != (di, cfg.ssm.state_dim):
        fail(f"{what}: the rank's A_log block is {tuple(a_log.shape)}, not "
             f"({di}, {cfg.ssm.state_dim})")
    err = kernel_verdict(what, "mamba_scan",
                         ops.mamba_scan(dt, xi, bb, cc, a_log),
                         msk.mamba_scan_plain(dt, xi, bb, cc, a_log),
                         SCAN_TOL)
    kern_ms = (time_ms(lambda: ops.mamba_scan(dt, xi, bb, cc, a_log), 3)
               if cuda else None)
    ops.reset_launch_counts()   # the comparison's launches: not main path
    del params, tokens, dt, xi, bb, cc
    dist.destroy_process_group()
    row = _m5_row(f"{tag} {LM_ARCH} prefill_32k {mshape}", art, note, peak,
                  per, ms, coll, dev_ms, "mamba_scan", err, kern_ms, t0,
                  card)
    row["scan_shape"] = [b, M5_SCAN_LEN, di]
    return row


def mesh_m6(card):
    """m6: ``launch.train --mesh 1x1:data,model --elastic-demo`` on
    granite-moe-1b-a400m at full width and ``M6_LAYERS`` layers and the
    same launch without a mesh: the losses agree within ``RESTART_TOL``.
    On the (1, 1) mesh the MoE block runs unsplit (no expert split, one
    data rank), so m6 checks the mesh trainer's placement, checkpoint
    and re-mesh around it, not expert parallelism."""
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    args = ["--arch", M6_ARCH, "--layers", str(M6_LAYERS), "--steps",
            str(M3_STEPS), "--seq", str(M3_SEQ), "--batch", str(M3_BATCH),
            "--device", lm_device().type]
    plain = launch_train.main(args)
    meshed = launch_train.main(args + ["--mesh", "1x1:data,model",
                                       "--elastic-demo"])
    if dist.is_initialized():
        dist.destroy_process_group()
    a = [m["loss"] for m in plain.metrics_log]
    b = [m["loss"] for m in meshed.metrics_log]
    rel = loss_verdict("m6", a, b, M3_STEPS, RESTART_TOL)
    log(f"[m6] {M6_ARCH} at full width, {M6_LAYERS} layers, {M3_BATCH} x "
        f"{M3_SEQ}: launch.train losses {a}; --mesh 1x1:data,model "
        f"--elastic-demo {b}; max rel diff {rel} (bound {RESTART_TOL}); "
        f"{time.perf_counter() - t0:.1f} s; {card}")
    del plain, meshed
    return dict(losses=a, mesh_losses=b, max_rel=rel,
                seconds=time.perf_counter() - t0)

def mesh_m7(win, card):
    """m7: the vlm and encdec families on the launched (1, 1) mesh
    against the unsharded route, at their published widths and depths
    (``M7_DEPTH``): a prefill of ``FAM_EXTRA_BATCH`` prompts of
    ``FAM_EXTRA_PROMPT`` tokens with stub ``patches``/``frames`` (bf16,
    as phase 6m's), then ``M1_STEPS`` decode steps.  Logits, tokens and
    every state leaf (the cross caches among them) bit-equal; launch
    windows exact: no ``flash_decode`` in a prefill, one per attention
    a step (48 for each model: llama-3.2-vision-11b's 40 self and 8
    cross, whisper-medium's 24 and 24).  A (1, 1) mesh splits nothing:
    m7 holds the placement and the plan's dispatch of the cross
    attentions, not the sharded numerics (``tests/
    test_torch_mesh_vlm_encdec.py``; m8 runs the sharded code under a
    fake group)."""
    import torch.distributed as dist

    dev = lm_device()
    cuda = dev.type == "cuda"
    out = {}
    g = torch.Generator(device=dev).manual_seed(820)
    for i, (arch, depth) in enumerate(M7_DEPTH.items()):
        t0 = time.perf_counter()
        mesh, world = _mesh_11(dev)
        base = lm_config(arch)
        cfg = base if depth is None else dataclasses.replace(
            base, n_layers=depth)
        model, params, mm, pm = _m4_model(cfg, dev, 821 + i, mesh)
        init_s = time.perf_counter() - t0
        b, l = FAM_EXTRA_BATCH, FAM_EXTRA_PROMPT
        extra = extra_inputs(cfg, b, g, dev)
        stub = next(iter(extra))
        toks = torch.randint(0, cfg.vocab, (b, l), generator=g, device=dev)
        max_len = l + M1_STEPS
        with torch.no_grad():
            ref_state, ref_logits = model.prefill(params, toks, max_len,
                                                  extra)
            (got_state, got_logits), counts = win.run(
                lambda: mm.prefill(pm, toks, max_len, extra))
        per_step_launches([counts["flash_decode"]], 0,
                          f"m7 {arch} prefill")
        rt = ref_logits.argmax(-1, keepdim=True)
        mesh_decode_verdict(world, ref_logits, got_logits, rt,
                            got_logits.argmax(-1, keepdim=True),
                            f"m7 {arch} prefill")
        state_verdict(world, ref_state, got_state, f"m7 {arch} prefill")
        expect = kernel_attn_per_step(cfg) if cuda else 0
        with torch.no_grad():
            per = _m4_decode(win, world, model, params, mm, pm, mesh,
                             ref_state, rt, f"m7 {arch}")
        per_step_launches(per, expect, f"m7 {arch}")
        del model, params, mm, pm, ref_state, got_state, extra
        dist.destroy_process_group()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        out[arch] = dict(layers=cfg.n_layers, depth_published=base.n_layers,
                         world=world, bit_equal=world == 1,
                         prefill=[b, l], flash_decode_per_prefill=0,
                         flash_decode_per_step=per, init_s=init_s,
                         seconds=time.perf_counter() - t0)
        log(f"[m7] {arch} ({cfg.family}), {cfg.n_layers} of "
            f"{base.n_layers} layers, on the (1, 1) mesh (world {world}) "
            f"against the unsharded route: a {b} x {l} prefill with stub "
            f"{stub}, then "
            f"{M1_STEPS} decode steps; logits, tokens and state bit-equal: "
            f"{world == 1}; flash_decode 0 in the prefill, {per} a step; "
            f"init {init_s:.1f} s; {out[arch]['seconds']:.1f} s; {card}")
    return out


def _decode_kernel_row(tag, what, q, kc, vc, kl, flush_buf, cuda):
    """``flash_decode`` at a rank's decode shape against its plain
    version (``FD_TOL``), and on the card timed as phase 7 times it
    (median of 16 launches after an L2 flush, warm beside it), its
    bound from the work function and SDPA over the same cache."""
    from repro_torch.kernels import flash_decode as fdk
    from repro_torch.kernels import ops

    err = kernel_verdict(f"{tag} {what}", "flash_decode",
                         ops.flash_decode(q, kc, vc, kl),
                         fdk.flash_decode_plain(q, kc, vc, kl), FD_TOL)
    b, s, kh, d = kc.shape
    h = q.shape[1]
    row = dict(what=what, shape=[b, h, kh, d, s], max_abs_err=err,
               ms=None, ms_warm_l2=None, bound_ms=None, library_ms=None)
    if cuda:
        lens = kl.cpu().numpy()
        _rows, _bytes, bound = decode_bound(fdk, kc, lens, b, h)
        cold, warm, _host = timed_launches(
            [lambda: ops.flash_decode(q, kc, vc, kl)] * 16, flush_buf)
        _lib, lib_cold = sdpa_ms(q, kc, vc, kl, flush_buf)
        row.update(ms=statistics.median(cold),
                   ms_warm_l2=statistics.median(warm), bound_ms=bound,
                   library_ms=lib_cold)
    ops.reset_launch_counts()   # the comparison's launches: not main path
    log(f"[{tag}] flash_decode {what} at the rank's shape (B {b}, S {s}, "
        f"{h}/{kh} heads of {d}): max |d| vs plain {err}; {row['ms']} ms "
        f"cold L2 ({row['ms_warm_l2']} warm), bound {row['bound_ms']} ms, "
        f"SDPA {row['library_ms']} ms cold L2")
    return row


def mesh_m8(win, card):
    """m8: rank 0 of (16, 16) ``decode_32k`` for llama-3.2-vision-11b
    and whisper-medium at the mesh dry run's rows a rank (8) under a
    fake process group (collectives counted, not timed), only its
    blocks, its rows' caches and its rows of the f32 stub inputs on the
    card, as m5: the peak within ``M2_PEAK_BOUND`` of the dry run's,
    the collective bytes a step equal to its, ``M5_STEPS`` steps of 48
    ``flash_decode`` launches each, and the kernel
    at the rank's heads (llama: all 32/8, since 8 kv heads do not split
    16 ways; whisper: its 1/1 of 64) over the self cache and the cross
    cache against plain, timed beside its bound and SDPA."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.launch.mesh import make_mesh_shape
    from repro_torch.models.model import build_model

    dev = lm_device()
    cuda = dev.type == "cuda"
    shape = SHAPES["decode_32k"]
    rows = []
    for i, arch in enumerate(M8_ARCHS):
        t0 = time.perf_counter()
        cfg = lm_config(arch)
        mesh = make_mesh_shape(M8_MESH, ("data", "model"), dev.type,
                               fake=True)
        art, note = _fit_batch(arch, "decode_32k", cfg, mesh)
        mm = build_model(cfg, device=dev, mesh=mesh)
        base = _m5_base(cuda)
        params = _rank_params(cfg, mm.plan, dev, 980 + i)
        state = mm.init_decode_state(art["batch"] * M8_MESH[0],
                                     shape.seq_len)
        state["cache_len"].fill_(shape.seq_len - 1)
        b = state["cache_len"].shape[0]
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        name, n = (("patches", cfg.n_patches) if cfg.family == "vlm"
                   else ("frames", cfg.enc_seq))
        # the step's stub input, held as the dry run's step holds it
        extra = {name: torch.zeros((b, n, cfg.d_model), device=dev)}

        def step():
            with torch.no_grad():
                return mm.decode_step(params, state, tokens, extra)[0]

        per, ms, coll, dev_ms = _m5_run(win, f"m8 {arch}", mm, step, cuda,
                                        "flash_decode",
                                        kernel_attn_per_step(cfg))
        peak = torch.cuda.max_memory_allocated() - base if cuda else None
        flush = (torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
                 if cuda else None)
        a = cfg.attn
        kern = []
        for j, (what, kk, vk, kl) in enumerate((
                ("self", "k_cache", "v_cache", state["cache_len"]),
                ("cross", "cross_k", "cross_v",
                 torch.full_like(state["cache_len"], n)))):
            kc, vc = state[kk][0], state[vk][0]
            gen = torch.Generator(device=dev).manual_seed(990 + 4 * i + j)
            kc.normal_(generator=gen)
            vc.normal_(generator=gen)
            kvh = kc.shape[2]
            q = torch.randn((b, kvh * a.n_heads // a.kv_heads, a.head_dim),
                            generator=gen, device=dev) / a.head_dim ** 0.5
            kern.append(_decode_kernel_row("m8", f"{arch} {what}", q, kc,
                                           vc, kl, flush, cuda))
        err = max(r["max_abs_err"] for r in kern)
        del params, state, extra, flush
        dist.destroy_process_group()
        row = _m5_row(f"m8 {arch} decode_32k {M8_MESH}", art, note, peak,
                      per, ms, coll, dev_ms, "flash_decode", err,
                      kern[0]["ms"], t0, card)
        row["flash_decode_shapes"] = kern
        rows.append(row)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return rows


def mesh_m9(win, card):
    """m9: m5's falcon-mamba-7b leg (``prefill_32k`` at ``LM_DEPTH``
    layers) under ``SSMConfig.batch_tp`` on ``M9_MESH``: the Mamba rows
    over ``model`` (a data rank's 2 rows, one a rank), ``d_inner``
    whole; ``mamba_scan`` at the rank's row on all 8,192 channels
    against plain."""
    base = lm_config(LM_ARCH)
    cfg = dataclasses.replace(base, n_layers=min(LM_DEPTH, base.n_layers),
                              ssm=dataclasses.replace(base.ssm,
                                                      batch_tp=True))
    row = _falcon_prefill_rank(win, cfg, M9_MESH, "m9", 995, card)
    if not row["rows_split"]:
        fail("m9: batch_tp did not put the Mamba rows over model")
    gc.collect()
    if lm_device().type == "cuda":
        torch.cuda.empty_cache()
    return row


class StubTokens:
    """``SyntheticTokens`` whose every batch also carries the stub
    frontend's input (vlm ``patches`` or encdec ``frames``, f32, one
    seeded draw held for every step): the trainer cuts it with the
    tokens."""

    def __init__(self, cfg, data, seed):
        self.data = data
        name, n = (("patches", cfg.n_patches) if cfg.family == "vlm"
                   else ("frames", cfg.enc_seq))
        rng = np.random.default_rng(seed)
        self.extra = {name: (rng.standard_normal(
            (data.local_batch, n, cfg.d_model), dtype=np.float32) * 0.5)}

    def state_dict(self):
        return self.data.state_dict()

    def load_state_dict(self, st):
        self.data.load_state_dict(st)

    def next_batch(self):
        import types

        b = self.data.next_batch()
        return types.SimpleNamespace(tokens=b.tokens, targets=b.targets,
                                     step=b.step, **self.extra)


def _m10_losses(cfg, dev, mesh):
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainConfig(optimizer=AdamWConfig(lr=1e-4),
                       schedule=ScheduleConfig(peak_lr=1e-4, warmup_steps=1,
                                               total_steps=M3_STEPS))
    data = StubTokens(cfg, SyntheticTokens(vocab=cfg.vocab, seq=M10_SEQ,
                                           local_batch=M10_BATCH), 1010)
    t = Trainer(build_model(cfg, device=dev), TrainerConfig(train=tcfg),
                data, mesh=mesh)
    t.run(M3_STEPS)
    return [m["loss"] for m in t.metrics_log]


def mesh_m10(card):
    """m10: a ``Trainer`` on the launched (1, 1) mesh against the
    unsharded one, each family at full width and ``M10_LAYERS`` layers,
    ``M3_STEPS`` steps of ``M10_BATCH`` x ``M10_SEQ`` whose batches
    carry their stub inputs: the losses within ``RESTART_TOL``."""
    import torch.distributed as dist

    dev = lm_device()
    out = {}
    for arch, layers in M10_LAYERS.items():
        t0 = time.perf_counter()
        base = lm_config(arch)
        cfg = dataclasses.replace(base, n_layers=layers, n_enc_layers=min(
            base.n_enc_layers, layers))
        plain = _m10_losses(cfg, dev, None)
        mesh, world = _mesh_11(dev)
        meshed = _m10_losses(cfg, dev, mesh)
        dist.destroy_process_group()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rel = loss_verdict(f"m10 {arch}", plain, meshed, M3_STEPS,
                           RESTART_TOL)
        out[arch] = dict(layers=cfg.n_layers, losses=plain,
                         mesh_losses=meshed, max_rel=rel,
                         seconds=time.perf_counter() - t0)
        log(f"[m10] {arch} at full width, {cfg.n_layers} layers"
            f"{f' + {cfg.n_enc_layers} encoder' if cfg.n_enc_layers else ''}"
            f", {M10_BATCH} x {M10_SEQ} with stub inputs: Trainer losses "
            f"{plain}; on the (1, 1) mesh {meshed}; max rel diff {rel} "
            f"(bound {RESTART_TOL}); {out[arch]['seconds']:.1f} s; {card}")
    return out


def mesh_phase(win, lm, served, card):
    """Phase m's dense legs m1, m2 and m3, on 6d's model (m4-m6 run
    after 6d has freed it: ``mesh_families_phase``)."""
    t0 = time.perf_counter()
    out = {"m1": mesh_m1(win, lm, served, card)}
    out["m2"] = mesh_m2(win, card)
    out["m3"] = mesh_m3(card)
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_families_phase(win, card, out):
    """Phase m's moe, ssm and hybrid legs m4, m5 and m6 after ``out``
    (``mesh_phase``'s), the whole phase within ``MESH_BUDGET_S``; then
    m7-m10 (``mesh_families2_phase``)."""
    t0 = time.perf_counter()
    out["m4"] = mesh_m4(win, card)
    out["m5"] = mesh_m5(win, card)
    out["m6"] = mesh_m6(card)
    out["seconds_m4_m6"] = time.perf_counter() - t0
    out["seconds"] += out["seconds_m4_m6"]
    legs = {key: out[key]["seconds"] if isinstance(out[key], dict)
            else sum(r["seconds"] for r in out[key])
            for key in ("m1", "m2", "m3", "m4", "m5", "m6")}
    log(f"[m] phase m {out['seconds']:.1f} s (budget {MESH_BUDGET_S} s; "
        + ", ".join(f"{key} {v:.1f}" for key, v in legs.items())
        + f"; m4-m6 {out['seconds_m4_m6']:.1f}); {card}")
    log("[m] summary " + json.dumps(out, default=str))
    budget_verdict("phase m", out["seconds"], MESH_BUDGET_S)
    mesh_families2_phase(win, card, out)
    return out


def mesh_families2_phase(win, card, out):
    """Phase m's vlm, encdec and ``batch_tp`` legs m7-m10, within their
    own ``MESH2_BUDGET_S``."""
    t0 = time.perf_counter()
    out["m7"] = mesh_m7(win, card)
    out["m8"] = mesh_m8(win, card)
    out["m9"] = mesh_m9(win, card)
    out["m10"] = mesh_m10(card)
    out["seconds_m7_m10"] = secs = time.perf_counter() - t0
    legs = {"m7": sum(v["seconds"] for v in out["m7"].values()),
            "m8": sum(r["seconds"] for r in out["m8"]),
            "m9": out["m9"]["seconds"],
            "m10": sum(v["seconds"] for v in out["m10"].values())}
    log(f"[m] m7-m10 {secs:.1f} s (budget {MESH2_BUDGET_S} s; "
        + ", ".join(f"{key} {v:.1f}" for key, v in legs.items())
        + f"); {card}")
    log("[m] m7-m10 summary " + json.dumps(
        {key: out[key] for key in ("m7", "m8", "m9", "m10")}, default=str))
    budget_verdict("m7-m10", secs, MESH2_BUDGET_S)
    return out


def family_prompts(cfg, rng):
    lens = rng.integers(FAM_PROMPT[0], FAM_PROMPT[1] + 1, FAM_REQUESTS)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]


def extra_inputs(cfg, b, g, dev):
    """vlm ``patches`` or encdec ``frames`` (stub frontends), bf16."""
    if cfg.family == "vlm":
        name, n = "patches", cfg.n_patches
    elif cfg.family == "encdec":
        name, n = "frames", cfg.enc_seq
    else:
        return None
    return {name: (torch.randn((b, n, cfg.d_model), generator=g, device=dev)
                   * 0.5).to(torch.bfloat16)}


def drive_with_extra(win, ops, model, params, extra, rng, max_len):
    """vlm / encdec: one prefill of ``FAM_EXTRA_BATCH`` prompts with their
    stub inputs, then ``FAM_NEW`` greedy decode steps, as
    ``tests/test_models_smoke.py`` drives them, in one counted window."""
    cfg = model.cfg
    dev = model.device
    toks = torch.as_tensor(rng.integers(
        0, cfg.vocab, (FAM_EXTRA_BATCH, FAM_EXTRA_PROMPT)), device=dev)
    calls = {"prefill": [], "decode": []}
    times = {"prefill": [], "decode": []}

    def step(kind, fn):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = fn()
        logits = out[1] if kind == "prefill" else out[0]
        if not bool(torch.isfinite(logits).all()):
            fail(f"{cfg.name}: non-finite {kind} logits")
        times[kind].append(time.perf_counter() - t)
        after = ops.launch_counts()
        calls[kind].append({key: after[key] - before[key] for key in after})
        return out

    def drive():
        state, logits = step("prefill", lambda: model.prefill(
            params, toks, max_len, extra))
        for _ in range(FAM_NEW):
            tok = torch.argmax(logits, -1)[:, None]
            logits, state = step("decode", lambda: model.decode_step(
                params, state, tok, extra))
        return state

    state, counts = win.run(drive)
    if state["cache_len"].tolist() != [FAM_EXTRA_PROMPT + FAM_NEW] \
            * FAM_EXTRA_BATCH:
        fail(f"{cfg.name}: cache_len {state['cache_len'].tolist()}")
    met = dict(prompt_tokens=FAM_EXTRA_BATCH * FAM_EXTRA_PROMPT,
               new_tokens=FAM_EXTRA_BATCH * FAM_NEW, decode_steps=FAM_NEW,
               prefill_tokens_per_s=FAM_EXTRA_BATCH * FAM_EXTRA_PROMPT
               / times["prefill"][0],
               prefill_ms=times["prefill"][0] * 1e3,
               decode_step_ms_median=statistics.median(times["decode"]) * 1e3,
               decode_step_ms_max=max(times["decode"]) * 1e3)
    return met, counts, calls


def families_phase(win, seed, card):
    """Phase 6m: every architecture but qwen3-14b and falcon-mamba-7b at
    its published widths, its depth cut as ``FAMILY_DEPTH`` says, random
    bf16 weights on the card, one at a time (each freed before the next):
    the text families serve ``FAM_REQUESTS`` requests through the batcher,
    vlm and encdec run a prefill and decode steps with their stub inputs;
    finite logits, the token counts, and ``flash_decode`` launched as many
    times a decode step as the step has attentions on the kernel route
    (gemma2-9b: none, its softcap and local windows take the plain
    route), never in a prefill."""
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    dev = lm_device()
    out = {}
    for i, (arch, depth) in enumerate(FAMILY_DEPTH.items()):
        t0 = time.perf_counter()
        base = lm_config(arch)
        cfg = base if depth is None else dataclasses.replace(base,
                                                             n_layers=depth)
        reset_peak(dev)
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + i))
        sync(dev)
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in leaves(params))
        rng = np.random.default_rng(seed + 800 + i)
        # counters move for CUDA launches only (none in a CPU rehearsal)
        expect = kernel_attn_per_step(cfg) if dev.type == "cuda" else 0
        g = torch.Generator(device=dev).manual_seed(seed + 900 + i)
        extra = extra_inputs(cfg, FAM_EXTRA_BATCH, g, dev)
        if extra is None:
            max_len = FAM_PROMPT[1] + FAM_NEW
            reqs, met, counts, calls, _b = serve_requests(
                win, ops, model, params, family_prompts(cfg, rng), FAM_NEW,
                FAM_REQUESTS, max_len)
        else:
            max_len = FAM_EXTRA_PROMPT + FAM_NEW
            met, counts, calls = drive_with_extra(win, ops, model, params,
                                                  extra, rng, max_len)
        per = {"decode": per_call_launches(calls, "decode", expect, arch),
               "prefill": per_call_launches(calls, "prefill", 0, arch)}
        if counts["mamba_scan"]:
            fail(f"{arch}: mamba_scan launched (no Mamba1 layer)")
        met = dict(layers=cfg.n_layers, depth_published=base.n_layers,
                   init_s=init_s, params=n_params, **met,
                   flash_decode_per_step=expect, peak_gib=peak_gib(dev))
        met["seconds"] = time.perf_counter() - t0
        log(f"[families] {arch} ({cfg.family}): {cfg.n_layers} of "
            f"{base.n_layers} layers{'' if cfg.family != 'encdec' else f' + {cfg.n_enc_layers} encoder'}, "
            f"d_model {cfg.d_model}; {n_params} parameters drawn in "
            f"{init_s:.2f} s; prefill {met['prefill_tokens_per_s']:.0f} "
            f"tokens/s; decode step ms median "
            f"{met['decode_step_ms_median']:.2f} max "
            f"{met['decode_step_ms_max']:.2f}; flash_decode per call {per} "
            f"(expected {expect} a step); peak {met['peak_gib']} GiB; "
            f"{met['seconds']:.1f} s")
        out[arch] = met
        del model, params, extra
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"[families] phase 6m {secs:.1f} s ({card})")
    return dict(archs=out, seconds=secs)


def decode_shapes():
    """(what, B, S, H, KH, D, lengths) of every family's decode
    attention on the kernel route as phases 6d and 6m run it: the
    self-attention caches (lengths ragged, S among them) and the vlm and
    encdec cross caches (every row at its full length)."""
    from repro_torch.configs import get_config

    out = []
    rng = np.random.default_rng(502)
    for arch in (DENSE_ARCH,) + tuple(FAMILY_DEPTH):
        cfg = get_config(arch)
        if not kernel_attn_per_step(cfg):
            continue
        a = cfg.attn
        if arch == DENSE_ARCH:
            b, s = LM_SLOTS, LM_PROMPT[1] + LM_NEW
        elif cfg.family in ("vlm", "encdec"):
            b, s = FAM_EXTRA_BATCH, FAM_EXTRA_PROMPT + FAM_NEW
        else:
            b, s = FAM_REQUESTS, FAM_PROMPT[1] + FAM_NEW
        lens = rng.integers(1, s + 1, b)
        lens[0] = s
        out.append((arch, b, s, a.n_heads, a.kv_heads, a.head_dim, lens))
        cross = {"vlm": cfg.n_patches, "encdec": cfg.enc_seq}.get(cfg.family)
        if cross:
            out.append((f"{arch} cross", b, cross, a.n_heads, a.kv_heads,
                        a.head_dim, np.full(b, cross)))
    return out


def decode_shape_checks(k, flush_buf, seed):
    """Phase 7: ``flash_decode`` against its plain version (``FD_TOL``) at
    every shape of ``decode_shapes``, bf16 caches; then timed beside SDPA
    (the yardstick only) at 6d's shape.  Returns the worst error and 6d's
    timings."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 503)
    err = 0.0
    timing = None
    for what, b, s, h, kh, d, lens in decode_shapes():
        q = torch.randn((b, h, d), generator=g, device=dev) / d ** 0.5
        kc = torch.randn((b, s, kh, d), generator=g, device=dev,
                         dtype=torch.bfloat16)
        vc = torch.randn((b, s, kh, d), generator=g, device=dev,
                         dtype=torch.bfloat16)
        kl = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        plan = k.device_plan(q, kc)
        ok_k = k.flash_decode(q, kc, vc, kl)
        ok_p = k.flash_decode_plain(q, kc, vc, kl)
        torch.cuda.synchronize()
        e = float((ok_k - ok_p).abs().max())
        good = bool(torch.allclose(ok_k, ok_p, rtol=FD_TOL, atol=FD_TOL))
        log(f"flash_decode vs plain, {what}: B {b}, S {s}, {h}/{kh} heads "
            f"of {d} (group {h // kh}), lengths {lens.tolist()}, plan "
            f"{plan._asdict()}: max |do| {e}, within {FD_TOL}: {good}")
        if not good or not bool(torch.isfinite(ok_k).all()):
            fail(f"flash_decode disagrees with its plain version ({what})")
        err = max(err, e)
        if what == DENSE_ARCH:
            rows, bytes_, bound = decode_bound(k, kc, lens, b, h)
            cold, warm, host = timed_launches(
                [lambda: k.flash_decode(q, kc, vc, kl)] * 16, flush_buf)
            lib, lib_cold = sdpa_ms(q, kc, vc, kl, flush_buf)
            plain_ms = time_ms(lambda: k.flash_decode_plain(q, kc, vc, kl),
                               1, 1)
            timing = dict(ms=statistics.median(cold), plain_ms=plain_ms,
                          ms_warm_l2=statistics.median(warm),
                          host_ms_per_call=host, library_ms=lib_cold,
                          library_ms_back_to_back=lib, bound_ms=bound,
                          positions=rows, shape=[b, h, kh, d, s],
                          plan=plan._asdict())
            log(f"flash_decode at 6d's shape (B {b}, S {s}, {h}/{kh} heads "
                f"of {d}): median {timing['ms']:.5f} ms cold L2, "
                f"{timing['ms_warm_l2']:.5f} warm; host issue {host:.5f} "
                f"ms/call; plain {plain_ms:.3f} ms; SDPA {lib:.5f} ms back "
                f"to back, {lib_cold:.5f} "
                f"ms cold L2; {rows} positions, {bytes_} B -> bound "
                f"{bound:.5f} ms; ms/bound {timing['ms'] / bound:.2f}")
        del q, kc, vc, ok_k, ok_p
    return err, timing


def sm_rates():
    """(FP32 issue slots, SFU results) per second: SMs x 128 and SMs x 16
    per clock, at the max SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_PER_SM_PER_CLOCK * hz, sms * SFU_PER_SM_PER_CLOCK * hz


def scan_row(caps, k, flush_buf):
    """Phase 7: mamba_scan against plain on layer 0's real inputs and on
    their first 1,000 positions, timed launch by launch over the captured
    layers, bounded by its bytes or its exponentials."""
    ragged = tuple(t[:, :1000].contiguous() if t.dim() == 3 else t
                   for t in caps[0])
    err = 0.0
    for what, args in (("layer 0", caps[0]), ("layer 0, L 1000", ragged)):
        yk = k.mamba_scan(*args)
        yp = k.mamba_scan_plain(*args)
        torch.cuda.synchronize()
        e = float((yk - yp).abs().max())
        same = float((yk == yp).float().mean())
        ok = bool(torch.allclose(yk, yp, rtol=SCAN_TOL, atol=SCAN_TOL))
        log(f"mamba_scan vs plain, {what} {tuple(args[0].shape)} N "
            f"{args[2].shape[2]}: max |dy| {e}, bit-equal share {same}, "
            f"within {SCAN_TOL}: {ok}")
        if not ok or not bool(torch.isfinite(yk).all()):
            fail(f"mamba_scan disagrees with its plain version ({what})")
        err = max(err, e)
    b, l, di = caps[0][0].shape
    n = caps[0][2].shape[2]
    # the kernel's work function: what the dry run counts on meta
    work = k.scan_work(b, l, di, n)
    bytes_, exps = work["bytes"], work["exps"]
    fp32, rate = sm_rates()
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = exps / rate * 1e3
    t_flops = work["flops_f32"] / (2 * fp32) * 1e3     # two FLOPs an FMA
    plan = k.scan_plan(b, l, di, n)
    log(f"mamba_scan plan at {(b, l, di, n)}: {plan._asdict()}")
    fns = [lambda a=a: k.mamba_scan(*a) for a in caps]
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.mamba_scan_plain(*caps[0]), 1, 1)
    bound = max(t_bytes, t_ops, t_flops)
    log(f"mamba_scan: median over {len(fns)} layers' inputs {ms:.5f} ms "
        f"cold L2 (min {min(cold):.5f}, max {max(cold):.5f}), {ms_warm:.5f} "
        f"ms warm L2; host issue {host:.5f} ms/call; plain {plain_ms:.3f} "
        f"ms; scan_work: bytes {bytes_} -> {t_bytes:.5f} ms, {exps} "
        f"exponentials at {rate:.4g}/s -> {t_ops:.5f} ms, "
        f"{work['flops_f32']} f32 FLOPs -> {t_flops:.5f} ms; ms/bound "
        f"{ms / bound:.1f}")
    return {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:67",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= bound else "operations",
        "library_ms": None, "ms_warm_l2": ms_warm, "host_ms_per_call": host,
        "bytes_ms": t_bytes, "exp_ms": t_ops, "flops_ms": t_flops,
        "sfu_per_s": rate,
        "shape": [b, l, di, n], "plan": plan._asdict()}


def flash_decode_inputs(seed):
    from repro_torch.configs import get_config

    a = get_config(FD_ATTN_ARCH).attn
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 500)
    q = torch.randn(FD_BATCH, a.n_heads, a.head_dim, generator=g,
                    device=dev) / a.head_dim ** 0.5
    kc = torch.randn(FD_BATCH, FD_SEQ, a.kv_heads, a.head_dim, generator=g,
                     device=dev, dtype=torch.bfloat16)
    vc = torch.randn(FD_BATCH, FD_SEQ, a.kv_heads, a.head_dim, generator=g,
                     device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(seed + 501)
    kv_len = rng.integers(1, FD_SEQ + 1, FD_BATCH)
    kv_len[:3] = (0, 1, FD_SEQ)
    return q, kc, vc, kv_len


def flash_decode_window(win, ops, q, kc, vc, kv_len):
    """Phase 6: ``ops.flash_decode`` through its entry point, one call per
    decode step with each row's length one longer (capped at S), in a
    counted window; each output finite, the empty row 0."""
    dev = q.device

    def drive():
        outs = []
        for step in range(FD_STEPS):
            kl = np.minimum(kv_len + step * (kv_len > 0), FD_SEQ)
            outs.append(ops.flash_decode(q, kc, vc, torch.as_tensor(
                kl, dtype=torch.int32, device=dev)))
        torch.cuda.synchronize()
        return outs

    outs, counts = win.run(drive)
    ok = all(bool(torch.isfinite(o).all()) and not o[0].any() for o in outs)
    log(f"[decode attention] ops.flash_decode over {FD_STEPS} steps, "
        f"{tuple(q.shape)} x cache {tuple(kc.shape)} bf16, lengths "
        f"{kv_len.tolist()}: finite with the empty row 0: {ok}; launches "
        f"{counts}")
    if not ok or counts["flash_decode"] != FD_STEPS:
        fail("flash_decode window: wrong outputs or launches")


def sdpa_ms(q, kc, vc, kl, flush_buf):
    """``scaled_dot_product_attention`` over the same cache (heads-major
    copies, a length mask): the library yardstick, timed only, never
    called by the port.  Returns the mean of 5 calls back to back (the
    host's issue time shows through when the call is short) and the
    median of 16 calls each alone after an L2 flush, timed as the
    kernels are (the figure to hold them against)."""
    import torch.nn.functional as F

    s = kc.shape[1]
    qs = q.to(kc.dtype)[:, :, None, :]
    ks, vs = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < kl[:, None].long()
            )[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              scale=1.0, enable_gqa=True)

    mean = time_ms(library, 5, 1)
    cold = statistics.median(launch_times_ms([library] * 16, flush_buf.zero_))
    return mean, cold


def decode_bound(k, kc, kv_len, b, h):
    """(positions, bytes, bound ms) from ``flash_decode``'s work function
    (what the dry run counts on meta) at these lengths: the K and V rows
    below kv_len read once, q and o in f32; the larger of its bytes over
    the card's rate and its f32 FLOPs and exponentials over theirs."""
    s, kh, d = kc.shape[1:]
    rows = int(np.minimum(kv_len, s).sum())
    work = k.decode_work(b, h, kh, s, d, kc.element_size(), rows)
    fp32, sfu = sm_rates()
    ms = max(work["bytes"] / HBM_BYTES_PER_S,
             work["flops_f32"] / (2 * fp32), work["exps"] / sfu) * 1e3
    return rows, work["bytes"], ms


def flash_decode_row(k, flush_buf, q, kc, vc, kv_len):
    """Phase 7: flash_decode against plain with the bf16 cache and an f32
    one, timed launch by launch, bounded by the K/V rows below kv_len
    plus q and o, beside SDPA (timed only); then the same at B 1 over the
    row of length S, where the split plan matters most."""
    dev = q.device
    kl = torch.as_tensor(kv_len, dtype=torch.int32, device=dev)
    b, s, kh, d = kc.shape
    h = q.shape[1]
    err = 0.0
    one = int(np.flatnonzero(kv_len == s)[0])      # the row of length S
    cases = (("bf16 cache", (q, kc, vc, kl)),
             ("f32 cache", (q[:FD_F32_BATCH].contiguous(),
                            kc[:FD_F32_BATCH].float(),
                            vc[:FD_F32_BATCH].float(), kl[:FD_F32_BATCH])),
             ("bf16 cache, B 1", (q[one:one + 1], kc[one:one + 1],
                                  vc[one:one + 1], kl[one:one + 1])))
    for what, args in cases:
        plan = k.device_plan(args[0], args[1])
        ok_k = k.flash_decode(*args, plan)
        ok_p = k.flash_decode_plain(*args, plan)
        torch.cuda.synchronize()
        e = float((ok_k - ok_p).abs().max())
        good = bool(torch.allclose(ok_k, ok_p, rtol=FD_TOL, atol=FD_TOL))
        lens = args[3].tolist()
        zero = all(not ok_k[i].any() and not ok_p[i].any()
                   for i, n in enumerate(lens) if n == 0)
        log(f"flash_decode vs plain, {what} {tuple(args[1].shape)}, "
            f"lengths {lens}, plan {plan._asdict()}: max |do| {e}, within "
            f"{FD_TOL}: {good} (plain's mean |o| "
            f"{float(ok_p.abs().mean())}); kv_len 0 rows zero in both: "
            f"{zero}")
        if not (good and zero):
            fail(f"flash_decode disagrees with its plain version ({what})")
        err = max(err, e)
        del ok_k, ok_p
    if kv_len[0] != 0:
        fail("flash_decode inputs lost their kv_len 0 row")
    plan = k.device_plan(q, kc)
    rows, bytes_, bound = decode_bound(k, kc, kv_len, b, h)
    fns = [lambda: k.flash_decode(q, kc, vc, kl)] * 16
    cold, warm, host = timed_launches(fns, flush_buf)
    ms, ms_warm = statistics.median(cold), statistics.median(warm)
    plain_ms = time_ms(lambda: k.flash_decode_plain(q, kc, vc, kl), 1, 1)
    lib_ms, lib_cold = sdpa_ms(q, kc, vc, kl, flush_buf)
    log(f"flash_decode: median over {len(fns)} launches {ms:.5f} ms cold L2 "
        f"(min {min(cold):.5f}, max {max(cold):.5f}), {ms_warm:.5f} ms warm "
        f"L2; host issue {host:.5f} ms/call; plain {plain_ms:.3f} ms; SDPA "
        f"{lib_ms:.5f} ms back to back, {lib_cold:.5f} ms cold L2; {rows} "
        f"K/V positions, {bytes_} B -> bound "
        f"{bound:.5f} ms; ms/bound {ms / bound:.2f}; plan {plan._asdict()}")
    a1 = cases[2][1]
    plan1 = k.device_plan(a1[0], a1[1])
    rows1, bytes1, bound1 = decode_bound(k, kc, kv_len[one:one + 1], 1, h)
    cold1, warm1, _h1 = timed_launches([lambda: k.flash_decode(*a1)] * 16,
                                       flush_buf)
    ms1 = statistics.median(cold1)
    lib1, lib1_cold = sdpa_ms(*a1, flush_buf)
    log(f"flash_decode at B 1, S {s}: median {ms1:.5f} ms cold L2, "
        f"{statistics.median(warm1):.5f} ms warm; SDPA {lib1:.5f} ms back "
        f"to back, {lib1_cold:.5f} ms cold L2; "
        f"{rows1} positions, {bytes1} B -> bound {bound1:.5f} ms; ms/bound "
        f"{ms1 / bound1:.2f}; plan {plan1._asdict()}")
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:69",
        "launches": None, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": lib_cold, "library_ms_back_to_back": lib_ms,
        "ms_warm_l2": ms_warm, "host_ms_per_call": host, "positions": rows,
        "shape": [b, h, kh, d, s], "plan": plan._asdict(),
        "b1_ms": ms1, "b1_ms_warm_l2": statistics.median(warm1),
        "b1_library_ms": lib1_cold, "b1_library_ms_back_to_back": lib1,
        "b1_bound_ms": bound1, "b1_plan": plan1._asdict()}


def flash_decode_rows(row32, err, at6d):
    """The flash_decode row of the kernel table: its timings at 6d's
    shape (the main path's: B 8, S 2,080, qwen3-14b's heads) as the
    row's ms, plain, bound and library figures, the B 16 x 32,768
    timings beside them under ``_32k``, and the worst error over every
    shape."""
    keep = ("name", "route", "source", "replaces", "launches", "bound_by")
    row = {key: row32[key] for key in keep}
    row.update(max_abs_err=max(row32["max_abs_err"], err), ms=at6d["ms"],
               plain_ms=at6d["plain_ms"], bound_ms=at6d["bound_ms"],
               library_ms=at6d["library_ms"],
               **{key: v for key, v in at6d.items()
                  if key not in ("ms", "plain_ms", "bound_ms",
                                 "library_ms")})
    row.update({f"{key}_32k": v for key, v in row32.items()
                if key not in keep and key != "max_abs_err"})
    return row


# ------------------------------------------------------------- phase r
def roofline_dryruns(root):
    """Phase r's dry runs, started before the build, each in its own
    ``python -m repro_torch.launch.dryrun`` process on the host's CPU
    (meta tensors; ``CUDA_VISIBLE_DEVICES`` empty, so none touches the
    card): r1 qwen3-14b ``decode_32k`` at the largest batch that fits;
    r2 falcon-mamba-7b ``prefill_32k`` at phase 6's depth, at the largest
    batch and at batch 1; r3 internlm2-1.8b ``train_4k`` at t1's batch
    and microbatches.  Returns {key: (process, artifact dir, log)}."""
    import shutil

    cells = {
        "r1": ["--arch", DENSE_ARCH, "--shape", "decode_32k"],
        "r2": ["--arch", LM_ARCH, "--shape", "prefill_32k", "--layers",
               str(LM_DEPTH)],
        "r2_b1": ["--arch", LM_ARCH, "--shape", "prefill_32k", "--layers",
                  str(LM_DEPTH), "--batch", "1"],
        "r3": ["--arch", TRAIN_ARCH, "--shape", "train_4k", "--batch",
               str(TRAIN_BATCH), "--microbatches", str(TRAIN_MICRO)]}
    out = root / "build" / "smoke_dryrun"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(root / "src")] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = {}
    for key, args in cells.items():
        d = out / key
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        logf = open(out / f"{key}.log", "w")
        procs[key] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--out-dir", str(d)], cwd=root, env=env, stdout=logf,
            stderr=subprocess.STDOUT), d, logf)
    return procs


def roofline_artifacts(procs):
    """The dry runs' artifacts, waiting for any still running (each
    process has ended when this returns)."""
    t0 = time.perf_counter()
    arts = {}
    for key, (proc, d, logf) in procs.items():
        rc = proc.wait(timeout=900)
        logf.close()
        found = sorted(d.glob("*.json"))
        if rc or len(found) != 1:
            fail(f"phase r's dry run {key} exited {rc} ({logf.name})")
        with open(found[0]) as f:
            arts[key] = art = json.load(f)
        log(f"[r] dry run {key}: {art['arch']} {art['shape']} at "
            f"{art['n_layers']} layers, batch {art['batch']} a card "
            f"({art['cards']:g} cards for the global batch), predicted peak "
            f"{art['counts']['peak_bytes'] / 1e9:.3f} GB (fits 80 GB: "
            f"{art['fits']}); counted in {art['seconds']:.1f} s on meta")
    log(f"[r] waited {time.perf_counter() - t0:.1f} s for the dry runs")
    return arts


def check_fit(tag, art, ran, why="") -> None:
    """Fails where the card contradicts the dry run's fit verdict: a
    cell predicted to fit that ran out of memory (``ran`` False), or one
    predicted not to fit that ran."""
    pred = art["counts"]["peak_bytes"] / 1e9
    if ran and not art["fits"]:
        fail(f"{tag}: predicted not to fit ({pred:.2f} GB) but it ran")
    if not ran and art["fits"]:
        fail(f"{tag}: predicted to fit ({pred:.2f} GB) but the card ran "
             f"out of memory: {why}")
    log(f"[{tag}] fit verdict held: predicted {pred:.2f} GB, "
        f"{'ran' if ran else 'out of memory'}")


def with_dryruns(root, work):
    """``work()`` with phase r's dry runs beside it on the host's CPU
    (the kernels' build, and in the full smoke phase 1b's checks, which
    time nothing on the host's clock), then the wait for the dry runs:
    (what ``work`` returned, their artifacts, {"wait_s": the wait}).  A
    failure in ``work`` stops the dry runs."""
    procs = roofline_dryruns(root)
    try:
        out = work()
    except BaseException:
        for proc, _d, logf in procs.values():
            proc.kill()
            proc.wait()
            logf.close()
        raise
    t0 = time.perf_counter()
    arts = roofline_artifacts(procs)
    return out, arts, {"wait_s": time.perf_counter() - t0}


def fit_verdict(tag, art, run):
    """``run()``, the card's side of a phase r cell, held to the dry
    run's fit verdict (``check_fit``): its result, or None where the card
    ran out of memory as predicted."""
    try:
        out = run()
    except torch.cuda.OutOfMemoryError as exc:
        check_fit(tag, art, False, str(exc))
        return None
    check_fit(tag, art, True)
    return out


def out_of_memory(art, t0):
    """A phase r cell's record where the card ran out of memory, as its
    dry run predicted: nothing measured."""
    return {"batch": art["batch"], "out_of_memory": True,
            "peak_predicted_gb": art["counts"]["peak_bytes"] / 1e9,
            "seconds": time.perf_counter() - t0}


def peak_line(tag, art, measured, what="max_memory_allocated"):
    """The predicted and measured peaks and their ratio (measured over
    predicted), printed; returns them."""
    pred = art["counts"]["peak_bytes"]
    log(f"[{tag}] peak: predicted {pred / 1e9:.3f} GB (dry run), measured "
        f"{measured / 1e9:.3f} GB ({what}); measured/predicted "
        f"{measured / pred:.4f}")
    return {"peak_predicted_gb": pred / 1e9, "peak_measured_gb":
            measured / 1e9, "peak_ratio": measured / pred}


def profile_call(fn):
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA): (the
    profiler, host wall ms), or (None, wall ms) where it fails: the
    profile is informational."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    except Exception as exc:      # informational: never fails the smoke
        log(f"profile: not measured ({exc!r})")
        return None, None
    return prof, wall


def device_ms(raw, names=()):
    """Summed device time (ms) of a profile's CUDA kernels, copies and
    fills (``raw``: the profiler's raw events), all or those whose name
    holds one of ``names``; the ranges that ``record_function`` mirrors
    onto the device's timeline are spans, not work, and do not count."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in raw
               if e.device_type() == cuda and not e.is_user_annotation()
               and (not names or any(n in e.name() for n in names))) / 1e6


def roofline_decode(win, lm, art, card):
    """Phase r1: qwen3-14b's ``decode_32k`` cell on the card at the dry
    run's per-card batch, on phase 6d's parameters: a zero cache of
    32,768 positions with ``cache_len`` 32,767 (6d's long-context step),
    ``R_DECODE_STEPS`` decode steps, each in a counted window
    (``flash_decode`` once an attention a step), then one more under
    ``torch.profiler``; beside the dry run's ``memory_s`` and peak."""
    from repro_torch.configs import SHAPES
    from repro_torch.utils.roofline import analyze_artifact

    t0 = time.perf_counter()
    model, params, cfg = lm["model"], lm["params"], lm["cfg"]
    dev = model.device
    b, s = art["batch"], SHAPES["decode_32k"].seq_len
    ana = analyze_artifact(art)
    expect = kernel_attn_per_step(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak(dev)

    def run():
        state = model.init_decode_state(b, s)
        state["cache_len"].fill_(s - 1)
        tokens = torch.zeros((b, 1), dtype=torch.long, device=dev)
        times, per, finite = [], [], True
        for _ in range(R_DECODE_STEPS):
            t = time.perf_counter()
            (logits, state), counts = win.run(
                lambda: model.decode_step(params, state, tokens))
            finite &= bool(torch.isfinite(logits).all())
            times.append((time.perf_counter() - t) * 1e3)
            per.append(counts["flash_decode"])
        prof, wall = profile_call(
            lambda: model.decode_step(params, state, tokens))
        peak = torch.cuda.max_memory_allocated()
        del state
        return times, per, finite, prof, wall, peak

    res = fit_verdict("r1", art, run)
    if res is None:
        return out_of_memory(art, t0)
    times, per, finite, prof, wall, peak = res
    if not finite or set(per) != {expect}:
        fail(f"r1: flash_decode launched {per} times in {R_DECODE_STEPS} "
             f"steps (expected {expect} a step); finite logits {finite}")
    raw = prof.profiler.kineto_results.events() if prof is not None else []
    dev_ms = device_ms(raw) if raw else None
    fd_ms = device_ms(raw, FD_KERNELS) if raw else None
    out = dict(batch=b, cards=art["cards"], step_ms=times,
               step_ms_median=statistics.median(times),
               flash_decode_per_step=expect, device_ms=dev_ms,
               flash_decode_ms=fd_ms, profiled_wall_ms=wall,
               memory_s=ana["memory_s"], compute_s=ana["compute_s"],
               bound=ana["bound"], **peak_line("r1", art, peak))
    log(f"[r1] {cfg.name} decode_32k at the dry run's batch {b} a card "
        f"({art['cards']:g} cards for 128 rows), cache_len {s - 1} of {s}: "
        f"{R_DECODE_STEPS} steps, host ms {[round(x, 2) for x in times]} "
        f"(median {out['step_ms_median']:.2f}); flash_decode {per} "
        f"launches a step; one step under torch.profiler: device ms "
        f"{dev_ms if raw else 'not measured'} (flash_decode "
        f"{fd_ms if raw else 'not measured'}); dry run: memory_s "
        f"{ana['memory_s'] * 1e3:.3f} ms, compute_s "
        f"{ana['compute_s'] * 1e3:.3f} ms, bound {ana['bound']}; {card}")
    out["seconds"] = time.perf_counter() - t0
    return out


def roofline_prefill(win, lm, art, art1, card):
    """Phase r2: falcon-mamba-7b's ``prefill_32k`` cell at batch 1 on
    phase 6's model (32 layers, the scan kernel), ``R_PREFILLS`` prefills
    of 32,768 random tokens, each in a counted window (``mamba_scan``
    once a layer); the last one's ms beside the batch-1 dry run's bound,
    and the dry run's per-card batch beside it."""
    from repro_torch.configs import SHAPES
    from repro_torch.utils.roofline import analyze_artifact

    t0 = time.perf_counter()
    model, params, cfg = lm["model"], lm["params"], lm["cfg"]
    dev = model.device
    l = SHAPES["prefill_32k"].seq_len
    ana = analyze_artifact(art1)
    tokens = torch.as_tensor(np.random.default_rng(800).integers(
        0, cfg.vocab, (1, l)).astype(np.int32), device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak(dev)

    def run():
        ms, per, finite = [], [], True
        for _ in range(R_PREFILLS):
            t = time.perf_counter()
            (_state, logits), counts = win.run(
                lambda: model.prefill(params, tokens, l + 1))
            finite &= bool(torch.isfinite(logits).all())
            ms.append((time.perf_counter() - t) * 1e3)
            per.append(counts["mamba_scan"])
        return ms, per, finite, torch.cuda.max_memory_allocated()

    res = fit_verdict("r2", art1, run)
    if res is None:
        return out_of_memory(art1, t0)
    ms, per, finite, peak = res
    if not finite or set(per) != {cfg.n_layers}:
        fail(f"r2: mamba_scan launched {per} times in {R_PREFILLS} prefills "
             f"of {cfg.n_layers} layers; finite logits {finite}")
    out = dict(ms=ms, bound_ms=ana["step_s"] * 1e3,
               compute_ms=ana["compute_s"] * 1e3,
               memory_ms=ana["memory_s"] * 1e3, bound=ana["bound"],
               dryrun_batch=art["batch"], dryrun_cards=art["cards"],
               **peak_line("r2", art1, peak))
    log(f"[r2] {cfg.name} prefill_32k at {cfg.n_layers} layers, batch 1: "
        f"ms {[round(x, 1) for x in ms]} (host clock to a sync, the first "
        f"warms); dry run at batch 1: compute {out['compute_ms']:.2f} ms, "
        f"memory {out['memory_ms']:.2f} ms, bound {out['bound_ms']:.2f} ms "
        f"({ana['bound']}); last/bound {ms[-1] / out['bound_ms']:.2f}; "
        f"mamba_scan {per} launches a prefill; the dry run's per-card batch "
        f"{art['batch']} ({art['cards']:g} cards for 32 rows); {card}")
    out["seconds"] = time.perf_counter() - t0
    return out


_PRODUCTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}


def _spans(pairs):
    """{thread: (sorted starts, ends)} of the union of ``(thread, start,
    end)`` intervals (nested ones merged)."""
    by = collections.defaultdict(list)
    for t, a, b in pairs:
        by[t].append((a, b))
    out = {}
    for t, iv in by.items():
        iv.sort()
        merged = [list(iv[0])]
        for a, b in iv[1:]:
            if a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        out[t] = ([m[0] for m in merged], [m[1] for m in merged])
    return out


def _inside(spans, thread, ts) -> bool:
    import bisect

    if thread not in spans:
        return False
    starts, ends = spans[thread]
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


def step_split(raw, tag):
    """A profiled train step's device time (ms) in three parts, from the
    profiler's raw events (``raw``): the f32 attention's ops, the matrix
    products (``_PRODUCTS``; bf16 outside the attention on this path),
    and the rest; plus what no op launched, and the total.  A kernel
    belongs to the op that launched it.  An op is the attention's when it
    ran inside a ``tag`` range (the forward, and its recompute under
    remat) or inside a backward node whose forward op did: the profiler
    pairs a node with its forward op by (sequence number, thread).  The
    ranges that ``record_function`` mirrors onto the device's timeline
    are spans, not work, and do not count."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ops, tags, nodes, kernels = {}, [], [], []
    for e in raw:
        dev = e.device_type()
        if dev == cpu:
            t, a, name = e.start_thread_id(), e.start_ns(), e.name()
            if name == tag:
                tags.append((t, a, a + e.duration_ns()))
            elif e.scope() == 1:            # a backward node
                nodes.append((e.sequence_nr(), e.fwd_thread_id(), t, a,
                              a + e.duration_ns()))
            else:
                ops[e.correlation_id()] = (t, a, name in _PRODUCTS,
                                           e.sequence_nr())
        elif dev == cuda and not e.is_user_annotation():
            kernels.append((e.linked_correlation_id(), e.duration_ns()))
    tag_spans = _spans(tags)
    keys = {(q, t) for t, a, _p, q in ops.values()
            if q >= 0 and _inside(tag_spans, t, a)}
    node_spans = _spans((t, a, b) for q, f, t, a, b in nodes
                        if (q, f) in keys)
    parts = {"attention": 0.0, "products": 0.0, "rest": 0.0,
             "unattributed": 0.0}
    for corr, ns in kernels:
        op = ops.get(corr)
        if op is None:
            parts["unattributed"] += ns
        elif _inside(tag_spans, op[0], op[1]) \
                or _inside(node_spans, op[0], op[1]):
            parts["attention"] += ns
        else:
            parts["products" if op[2] else "rest"] += ns
    parts["total"] = sum(parts.values())
    return {key: v / 1e6 for key, v in parts.items()}


def roofline_train(win, trainer, t1, art, card):
    """Phase r3: one more t1 step (internlm2-1.8b, 8 x 4,096 as 2
    microbatches) under ``torch.profiler`` with the chunked attention in
    an ``ATTN_TAG`` range; its device time split three ways
    (``step_split``), beside the dry run's compute (bf16 and f32 apart)
    and memory terms; t1's median step and peak beside the dry run's.
    t1 has run: a dry run that predicted its shape not to fit fails."""
    from repro_torch.models import attention
    from repro_torch.utils.roofline import analyze_artifact

    check_fit("r3", art, True)
    t0 = time.perf_counter()
    ana = analyze_artifact(art)
    orig = attention.flash_attention

    def tagged(*args, **kwargs):
        with torch.profiler.record_function(ATTN_TAG):
            return orig(*args, **kwargs)

    step = len(trainer.metrics_log) + 1
    attention.flash_attention = tagged
    try:
        (prof, wall), _c = win.run(
            lambda: profile_call(lambda: trainer.run(step)))
    finally:
        attention.flash_attention = orig
    no_launches(_c, "r3's profiled step")
    out = dict(step_ms_median=t1["step_ms_median"],
               compute_s=ana["compute_s"], compute_bf16_s=ana["compute_bf16_s"],
               compute_f32_s=ana["compute_f32_s"], sfu_s=ana["sfu_s"],
               memory_s=ana["memory_s"], bound=ana["bound"],
               profiled_wall_ms=wall,
               **peak_line("r3", art, t1["peak_gib"] * 2**30,
                           "t1's max_memory_allocated"))
    if prof is not None:
        t = time.perf_counter()
        parts = step_split(prof.profiler.kineto_results.events(), ATTN_TAG)
        total = parts.pop("total")
        out.update(device_ms=total, parts_ms=parts,
                   attention_share=parts["attention"] / max(total, 1e-9),
                   parse_s=time.perf_counter() - t)
    log(f"[r3] {TRAIN_ARCH} train_4k at t1's shape ({TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, {TRAIN_MICRO} microbatches): t1's median step "
        f"{t1['step_ms_median']:.1f} ms; dry run compute "
        f"{ana['compute_s'] * 1e3:.1f} ms (bf16 "
        f"{ana['compute_bf16_s'] * 1e3:.1f}, f32 "
        f"{ana['compute_f32_s'] * 1e3:.1f}, SFU {ana['sfu_s'] * 1e3:.1f}), "
        f"memory {ana['memory_s'] * 1e3:.1f} ms, bound {ana['bound']}; one "
        f"step under torch.profiler ({wall} ms wall): device ms "
        f"{out.get('device_ms', 'not measured')}, parts "
        f"{out.get('parts_ms', 'not measured')}, attention share "
        f"{out.get('attention_share', 'not measured')} (measured inside the "
        f"step; extrapolated from one layer alone: "
        f"{t1.get('attn_share_of_step_extrapolated', 'not measured')}); "
        f"{card}")
    out["seconds"] = time.perf_counter() - t0
    return out


# ----------------------------------------------------------------- main
# ------------------------------- the paper backend, baselines, page table
def kernel_launches(counts) -> int:
    """Kernel launches in a window's counts (the truncation count is not
    a launch)."""
    return sum(v for key, v in counts.items() if key != "scan_truncated")


def no_launches(counts, what) -> None:
    if kernel_launches(counts):
        fail(f"{what} launched kernels on a path that has none: {counts}")


def quickstart_phase(m, win, card):
    """Phase 8q: ``examples/quickstart.py`` steps 1-4 on the port, on the
    card (no ``device``), at its sizes and with its assertions."""
    t_phase = time.perf_counter()
    # 1. a hard key distribution (the paper's longlat composite keys)
    keys = m.make_dataset("longlat", 100_000)
    payloads = np.arange(len(keys), dtype=np.int64)

    def drive():
        # 2. two-stage NFL: Numerical NF transform -> AFLI
        nfl = m.NFL(m.NFLConfig())
        nfl.bulkload(keys[::2], payloads[::2])
        # 3. batched queries + inserts
        hits = nfl.lookup_batch(keys[::2][:10_000])
        ok = [bool((hits == payloads[::2][:10_000]).all())]
        nfl.insert_batch(keys[1::2][:10_000], payloads[1::2][:10_000])
        ok.append(bool((nfl.lookup_batch(keys[1::2][:10_000])
                        == payloads[1::2][:10_000]).all()))
        # 4. against a classic B-Tree on the same workload
        bt = m.make_index("btree")
        bt.bulkload(keys[::2], payloads[::2])
        ok.append(bool((bt.lookup_batch(keys[::2][:1000])
                        == payloads[::2][:1000]).all()))
        return nfl, bt, ok

    (nfl, bt, ok), counts = win.run(drive)
    mt = nfl.metrics
    log(f"[quickstart] NF enabled: {nfl.use_flow}; tail conflict degree: "
        f"{mt['tail_conflict_original']:.0f} -> "
        f"{mt['tail_conflict_transformed']:.0f}; flow params on "
        f"{nfl.flow_params['out_log_scale'].device}")
    log(f"[quickstart] index stats: {nfl.stats().as_dict()}")
    log(f"[quickstart] btree height: {bt.stats()['height']} vs AFLI "
        f"height: {nfl.stats().height}; checks {ok}; launches {counts}; "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    if not all(ok):
        fail(f"quickstart: an assertion of steps 3-4 failed: {ok}")
    if nfl.flow_params["out_log_scale"].device.type != "cuda":
        fail("quickstart: the flow did not train on the card")
    no_launches(counts, "quickstart")
    return {"use_flow": nfl.use_flow, "checks": ok,
            "afli_height": nfl.stats().height,
            "btree_height": bt.stats()["height"],
            "seconds": time.perf_counter() - t_phase}


def paper_backend_phase(m, win, card):
    """Phase 8a: ``NFL(NFLConfig())``, the paper's AFLI backend with the
    default flow and training, over longlat (half of ``PAPER_KEYS``
    bulk-loaded): reads, misses, ``write_heavy`` writes with every insert
    read back, updates and deletes, and the scan that must raise."""
    t_phase = time.perf_counter()
    name = "paper"
    keys = m.make_dataset("longlat", PAPER_KEYS)
    wl = m.make_workload(keys, m.WorkloadConfig(
        mix="read_only", n_ops=PAPER_READ_BATCHES * BATCH, batch_size=BATCH,
        zipf_s=0.99, seed=0))
    unloaded = np.setdiff1d(keys, wl.load_keys, assume_unique=True)
    rng = np.random.default_rng(8)
    miss = rng.choice(unloaded, BATCH, replace=False)
    truth = Truth(wl.load_keys, wl.load_payloads)
    log(f"[{name}] longlat {keys.shape[0]} keys, "
        f"{wl.load_keys.shape[0]} bulk-loaded into NFL(NFLConfig()) "
        f"(backend {m.NFLConfig().backend!r})")

    def bulkload(force):
        torch.cuda.reset_peak_memory_stats()
        nfl = m.NFL(m.NFLConfig(force_flow=force))
        t = time.perf_counter()
        nfl.bulkload(wl.load_keys, wl.load_payloads)
        return nfl, time.perf_counter() - t

    (nfl, t_bulk), counts = win.run(lambda: bulkload(None))
    mt = nfl.metrics
    verdict = nfl.use_flow
    log(f"[{name}] AutoSwitch: tails {mt['tail_conflict_original']:.0f} "
        f"-> {mt['tail_conflict_transformed']:.0f}, use_flow={verdict}")
    if not nfl.use_flow:
        log(f"[{name}] AutoSwitch declined the flow; rerunning with "
            "force_flow=True so the flow path is driven")
        (nfl, t_bulk), counts = win.run(lambda: bulkload(True))
        mt = nfl.metrics
    no_launches(counts, f"{name} bulk load")
    if not nfl.use_flow:
        fail(f"{name}: the flow does not serve")
    if any(t.device.type != "cuda" for t in
           [nfl.flow_params["out_log_scale"],
            *(layer["w"] for layer in nfl.flow_params["layers"])]):
        fail(f"{name}: the flow params are not on the card")
    split = {"train_s": mt["flow_train_s"], "transform_s": mt["transform_s"],
             "build_s": mt["index_build_s"], "total_s": t_bulk}
    log(f"[{name}] bulkload {t_bulk:.2f} s = train "
        f"{mt['flow_train_s']:.2f} s ({mt['flow_n_steps']:.0f} steps) + "
        f"transform {mt['transform_s']:.2f} s + build "
        f"{mt['index_build_s']:.2f} s")

    def reads():
        wrong = n = 0
        t = time.perf_counter()
        for _op, k, p in wl.batches:
            wrong += int((nfl.lookup_batch(k) != p).sum())
            n += k.shape[0]
        secs = time.perf_counter() - t
        return wrong, n, secs, int((nfl.lookup_batch(miss) != -1).sum())

    (wrong, n_reads, t_reads, wrong_miss), counts = win.run(reads)
    log(f"[{name}] reads: {n_reads} in {PAPER_READ_BATCHES} batches, "
        f"wrong={wrong}, {n_reads / t_reads:.0f} lookups/s; misses: {BATCH} "
        f"unloaded keys, wrong={wrong_miss}; launches {counts}")
    if wrong or wrong_miss:
        fail(f"{name}: {wrong} wrong reads, {wrong_miss} wrong misses")
    no_launches(counts, f"{name} reads")

    wlw = m.make_workload(keys, m.WorkloadConfig(
        mix="write_heavy", n_ops=PAPER_WRITE_BATCHES * BATCH,
        batch_size=BATCH, zipf_s=0.99, seed=0))
    if not np.array_equal(wlw.load_keys, wl.load_keys):
        fail(f"{name}: the write workload's load split differs")

    def writes():
        wrong = n_r = 0
        ins_k, ins_p = [], []
        t_ins = 0.0
        for op, k, p in wlw.batches:
            r = op == 0
            wrong += int((nfl.lookup_batch(k[r]) != p[r]).sum())
            n_r += int(r.sum())
            t = time.perf_counter()
            nfl.insert_batch(k[~r], p[~r])
            t_ins += time.perf_counter() - t
            ins_k.append(k[~r])
            ins_p.append(p[~r])
        return wrong, n_r, np.concatenate(ins_k), np.concatenate(ins_p), \
            t_ins

    (wrong, n_r, ins_k, ins_p, t_ins), counts = win.run(writes)
    truth.insert(ins_k, ins_p)
    ins_u = np.unique(ins_k)
    (back,), counts_b = win.run(lambda: (nfl.lookup_batch(ins_u),))
    wrong_back = int((back != truth.lookup(ins_u)).sum())
    log(f"[{name}] writes: {PAPER_WRITE_BATCHES} write_heavy batches, "
        f"{n_r} reads (wrong={wrong}), {ins_k.shape[0]} inserts at "
        f"{ins_k.shape[0] / t_ins:.0f} inserts/s; {ins_u.shape[0]} "
        f"inserted keys read back, wrong={wrong_back}; launches "
        f"{counts} / {counts_b}")
    if wrong or wrong_back:
        fail(f"{name}: {wrong} wrong reads during writes, {wrong_back} "
             "inserted keys read back wrong")
    no_launches(counts, f"{name} writes")
    no_launches(counts_b, f"{name} read-back")

    pick = rng.choice(wl.load_keys.shape[0], 2 * PAPER_WRITES,
                      replace=False)
    upd = wl.load_keys[pick[:PAPER_WRITES]]
    dele = wl.load_keys[pick[PAPER_WRITES:]]
    upd_pv = wl.load_payloads[pick[:PAPER_WRITES]] + (1 << 28)
    absent = np.setdiff1d(unloaded, ins_u, assume_unique=True)[:1024]

    def upd_del():
        t = time.perf_counter()
        ok_u = nfl.update_batch(upd, upd_pv)
        ok_d = nfl.delete_batch(dele)
        secs = time.perf_counter() - t
        ok_a = nfl.update_batch(absent, np.arange(absent.shape[0]))
        return (secs, ok_u, ok_d, ok_a, nfl.lookup_batch(upd),
                nfl.lookup_batch(dele), nfl.lookup_batch(absent))

    (secs, ok_u, ok_d, ok_a, got_u, got_d, got_a), counts = win.run(upd_del)
    truth.update(upd, upd_pv)
    truth.delete(dele)
    wrong = {"update_ok": int((~ok_u).sum()),
             "delete_ok": int((~ok_d).sum()),
             "absent_update_ok": int(ok_a.sum()),
             "updated_reads": int((got_u != upd_pv).sum()),
             "deleted_hits": int((got_d != -1).sum()),
             "absent_hits": int((got_a != -1).sum())}
    log(f"[{name}] {PAPER_WRITES} updates + {PAPER_WRITES} deletes: "
        f"{2 * PAPER_WRITES / secs:.0f} writes/s; {absent.shape[0]} "
        f"updates of absent keys; wrong {wrong}; n_keys "
        f"{nfl.index.n_keys} (truth {truth.keys.shape[0]}); launches "
        f"{counts}")
    if any(wrong.values()) or nfl.index.n_keys != truth.keys.shape[0]:
        fail(f"{name}: wrong updates or deletes: {wrong}")
    no_launches(counts, f"{name} updates and deletes")

    try:
        nfl.scan_batch(wl.load_keys[:4], wl.load_keys[4:8])
    except NotImplementedError as exc:
        log(f"[{name}] scan_batch raises NotImplementedError: {exc}")
    else:
        fail(f"{name}: scan_batch served on the AFLI backend")

    # one read batch in its own window: the AFLI path launches nothing
    (got,), counts = win.run(lambda: (nfl.lookup_batch(wl.batches[0][1]),))
    if (got != truth.lookup(wl.batches[0][1])).any():
        fail(f"{name}: wrong reads after the writes")
    no_launches(counts, f"{name} read batch")
    t = time.perf_counter()
    st = nfl.stats().as_dict()
    t_stats = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    log(f"[{name}] stats() {st} in {t_stats:.2f} s; launches over a read "
        f"batch {kernel_launches(counts)}; max_memory_allocated since the "
        f"bulk load {peak / 2**20:.1f} MiB; "
        f"dispatch_stats {nfl.dispatch_stats()}")
    secs = time.perf_counter() - t_phase
    log(f"[{name}] phase 8a {secs:.1f} s ({card})")
    return {"name": name, "keys": keys, "wl": wl, "unloaded": unloaded,
            "verdict": verdict, "tails": (mt["tail_conflict_original"],
                                          mt["tail_conflict_transformed"]),
            "bulkload": split, "lookups_per_s": n_reads / t_reads,
            "inserts_per_s": ins_k.shape[0] / t_ins, "stats": st,
            "stats_s": t_stats, "peak_bytes": peak, "seconds": secs}


def baselines_phase(m, win, paper, card):
    """Phase 8b: each baseline of ``index.REGISTRY`` on 8a's raw keys:
    8a's first read batches and unloaded keys, then inserts read back
    and deletes (RMI is static: its insert must raise)."""
    t_phase = time.perf_counter()
    wl = paper["wl"]
    batches = wl.batches[:BASE_READ_BATCHES]
    rng = np.random.default_rng(9)
    pool = rng.choice(paper["unloaded"], 2 * BASE_PROBES, replace=False)
    miss, fresh = pool[:BASE_PROBES], pool[BASE_PROBES:]
    fresh_pv = (1 << 29) + np.arange(BASE_PROBES)
    out = {}
    for name in BASELINES:
        idx = m.make_index(name)

        def drive():
            t = time.perf_counter()
            idx.bulkload(wl.load_keys, wl.load_payloads)
            t_bulk = time.perf_counter() - t
            wrong = n = 0
            t = time.perf_counter()
            for _op, k, p in batches:
                wrong += int((idx.lookup_batch(k) != p).sum())
                n += k.shape[0]
            t_reads = time.perf_counter() - t
            wrong_miss = int((idx.lookup_batch(miss) != -1).sum())
            row = {"bulkload_s": t_bulk, "lookups_per_s": n / t_reads,
                   "wrong": wrong, "wrong_miss": wrong_miss}
            if name == "rmi":
                try:
                    idx.insert(float(fresh[0]), 1)
                except NotImplementedError:
                    row["insert"] = "raises (static)"
                else:
                    fail("rmi: insert did not raise")
                return row
            t = time.perf_counter()
            idx.insert_batch(fresh, fresh_pv)
            row["inserts_per_s"] = BASE_PROBES / (time.perf_counter() - t)
            row["wrong_readback"] = int(
                (idx.lookup_batch(fresh) != fresh_pv).sum())
            victims = fresh[:BASE_DELETES]
            if name == "pgm":
                # PGM's static runs are immutable (the reference's
                # documented simplification): a delete reaches only the
                # insert buffer.  Buffer a few keys, delete them with the
                # flushed victims: the buffered ones must miss, the
                # flushed ones must be refused and still read
                extra = miss[:BASE_PGM_BUFFERED]
                idx.insert_batch(extra, np.arange(extra.shape[0]))
                victims = np.concatenate([extra, victims[extra.shape[0]:]])
            ok = np.array([idx.delete(float(k)) for k in victims])
            got = idx.lookup_batch(victims)
            if name == "pgm":
                nb = BASE_PGM_BUFFERED
                row["wrong_delete"] = (int((~ok[:nb]).sum())
                                       + int((got[:nb] != -1).sum())
                                       + int(ok[nb:].sum())
                                       + int((got[nb:] != fresh_pv[nb:
                                              BASE_DELETES]).sum()))
            else:
                row["wrong_delete"] = int((~ok).sum()) + int(
                    (got != -1).sum())
            return row

        row, counts = win.run(drive)
        row["size_bytes"] = idx.size_bytes()
        row["stats"] = idx.stats()
        log(f"[baseline {name}] bulkload {row['bulkload_s']:.2f} s; "
            f"{row['lookups_per_s']:.0f} lookups/s (AFLI backend 8a "
            f"{paper['lookups_per_s']:.0f}); {json.dumps(row, default=str)}; "
            f"launches {counts} ({card})")
        bad = {k: v for k, v in row.items()
               if k.startswith("wrong") and v}
        if bad:
            fail(f"baseline {name}: {bad}")
        no_launches(counts, f"baseline {name}")
        out[name] = row
        del idx
    secs = time.perf_counter() - t_phase
    log(f"[baselines] phase 8b {secs:.1f} s ({card})")
    out["seconds"] = secs
    return out


def page_table_phase(m, win, card):
    """Phase 8c: ``NFLPageTable()`` on the card over composite session
    keys (one ``fused_lookup`` per ``lookup`` call, no ``nf_forward``),
    inserts of new sessions read back, then a second table over prefix
    hashes, whose flow AutoSwitch must decline."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1)
    seqs = np.repeat(rng.integers(0, 1 << 30, PT_SESSIONS), PT_BLOCKS)
    blocks = np.tile(np.arange(PT_BLOCKS), PT_SESSIONS)
    keys = np.unique(m.composite_key(seqs, blocks))
    pages = rng.permutation(keys.shape[0]).astype(np.int64)
    truth = Truth(keys, pages)
    pt = m.NFLPageTable()
    t = time.perf_counter()
    _none, counts = win.run(lambda: pt.bulkload(keys, pages))
    t_bulk = time.perf_counter() - t
    st = pt.stats()
    log(f"[page table] {keys.shape[0]} composite keys ({PT_SESSIONS} "
        f"sessions x {PT_BLOCKS} blocks); flow verdict: "
        f"{st['flow_enabled']}; table autoswitch "
        f"{pt.index.autoswitch}; bulkload {t_bulk:.2f} s; launches {counts}")

    def lookups(q_all, what):
        wrong = calls = 0
        t = time.perf_counter()
        for i in range(0, q_all.shape[0], BATCH):
            q = q_all[i:i + BATCH]
            got, counts = win.run(lambda: pt.lookup(q))
            calls += 1
            wrong += int((got != truth.lookup(q)).sum())
            if (counts["fused_lookup"] != 1 or counts["nf_forward"]
                    or kernel_launches(counts) != 1):
                fail(f"page table: a lookup call of {q.shape[0]} keys "
                     f"({what}) launched {counts}, not one fused_lookup")
        secs = time.perf_counter() - t
        log(f"[page table] {what}: {q_all.shape[0]} keys in {calls} lookup "
            f"calls, wrong={wrong}, {q_all.shape[0] / secs:.0f} lookups/s; "
            "each call one fused_lookup")
        if wrong:
            fail(f"page table: {wrong} wrong pages ({what})")
        return q_all.shape[0] / secs

    rate = lookups(keys, "every key")
    nseqs = np.repeat(rng.integers(1 << 30, 1 << 31, PT_NEW_SESSIONS),
                      PT_BLOCKS)
    new = m.composite_key(nseqs, np.tile(np.arange(PT_BLOCKS),
                                         PT_NEW_SESSIONS))
    new_pages = keys.shape[0] + np.arange(new.shape[0])

    def inserts():
        for i in range(0, new.shape[0], PT_INSERT_CALL):
            pt.insert(new[i:i + PT_INSERT_CALL],
                      new_pages[i:i + PT_INSERT_CALL])

    t = time.perf_counter()
    _none, counts = win.run(inserts)
    t_ins = time.perf_counter() - t
    truth.insert(new, new_pages)
    st = pt.stats()
    log(f"[page table] {new.shape[0]} keys of {PT_NEW_SESSIONS} new "
        f"sessions inserted in {new.shape[0] // PT_INSERT_CALL} calls of "
        f"{PT_INSERT_CALL} ({new.shape[0] / t_ins:.0f} inserts/s); "
        f"n_rebuilds {st['n_rebuilds']}, builds {st['builds']}; run "
        f"{st['run_len']} delta {st['delta_len']}; launches {counts}")
    lookups(new, "inserted keys read back")
    lookups(keys, "old keys after the inserts")

    toks = np.random.default_rng(2).integers(0, 1 << 31, (PH_KEYS, PH_TOKENS))
    t = time.perf_counter()
    hashes = np.unique(np.array([m.prefix_hash(row) for row in toks]))
    t_hash = time.perf_counter() - t
    hpages = np.arange(hashes.shape[0])
    ph = m.NFLPageTable()
    _none, counts = win.run(lambda: ph.bulkload(hashes, hpages))
    hst = ph.stats()
    (got,), counts_l = win.run(lambda: (ph.lookup(hashes),))
    wrong = int((got != hpages).sum())
    log(f"[page table] prefix hashes: {hashes.shape[0]} keys of "
        f"{PH_TOKENS} tokens (hashed in {t_hash:.2f} s); flow verdict "
        f"{hst['flow_enabled']} ({ph.index.autoswitch}); read back "
        f"wrong={wrong}; launches {counts_l}")
    if hst["flow_enabled"]:
        fail("page table: AutoSwitch kept the flow on prefix hashes")
    if wrong or counts_l["fused_lookup"] != 1 \
            or kernel_launches(counts_l) != 1:
        fail(f"page table: prefix-hash reads wrong={wrong}, launches "
             f"{counts_l}")
    secs = time.perf_counter() - t_phase
    log(f"[page table] phase 8c {secs:.1f} s ({card})")
    return {"flow_enabled": bool(pt.stats()["flow_enabled"]),
            "n_keys": int(truth.keys.shape[0]),
            "lookups_per_s": rate, "inserts_per_s": new.shape[0] / t_ins,
            "n_rebuilds": int(st["n_rebuilds"]), "builds": int(st["builds"]),
            "hash_flow_enabled": bool(hst["flow_enabled"]), "seconds": secs}


def paper_phase(m, win, card):
    """Phase 8: the paper backend, the baselines and the page table."""
    out = {"8q": quickstart_phase(m, win, card)}
    paper = paper_backend_phase(m, win, card)
    out["8b"] = baselines_phase(m, win, paper, card)
    out["8a"] = {k: v for k, v in paper.items()
                 if k not in ("keys", "wl", "unloaded")}
    out["8c"] = page_table_phase(m, win, card)
    return out


# --------------------------------------------------------- LM training (t)
def train_windows(win, fn, what):
    """``fn`` in a counted window that must launch no kernel: the
    training path has none (no Pallas kernel has a backward)."""
    out, counts = win.run(fn)
    no_launches(counts, what)
    return out


def train_full(win, card, r3_art=None):
    """t1: internlm2-1.8b at its full published config through
    ``Trainer.run``, one counted window a step; then, with ``r3_art``,
    phase r3 on the same trainer (``roofline_train``)."""
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = lm_device()
    cfg = lm_config(TRAIN_ARCH)
    log(f"[t1] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.attn.n_heads}/{cfg.attn.kv_heads} heads of "
        f"{cfg.attn.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}, remat {cfg.remat}, loss_chunk "
        f"{cfg.loss_chunk}; {cfg.param_count() / 1e9:.3f} B parameters")
    reset_peak(dev)
    model = build_model(cfg, device=dev)
    data = SyntheticTokens(vocab=cfg.vocab, seq=TRAIN_SEQ,
                           local_batch=TRAIN_BATCH, seed=0)
    trainer = Trainer(model, TrainerConfig(train=TrainConfig(
        optimizer=AdamWConfig(lr=3e-4, weight_decay=0.1),
        schedule=ScheduleConfig(peak_lr=3e-4, warmup_steps=2,
                                total_steps=TRAIN_STEPS),
        microbatches=TRAIN_MICRO)), data)
    t0 = time.perf_counter()
    trainer.initialize()
    sync(dev)
    init_s = time.perf_counter() - t0
    for k in range(TRAIN_STEPS):
        train_windows(win, lambda: trainer.run(k + 1), f"t1 step {k}")
    logm = trainer.metrics_log
    losses = [m["loss"] for m in logm]
    norms = [m["grad_norm"] for m in logm]
    if len(logm) != TRAIN_STEPS or not all(
            np.isfinite(losses + norms)):
        fail(f"t1: losses {losses}, grad norms {norms}")
    if abs(losses[0] - np.log(cfg.vocab)) > 1.0:
        fail(f"t1: first loss {losses[0]:.4f} is not within 1 nat of "
             f"ln {cfg.vocab} = {np.log(cfg.vocab):.4f}")
    times = [m["step_time_s"] * 1e3 for m in logm]
    tokens = TRAIN_SEQ * TRAIN_BATCH
    med = statistics.median(times)
    rate = tokens / (med / 1e3)
    flops = 6 * cfg.param_count() * rate
    out = {"arch": cfg.name, "params_B": cfg.param_count() / 1e9,
           "init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_ms": times, "step_ms_median": med,
           "step_ms_max": max(times), "tokens_per_s": rate,
           "six_n_flops_per_s": flops,
           "six_n_share_of_bf16_peak": flops / BF16_PEAK,
           "peak_gib": peak_gib(dev),
           "stragglers": len(trainer.straggler_events)}
    log(f"[t1] {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
        f"({TRAIN_MICRO} microbatches), init {init_s:.2f} s: losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 4) for x in norms]}; step ms median {med:.1f}, max "
        f"{max(times):.1f} (all {[round(x, 1) for x in times]}); "
        f"{rate:,.0f} tokens/s; 6 N tokens/s {flops / 1e12:.1f} TFLOP/s = "
        f"{flops / BF16_PEAK:.3f} of the bf16 dense peak (989 TFLOP/s at "
        f"700 W; card: {card}); peak {out['peak_gib']} GiB; "
        f"stragglers {out['stragglers']}")
    out.update(attention_share(cfg, med))
    if r3_art is not None:
        out["r3"] = roofline_train(win, trainer, out, r3_art, card)
    del trainer, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def attention_share(cfg, step_ms):
    """One layer's f32 chunked attention at t1's microbatch shape, timed
    alone (CUDA events): forward, then forward and backward; a step runs
    it ``2 x n_layers`` times forward (the step and the recompute) and
    ``n_layers`` times backward, per microbatch.  The share of the step
    is extrapolated from this one layer on random inputs with warm
    caches; it is not measured inside the step."""
    from repro_torch.models.attention import flash_attention

    dev = lm_device()
    if dev.type != "cuda":
        return {}   # a CPU rehearsal has no device clock
    a = cfg.attn
    b, l = TRAIN_BATCH // TRAIN_MICRO, TRAIN_SEQ
    g = torch.Generator(device=dev).manual_seed(0)
    dt = torch.bfloat16

    def mk(h):
        return torch.randn(b, l, h, a.head_dim, generator=g, device=dev,
                           dtype=torch.float32).to(dt).requires_grad_(True)

    q, k, v = mk(a.n_heads), mk(a.kv_heads), mk(a.kv_heads)
    pos = torch.arange(l, dtype=torch.int32, device=dev)

    def fwd():
        with torch.no_grad():
            return flash_attention(q, k, v, pos, pos, True, None, None,
                                   cfg.attn_chunk_q, cfg.attn_chunk_k)

    def fwd_bwd():
        o = flash_attention(q, k, v, pos, pos, True, None, None,
                            cfg.attn_chunk_q, cfg.attn_chunk_k)
        torch.autograd.grad(o.float().sum(), (q, k, v))

    f_ms = time_ms(fwd, 2, warmup=1)
    fb_ms = time_ms(fwd_bwd, 2, warmup=1)
    per_step = TRAIN_MICRO * cfg.n_layers * (f_ms + fb_ms)
    log(f"[t1] one layer's f32 chunked attention at [{b}, {l}, "
        f"{a.n_heads}/{a.kv_heads}, {a.head_dim}]: forward {f_ms:.1f} ms, "
        f"forward + backward {fb_ms:.1f} ms; extrapolated to "
        f"{per_step:.0f} ms a step = {per_step / step_ms:.3f} of the median "
        f"step (one layer timed alone, not measured inside the step)")
    return {"attn_fwd_ms": f_ms, "attn_fwd_bwd_ms": fb_ms,
            "attn_ms_per_step_extrapolated": per_step,
            "attn_share_of_step_extrapolated": per_step / step_ms}


def _smoke_batch(cfg, b, l, seed, dev):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, l)).astype(
        np.int32)).to(dev) for k in ("tokens", "targets")}
    names = {"vlm": ("patches", cfg.n_patches), "encdec": ("frames",
                                                         cfg.enc_seq)}
    if cfg.family in names:
        name, n = names[cfg.family]
        batch[name] = torch.from_numpy((rng.standard_normal(
            (b, n, cfg.d_model)) * 0.5).astype(np.float32)).to(dev)
    return batch


def train_families(win):
    """t2: every architecture's smoke config, ``train_loss`` and its
    gradients on the card against the port's CPU result (f32); then
    ``use_scan_kernel`` under autograd must raise on the card."""
    from repro_torch.configs import arch_names, get_config
    from repro_torch.models.model import build_model
    from repro_torch.train.train_step import loss_and_grads

    dev = lm_device()
    out = {}
    for arch in arch_names():
        cfg = get_config(arch, smoke=True)
        cpu = build_model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(3))
        batch = _smoke_batch(cfg, 2, TRAIN_SMOKE_LEN, 4, torch.device("cpu"))
        want_l, _, want_g = loss_and_grads(cpu, params, batch)
        card = build_model(cfg, device=dev)
        tparams = _to_device(params, dev)
        tbatch = {k: v.to(dev) for k, v in batch.items()}
        got_l, _, got_g = train_windows(
            win, lambda: loss_and_grads(card, tparams, tbatch),
            f"t2 {arch} train_loss")
        err = max(float((g.cpu() - w).abs().max())
                  / max(float(w.abs().max()), 1e-30)
                  for g, w in zip(got_g, want_g))
        lerr = abs(float(got_l) - float(want_l)) / abs(float(want_l))
        out[arch] = {"loss": float(got_l), "loss_rel_err": lerr,
                     "grad_rel_err": err}
        if not (np.isfinite(float(got_l)) and lerr <= TRAIN_CARD_TOL
                and err <= TRAIN_CARD_TOL):
            fail(f"t2 {arch}: card vs CPU loss rel err {lerr:.3e}, worst "
                 f"grad leaf rel err {err:.3e} (tolerance "
                 f"{TRAIN_CARD_TOL})")
    cfg = get_config("falcon-mamba-7b", smoke=True)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, use_scan_kernel=True))
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    try:
        loss_and_grads(model, params, _smoke_batch(cfg, 2, TRAIN_SMOKE_LEN,
                                                   4, dev))
        fail("t2: use_scan_kernel=True trained on the card")
    except NotImplementedError as e:
        if "no backward kernel" not in str(e):
            raise
        out["scan_kernel_backward"] = str(e)
    log(f"[t2] card vs CPU, f32 smoke configs (loss, max rel err loss, "
        f"grads): " + "; ".join(
            f"{a} {v['loss']:.4f} {v['loss_rel_err']:.1e} "
            f"{v['grad_rel_err']:.1e}" for a, v in out.items()
            if isinstance(v, dict)) + f"; use_scan_kernel under autograd "
        f"raised: {out['scan_kernel_backward']}")
    return out


def _to_device(tree, dev):
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [x.to(dev) for x in tree_leaves(tree)])


def _leaf_list(tree):
    from repro_torch.train.checkpoint import tree_flatten

    return [x for _, x in tree_flatten(tree)]


def train_restart(win, ckpt_root):
    """t3: internlm2-1.8b's smoke config on the card: 10 steps with a
    checkpoint every 5, a fresh trainer restores step 10 bit for bit and
    continues to 16 against an uninterrupted run; SIGTERM mid-run leaves
    a committed checkpoint; Adafactor 10 steps, its factored state."""
    import shutil
    import signal

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models.model import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdafactorConfig, AdamWConfig
    from repro_torch.train.schedule import ScheduleConfig
    from repro_torch.train.train_step import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = lm_device()
    cfg = get_config(TRAIN_ARCH, smoke=True)
    shutil.rmtree(ckpt_root, ignore_errors=True)

    def trainer(name, opt=None, data_cls=SyntheticTokens, every=5):
        data = data_cls(vocab=cfg.vocab, seq=64, local_batch=4, seed=1)
        tcfg = TrainerConfig(
            train=TrainConfig(
                optimizer=opt or AdamWConfig(lr=5e-3),
                schedule=ScheduleConfig(peak_lr=5e-3, warmup_steps=5,
                                        total_steps=100)),
            ckpt_dir=str(ckpt_root / name), ckpt_every=every)
        return Trainer(build_model(cfg, device=dev), tcfg, data), data

    a, _ = trainer("run")
    train_windows(win, lambda: a.run(10), "t3 first 10 steps")
    saved = [x.clone() for x in _leaf_list(a.state)]
    b, data_b = trainer("run")
    start = b.initialize()
    restored = _leaf_list(b.state)
    same = all(torch.equal(x, y) for x, y in zip(saved, restored))
    if start != 10 or data_b.step != 10 or not same:
        fail(f"t3: restore gave step {start}, data step {data_b.step}, "
             f"bit-equal {same}")
    train_windows(win, lambda: b.run(16), "t3 resumed steps")
    ref, _ = trainer("ref")
    train_windows(win, lambda: ref.run(16), "t3 uninterrupted run")
    resumed = [m["loss"] for m in b.metrics_log]
    uninterrupted = [m["loss"] for m in ref.metrics_log[10:]]
    gap = max(abs(x - y) / abs(y) for x, y in zip(resumed, uninterrupted))
    if len(resumed) != 6 or gap > RESTART_TOL:
        fail(f"t3: resumed losses {resumed} vs uninterrupted "
             f"{uninterrupted} (max rel gap {gap:.2e})")

    class Preempted(SyntheticTokens):
        def next_batch(self):
            if self.step == 3:
                os.kill(os.getpid(), signal.SIGTERM)
            return super().next_batch()

    c, _ = trainer("sigterm", data_cls=Preempted, every=100)
    res = train_windows(win, lambda: c.run(50), "t3 preempted run")
    last = ckpt.latest_step(str(ckpt_root / "sigterm"))
    if res["final_step"] != 4 or last != 4:
        fail(f"t3: SIGTERM at step 3 stopped at {res['final_step']}, "
             f"committed {last}")
    fac = AdafactorConfig(lr=5e-3)
    d, _ = trainer("adafactor", opt=fac)
    res_d = train_windows(win, lambda: d.run(10), "t3 Adafactor")
    params = dict(zip([p for p, _ in ckpt.tree_flatten(d.state.params)],
                      _leaf_list(d.state.params)))
    vr = _leaf_list(d.state.opt.vr)
    vc = _leaf_list(d.state.opt.vc)
    bad = []
    for (path, p), r, c_ in zip(params.items(), vr, vc):
        fac_leaf = p.dim() >= 2 and min(p.shape[-2:]) >= fac.min_dim_factored
        want_r = tuple(p.shape[:-1]) if fac_leaf else tuple(p.shape)
        want_c = (tuple(p.shape[:-2]) + tuple(p.shape[-1:]) if fac_leaf
                  else (1,))
        if tuple(r.shape) != want_r or tuple(c_.shape) != want_c:
            bad.append(path)
    n_fac = sum(p.dim() >= 2 and min(p.shape[-2:]) >= fac.min_dim_factored
                for p in params.values())
    if bad or not np.isfinite(res_d["final_loss"]) or not n_fac:
        fail(f"t3: Adafactor state shapes wrong at {bad}, final loss "
             f"{res_d['final_loss']}, factored leaves {n_fac}")
    out = {"restored_step": start, "restore_bit_equal": same,
           "resumed_losses": resumed, "uninterrupted_losses": uninterrupted,
           "max_rel_gap": gap, "sigterm_committed_step": last,
           "adafactor_final_loss": res_d["final_loss"],
           "adafactor_factored_leaves": n_fac}
    log(f"[t3] restore at step {start} bit-equal {same}; resumed vs "
        f"uninterrupted losses max rel gap {gap:.2e} (tolerance "
        f"{RESTART_TOL}); SIGTERM at step 3 -> committed step {last}; "
        f"Adafactor 10 steps, final loss {res_d['final_loss']:.4f}, "
        f"{n_fac} factored leaves, vr/vc shapes as JAX's")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return out


def train_example(win, ckpt_dir):
    """t4: the port's ``examples/train_lm.py`` on the card, 300 steps."""
    from repro_torch.examples import train_lm

    with contextlib.redirect_stdout(io.StringIO()) as buf:
        res = train_windows(win, lambda: train_lm.main(
            ["--ckpt-dir", str(ckpt_dir), "--device", str(lm_device())]),
            "t4 example")
    for line in buf.getvalue().splitlines():
        log(f"[t4] {line}")
    drop = res["first"] - res["last"]
    if res["final_step"] != 300 or not drop > 1.0:
        fail(f"t4: {res['final_step']} steps, loss drop {drop:.3f} nats")
    t = res.pop("step_times_s")
    res["step_ms_median"] = statistics.median(t) * 1e3
    log(f"[t4] step ms median {res['step_ms_median']:.2f}")
    return res


def train_collectives(tmp_dir):
    """t5: the collectives, the pipeline and a mesh over an NCCL group of
    world size 1 on the card (gloo in a CPU rehearsal), against their
    plain oracles."""
    import torch.distributed as dist

    from repro_torch.dist.collectives import (compressed_psum,
                                              dequantize_int8,
                                              flash_decode_combine,
                                              quantize_int8,
                                              static_axis_size)
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh_shape

    dev = lm_device()
    store = tmp_dir / "nccl_store"
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}", world_size=1,
                            rank=0)
    try:
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(64, 512, generator=g, device=dev)
        psum = compressed_psum(x)
        oracle = dequantize_int8(*quantize_int8(x))
        q, k, v = (torch.randn(s, generator=g, device=dev)
                   for s in ((2, 8, 64), (2, 256, 8, 64), (2, 256, 8, 64)))
        s = torch.einsum("bhd,bshd->bhs", q, k)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        comb = flash_decode_combine(torch.einsum("bhs,bshd->bhd", p, v), m,
                                    p.sum(-1))
        ref = torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), v)
        w = torch.randn(128, 128, generator=g, device=dev) * 0.1
        xs = torch.randn(4, 16, 128, generator=g, device=dev)
        pipe = pipeline_apply(lambda pw, h: torch.tanh(h @ pw), w, xs)
        mesh = make_mesh_shape((1, 1), ("data", "model"), dev.type)
        serial = torch.stack([torch.tanh(x @ w) for x in xs])
        errs = {"compressed_psum": float((psum - oracle).abs().max()),
                "flash_decode_combine": float((comb - ref).abs().max()),
                "pipeline_apply": float((pipe - serial).abs().max())}
        out = {"backend": dist.get_backend(), "world": static_axis_size(),
               "mesh": tuple(mesh.shape), **errs}
    finally:
        dist.destroy_process_group()
    log(f"[t5] {out['backend']} world of {out['world']}: max |d| against "
        f"the oracles "
        f"{errs}; mesh {out['mesh']}")
    if out["world"] != 1 or errs["compressed_psum"] != 0.0 \
            or errs["flash_decode_combine"] > 1e-5 \
            or errs["pipeline_apply"] > 1e-6:
        fail(f"t5: {out}")
    return out


def training_phase(win, card, root, r3_art=None):
    """Phase t: LM training on the card (t1-t5), inside its budget (phase
    r3, run on t1's trainer, is phase r's and not counted in it)."""
    t_phase = time.perf_counter()
    walls = {}

    def leg(tag, fn):
        t0 = time.perf_counter()
        res = fn()
        walls[tag] = time.perf_counter() - t0
        return res

    work = root / "build" / "smoke_train"
    work.mkdir(parents=True, exist_ok=True)
    out = {"t1": leg("t1", lambda: train_full(win, card, r3_art))}
    gc.collect()
    torch.cuda.empty_cache()
    out["t2"] = leg("t2", lambda: train_families(win))
    out["t3"] = leg("t3", lambda: train_restart(win, work / "ckpt"))
    out["t4"] = leg("t4", lambda: train_example(win, work / "example"))
    out["t5"] = leg("t5", lambda: train_collectives(work))
    r3_s = out["t1"].get("r3", {}).get("seconds", 0.0)
    walls["t1"] -= r3_s
    wall = time.perf_counter() - t_phase - r3_s
    out["walls"] = walls
    log(f"[t] phase wall {wall:.1f} s (budget {TRAIN_BUDGET_S} s; legs "
        f"{ {k: round(v, 1) for k, v in walls.items()} }); {card}")
    if wall > TRAIN_BUDGET_S:
        fail(f"phase t took {wall:.1f} s, past its {TRAIN_BUDGET_S} s "
             "budget")
    return out


class Mods:
    """The port's modules the smoke drives (imported after the checks)."""

    def __init__(self):
        from repro_torch.core.drift import DriftConfig, ReshardConfig
        from repro_torch.core.flat_afli import FlatAFLIConfig
        from repro_torch.core.nfl import NFL, NFLConfig
        from repro_torch.core.train_flow import FlowTrainConfig
        from repro_torch.data.datasets import make_dataset
        from repro_torch.data.workloads import (WorkloadConfig,
                                                _zipf_indices, make_workload)
        from repro_torch.index import make_index
        from repro_torch.kernels import ops
        from repro_torch.serve import faults
        from repro_torch.serve.frontend import (FrontEnd, FrontEndConfig,
                                                ServiceRequest)
        from repro_torch.serve.prefix_cache import (NFLPageTable,
                                                    composite_key,
                                                    prefix_hash)

        self.NFL, self.NFLConfig = NFL, NFLConfig
        self.FrontEnd, self.FrontEndConfig = FrontEnd, FrontEndConfig
        self.ServiceRequest, self.faults = ServiceRequest, faults
        self.DriftConfig, self.FlatAFLIConfig = DriftConfig, FlatAFLIConfig
        self.ReshardConfig = ReshardConfig
        self.FlowTrainConfig = FlowTrainConfig
        self.make_dataset, self.make_workload = make_dataset, make_workload
        self.WorkloadConfig, self.zipf_indices = WorkloadConfig, _zipf_indices
        self.ops = ops
        self.make_index, self.NFLPageTable = make_index, NFLPageTable
        self.composite_key, self.prefix_hash = composite_key, prefix_hash


class Kernels:
    def __init__(self):
        from repro_torch.kernels.fused_lookup import (fused_lookup,
                                                      fused_lookup_plain)
        from repro_torch.kernels.index_probe import (index_probe,
                                                     index_probe_plain)
        from repro_torch.kernels.streamed_lookup import (
            streamed_lookup, streamed_lookup_plain)
        from repro_torch.kernels.nf_forward import (nf_forward,
                                                    nf_forward_plain)
        from repro_torch.kernels.range_scan import (fused_range_scan,
                                                    fused_range_scan_plain)

        self.nf_forward, self.nf_forward_plain = nf_forward, nf_forward_plain
        self.fused_lookup = fused_lookup
        self.fused_lookup_plain = fused_lookup_plain
        self.fused_range_scan = fused_range_scan
        self.fused_range_scan_plain = fused_range_scan_plain
        self.streamed_lookup = streamed_lookup
        self.streamed_lookup_plain = streamed_lookup_plain
        self.index_probe, self.index_probe_plain = (index_probe,
                                                    index_probe_plain)
        from repro_torch.kernels.flash_decode import (decode_work,
                                                      device_plan,
                                                      flash_decode,
                                                      flash_decode_plain)
        from repro_torch.kernels.mamba_scan import (mamba_scan,
                                                    mamba_scan_plain,
                                                    scan_plan, scan_work)

        self.mamba_scan, self.mamba_scan_plain = mamba_scan, mamba_scan_plain
        self.scan_plan, self.scan_work = scan_plan, scan_work
        self.decode_work = decode_work
        self.flash_decode = flash_decode
        self.flash_decode_plain = flash_decode_plain
        self.device_plan = device_plan


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.core.flat_afli import split_key_bits
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    card = card_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} visible")
    # phase r's dry runs share the host's CPU with the build alone
    walls = {}

    def wall(tag, t0):
        walls[tag] = time.perf_counter() - t0
        log(f"phase {tag}: {walls[tag]:.1f} s wall")

    def build_and_check():
        phase_build(build)
        t0 = time.perf_counter()
        out = analysis_checks()
        wall("contract checker", t0)
        return out

    # ---- the build and the contract checker, phase r's dry runs beside
    checked, r_arts, r_out = with_dryruns(root, build_and_check)
    m, k = Mods(), Kernels()
    win = Windows(m.ops)
    dev = torch.device("cuda")
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    t0 = time.perf_counter()
    fixture_rows = fixture_timings(checked, flush_buf)
    del checked
    wall("fixture kernel timings", t0)

    # ---- longlat, flow on
    t0 = time.perf_counter()
    ll = bulkload_and_read("longlat", LONGLAT_KEYS, None, 0, m, win,
                           train=FLOW_TRAIN)
    if not ll["use_flow"]:
        fail("longlat phase did not serve with the flow on")
    wall("longlat reads", t0)
    look = {True: time_lookup(ll, k, split_key_bits, flush_buf)}
    t0 = time.perf_counter()
    s1 = streamed_reads(ll, win, split_key_bits, "fresh index",
                        {"misses": ll["miss_keys"]})
    probe_args = root_probe(ll, m, win, s1["fused"], split_key_bits)
    wall("longlat streamed reads", t0)
    streamed = {True: time_streamed(ll, k, split_key_bits, flush_buf,
                                    look[True])}
    probe = time_probe(ll, k, probe_args, flush_buf)
    del probe_args, s1
    t0 = time.perf_counter()
    ins_k, _ins_p = write_stream(ll, m, win, N_WRITE_BATCHES, False)
    ins_u = np.unique(ins_k)
    readback(ll, ins_u, win, "inserted keys read back")
    look_tiers = time_lookup_tiers(ll, k, ins_u, split_key_bits, flush_buf)
    streamed_tiers = time_streamed_tiers(ll, k, ins_u, split_key_bits,
                                         flush_buf, look_tiers)
    rows = {"nf_forward": nf_forward_row(ll, k, flush_buf,
                                         ll.pop("write_batches"))}
    update_and_delete(ll, win, ins_k)
    wall("longlat writes", t0)
    t0 = time.perf_counter()
    readback(ll, ins_u, win, "inserted keys read back", streamed=True)
    readback(ll, ll["updated"][0], win, "updated keys", streamed=True)
    readback(ll, ll["deleted"], win, "deleted keys", streamed=True)
    wall("longlat streamed readback", t0)
    del ins_u
    t0 = time.perf_counter()
    sk, zs, ps = scan_truth(ll, m, dev)
    queries = scan_queries(ll, m, sk, N_SCAN_BATCHES)
    ll["scan"] = run_scans(ll, win, sk, zs, ps, queries, "YCSB E")
    wall("longlat scans", t0)
    err_tiers = {True: compare_lookup_tiers(ll, k, split_key_bits)}
    ranged = {True: time_range(ll, scan_args(ll["nfl"], sk, queries, dev),
                               k, flush_buf)}
    t0 = time.perf_counter()
    idx = ll["nfl"].index
    router_builds = idx._serving.router_builds
    (_none, counts) = win.run(idx.rebuild)
    log(f"[longlat] rebuild(): {time.perf_counter() - t0:.2f} s, fold "
        f"{idx.last_fold}; n_rebuilds {idx.n_rebuilds}; run "
        f"{idx.stats()['run_len']}; launches {counts}")
    if idx.n_rebuilds < 1 or idx.stats()["run_len"] != idx.n_shadowed:
        fail("longlat: rebuild did not fold the tiers")
    readback(ll, np.concatenate(ll["batches"]), win,
             "read batches after rebuild (updates and deletes applied)")
    readback(ll, ll["deleted"], win, "deleted keys after rebuild")
    run_scans(ll, win, sk, zs, ps, queries[:1], "after rebuild")
    streamed_reads(ll, win, split_key_bits, "after rebuild",
                   {"deleted keys": ll["deleted"]})
    built = idx._serving.router_builds - router_builds
    log(f"[longlat] router builds across rebuild(): {built}")
    if built != 1:
        fail(f"longlat: the router was built {built} times for the folded "
             "scan pool (expected once)")
    wall("longlat rebuild", t0)
    log(f"[longlat] max_memory_allocated since its bulkload "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    fronted = {"2f": frontend_phase(ll, m, win, sk, zs, ps, card)}
    wall("longlat front end (2f)", t0)
    del sk, zs, ps

    # ---- lognormal, flow off
    t0 = time.perf_counter()
    ln = bulkload_and_read("lognormal", LOGNORMAL_KEYS, False, 1, m, win,
                           train=FLOW_TRAIN)
    look[False] = time_lookup(ln, k, split_key_bits, flush_buf)
    streamed[False] = time_streamed(ln, k, split_key_bits, flush_buf,
                                    look[False])
    ins_k, _ = write_stream(ln, m, win, MAX_FOLD_BATCHES, True,
                            alternate=True)
    readback(ln, np.unique(ins_k), win, "inserted keys read back")
    dele = np.random.default_rng(301).choice(ln["truth"].keys, TAIL,
                                             replace=False)

    def tail_delete():
        return ln["nfl"].delete_batch(dele), ln["nfl"].lookup_batch(dele)

    (ok, got), _c = win.run(tail_delete)
    ln["truth"].delete(dele)
    ln["deleted"] = dele
    st = ln["nfl"].index.stats()
    log(f"[lognormal] {TAIL} deletes: n_keys {st['n_keys']} (truth "
        f"{ln['truth'].keys.shape[0]}); run {st['run_len']} delta "
        f"{st['delta_len']}")
    if not ok.all() or (got != -1).any() \
            or st["n_keys"] != ln["truth"].keys.shape[0]:
        fail("lognormal: wrong tail deletes")
    if not (st["run_len"] and st["delta_len"]):
        fail("lognormal: the tiers do not both hold data before the scans")
    sk, zs, ps = scan_truth(ln, m, dev)
    queries = scan_queries(ln, m, sk, 1)
    ln["scan"] = run_scans(ln, win, sk, zs, ps, queries, "YCSB E")
    err_tiers[False] = compare_lookup_tiers(ln, k, split_key_bits)
    _g, err_off, _kw = compare_range(ln, scan_args(ln["nfl"], sk, queries,
                                                   dev)[0], k)
    wall("lognormal", t0)
    log(f"[lognormal] max_memory_allocated since its bulkload "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del flush_buf

    # ---- drift and re-flow on phase 3's load, its index freed first
    del ln["nfl"], sk, zs, ps, queries
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    drifted = drift_phase(ln, m, win, dev, card)
    wall("drift and re-flow", t0)

    # ---- the sharded episodes on phase 3's load
    t0 = time.perf_counter()
    migrated = migration_phase(ln, m, win, dev, card)
    wall("sharded migration", t0)
    t0 = time.perf_counter()
    reflowed = sharded_reflow_phase(ln, m, win, dev, card, drifted)
    wall("sharded re-flow", t0)

    # ---- sharded serving: the single indexes' tensors go first
    del ln, idx, ll["nfl"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = sharded_phase(ll, m, win, split_key_bits, dev, card, fronted,
                            wall)
    wall("sharded", t0)
    t0 = time.perf_counter()
    fronted["launcher"] = launcher_check(card)
    wall("launcher --mode index", t0)

    # ---- LM serving: the index phases' tensors go first
    del ll
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm = lm_serve(win, 0)
    lm["replay"] = lm_replay(lm)
    lm["decode_profile"] = decode_profile(lm)
    caps, lm["branches"] = lm_branches(lm, 0)
    r_out["r2"] = roofline_prefill(win, lm, r_arts["r2"], r_arts["r2_b1"],
                                   card)
    del lm["model"], lm["params"]
    gc.collect()
    torch.cuda.empty_cache()
    wall("lm serving (6)", t0)
    # ---- the other LM families, phase 6's tensors freed
    t0 = time.perf_counter()
    dense = dense_phase(win, 0, card, r_arts["r1"], mesh=True)
    r_out["r1"] = dense.pop("r1")
    m_out = dense.pop("m")
    gc.collect()
    torch.cuda.empty_cache()
    wall("dense serving (6d)", t0)
    # ---- phase m's moe, ssm, hybrid, vlm and encdec legs, 6d's model freed
    t0 = time.perf_counter()
    mesh_families_phase(win, card, m_out)   # prints phase m's summary
    # flash_decode at the mesh ranks' shapes (m8), for its kernel row
    fd_rank_shapes = [k for row in m_out["m8"]
                      for k in row["flash_decode_shapes"]]
    del m_out
    gc.collect()
    torch.cuda.empty_cache()
    wall("mesh families (m4-m10)", t0)
    t0 = time.perf_counter()
    families = families_phase(win, 0, card)
    wall("families (6m)", t0)
    t0 = time.perf_counter()
    fd_in = flash_decode_inputs(0)
    flash_decode_window(win, m.ops, *fd_in)
    wall("decode attention window", t0)
    t0 = time.perf_counter()
    flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    lm_rows = {"mamba_scan": scan_row(caps, k, flush_buf)}
    del caps
    lm_rows["flash_decode"] = flash_decode_rows(
        flash_decode_row(k, flush_buf, *fd_in),
        *decode_shape_checks(k, flush_buf, 0))
    lm_rows["flash_decode"]["mesh_rank_shapes"] = fd_rank_shapes
    del fd_in, flush_buf
    gc.collect()
    torch.cuda.empty_cache()
    wall("lm kernels (7)", t0)

    # ---- the paper backend, the baselines and the page table
    t0 = time.perf_counter()
    paper = paper_phase(m, win, card)
    wall("paper backend, baselines and page table (8)", t0)

    # ---- LM training: phase 8's tensors go first
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    trained = training_phase(win, card, root, r_arts["r3"])
    r_out["r3"] = trained["t1"].pop("r3")
    wall("lm training (t)", t0)
    r_wall = r_out["wait_s"] + sum(r_out[key]["seconds"]
                                   for key in ("r1", "r2", "r3"))
    log(f"[r] phase r wall {r_wall:.1f} s (budget {R_BUDGET_S} s; r1 "
        f"{r_out['r1']['seconds']:.1f}, r2 {r_out['r2']['seconds']:.1f}, "
        f"r3 {r_out['r3']['seconds']:.1f}, waiting for the dry runs "
        f"{r_out['wait_s']:.1f}); {card}")
    log("[r] summary " + json.dumps(r_out, default=str))
    if r_wall > R_BUDGET_S:
        fail(f"phase r took {r_wall:.1f} s, past its {R_BUDGET_S} s budget")
    log("[train] summary " + json.dumps(trained, default=str))
    log("[paper] summary " + json.dumps(paper, default=str))
    log("[lm] summary " + json.dumps({key: lm[key] for key in
                                      ("met", "replay", "decode_profile",
                                       "branches")}))
    log("[dense] summary " + json.dumps(dense, default=str))
    log("[families] summary " + json.dumps(families, default=str))
    log("[sharded] summary " + json.dumps(sharded, default=str))
    log("[drift] summary " + json.dumps(drifted, default=str))
    log("[migrate] summary " + json.dumps(migrated, default=str))
    log("[sharded re-flow] summary " + json.dumps(reflowed, default=str))
    log("[front end] summary " + json.dumps(
        {key: {leg: ({k: v for k, v in row.items()
                      if k not in ("dispatch", "reasons")}
                     if isinstance(row, dict) else row)
               for leg, row in val.items()} for key, val in fronted.items()},
        default=str))

    launches = dict(win.total)
    log(f"main-path launches (every window): {launches}")
    lookup_sizes = size_buckets(win.lookup_sizes)
    log(f"fused_lookup main-path launches by batch size: {lookup_sizes} "
        f"(exact sizes: {len(win.lookup_sizes)} distinct; "
        f"{win.lookup_sizes.get(BATCH, 0)} of {BATCH}, "
        f"{win.lookup_sizes.get(VERIFY_CHUNK, 0)} of {VERIFY_CHUNK})")
    nf_sizes = size_buckets(win.nf_sizes)
    log(f"nf_forward main-path launches by batch size: {nf_sizes} (exact "
        f"sizes: {dict(sorted(win.nf_sizes.items()))})")
    rows["nf_forward"]["launches_by_batch"] = nf_sizes
    on, off = look[True], look[False]
    rows["fused_lookup"] = {
        "name": "fused_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_lookup.cu",
        "replaces": "src/repro/kernels/fused_lookup.py:490",
        "launches": None,
        "max_abs_err": max(on["max_abs_err"], off["max_abs_err"],
                           look_tiers["max_abs_err_tiers"],
                           *(e[0] for e in err_tiers.values())),
        "ms": on["ms"], "plain_ms": on["plain_ms"],
        "bound_ms": on["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_warm_l2": on["ms_warm_l2"],
        "host_ms_per_call": on["host_ms_per_call"],
        "ms_verify_chunk": on["ms_verify_chunk"],
        "ms_warm_l2_verify_chunk": on["ms_warm_l2_verify_chunk"],
        **{key: v for key, v in look_tiers.items() if key.endswith("tiers")
           and not key.startswith("max_abs_err")},
        "launches_by_batch": lookup_sizes,
        **{f"{key}_flow_off": v for key, v in off.items()
           if key != "max_abs_err"},
    }
    rs = ranged[True]
    rows["fused_range_scan"] = {
        "name": "fused_range_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/range_scan.cu",
        "replaces": "src/repro/kernels/range_scan.py:232",
        "launches": None, "max_abs_err": max(rs["max_abs_err"], err_off),
        "ms": rs["ms"], "plain_ms": rs["plain_ms"],
        "bound_ms": rs["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "ms_warm_l2": rs["ms_warm_l2"],
        "host_ms_per_call": rs["host_ms_per_call"],
        "ratio_to_bound": rs["ratio_to_bound"],
    }
    son, soff = streamed[True], streamed[False]
    rows["streamed_lookup"] = {
        "name": "streamed_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/streamed_lookup.cu",
        "replaces": "src/repro/kernels/streamed_lookup.py:283",
        "launches": None,
        "max_abs_err": max(son["max_abs_err"], soff["max_abs_err"],
                           streamed_tiers["max_abs_err_tiers"],
                           *(e[1] for e in err_tiers.values())),
        "ms": son["ms"], "plain_ms": son["plain_ms"],
        "bound_ms": son["bound_ms"], "bound_by": "bytes", "library_ms": None,
        **{key: v for key, v in son.items()
           if key not in ("ms", "plain_ms", "bound_ms", "max_abs_err")},
        **{key: v for key, v in streamed_tiers.items()
           if key != "max_abs_err_tiers"},
        **{f"{key}_flow_off": v for key, v in soff.items()
           if key != "max_abs_err"},
    }
    log("streamed/fused kernel time, cold L2: longlat (flow on) "
        f"{son['streamed_over_fused']:.3f} fresh, "
        f"{streamed_tiers['streamed_over_fused_tiers']:.3f} with tiers; "
        f"lognormal (flow off) {soff['streamed_over_fused']:.3f} fresh")
    rows["index_probe"] = {
        "name": "index_probe", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/index_probe.cu",
        "replaces": "src/repro/kernels/index_probe.py:62",
        "launches": None, "max_abs_err": probe["max_abs_err"],
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "ms_warm_l2": probe["ms_warm_l2"],
        "host_ms_per_call": probe["host_ms_per_call"],
        "sectors_kernel": probe["sectors_kernel"],
    }
    rows.update(lm_rows)
    rows.update(fixture_rows)
    # the fixture kernels' main path is the checker's self-test (phase 1b)
    launches.update({name: row["launches"]
                     for name, row in fixture_rows.items()})
    out = []
    for row in rows.values():
        row["launches"] = launches.get(row["name"], 0)
        if row["launches"] <= 0:
            fail(f"{row['name']} was not launched on the main path")
        out.append(row)
    log(f"phase walls: {walls}")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
