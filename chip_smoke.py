#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the CUDA kernels from ``src/repro_torch/csrc`` (timed) and
   prints ``-Xptxas -v``'s registers and spills of both routes of
   ``fused_transform``, ``embedding_bag``, ``dense_unpack`` and
   ``ragged_gather``, and of ``sigrid_hash``.
3. Captures the data path's kernel operands from one stripe of the
   full-width ``dlrm-paper`` data path, holds each kernel bit-exact
   (``torch.equal``) against its plain PyTorch version on the card, and
   times kernel, plain version and, where one exists, the single PyTorch
   call computing the same function (device time and call time both from
   CUDA events: ``_queued_ms``, ``_call_ms``); ``fused_transform``,
   ``dense_unpack`` and ``ragged_gather`` by both routes, the route the
   engine's operands take and the general route.  Then holds each kernel
   (both routes where the new route takes the operands) bit-exact on
   adversarial inputs the main path never makes (NaN payloads, signed
   zeros, subnormals, extreme parameters, both tile layouts, rows 4k to
   4k+3, unsorted, tied, signed-zero, +inf and NaN border rows, aligned
   and unaligned views, bitmaps of 1 to 33 and 1,250 words with C of 1
   to above 32 W, all-absent and all-present features, every byte shift,
   non-consecutive, straddling and mixed-shift index pairs, the last word
   pair; for ``embedding_bag`` empty bags, duplicate ids, the
   last row, fractional weights, L of 0 to 300 and E of 1 to 1000,
   NaN/inf rows under a mask of
   0, subnormal rows, a table of more than 2^31 elements);
   ``xor_decrypt`` and ``torch.bitwise_xor`` again in turns, and the two
   routes of ``dense_unpack``, of ``ragged_gather`` and of
   ``fused_transform`` (at each wave) in turns.  Then the
   standalone ``sigrid_hash`` and ``bucketize`` (no path launches them)
   bit-exact at one batch's tiles and on adversarial inputs, and timed
   (``sigrid_hash`` also in turns beside ``torch.bitwise_xor``, which
   moves the same bytes, and at an 8-batch tile; ``bucketize`` also with
   tied, 5,000 sorted and 5,000 unsorted borders).
4. The serving path: serves every batch of the full-width ``dlrm-paper``
   DPP session through ``dlrm_dpp_batches(CONFIG, 512, device="cuda")``
   with the launch counts set to 0 just before, checks that every data
   path kernel launched (``fused_transform`` by its vec route only,
   ``dense_unpack`` and ``ragged_gather`` once a stripe by their warp and
   vec routes only), that
   the batches have the expected shapes and
   finite dense values, and that they are byte-identical (as a multiset:
   workers race) to the port's numpy-engine session on the same data;
   prints batches/s and rows/s.  Then the multi-tenant service
   (``_service_phase``) on the same table and spec: two tenants at once
   through ``DPPService.run_all`` over a shared stripe cache (2 workers
   each, torch engines on the card; each tenant's batches the numpy
   engines', storage reads at most 0.6 of two sessions', hit rate at
   least 0.5, per-tenant cache bytes adding up to the tiers', one
   ``dense_unpack_warp`` and one ``ragged_gather_vec`` launch a stripe a
   tenant and no general route); a second tenant served wholly from a
   shared ``TensorCache`` with no launch at all; and the traced two-tenant
   ``obs.smoke`` run on the card, its artifact passing
   ``obs.report --check``.  Prints a ``{"service": ...}`` line.  Then the
   invariant gate and sanitizers (``_sanitizer_phase``,
   ``repro_torch.analysis``): the static gate clean over its 13 rules with
   the empty ``scripts/analysis_baseline_torch.txt``; the same full-width
   session, and the service's two tenants, each run in turns
   uninstrumented and built and run inside the lock-order sanitizer and
   the lockset race detector (no cycle, no race, the numpy engines' batches, every
   data-path kernel launched in the window and no general route); and the
   interleaving explorer exhausting every control-plane scenario with
   ``device="cuda"``.  Prints a ``{"sanitizers": ...}`` line.
5. The trainer path: with the launch counts set to 0, serves the
   ``dlrm-paper`` session with its one cut (vocab 200,000 per table instead
   of 2,000,000: the store's host tier is numpy on the host) and trains 8
   steps of the tiered-store DLRM on its batches with ``Trainer(...,
   device="cuda")`` and ``kernel_bags=True``; checks that
   ``embedding_bag`` launched, by its warp route only, that every loss is
   finite, and that a CPU
   trainer (same batches, same tables) stepped in turn with a card
   trainer, loading the card's MLP weights and AdamW state before each
   step and taking the card's ReLU pattern (its pre-activations within
   1e-4 of their rms of the card's), gives every step's loss within rtol
   1e-4, and that after each
   step the card's AdamW mu, nu and grad norm are within 1e-4 (relative
   norm, leaf by leaf) of the CPU's and its parameters within 1e-5 of the
   float64 AdamW update of its own state; the lockstep card losses must
   equal the main run's.  Prints per-step times, steps/s, rows/s, the hot
   rate and the device idle share of a profiled run, then holds both
   routes of ``embedding_bag`` bit-exact against its plain version at the
   operands of that run's first fully-hot lookup and times them (and
   ``torch.nn.functional.embedding_bag`` as the library yardstick), in
   turns too; then the same at every bag of one step (21,504 bags of the
   first batch folded onto the same hot-slot table), not gated on time.
   Then checkpoint and restart (``_checkpoint_phase``):
   ``examples/torch/train_dlrm_e2e.py``'s ``dlrm-100m`` (102.6 M
   parameters) at its own size on the card, batch 256, 4 partitions x
   8,192 rows, 3 workers, 200 steps.  Phase 1 trains 100 steps into a
   fresh temporary checkpoint directory; checks that the newest complete
   step is 100 and the kept steps are ``keep``'s, that the step-100
   shard is within 1% of the bytes params, mu and nu take, and that every
   leaf read back from disk is byte-identical to the trainer's returned
   state.  Phase 2 restarts a fresh trainer on that directory with a
   fresh DPP session and checks that it resumes at step 101, ends at 200
   and ends with a loss below phase 1's first.  The launch counts are set
   to 0 before each session and read after it: each launches
   ``xor_decrypt``, ``dense_unpack_warp``, ``ragged_gather_vec`` and
   ``fused_transform_vec`` and no general route.  Prints a
   ``{"checkpoint": ...}`` line (shard bytes, each save's and the
   restore's seconds, each phase's steps/s and stall fraction, the first
   and last loss, the launches), and removes the directory.  Then the
   sharded DLRM step (``_sharded_phase``): ``dlrm-paper`` at full width
   and its full 2,000,000-row vocab (43 GB of tables) vocab-sharded on
   mesh (1, 4), four gloo ranks on the one card started by
   ``repro_torch.distributed.spawn`` (10.75 GB of tables each, CUDA
   tensors staged through pinned host memory for gloo), 8 steps of
   ``launch.steps.make_dlrm_sparse_train_step`` on the serving phase's 8
   batches; then the same 8 steps on mesh (1, 1), one NCCL rank holding
   the whole tables (the unsharded path).  The kernels are built in this
   process first; the ranks only load the library.  Checks each of the
   four ranks' counts (set to 0 before its steps, read after): 8
   ``embedding_bag_warp`` and 8 ``rowwise_adagrad`` launches and none on
   the block route, 8 ``rowwise_adagrad`` and nothing else on the one
   rank; the MLPs bit-identical and the losses equal across the four
   ranks; the one rank's MLP ReLUs keep exactly the units the four ranks'
   kept (their pre-activations recorded by rank 0), its own
   pre-activations within 1e-4 of their rms of the four ranks' at every
   step (a ReLU derivative jumps at 0, and a pre-activation within
   float32 rounding of 0 can fall on either side under the two sums'
   orders: the flips are counted and printed); their losses within rtol
   1e-5 of the one rank's at step 1 and 1e-4 after; the rows batch 1 touched and their accumulator entries,
   after step 1, each within rtol 1e-4, and every touched row after step
   8 within 1e-3 in relative norm (the trajectories may part at the 1e-5
   loss level, where rows with tiny, cancelling gradients move apart by
   percents); a seeded sample of untouched rows unchanged bit for bit.
   Prints steps/s (all 8 and after the first), each rank's peak device
   memory, the all_reduce of a (512, 42, 128) pooled tensor (CUDA
   events) and a ``{"sharded": ...}`` line.  Then the table-update kernel
   at the benchmark cell's shape (``_table_update_phase``: 4096 bags of
   42 tables of 32 slots over the full 2,000,000-row tables, Zipf 1.3 ids,
   83% pads): ``rowwise_adagrad`` against its plain version on the rows
   it touches (a compact copy, and float64 beside both), untouched rows
   unchanged, NaN where the plain version puts it, its device counters,
   its scratch beside the (N, E) gradient it never makes; adversarial
   batches (every slot of a table on one row, NaN and inf d(pooled) rows,
   all pads, the last row); its device time, the sort's, the parent's
   plain update's and its bound; a ``{"table_update": ...}`` line.  Then
   the paper's characterization models (host numpy only): Table 9 and Table
   7 from ``core/dpp/simulator.py``, Fig. 1's power split of each
   workload, ``coordination.simulate`` (60 days, seed 3) and the
   scheduler's ``replication_report``, held to the bands of
   ``tests/test_simulator.py`` and ``tests/test_extensions.py``; prints a
   ``{"characterization": ...}`` line.
6. The LM serving path (``_lm_serve_path``): with the launch counts set to 0,
   serves the full-width ``qwen3-8b`` (36 layers, d_model 4096, bf16,
   weights drawn on the card from seed 0) through
   ``repro_torch.launch.serve.serve``: batch 4, prompt 1024, 32 decode
   steps, cache 128.  Checks that the tensor-core ``flash_attention_sm90``
   launched once per layer of the prefill (36), the FMA route not once,
   and that the logits are finite; prints
   ``prefill_s``, ``decode_tok_per_s``, peak device memory and the device
   idle share of a profiled decode loop.  Then a full-width
   ``BatchingServer`` (4 slots, 4 requests of 16 prompt tokens and 8 new
   ones) and its ``latency_report``.
7. ``flash_attention`` against its plain version on the card: at q/k/v
   captured from layers 0 and 35 of that prefill (bf16 through both
   routes, the tensor-core one the path takes and the FMA one, and the
   same operands in float32 at the float32 tolerance), and on
   adversarial inputs through whichever route each takes (S of 1, 63, 65,
   127, 129, 1000; T != S; D of 32, 48, 64, 128; GQA groups 1, 4 and 8;
   float32 and bf16; the model's transposed views; scores of |s| ~ 1e4
   whose running max moves at every key tile); times both routes, the
   plain version and ``F.scaled_dot_product_attention`` beside the bound,
   the tensor-core route and SDPA again in turns.  Then a depth-2,
   full-width model from one set of weights on the card and on the CPU:
   logits within tolerance and greedy tokens equal, in float32 and bf16.
8. The SSM serving path (``_ssm_serve_path``): with the launch counts set
   to 0, serves the full-width ``mamba2-2.7b`` (64 layers, d_model 2560,
   80 heads, d_state 128, bf16, seed 0) through the same ``serve`` (batch
   4, prompt 1024 = 4 chunks, 32 decode steps); checks that the
   tensor-core ``ssd_chunk_forward_sm90`` launched once per layer (64),
   the FMA route not once, and nothing else, and that the logits are
   finite; prints ``prefill_s``,
   ``decode_tok_per_s``, peak memory, the bounds, and a profiled 4-step
   decode window; then a 4-slot ``BatchingServer``.  ``ssd_chunk_forward``
   against its plain version (the sequential float32 recurrence) at the
   scan operands of layers 0 and 63 (bf16 through both routes, float32
   through the FMA route, y and the final state) and on adversarial
   inputs through the route each takes (S from 1 to 1000 with ragged
   chunks, 1-8 groups, P and N of 16-128, chunks of 64-256, |cs| to 1e4,
   A = 0, an initial state; bf16 cases that must take the tensor-core
   route), both routes timed beside the bound and in turns.  Then a
   depth-2, full-width model from one set of weights on the card and on
   the CPU (prompt 512).
9. The LM families (``_lm_families_path``): with the earlier models
   freed and the launch counts set to 0, serves ``deepseek-v2-236b`` (MLA
   + MoE) at full width with its depth cut from 60 layers to 6 (24.9 B
   parameters, 49.8 GB, drawn on the card from seed 0) through the same
   ``serve`` (batch 4, prompt 1024, 32 decode steps, cache 128); checks
   6 launches of ``flash_attention``'s FMA route (MLA attends at D = 128
   + 64 = 192 with v padded from 128), none of the tensor-core route and
   nothing else, the MoE capacity (192 slots an expert at 4,096 tokens)
   and finite logits; prints ``prefill_s``, ``decode_tok_per_s`` and the
   peak; then a 4-slot ``BatchingServer``.  ``flash_attention`` at D =
   192 against its plain version at the q/k/v of layers 0 and 5 (bf16
   against the plain version in float32, float32 operands at the float32
   tolerance, the padded columns 0) and on adversarial inputs (D 129, 160,
   192 x S 1, 63, 65, 1000 x both types, groups 1 and 4, T != S, the
   model's views), timed beside its bound and SDPA.  Then a depth-1,
   full-width ``deepseek-v2-236b`` on the card against the CPU in float32
   and bf16 (routing recorded on both; every flip at a top-k margin under
   1e-5).  Then ``codeqwen1.5-7b`` and ``llava-next-mistral-7b`` whole,
   ``kimi-k2-1t-a32b`` at 1 layer, ``qwen2-72b`` and ``llama3-405b`` at
   4, all at full width: a prefill (1024 tokens; llava 3072, its 2,880
   image rows among them) and 8 decode steps at batch 1, one
   ``flash_attention_sm90`` launch a layer, finite logits.  Prints a
   ``{"lm_families": ...}`` line.
10. The hybrid and encoder-decoder families (``_hybrid_encdec_path``):
   with the earlier models freed, ``seamless-m4t-large-v2`` whole (24
   encoder and 24 decoder layers, d_model 1024, 16 heads of 64, 2.03 B
   parameters) and ``jamba-1.5-large-398b`` at every published width with
   one block of its 72 layers and 8 of its 16 experts (25.8 B parameters,
   51.6 GB: one block with all 16 is 90.3 GB), each drawn on the card from
   seed 0 and served through ``serve`` (batch 4, 32 decode steps, cache
   128; seamless' prompt 1024 frames and 128 decoder tokens, jamba's 1024
   tokens) with the launch counts set to 0 just before and read just
   after.  Checks exactly 72 ``flash_attention_sm90`` launches a seamless
   prefill (24 encoder and 24 cross calls full, 24 decoder calls causal,
   all at D = 64) and nothing else; exactly one ``flash_attention_sm90``
   and 7 ``ssd_chunk_forward`` (the FMA route: d_state 16) a jamba
   prefill and nothing else, its MoE capacity 1280; finite logits.  Then
   ``flash_attention_sm90`` at seamless' layer-0 encoder and cross
   operands and at jamba's attention, held to the plain version in
   float32, and the FMA ``ssd_chunk_forward`` at jamba's layer-0 scan
   held to the sequential recurrence within ``SSD_TOL``, each timed
   beside its bound (and SDPA for attention).  Then float32 models on the
   card against the CPU: seamless at full width with 2 + 2 layers and
   jamba's SMOKE, a prefill and 3 decode steps, logits within 1e-3 of
   their rms, every routing flip at a top-k margin under 1e-5.  Prints a
   ``{"hybrid_encdec": ...}`` line.
11. LM training (``_lm_train_path``): a DWRF token corpus
   (``core.tokens.build_corpus``: 3 partitions of 96 documents at
   ``qwen3-8b``'s vocab) read whole through ``lm_batches_from_table(...,
   decode_engine="torch")`` with the counts set to 0: one ``xor_decrypt``
   and one ``ragged_gather_vec`` launch a stripe, the scalar route never,
   every batch byte-identical to the numpy engine's.  Then ``qwen3-8b`` at
   full width with its depth cut from 36 layers to 4 (2.02 B parameters;
   AdamW's state beside them) trained 6 steps at batch 2 x 4096 by
   ``Trainer.fit`` fed live by the same reader, counts set to 0 just
   before and read just after: no ``flash_attention*`` or ``ssd_chunk*``
   launch (forward-only kernels: training attends through the plain
   ``_Flash``), the decode kernels launched, finite losses and grad
   norms; step times by CUDA events, tokens/s, peak memory, the stall
   fraction and the model FLOPs' share of the bf16 peak.  Then the
   attention's share of a step (``_Flash`` beside SDPA at the step's
   operands), ``_Flash`` at (1, 1024, 32, 128) over 8 KV heads in bf16
   against float64 on the card (2e-2 in relative norm) and one narrow
   float32 training step on the card against the CPU and float64.
   Prints a ``{"lm_train": ...}`` line.
12. Prints one JSON line with every kernel's numbers (twenty: the nine
   TPU kernels' ports, ``fused_transform``, ``dense_unpack``,
   ``ragged_gather``, ``embedding_bag``, flash attention and the SSD scan
   by both of their routes, flash attention's FMA route again at MLA's D
   = 192, its tensor-core route at seamless' D = 64 full and cross
   operands and at jamba's attention, and the SSD scan's FMA route at
   jamba's N = 16), the card's line,
   and last the result line
   ``{"ok": true, "device": {...}}``.

The device's busy time and idle share in steps 4-6 and 8 come from
torch.profiler; where it records no device activity they print as not
measured (null in the JSON), and nothing else depends on it.

Float32 matrix products run in full float32 (TF32 is switched off for
both matmul and cuDNN).

Any failure raises, so the script exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 dense tensor-core peak
BATCH = 512
# the trainer path's one cut: the store's host tier is numpy on the host,
# 43 GB at 2M rows per table; the card's work is the same at either vocab
TRAIN_VOCAB = 200_000
TRAIN_STEPS = 8
HOT_ROWS = 1024
# the trainer's lockstep check, per leaf: the card's mu, nu and grad norm
# against the CPU's after one step from the same state, and the card's
# parameters against the float64 AdamW update of its own state (float32
# rounding of the update is ~3e-7 of it; an update 1% off moves weights by
# more than 1e-5 of their norm)
LOCKSTEP_RTOL = 1e-4
UPDATE_RTOL = 1e-5
# the LM serving path: launch/serve.py's flags at full qwen3-8b width
LM_BATCH, LM_PROMPT, LM_DECODE, LM_CACHE = 4, 1024, 32, 128
LM_CAPTURE_LAYERS = (0, 35)
# flash_attention against its plain version: the reference's own sweep
# (tests/test_kernels.py) holds its Pallas kernel to its dense oracle
# within atol = rtol = 2e-5 (float32) and 2e-2 (bf16) on unit-normal
# operands.  Attention is linear in v, so on operands whose v has another
# scale the same bound applies to out / rms(v).
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the SSM serving path: mamba2-2.7b at full width, the same serve flags
SSM_CAPTURE_LAYERS = (0, 63)
# ssd_chunk_forward against its plain version (the sequential float32
# recurrence), per element within atol * rms(want) + rtol * |want|: float32
# the reference's own SSD sweep (tests/test_kernels.py: atol 5e-4, rtol
# 1e-3 against its sequential oracle), applied in units of rms(want); bf16
# 2e-2 of both, as the flash_attention sweep's bf16 bound (the kernel
# rounds m to bf16 before m.x, 2^-9 relative a term, and y to bf16).  The
# final state is float32 in both types and held to the float32 bound.
SSD_TOL = {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 2e-2)}
# the LM families phase: deepseek-v2-236b at full width with its depth cut
# from 60 layers to 6 (6 x 7.94 GB of bf16 layers and 2.1 GB of
# embeddings fit one card), served with the LM path's flags; MLA's
# prefill attends at D = 128 + 64 with v padded from 128
FAM_LAYERS = 6
FAM_CAPTURE_LAYERS = (0, 5)
FAM_CAPACITY = 192            # slots an expert: 4,096 tokens x top 6 x 1.25 / 160
MLA_QK_DIM, MLA_V_DIM = 192, 128
FAM_CPU_DECODE = 3            # decode steps of the depth-1 card-vs-CPU check
ROUTE_FLIP_MARGIN = 1e-5      # a routing flip between card and CPU must sit below this
# the five other configs at full width: (arch, layers kept or None for all
# of them, prompt); llava's prompt holds its 2,880 image rows
FAM_OTHERS = (("codeqwen1.5-7b", None, 1024), ("llava-next-mistral-7b", None, 3072),
              ("kimi-k2-1t-a32b", 1, 1024), ("qwen2-72b", 4, 1024), ("llama3-405b", 4, 1024))
FAM_OTHER_DECODE = 8
# the hybrid and encoder-decoder phase: seamless-m4t-large-v2 whole, its
# prompt 1024 frames (the decoder's 128 tokens); jamba-1.5-large-398b at
# every published width, one block of 8 layers, 8 of its 16 experts (one
# block with 16 is 90.26 GB of bf16, with 8 51.61 GB)
ENCDEC_FRAMES = 1024
JAMBA_EXPERTS = 8
JAMBA_CAPACITY = 1280         # slots an expert: 4,096 tokens x top 2 x 1.25 / 8
# the LM training phase: qwen3-8b at every published width, its depth cut
# from 36 layers to 4 (PERF.md section 4: ~2.0 B parameters, bf16 weights
# and gradients plus float32 AdamW moments and the update's copies ~60 GB),
# batch 2 at seq 4096 (the reference's SHAPES["train_4k"]), 6 steps from a
# DWRF token corpus of 3 partitions of 96 documents read through the decode
# kernels
LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 4, 2, 4096, 6
LM_TRAIN_PARTITIONS, LM_TRAIN_DOCS = 3, 96
LM_TRAIN_OPT = dict(learning_rate=3e-4, warmup_steps=2, total_steps=LM_TRAIN_STEPS)
# one step on the card against the CPU: a narrow qwen3 in float32 whose
# chunks divide seq 256 into 4 attention blocks and 4 logit chunks
LM_TRAIN_NARROW = dict(num_layers=2, d_model=256, vocab_size=2048, attn_chunk=64,
                       attn_k_chunk=64, logit_chunk=64)
LM_TRAIN_NARROW_SEQ = 256
# the attention backward alone at qwen3-8b's head shape: q (1, 1024, 32,
# 128) over 8 KV heads, bf16, in 256-row q and 512-row k blocks; dq, dk and
# dv within 2e-2 of a float64 run's rms in relative norm (the reference
# kernel sweep's bf16 bound)
FLASH_BWD_Q, FLASH_BWD_KV_HEADS, FLASH_BWD_CHUNKS = (1, 1024, 32, 128), 8, (256, 512)
FLASH_BWD_TOL = 2e-2
# the kernels a training step must not launch: forward-only, they return
# no log-sum-exp for a backward
FORWARD_ONLY_KERNELS = ("flash_attention", "flash_attention_sm90", "ssd_chunk_forward",
                        "ssd_chunk_forward_sm90")
# its float32 card-vs-CPU check against a float64 model of the same weights:
# the card within CARD_CPU_TOL of the logits' rms, or within F32_ERR_FACTOR
# times the CPU float32 model's own distance where that is larger (two
# float32 sums in other orders, each off the float64 one by its own draw)
CARD_CPU_TOL = 1e-3
F32_ERR_FACTOR = 3
# the LM families' training phase, bf16, seed 0, remat, LM_TRAIN_OPT's
# AdamW, 6 steps of batch 2: mamba2-2.7b at every published width, its
# depth cut from 64 layers to 16 (PERF.md section 4: 900,815,104
# parameters; 64 reckon to ~70-74 GB at the 24.5 B a parameter measured
# for qwen3; 32, PR 27's cut, took ~30 s more of a script that the
# sharded LM phase took past 900 s), on 4096-token rows from the DWRF
# token corpus; seamless-m4t-
# large-v2 whole (2,034,784,256 parameters) on 4096 frames and 512 decoder
# tokens a row from lm_synthetic_batches
MAMBA_TRAIN_LAYERS = 16
SSM_MATMULS = ("wz", "wx", "wB", "wC", "wdt", "out")    # a mixer's matrix products
# the SSD backward alone at mamba2-2.7b's layer shape, bf16: y and the
# gradients of x, dt, A, B and C within 2e-2 of a float64 run's in relative
# norm, as _Flash is held (FLASH_BWD_TOL)
SSD_BWD_X, SSD_BWD_N, SSD_BWD_CHUNK = (2, 4096, 80, 64), 128, 256
# one step on the card against the CPU, float32: mamba2 at 2 layers, d_model
# 256 and chunk 64 on 256 tokens (4 chunks), and the SMOKE configs of
# jamba (attention, SSM and MoE in one block), seamless and deepseek-v2
# (MoE and MLA).  The init takes a stack's length as the fan-in of every
# "scaled" leaf, as the reference's does: a router's softmax saturates and
# ties top-k probabilities within 1e-9, and without qk_norm the attention
# scores reach ~60, a one-hot softmax whose float32 gradients sit 4e-3 to
# 8e-3 from float64 on either device.  So, as the CPU tests do, routers are
# scaled by 0.1 and, where the config has no qk_norm, wq and wk by 1/8
MAMBA_TRAIN_NARROW = dict(num_layers=2, d_model=256, vocab_size=2048)
MAMBA_TRAIN_NARROW_CHUNK = 64
TRAIN_ROUTER_SCALE, TRAIN_QK_SCALE = 0.1, 0.125
# the data-path kernels every DPP session launches on the card, and the
# general routes of three of them, which no engine operand takes
DATA_PATH_KERNELS = ("xor_decrypt", "dense_unpack_warp", "ragged_gather_vec",
                     "fused_transform_vec")
GENERAL_ROUTES = ("fused_transform", "dense_unpack", "ragged_gather")
# the checkpoint phase: examples/torch/train_dlrm_e2e.py's own step count
CKPT_STEPS = 200
# the sharded DLRM step: dlrm-paper at its full 2,000,000-row vocab, vocab-
# sharded over four gloo ranks on the one card, against one NCCL rank
SHARDED_MESH = (1, 4)
SHARDED_SEED = 5
SHARDED_OPT = dict(warmup_steps=1)          # lr 3e-4; the tables move by lr * 10
SHARDED_SAMPLE = 64           # untouched rows sampled per table and rank
SHARDED_TIMEOUT_S = 400       # each spawn's join
# losses of the four ranks against the one: float32 sums in another order
SHARDED_LOSS_RTOL = (1e-5, 1e-4)   # step 1, steps 2-8
SHARDED_ROW_TOL = dict(rtol=1e-4, atol=1e-6)    # touched rows after step 1
SHARDED_NORM_RTOL = 1e-3      # touched rows after step 8, in relative norm
# the sharded LM step: deepseek-v2-236b at every published width (d_model
# 5120, 128 heads, MLA ranks q 1536 / kv 512, qk 128 + 64, v 128, expert
# d_ff 1536, top 6, 2 shared experts of d_ff 3072, vocab 102,400), bf16,
# remat, seed 0, its depth cut to 1 of 60 layers and its experts to 32 of
# 160 (PERF.md section 4: 2.00 B parameters; whole on one rank ~24 GB of
# weights, gradients and moments and ~20 GB of AdamW's copies; 64 experts
# would add ~7 GB a rank of the four), on mesh (2, 2) over ("data",
# "model"): four gloo ranks on the one card, each holding its TRAIN_RULES
# slices and 16 experts; 3 steps of 4 rows x 1024 tokens (2 rows a data
# rank), then a prefill of 4 x 1024 and one decode step under SERVE_RULES;
# the same on mesh (1, 1), one NCCL rank
# the table-update kernel at the benchmark cell's shape (dlrm-paper.train.b4096)
TABLE_UPDATE_BATCH = 4096
TABLE_UPDATE_LIVE = 0.17      # live slots of a DPP batch of the cell: ~950k of 5.5M
# kernel against the plain version on the same rows: each changed row
# within this share of the largest change, each accumulator entry within
# this rtol -- both sum the same float32 terms in another order (the
# plain version's index_add_ atomics in the hardware's), up to 131,072 of
# them into one row here
TABLE_UPDATE_TOL = 1e-4
TABLE_UPDATE_SAMPLE = 1 << 16     # untouched rows sampled, unchanged bit for bit
SHARDED_LM_MESH = (2, 2)
SHARDED_LM_LAYERS, SHARDED_LM_EXPERTS = 1, 32
SHARDED_LM_BATCH, SHARDED_LM_SEQ, SHARDED_LM_STEPS = 4, 1024, 3
SHARDED_LM_OPT = dict(warmup_steps=1)
SHARDED_LM_SEED = 0
# the training attention (the plain _Flash) in blocks of 256 query rows,
# not the config's 1024: a lowering knob (online softmax, the same values
# to rounding) that cuts each rank's float32 score blocks from 1 GiB to
# 256 MiB; at 1024 the four ranks' peaks of 17.2 GB and the script's own
# process ran the card out of memory in a full run
SHARDED_LM_ATTN_CHUNK = 256
SHARDED_LM_DECODE_EXTRA = 8   # cache positions past the prompt for the decode step
SHARDED_LM_TIMEOUT_S = 400    # each spawn's join
# bounds of the four ranks against the one, stated before the first run:
# bf16 activations rounded in other orders (partial expert sums added by
# the all-reduce, 2 rows a rank against 4 in one matrix product), each
# rounding 2^-8 of its value, and the MoE aux loss of each data shard's
# tokens against all tokens' (its coefficient 0.01)
SHARDED_LM_LOSS_RTOL = 2e-2   # each step's loss
SHARDED_LM_NORM_RTOL = 5e-2   # each step's grad norm
SHARDED_LM_LOGIT_RTOL = 2e-2  # prefill and decode logits, relative norm
# the SMOKE check: deepseek-smoke (8 experts, remat) in float32, the same
# steps on the card and on the CPU on meshes (2, 2) and (1, 4), 3 steps of
# 4 x 64 tokens from seed 2; routers scaled by TRAIN_ROUTER_SCALE
SHARDED_LM_SMOKE_MESHES = ((2, 2), (1, 4))
SHARDED_LM_SMOKE_BATCH, SHARDED_LM_SMOKE_SEQ, SHARDED_LM_SMOKE_SEED = 4, 64, 2
# the losses, step 1's grad norm and the slices after step 1 within 1e-4
# (relative; slices rtol and atol); later grad norms within 1e-3 and the
# slices within 1e-4 plus 2 lr a step: AdamW moves an element by about lr
# whatever its gradient's size, so float32 noise in a near-zero gradient
# (an embedding row whose uses cancel) turns into lr-sized differences
SHARDED_LM_SMOKE_TOL = 1e-4
SHARDED_LM_SMOKE_LATER_NORM_RTOL = 1e-3
# the launch tooling phase: three production cells dry-run on the (16, 16)
# VirtualMesh (launch/dryrun.py), each in a process of its own beside the
# card's work; the LM training phase's qwen3-8b step (LM_TRAIN_*) and the
# serving phase's whole qwen3-8b prefill (LM_BATCH x LM_PROMPT) traced on
# the card (launch/hlo_analysis.py) and held to their meta dry runs: flops
# identical, bytes within TOOLING_BYTES_RTOL (the same ops on both
# devices), the card's peak memory within TOOLING_PEAK_RTOL of the dry
# run's total; the sharded LM phase's step-1 collectives equal to its
# (2, 2) dry run's
TOOLING_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "prefill_32k"),
                 ("deepseek-v2-236b", "train_4k"))
TOOLING_TIMED = 3             # untraced steps and prefills timed after the traced one
TOOLING_BYTES_RTOL = 1e-2
TOOLING_PEAK_RTOL = 0.2
TOOLING_DRYRUN_TIMEOUT_S = 300
# the paper's Table 9 (tests/test_simulator.py): DPP worker throughput and
# workers per trainer of RM1-RM3 on C-v1, held within 8% (12% for wpt)
TABLE9 = {
    "RM1": dict(kqps=11.6, rx=0.8, trx=1.37, tx=0.68, wpt=24.2),
    "RM2": dict(kqps=8.0, rx=1.2, trx=0.96, tx=0.50, wpt=9.4),
    "RM3": dict(kqps=36.9, rx=0.8, trx=1.01, tx=0.22, wpt=55.2),
}
# kernels whose registers and spills the build prints on their own lines
PTXAS_KERNELS = ("fused_transform_kernel", "fused_transform_vec_kernel",
                 "embedding_bag_kernel", "embedding_bag_warp_kernel",
                 "dense_unpack_kernel", "dense_unpack_warp_kernel",
                 "ragged_gather_kernel", "ragged_gather_vec_kernel",
                 "sigrid_hash_kernel", "rowwise_adagrad_keys_kernel",
                 "rowwise_adagrad_rows_kernel", "rowwise_adagrad_carry_kernel")


def _setup():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py: src/repro_torch not found beside this script")
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    return torch, card


def _ptxas_summary(text: str, names) -> list:
    """One line a kernel instantiation of ``nvcc -Xptxas -v``'s output whose
    mangled name holds one of ``names``: its registers and spills."""
    out, fn, props = [], None, []
    for line in text.splitlines() + ["ptxas info    : Compiling entry function '' for"]:
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            if fn and any(n in fn for n in names):
                out.append(f"{fn}: " + "; ".join(props))
            fn, props = m.group(1), []
        elif fn and ("spill" in line or "registers" in line):
            props.append(line.split(":", 1)[-1].strip())
    return out


def _digest(batch) -> str:
    import numpy as np

    h = hashlib.sha256()
    for k in sorted(batch):
        a = np.ascontiguousarray(batch[k])
        h.update(f"{k}|{a.dtype}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _call_ms(torch, fn, iters: int = 200) -> float:
    """Time per call of back-to-back calls, CUDA events around the run:
    what a caller pays, launch and host overhead included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _queued_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call, from CUDA events around ``iters`` calls that
    the host queues while the stream is held by a sleep kernel, so the
    calls run back to back on the device whatever their host cost.  The
    sleep starts at about twice the host's queueing time; where it ends
    before the host has queued every call (the sleep was short, or the
    launch queue filled), it doubles and fewer calls are queued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    cycles = max(10 ** 8, int(4e9 * host_s))    # ~2 GHz: 10**8 cycles ~50 ms
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()          # the sleep outlasted the queueing
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        cycles *= 2
        iters = max(1, iters // 2)
    raise RuntimeError("the host could not queue the calls ahead of the device")


def _device_by_name(torch, prof):
    """Device time (us) of a profiler run by kernel or copy name, and the
    number of device kernels and copies it recorded.  ``({}, 0)`` where the
    profiler recorded no device activity: CUPTI tracing is not open to
    every process on every machine, so the busy times and idle shares read
    from it are then reported as not measured (null), and no check or
    kernel time rests on it."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name, count = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == cuda and ev.self_device_time_total > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + ev.self_device_time_total
            count += ev.count
    return by_name, count


def _warm_profiler(torch) -> None:
    """One throwaway torch.profiler session on a small op.  The first
    session of a process can record no device activity, and it stalls the
    host while CUPTI starts (a profiled DPP session then ran 7x slower and
    re-served splits whose leases ran out), so it is taken before any
    measured one."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(10):
            x = x * 1.0
        torch.cuda.synchronize()


def _idle_share(busy_s, wall_s):
    return None if busy_s is None else 1 - busy_s / wall_s


def _fmt(x, spec: str) -> str:
    return "not measured" if x is None else format(x, spec)


def _capture_operands(torch):
    """Every kernel's operands as the main path builds them for its first
    stripe (partition 0, rows [0, 512))."""
    import numpy as np

    from repro_torch.core.decode import TorchDecodeEngine
    from repro_torch.core.engine import TorchEngine
    from repro_torch.core.reader import TableReader
    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.launch.train import dlrm_dpp_table

    class CaptureDecode(TorchDecodeEngine):
        def __init__(self):
            super().__init__("cuda")
            self.operands = {}
            self._kernel = None

        def _to_device(self, a):
            t = super()._to_device(a)
            self.operands.setdefault(self._kernel, []).append(t.clone())
            return t

        def _xor(self, buf, n):
            self._kernel = "xor_decrypt"
            return super()._xor(buf, n)

        def _dense_launch(self, rows, bm, vals_list):
            self._kernel = "dense_unpack"
            return super()._dense_launch(rows, bm, vals_list)

        def _gather_launch(self, pool, requests):
            self._kernel = "ragged_gather"
            return super()._gather_launch(pool, requests)

    class CaptureTransform(TorchEngine):
        def __init__(self, pipeline):
            super().__init__(pipeline, "cuda")
            self.waves = []

        def _launch(self, mat, codes, p0, p1, borders):
            self.waves.append(tuple(
                torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in (mat, codes, p0, p1, borders)
            ))
            return super()._launch(mat, codes, p0, p1, borders)

    table, spec = dlrm_dpp_table(CONFIG, BATCH)
    decode = CaptureDecode()
    reader = TableReader(table, list(spec.feature_ids), record_popularity=False,
                         decode_engine=decode)
    meta = table.partitions[0]
    stripe = next(reader.iter_stripes(meta, 0, BATCH))
    transform = CaptureTransform(spec.pipeline())
    transform.run(stripe.batch)
    if sorted(decode.operands) != ["dense_unpack", "ragged_gather", "xor_decrypt"]:
        raise RuntimeError(f"decode captured {sorted(decode.operands)}")
    if len(transform.waves) != 2:
        raise RuntimeError(f"expected 2 transform waves, captured {len(transform.waves)}")
    return decode.operands, transform.waves


def _kernel_checks(torch, operands, waves):
    """Bit-exactness and times of each kernel against its plain version."""
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import fused_transform as kft
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import kernel_bound

    # bounds: launch.roofline.kernel_work's bytes (each input read once and
    # each output written once) and operations (~12 integer ops per hashed,
    # clamped or bucketized element, one compare per border for BUCKETIZE_F)

    cases = []
    (words,) = operands["xor_decrypt"]
    cases.append(dict(
        name="xor_decrypt", source="src/repro_torch/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:49",
        kernel=lambda: kdecode.xor_decrypt(words), plain=lambda: ref.xor_decrypt(words),
        library=lambda: torch.bitwise_xor(words, ref.XOR_KEY32),
        bound=kernel_bound("xor_decrypt", words),
        shape=f"words {tuple(words.shape)}",
    ))
    # dense_unpack and ragged_gather by both routes each: the route the
    # engine's operands take and the general route on the same operands
    bm, vals = operands["dense_unpack"]
    src, idx, sh = operands["ragged_gather"]
    if kdecode.dense_unpack_route(bm) != "warp":
        raise RuntimeError(f"the main path's bitmap {tuple(bm.shape)} does not take the warp route")
    if kdecode.ragged_gather_route(idx, sh) != "vec":
        raise RuntimeError(f"the main path's idx {tuple(idx.shape)} does not take the vec route")
    for name, kernel_route, fn in (("dense_unpack_warp", "warp", kdecode.dense_unpack_warp),
                                   ("dense_unpack", "block", kdecode.dense_unpack_block)):
        cases.append(dict(
            name=name, kernel_route=kernel_route, source="src/repro_torch/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:87",
            kernel=lambda fn=fn: fn(bm, vals),
            plain=lambda: ref.dense_unpack(bm, vals), library=None,
            bound=kernel_bound("dense_unpack", bm, vals),
            shape=f"bitmap {tuple(bm.shape)} values {tuple(vals.shape)}",
        ))
    for name, kernel_route, fn in (("ragged_gather_vec", "vec", kdecode.ragged_gather_vec),
                                   ("ragged_gather", "scalar", kdecode.ragged_gather_scalar)):
        cases.append(dict(
            name=name, kernel_route=kernel_route, source="src/repro_torch/csrc/decode.cu",
            replaces="src/repro/kernels/decode.py:125",
            kernel=lambda fn=fn: fn(src, idx, sh),
            plain=lambda: ref.ragged_gather(src, idx, sh), library=None,
            bound=kernel_bound("ragged_gather", src, idx, sh),
            shape=f"src {tuple(src.shape)} idx {tuple(idx.shape)}",
        ))
    # fused_transform by both routes at each wave: the 16-byte-lane route
    # the engine's tiles take, and the general route on the same operands
    ft_routes = (("fused_transform_vec", "vec", kft.fused_transform_vec),
                 ("fused_transform", "scalar", kft.fused_transform_scalar))
    for w, (mat, codes, p0, p1, brd) in enumerate(waves):
        if kft.route(mat, features_major=True) != "vec":
            raise RuntimeError(f"wave {w}'s tile {tuple(mat.shape)} does not take the vec route")
        present = sorted(set(codes.tolist()))
        for name, kernel_route, fn in ft_routes:
            cases.append(dict(
                name=name, kernel_route=kernel_route, wave=w,
                source="src/repro_torch/csrc/fused_transform.cu",
                replaces="src/repro/kernels/fused_transform.py:81",
                kernel=(lambda fn=fn, mat=mat, codes=codes, p0=p0, p1=p1, brd=brd:
                        fn(mat, codes, p0, p1, brd, features_major=True)),
                plain=(lambda mat=mat, codes=codes, p0=p0, p1=p1, brd=brd:
                       ref.fused_transform(mat.T, codes, p0, p1, brd).T),
                library=None,
                bound=kernel_bound("fused_transform", mat, codes, p0, p1, brd,
                                   features_major=True),
                shape=f"tile {tuple(mat.shape)} nb {brd.shape[1]} codes {present}",
            ))

    rows = []
    for c in cases:
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"{c['name']}: kernel disagrees with its plain version")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        if c["library"] is not None and not torch.equal(c["library"](), want):
            raise RuntimeError(f"{c['name']}: library call disagrees with the plain version")
        ms = _queued_ms(torch, c["kernel"])
        plain_ms = _queued_ms(torch, c["plain"], iters=5)
        library_ms = _queued_ms(torch, c["library"]) if c["library"] else None
        call_ms = _call_ms(torch, c["kernel"])
        plain_call_ms = _call_ms(torch, c["plain"], iters=20)
        library_call_ms = _call_ms(torch, c["library"]) if c["library"] else None
        bound_ms, bound_by = c["bound"][:2]
        rows.append(dict(
            name=c["name"], wave=c.get("wave"), shape=c["shape"],
            route="cuda", **({"kernel_route": c["kernel_route"]} if "kernel_route" in c else {}),
            source=c["source"], replaces=c["replaces"],
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, call_ms=call_ms, plain_call_ms=plain_call_ms,
            library_call_ms=library_call_ms,
        ))
        print(f"[kernel] {c['name']}{'' if c.get('wave') is None else ' wave ' + str(c['wave'])}"
              f" {c['shape']}: bit-exact, kernel_ms={ms:.6f} plain_ms={plain_ms:.6f}"
              f" library_ms={library_ms} bound_ms={bound_ms:.6f}"
              f" call_ms={call_ms:.6f} plain_call_ms={plain_call_ms:.6f}"
              f" library_call_ms={library_call_ms}", flush=True)
    # xor_decrypt and torch.bitwise_xor in turns: is the kernel's gap to the
    # library call outside the spread of either?
    xor = cases[0]
    turns = {"kernel": [], "library": []}
    for _ in range(3):
        turns["kernel"].append(_queued_ms(torch, xor["kernel"]))
        turns["library"].append(_queued_ms(torch, xor["library"]))
        turns["library"].append(_queued_ms(torch, xor["library"]))
        turns["kernel"].append(_queued_ms(torch, xor["kernel"]))
    rows[0]["turns_ms"] = turns
    print(f"[kernel] xor_decrypt and torch.bitwise_xor in turns: {json.dumps(turns)}",
          flush=True)
    # dense_unpack's and ragged_gather's two routes in turns (new, general,
    # general, new), three times
    for new_name, general_name in (("dense_unpack_warp", "dense_unpack"),
                                   ("ragged_gather_vec", "ragged_gather")):
        new_c, general_c = (next(c for c in cases if c["name"] == n)
                            for n in (new_name, general_name))
        turns = {new_name: [], general_name: []}
        for _ in range(3):
            turns[new_name].append(_queued_ms(torch, new_c["kernel"]))
            turns[general_name].append(_queued_ms(torch, general_c["kernel"]))
            turns[general_name].append(_queued_ms(torch, general_c["kernel"]))
            turns[new_name].append(_queued_ms(torch, new_c["kernel"]))
        next(r for r in rows if r["name"] == new_name)["turns_ms"] = turns
        print(f"[kernel] {new_name} and {general_name} {new_c['shape']} in turns "
              f"{json.dumps(turns)}", flush=True)
    # fused_transform's two routes at each wave in turns (vec, scalar,
    # scalar, vec), three times
    for w in range(len(waves)):
        vec, scalar = (next(c for c in cases if c["name"] == n and c.get("wave") == w)
                       for n, _, _ in ft_routes)
        turns = {"fused_transform_vec": [], "fused_transform": []}
        for _ in range(3):
            turns["fused_transform_vec"].append(_queued_ms(torch, vec["kernel"]))
            turns["fused_transform"].append(_queued_ms(torch, scalar["kernel"]))
            turns["fused_transform"].append(_queued_ms(torch, scalar["kernel"]))
            turns["fused_transform_vec"].append(_queued_ms(torch, vec["kernel"]))
        next(r for r in rows if r["name"] == "fused_transform_vec"
             and r["wave"] == w)["turns_ms"] = turns
        print(f"[kernel] fused_transform wave {w} {vec['shape']}: vec and scalar routes in "
              f"turns {json.dumps(turns)}", flush=True)
    # one entry per kernel: fused_transform's two waves (both launched for
    # every stripe) add up, and keep their own numbers under "waves"
    results = []
    for r in rows:
        same = [q for q in results if q["name"] == r["name"]]
        if not same:
            results.append(dict(r, waves=[dict(r)] if r["wave"] is not None else None))
            continue
        q = same[0]
        for k in ("ms", "plain_ms", "bound_ms", "call_ms", "plain_call_ms"):
            q[k] += r[k]
        q["max_abs_err"] = max(q["max_abs_err"], r["max_abs_err"])
        q["shape"] += "; " + r["shape"]
        q["waves"].append(dict(r))
    for q in results:
        q.pop("wave")
        if q["waves"] is None:
            q.pop("waves")
        else:
            q.pop("turns_ms", None)       # each wave keeps its own
    return results


def _adversarial_checks(torch) -> None:
    """Each kernel against its plain version on inputs the main path never
    makes: every op code with NaN payloads, signed zeros, subnormals and
    extreme parameters in both tile layouts, bitmaps of many 256-word
    chunks with too few values, every byte shift, odd sizes."""
    import numpy as np

    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import fused_transform as kft
    from repro_torch.kernels import ref

    i32 = (-(2 ** 31), 2 ** 31 - 1)
    bits = lambda v: int(np.float32(v).view(np.int32))
    cuda = lambda a, dt=torch.int32: torch.from_numpy(np.ascontiguousarray(a)).to(
        device="cuda", dtype=dt)

    def lanes(rng, n, floats):
        if floats:
            v = (rng.standard_normal(n) * 100).astype(np.float32).view(np.int32).copy()
            special = [bits(x) for x in (np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                                         1e-40, -1e-42)] + [0x7FC00001, 0x7F800001]
        else:
            v = rng.integers(*i32, n, dtype=np.int64).astype(np.int32)
            special = [i32[0], i32[1], 0, -1]
        special = np.array(special, np.int64).astype(np.int32)
        k = min(n, 3 * len(special))
        v[rng.choice(n, k, replace=False)] = np.resize(special, k)
        return v

    params = {
        ref.OP_IDENTITY: [(0, 0)],
        ref.OP_SIGRID_HASH: [(7, 33), (i32[1], i32[1] - 1), (0, 0), (-5, -1)],
        ref.OP_POSITIVE_MODULUS: [(0, 13), (0, i32[1]), (0, 0), (0, -7)],
        ref.OP_CLAMP: [(-50, 50), (50, -50), i32],
        ref.OP_BUCKETIZE: [(-100, 10), (i32[1], 1), (i32[0], 3), (5, 0), (5, -9)],
        ref.OP_CLAMP_F: [(bits(a), bits(b)) for a, b in (
            (-1.0, 1.0), (1.0, -1.0), (-0.0, 0.0), (0.0, -0.0), (np.nan, 2.0),
            (-2.0, np.nan), (1e-40, 1.0))],
        ref.OP_BUCKETIZE_F: [(0, 0)] * 3,
        9: [(0, 0)],                       # unknown codes pass through
    }
    def ft_check(label, mat, c, a, b, bd):
        """The features-major tile through the route it takes and, where that
        is the vec route, through the general route too; then rows-major
        (the general route), with and without borders."""
        rm = mat.T.contiguous()
        want_fm = ref.fused_transform(rm, c, a, b, bd).T
        fm = [kft.fused_transform(mat, c, a, b, bd, features_major=True)]
        vec = kft.route(mat, features_major=True) == "vec"
        if vec:
            fm += [kft.fused_transform_vec(mat, c, a, b, bd, features_major=True),
                   kft.fused_transform_scalar(mat, c, a, b, bd, features_major=True)]
        for got, want in [(g, want_fm) for g in fm] + [
            (kft.fused_transform(rm, c, a, b, bd), ref.fused_transform(rm, c, a, b, bd)),
            (kft.fused_transform(rm, c, a, b), ref.fused_transform(rm, c, a, b)),
        ]:
            if not torch.equal(got, want):
                raise RuntimeError(f"fused_transform: adversarial {label} {tuple(mat.shape)} "
                                   "differs")
        return "vec and scalar routes" if vec else "scalar route"

    # rows 4k (the vec route) and 4k+1..4k+3 (the general route)
    for rows in (37, 38, 39, 40, 70_000, 70_001):
        rng = np.random.default_rng(rows)
        cols, codes, p0, p1, brd = [], [], [], [], []
        for code, pl in params.items():
            for a, b in pl:
                cols.append(lanes(rng, rows, code in (ref.OP_CLAMP_F, ref.OP_BUCKETIZE_F)))
                codes.append(code)
                p0.append(a)
                p1.append(b)
                k = int(rng.integers(1, 18))
                row = np.full(17, np.inf, np.float32)
                row[:k] = np.sort(rng.standard_normal(k) * 50)
                brd.append(row)
        mat, c, a, b = cuda(np.stack(cols)), cuda(codes), cuda(p0), cuda(p1)
        bd = cuda(np.stack(brd), torch.float32)
        taken = ft_check("every op", mat, c, a, b, bd)
        print(f"[adversarial] fused_transform {tuple(mat.shape)} every op, both layouts, "
              f"features-major by the {taken}: bit-exact", flush=True)

    # BUCKETIZE_F border rows the engine never fuses, one per feature of a
    # features-major tile: unsorted, ties, signed zeros, +inf inside and
    # as padding, NaN, one NaN border, 300 sorted and 300 unsorted borders
    # (several of a warp's check steps), subnormals; values NaN, +-inf,
    # +-0, subnormal, on the borders and random
    nb = 300
    inf, nan = np.inf, np.nan
    specials = [
        [2.0, -1.0, 0.5, -3.0], [-1.0, -1.0, -1.0, 0.0, 0.0, 1.0, 1.0],
        [-0.0, 0.0, -0.0, 0.0], [0.0, -0.0], [-1.0, inf, inf, inf], [inf],
        [-inf, -inf, 0.0, inf], [-1.0, nan, 0.5], [nan], [0.0, 1.0, nan],
        [1e-40, -1e-42, 3e-39], [-1e-40, 0.0, 1e-40], list(np.linspace(-3, 3, 63)),
    ]
    rng = np.random.default_rng(17)
    brd_rows = [np.pad(np.array(r, np.float32), (0, nb - len(r)), constant_values=inf)
                for r in specials]
    brd_rows.append(np.sort(rng.standard_normal(nb).astype(np.float32)).round(1))
    brd_rows.append(rng.standard_normal(nb).astype(np.float32))
    bd = cuda(np.stack(brd_rows), torch.float32)
    feats = len(brd_rows)
    ties = np.array([-3.0, -1.0, -0.0, 0.0, 0.5, 1.0, 2.0, 1e-40, -1e-40, inf, -inf, nan,
                     3e-39, -1e-42], np.float32)
    c = cuda(np.full(feats, ref.OP_BUCKETIZE_F, np.int32))
    z = cuda(np.zeros(feats, np.int32))
    for rows in (4096, 4098):
        vals = (rng.standard_normal((feats, rows)) * 3).astype(np.float32)
        vals[:, : len(ties)] = ties
        vals[:, len(ties): 2 * len(ties)] = ties[::-1]
        taken = ft_check("BUCKETIZE_F borders", cuda(vals.view(np.int32)), c, z, z, bd)
        print(f"[adversarial] fused_transform BUCKETIZE_F ({feats}, {rows}) on unsorted, "
              f"tied, +-0.0, +inf and NaN border rows, by the {taken}: bit-exact", flush=True)

    # views of one buffer: a base 16 bytes in (the vec route) and 4 bytes
    # in (the general route)
    flat = cuda(lanes(rng, 8 * 512 + 8, False))
    for off in (4, 1):
        mat = flat[off: off + 8 * 512].view(8, 512)
        c8 = cuda(np.array([0, 1, 2, 3, 4, 5, 6, 9], np.int32))
        a8 = cuda(np.array([0, 7, 0, -50, -100, bits(-1.0), 0, 0], np.int32))
        b8 = cuda(np.array([0, 33, 13, 50, 10, bits(1.0), 0, 0], np.int32))
        bd8 = cuda(np.stack([np.sort(rng.standard_normal(17) * 50)] * 8).astype(np.float32),
                   torch.float32)
        want = "vec" if off == 4 else "scalar"
        if kft.route(mat, features_major=True) != want:
            raise RuntimeError(f"fused_transform: a view {off * 4} bytes in takes "
                               f"{kft.route(mat, features_major=True)}, expected {want}")
        ft_check(f"view {off * 4} bytes in", mat, c8, a8, b8, bd8)
    print("[adversarial] fused_transform views 16 bytes in (vec route) and 4 bytes in "
          "(scalar route): bit-exact", flush=True)

    rng = np.random.default_rng(1)
    for n in (1, 40_000):
        w = cuda(rng.integers(*i32, (n, 128), dtype=np.int64).astype(np.int32))
        if not torch.equal(kdecode.xor_decrypt(w), ref.xor_decrypt(w)):
            raise RuntimeError(f"xor_decrypt: ({n}, 128) differs")
    print("[adversarial] xor_decrypt (1, 128) and (40000, 128): bit-exact", flush=True)

    def unpack_check(bm, v):
        """Through the route it takes and both routes by name (the warp
        route where it takes the bitmap); returns the route."""
        want = ref.dense_unpack(bm, v)
        fns = [kdecode.dense_unpack, kdecode.dense_unpack_block]
        taken = kdecode.dense_unpack_route(bm)
        if taken == "warp":
            fns.append(kdecode.dense_unpack_warp)
        for fn in fns:
            if not torch.equal(fn(bm, v), want):
                raise RuntimeError(f"{fn.__name__}: bitmap {tuple(bm.shape)} values "
                                   f"{tuple(v.shape)} differs")
        return taken

    special = np.array([0x7FC00001, 0x7F800001, 0xFFC00000, 0x7F800000, 0x80000000, 0, 1,
                        0x807FFFFF], np.uint32).view(np.int32)    # NaN payloads, subnormals
    for rows, feats in [(1, 3), (40_000, 7)] + [(32 * w - (w % 3), 7) for w in range(1, 34)]:
        nw = -(-rows // 32)
        bitmap = np.zeros((feats, nw), np.int32)
        values = np.zeros((feats, rows), np.int32)
        for f in range(feats):
            present = rng.random(rows) < (0.0, 0.3, 1.0, 0.5, 0.9, 0.7, 0.05)[f]
            buf = np.zeros(nw * 4, np.uint8)
            packed = np.packbits(present.astype(np.uint8))
            buf[: len(packed)] = packed
            bitmap[f] = buf.view("<i4")
            n = int(present.sum()) // (2 if f % 2 else 1)    # some too few values
            values[f, :n] = lanes(rng, max(n, 1), True)[:n]
            values[f, : min(n, len(special))] = special[: min(n, len(special))]
        bm, vals = cuda(bitmap), cuda(values)
        wide = cuda(np.concatenate(                               # C above 32 W
            [values, rng.integers(*i32, (feats, 37), dtype=np.int64).astype(np.int32)], 1))
        # C of 1, C below the rows present (ranks clip to C-1), C of 32 W, C above
        for v in (vals, vals[:, :1].contiguous(), vals[:, :3].contiguous(), wide):
            want_route = "warp" if nw <= 32 else "block"
            if unpack_check(bm, v) != want_route:
                raise RuntimeError(f"dense_unpack: {nw} words took the wrong route")
    print("[adversarial] dense_unpack 1 to 33 and 1250 words x 7 features (all absent, all "
          "present), C of 1, 3, 32 W and above, NaN payloads and subnormals: warp route "
          "(up to 32 words) and block route bit-exact", flush=True)

    def gather_check(src, idx, sh, label):
        want = ref.ragged_gather(src, idx, sh)
        fns = [kdecode.ragged_gather, kdecode.ragged_gather_scalar]
        taken = kdecode.ragged_gather_route(idx, sh)
        if taken == "vec":
            fns.append(kdecode.ragged_gather_vec)
        for fn in fns:
            if not torch.equal(fn(src, idx, sh), want):
                raise RuntimeError(f"{fn.__name__}: {label} ({tuple(idx.shape)}) differs")
        return taken

    for m in (1, 20_000):
        n = max(m, 2) * 128
        src = cuda(rng.integers(*i32, (n // 128, 128), dtype=np.int64).astype(np.int32))
        idx = rng.integers(0, n - 1, (m, 128)).astype(np.int32)
        sh = rng.choice(np.array([0, 8, 16, 24], np.int32), (m, 128))
        idx.flat[0], sh.flat[0] = n - 2, 24                 # the last word pair
        if gather_check(src, cuda(idx), cuda(sh), "random") != "vec":
            raise RuntimeError("ragged_gather: fresh (M, 128) operands took the scalar route")
        # runs of consecutive words at one shift a run, runs of random even
        # lengths, pairs of non-consecutive indices, a pair that straddles
        # two runs, a pair of mixed shifts, a run to the last word pair
        flat_i, flat_s = idx.reshape(-1), sh.reshape(-1)
        at = 0
        while at < flat_i.size:
            length = min(2 * int(rng.integers(1, 60)), flat_i.size - at)
            flat_i[at: at + length] = int(rng.integers(0, n - length - 1)) + np.arange(length)
            flat_s[at: at + length] = rng.choice([0, 8, 16, 24])
            at += length
        flat_i[0:4] = [5, 9, 6, 7]
        flat_i[4:8], flat_s[4:8] = [20, 21, 22, 23], [8, 8, 16, 8]
        flat_i[8:12], flat_s[8:12] = np.arange(n - 5, n - 1), 24
        flat_i[13:15] = [flat_i[13], flat_i[13] + 40]
        flat_i[-1], flat_s[-1] = n - 2, 24
        if gather_check(src, cuda(idx), cuda(sh), "runs") != "vec":
            raise RuntimeError("ragged_gather: fresh (M, 128) operands took the scalar route")
        for shift in (0, 8, 16, 24):                        # every shift, all runs
            run = cuda((np.arange(m * 128) % (n - 1)).astype(np.int32).reshape(m, 128))
            gather_check(src, run, torch.full_like(run, shift), f"runs at shift {shift}")
    # views 4 bytes into one buffer take the scalar route
    buf_i = cuda(rng.integers(0, 255, 8 * 128 + 1).astype(np.int32))
    buf_s = cuda(rng.choice(np.array([0, 8, 16, 24], np.int32), 8 * 128 + 1))
    src = cuda(rng.integers(*i32, (2, 128), dtype=np.int64).astype(np.int32))
    if gather_check(src, buf_i[1:].view(8, 128), buf_s[1:].view(8, 128), "view") != "scalar":
        raise RuntimeError("ragged_gather: a view 4 bytes in took the vec route")
    print("[adversarial] ragged_gather every shift, random indices, runs of even lengths, "
          "non-consecutive, straddling and mixed-shift pairs, the last word pair, M of 1 and "
          "20000: vec and scalar routes bit-exact; a view 4 bytes in: scalar route bit-exact",
          flush=True)


def _serve(torch, engine: str, profile: bool = False):
    """Serve every batch of the full-width session; returns the batches,
    the session, setup and serve seconds, and (profiled) device seconds."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.launch.train import dlrm_dpp_batches

    t0 = time.perf_counter()
    batches, session = dlrm_dpp_batches(
        CONFIG, BATCH, device="cuda", engine=engine, decode_engine=engine,
    )
    t1 = time.perf_counter()
    out = []
    t_last = t1
    prof = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.start()
    for b in batches:
        out.append(b)
        t_last = time.perf_counter()
    device_s = None
    if prof is not None:
        torch.cuda.synchronize()
        prof.stop()
        by_name, _ = _device_by_name(torch, prof)
        device_s = sum(by_name.values()) / 1e6 if by_name else None
    if session.state != "COMPLETED":
        raise RuntimeError(f"{engine} session ended {session.state}")
    m = session.worker_metrics()
    stages = {k: getattr(m, k) for k in (
        "extract_s", "transform_s", "load_s", "extract_fused_s",
        "extract_fallback_s", "transform_fused_s", "transform_fallback_s",
        "kernel_launches", "decode_launches", "fused_features",
        "fallback_features", "splits_done",
    )}
    serve_s = t_last - t1
    rows = sum(len(b["label"]) for b in out)
    print(f"[serve] {engine}: {len(out)} batches, setup {t1 - t0:.3f} s, serve "
          f"{serve_s:.3f} s, {len(out) / serve_s:.3f} batches/s, "
          f"{rows / serve_s:.1f} rows/s, workers {len(session.workers)}"
          + (f", device busy {_fmt(device_s, '.6f')} s, idle share "
             f"{_fmt(_idle_share(device_s, serve_s), '.4f')}" if profile else "")
          + f", stages {json.dumps(stages)}", flush=True)
    return out, session, serve_s, device_s


def _service_phase(torch, ref_digests, single):
    """The multi-tenant DPP service on the card (``DPPService``), at the
    serving path's table and spec.

    (a) Two tenants of that spec at once through ``run_all``: a shared
    default ``StripeCache``, no tensor cache, 2 workers each, no
    auto-scaling, torch engines on the card.  Each tenant's batches must
    be the numpy engines' (``ref_digests``), the fleet must read at most
    0.6 of two single sessions' storage bytes (``single``: the serving
    path's session metrics) with a hit rate of at least 0.5, the
    per-tenant cache bytes must add up to the tiers', and every stripe
    must be decoded once per tenant by the warp and vec routes.
    (b) A first tenant with a shared ``TensorCache``, run to its end, then
    a second of the same spec on the same service with the launch counts
    set to 0: every row from the cache, no kernel launched, the first
    tenant's batches.  (c) ``obs.smoke.run_smoke`` on the card, its
    artifact held to ``obs.report.check``.  Returns the phase's record."""
    import tempfile

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.core.dpp import DPPService
    from repro_torch.core.dpp.tensor_cache import TensorCache
    from repro_torch.kernels import build
    from repro_torch.launch.train import dlrm_dpp_warehouse
    from repro_torch.obs import Tracer
    from repro_torch.obs import report as obs_report
    from repro_torch.obs.smoke import run_smoke

    engines = dict(device="cuda", engine="torch", decode_engine="torch",
                   n_workers=2, auto_scale=False)
    wh, spec = dlrm_dpp_warehouse(CONFIG, BATCH)
    table = wh.table(spec.table)
    n_rows = sum(p.num_rows for p in table.partitions.values())
    n_stripes = sum(len(p.footer.stripes) for p in table.partitions.values())
    tenants = ("tenant_a", "tenant_b")

    # (a) two tenants at once over the shared stripe cache; the tracer's
    # session.run spans give each tenant's serve seconds
    tracer = Tracer()
    svc = DPPService(wh, tracer=tracer)
    for name in tenants:
        svc.create_session(name, spec, **engines)
    build.LAUNCHES.reset()
    t0 = time.perf_counter()
    results = svc.run_all(timeout_s=300)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches_a = build.LAUNCHES.snapshot()
    if svc.session_errors:
        raise RuntimeError(f"service tenants failed: {svc.session_errors}")
    for name in tenants:
        state = svc.sessions[name].state
        if state != "COMPLETED":
            raise RuntimeError(f"service tenant {name} ended {state}")
        got = sorted(map(_digest, results[name]))
        if got != ref_digests:
            raise RuntimeError(f"service tenant {name}'s {len(got)} batches differ from "
                               "the numpy-engine batches")
    serve_s = {}
    for sp in tracer.spans():
        if sp.name == "session.run":
            serve_s[sp.labels["tenant"]] = sp.duration
    fleet = svc.fleet_metrics()
    cache = svc.stripe_cache
    if fleet.over_read_ratio != 1.0:
        raise RuntimeError(f"service over_read_ratio {fleet.over_read_ratio}, expected 1.0")
    if fleet.storage_rx_bytes > 0.6 * 2 * single.storage_rx_bytes:
        raise RuntimeError(f"service storage_rx_bytes {fleet.storage_rx_bytes} above 0.6 of "
                           f"two sessions' {2 * single.storage_rx_bytes}")
    if fleet.cache_rx_bytes <= 0:
        raise RuntimeError("the service read nothing from the stripe cache")
    if cache.hit_rate < 0.5:
        raise RuntimeError(f"stripe cache hit rate {cache.hit_rate} below 0.5")
    for tier in ("dram", "flash"):
        for field in ("bytes_stored", "admitted", "evictions", "hits", "bytes_served"):
            by_tenant = sum(getattr(getattr(ts, tier), field) for ts in cache.tenants.values())
            if by_tenant != getattr(getattr(cache, tier), field):
                raise RuntimeError(f"per-tenant {tier}.{field} {by_tenant} != the tier's "
                                   f"{getattr(getattr(cache, tier), field)}")
    if sum(ts.misses for ts in cache.tenants.values()) != cache.misses:
        raise RuntimeError("per-tenant cache misses do not add up to the tier's")
    for name in DATA_PATH_KERNELS:
        if launches_a.get(name, 0) <= 0:
            raise RuntimeError(f"the service never launched {name}")
    for general in GENERAL_ROUTES:
        if launches_a.get(general, 0) != 0:
            raise RuntimeError(f"the service launched {general}'s general route "
                               f"{launches_a[general]} times")
    for name in ("dense_unpack_warp", "ragged_gather_vec"):
        if launches_a[name] != len(tenants) * n_stripes:
            raise RuntimeError(f"the service launched {name} {launches_a[name]} times, "
                               f"expected one a stripe a tenant ({len(tenants) * n_stripes})")
    print(f"[service] (a) {len(tenants)} tenants, {n_rows} rows each, wall {wall_s:.3f} s, "
          f"{len(tenants) * n_rows / wall_s:.1f} rows/s; storage_rx {fleet.storage_rx_bytes} "
          f"cache_rx {fleet.cache_rx_bytes} hit_rate {cache.hit_rate:.4f}; launches "
          f"{launches_a}; batches byte-identical to the numpy engines", flush=True)

    # (b) the tensor cache: a second tenant of the same spec launches nothing
    svc_b = DPPService(wh, tensor_cache=TensorCache())
    first = svc_b.create_session("tc_first", spec, **engines)
    out_first = first.run_to_completion(timeout_s=300)
    second = svc_b.create_session("tc_second", spec, **engines)
    build.LAUNCHES.reset()
    t1 = time.perf_counter()
    out_second = second.run_to_completion(timeout_s=300)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t1
    launches_b = build.LAUNCHES.snapshot()
    for sess in (first, second):
        if sess.state != "COMPLETED":
            raise RuntimeError(f"tensor-cache tenant {sess.name} ended {sess.state}")
    m2 = second.worker_metrics()
    if m2.rows_from_cache != n_rows or m2.rows_done != n_rows:
        raise RuntimeError(f"the second tenant took {m2.rows_from_cache} of {m2.rows_done} "
                           f"rows from the tensor cache, expected all {n_rows}")
    if any(launches_b.values()):
        raise RuntimeError(f"a tensor-cache hit launched kernels: {launches_b}")
    if sorted(map(_digest, out_first)) != ref_digests:
        raise RuntimeError("the first tensor-cache tenant's batches differ from the numpy "
                           "engines'")
    if sorted(map(_digest, out_second)) != sorted(map(_digest, out_first)):
        raise RuntimeError("the tensor-cache tenant's batches differ from the first's")
    tstats = svc_b.tensor_cache.stats
    print(f"[service] (b) tensor cache: second tenant {m2.rows_from_cache} of {n_rows} rows "
          f"from the cache in {second_s:.3f} s, launches {launches_b}, hits {tstats.hits} "
          f"misses {tstats.misses} bytes_stored {tstats.bytes_stored}", flush=True)

    # (c) the traced two-tenant smoke run on the card and its stall report
    build.LAUNCHES.reset()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        smoke = run_smoke(str(path), device="cuda")
        torch.cuda.synchronize()
        launches_c = build.LAUNCHES.snapshot()
        doc = json.loads(path.read_text())
        if not all(smoke.get(t) for t in ("tenant_a", "tenant_b")):
            raise RuntimeError(f"the smoke run served "
                               f"{ {k: len(v) for k, v in smoke.items()} } batches")
        print("[service] (c) the smoke artifact's stall report:", flush=True)
        if obs_report.main([str(path), "--check"]) != 0:     # prints check()'s findings
            raise RuntimeError("obs.report.check found problems in the smoke artifact")
    if launches_c.get("xor_decrypt", 0) <= 0:
        raise RuntimeError(f"the smoke run launched no data-path kernel: {launches_c}")
    report = obs_report.build_report(doc)

    return {
        "tenants": len(tenants), "batches": {n: len(results[n]) for n in tenants},
        "rows": {n: n_rows for n in tenants}, "stripes": n_stripes,
        "serve_s": serve_s, "run_all_wall_s": wall_s,
        "aggregate_rows_per_s": len(tenants) * n_rows / wall_s,
        "storage_rx_bytes": fleet.storage_rx_bytes, "cache_rx_bytes": fleet.cache_rx_bytes,
        "single_session": {"storage_rx_bytes": single.storage_rx_bytes,
                           "extract_out_bytes": single.extract_out_bytes,
                           "tx_bytes": single.tx_bytes},
        "hit_rate": cache.hit_rate, "cache_summary": cache.summary(),
        "tenant_summary": svc.tenant_summary(),
        "launches": {"a": launches_a, "b": launches_b, "c": launches_c},
        "tensor_cache": {"second_serve_s": second_s, "rows_from_cache": m2.rows_from_cache,
                         "hits": tstats.hits, "misses": tstats.misses,
                         "bytes_stored": tstats.bytes_stored},
        "report": report,
    }


def _sanitized(run):
    """``run()`` under the port's lock-order sanitizer and lockset race
    detector over its nine core threaded classes: the locks and objects
    ``run`` builds are tracked.  Returns its result, seconds, the lock
    graph and the detector."""
    from repro_torch.analysis import lockdep, racedep, sched

    files = sched._REPO_LOCK_FILES + ("embedding_cache.py",)
    with lockdep.patched(name_filter=lambda s: s.startswith(files)) as graph:
        with racedep.instrument(graph, classes=racedep.core_classes()) as det:
            out, seconds = run()
    return out, seconds, graph, det


def _sanitizer_phase(torch, ref_digests, device="cuda"):
    """The port's invariant gate and runtime sanitizers (``repro_torch.analysis``)
    around the data path on the card.

    (a) The static gate over the 13 rules with the empty baseline: no
    finding.  (b) The full-width ``dlrm-paper`` session of the serving path
    (``dlrm_dpp_batches``, torch engines), built and run inside the lock-order
    sanitizer and the race detector: no race, no lock-order cycle, the
    numpy engines' batches (``ref_digests``), every data-path kernel
    launched in the window and no general route.  (c) The service phase's
    two tenants over the shared stripe cache through ``DPPService.run_all``,
    with the same three checks.  (b) and (c) each run four times in turns,
    uninstrumented, instrumented, instrumented, uninstrumented, for the
    instrumentation's cost; every run's batches are the numpy engines'.  (d) The interleaving explorer
    on every control-plane scenario on ``device``: each passes every
    schedule and is exhausted.  Returns the phase's record."""
    from repro_torch.analysis import all_rules, load_baseline, run_checks, sched
    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.core.dpp import DPPService
    from repro_torch.kernels import build
    from repro_torch.launch.train import dlrm_dpp_batches, dlrm_dpp_warehouse

    root = Path(__file__).resolve().parent
    t = time.perf_counter()
    new, known = run_checks(root, baseline=load_baseline(
        root / "scripts" / "analysis_baseline_torch.txt"))
    if new or known:
        raise RuntimeError("the invariant gate found " + "; ".join(
            f.render() for f in new + known))
    print(f"[sanitizers] (a) static gate: 0 new, 0 baselined over {len(all_rules())} rules "
          f"in {time.perf_counter() - t:.3f} s", flush=True)

    engines = dict(device=device, engine="torch", decode_engine="torch")
    tenants = ("tenant_a", "tenant_b")

    def session():
        """Setup and serve to the last batch (as ``_serve`` times it: the
        generator's end then waits out one 5 s poll, timed by neither)."""
        t0 = time.perf_counter()
        batches, sess = dlrm_dpp_batches(CONFIG, BATCH, **engines)
        out, t_last = [], t0
        for b in batches:
            out.append(b)
            t_last = time.perf_counter()
        torch.cuda.synchronize()
        if sess.state != "COMPLETED":
            raise RuntimeError(f"sanitizer-phase session ended {sess.state}")
        return {"session": out}, t_last - t0

    def service():
        t0 = time.perf_counter()
        wh, spec = dlrm_dpp_warehouse(CONFIG, BATCH)
        svc = DPPService(wh)
        for name in tenants:
            svc.create_session(name, spec, n_workers=2, auto_scale=False, **engines)
        results = svc.run_all(timeout_s=300)
        torch.cuda.synchronize()
        if svc.session_errors:
            raise RuntimeError(f"sanitizer-phase tenants failed: {svc.session_errors}")
        for name in tenants:
            if svc.sessions[name].state != "COMPLETED":
                raise RuntimeError(f"sanitizer-phase tenant {name} ended "
                                   f"{svc.sessions[name].state}")
        return results, time.perf_counter() - t0

    record = {"rules": len(all_rules()), "new": 0, "baselined": 0}
    for label, run in (("session", session), ("service", service)):
        seconds = {"plain": [], "sanitized": []}
        for mode in ("plain", "sanitized", "sanitized", "plain"):     # in turns
            build.LAUNCHES.reset()
            if mode == "plain":
                out, secs = run()
            else:
                out, secs, graph, det = _sanitized(run)
            launches = build.LAUNCHES.snapshot()
            seconds[mode].append(secs)
            for name, got in out.items():
                if sorted(map(_digest, got)) != ref_digests:
                    raise RuntimeError(f"the {mode} {label}'s {name} batches differ from "
                                       "the numpy engines'")
            if mode == "plain":
                continue
            if det.races():
                raise RuntimeError(f"the race detector found races in the {label}:\n"
                                   + det.report())
            if graph.cycles():
                raise RuntimeError(f"lockdep found lock-order cycles in the {label}:\n"
                                   + graph.report())
            for name in DATA_PATH_KERNELS:
                if launches.get(name, 0) <= 0:
                    raise RuntimeError(f"the sanitized {label} never launched {name}")
            for general in GENERAL_ROUTES:
                if launches.get(general, 0) != 0:
                    raise RuntimeError(f"the sanitized {label} launched {general}'s "
                                       f"general route {launches[general]} times")
            sanitized_launches = launches
        launches = sanitized_launches
        seen, shared = det.observed()
        record[label] = {
            "plain_s": seconds["plain"], "sanitized_s": seconds["sanitized"],
            "lock_sites": len(graph.nodes()), "lock_edges": len(graph.edges()),
            "attrs_observed": seen, "attrs_shared": shared, "races": 0, "cycles": 0,
            "batches": sum(len(v) for v in out.values()), "launches": launches,
        }
        print(f"[sanitizers] ({'b' if label == 'session' else 'c'}) {label}, in turns: "
              f"uninstrumented {', '.join(f'{x:.3f}' for x in seconds['plain'])} s, "
              f"instrumented {', '.join(f'{x:.3f}' for x in seconds['sanitized'])} s; "
              f"lockdep tracked {len(graph.nodes())} lock sites, {len(graph.edges())} "
              f"ordered edges, 0 cycles; racedep saw {shared} shared (object, attribute) "
              f"pairs of {seen} observed, 0 races; {record[label]['batches']} batches a run "
              f"byte-identical to the numpy engines; launches {launches}", flush=True)

    record["explorer"] = {}
    for scenario in sched.scenarios(device):
        t = time.perf_counter()
        res = sched.explore(scenario)
        if not res.exhausted:
            raise RuntimeError(f"the explorer was cut short on '{res.scenario}': {res}")
        record["explorer"][res.scenario] = {"schedules": res.schedules,
                                            "pruned": res.pruned,
                                            "seconds": time.perf_counter() - t}
        print(f"[sanitizers] (d) explorer on {device}: {res.scenario}: {res.schedules} "
              f"schedules, {res.pruned} pruned, exhausted", flush=True)
    return record


def _bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality of two float32 tensors (NaN payloads and signed
    zeros included, which ``torch.equal`` would not tell apart)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def _bag_adversarial_checks(torch) -> None:
    """``embedding_bag`` against its plain version on bags the main path
    never makes: empty bags, duplicate ids, the last row, fractional
    weights, L and E that are not multiples of 32 (E=16 is dlrm-smoke's),
    L longer than a shared-memory chunk, NaN and inf rows under a mask of 0,
    a NaN mask, subnormal rows, ids out of range (clamped) and a table of
    more than 2^31 elements (int64 offsets)."""
    import numpy as np

    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ref

    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def check(name, table, ids, mask):
        """Both modes through the route the operands take and, where that
        is the warp route, through the block route too."""
        out = {}
        fns = [kbag.embedding_bag]
        if kbag.route(table) == "warp":
            fns += [kbag.embedding_bag_warp, kbag.embedding_bag_block]
        for mode in ("mean", "sum"):
            want = ref.embedding_bag(table, ids, mask, mode=mode)
            for fn in fns:
                got = fn(table, ids, mask, mode=mode)
                torch.cuda.synchronize()
                if not _bits_equal(torch, got, want):
                    raise RuntimeError(f"{fn.__name__} ({mode}): {name} differs from the "
                                       "plain version")
            out[mode] = got
        return out

    rng = np.random.default_rng(12)
    taken = {"warp": [], "block": []}
    # E 1, 16, 40, 1000 and 42 (not a multiple of 4, over 512) and 4, 124,
    # 128, 132, 512 (one to four 128-column stripes, partial stripes); L of
    # 0, 1, 31, 32, 33 and 300 (runs of 32 slots and their ragged ends)
    for v, e, b, l in ((7, 1, 5, 3), (50, 16, 9, 8), (300, 40, 64, 33),
                       (1000, 128, 100, 300), (64, 1000, 8, 5), (10, 128, 4, 0),
                       (100, 4, 40, 1), (200, 124, 33, 31), (300, 128, 50, 33),
                       (150, 132, 20, 32), (64, 512, 16, 300), (500, 128, 17, 1),
                       (80, 42, 9, 7), (90, 516, 6, 33)):
        table = rng.standard_normal((v, e)).astype(np.float32)
        ids = rng.integers(0, v, (b, l)).astype(np.int32)
        mask = (rng.random((b, l)) < 0.6).astype(np.float32)
        if l:
            mask[: b // 3] *= rng.random((b // 3, l)).astype(np.float32) * 3   # fractional
            mask[-1] = 0.0                                                   # an empty bag
            ids[-2] = ids[-2, 0]                                             # duplicates
            ids[0, 0] = v - 1                                                # the last row
            ids[1, 0], ids[2, -1] = -3, v + 5                                # clamped
        table, ids, mask = cuda(table), cuda(ids), cuda(mask)
        taken[kbag.route(table)].append(e)
        out = check(f"(V={v}, E={e}, B={b}, L={l})", table, ids, mask)
        empty = out["sum"][-1:] if l else out["sum"]
        if not torch.equal(empty, torch.zeros_like(empty)):
            raise RuntimeError("embedding_bag: an empty bag is not 0")
    print(f"[adversarial] embedding_bag E by the warp and block routes {taken}, L of 0, "
          "1, 3, 5, 7, 8, 31, 32, 33 and 300, empty/duplicate/last-row/clamped/fractional: "
          "bit-exact", flush=True)

    # views of one buffer: a table 16 bytes in (the warp route) and 4 bytes
    # in (the block route)
    flat = cuda(rng.standard_normal(64 * 128 + 4).astype(np.float32))
    ids = cuda(rng.integers(0, 64, (30, 33)).astype(np.int32))
    mask = cuda((rng.random((30, 33)) < 0.7).astype(np.float32))
    for off, want in ((4, "warp"), (1, "block")):
        table = flat[off: off + 64 * 128].view(64, 128)
        if kbag.route(table) != want:
            raise RuntimeError(f"embedding_bag: a table {off * 4} bytes in takes "
                               f"{kbag.route(table)}, expected {want}")
        check(f"table {off * 4} bytes in", table, ids, mask)
    print("[adversarial] embedding_bag tables 16 bytes in (warp route) and 4 bytes in "
          "(block route): bit-exact", flush=True)

    table = np.array([[1, 2, 3, 4], [np.nan, np.inf, -np.inf, 1],
                      [1e-40, -1e-42, 3e-39, 5]], np.float32)
    ids = np.array([[0, 1], [2, 2], [1, 1], [0, 2], [2, 0]], np.int32)
    mask = np.array([[1, 0], [1, 0], [0, 0], [np.nan, 1], [1, 0]], np.float32)
    out = check("NaN/inf/subnormal rows", cuda(table), cuda(ids), cuda(mask))["sum"].cpu()
    if not (torch.isnan(out[0, :3]).all() and torch.isnan(out[2, :3]).all()
            and torch.isnan(out[3]).all()):
        raise RuntimeError("embedding_bag: NaN/inf rows under a mask of 0 must give NaN")
    if not torch.equal(out[1].view(torch.int32), torch.from_numpy(table[2]).view(torch.int32)):
        raise RuntimeError("embedding_bag: subnormal rows were flushed")
    print("[adversarial] embedding_bag NaN/inf rows under mask 0 -> NaN, NaN mask, "
          "subnormals kept: bit-exact", flush=True)

    e = 128
    v = 2 ** 31 // e + 4096                       # more than 2^31 elements
    big = torch.zeros((v, e), dtype=torch.float32, device="cuda")
    big[-4096:] = torch.randn((4096, e), device="cuda")
    ids = cuda(rng.integers(v - 4096, v, (64, 8)).astype(np.int32))
    mask = cuda((rng.random((64, 8)) < 0.7).astype(np.float32))
    check(f"table ({v}, {e})", big, ids, mask)
    del big
    torch.cuda.empty_cache()
    print(f"[adversarial] embedding_bag table ({v}, {e}) = {v * e} elements: bit-exact",
          flush=True)


def _make_trainer(cfg, tables, device, store_cls=None):
    """The tiered-store DLRM trainer of the trainer path, and its store."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TieredEmbeddingStore, Trainer, TrainerConfig

    store = (store_cls or TieredEmbeddingStore)(
        tables, HOT_ROWS, admit_reads=2, device=device)
    trainer = Trainer(
        cfg,
        OptimizerConfig(learning_rate=1e-2, warmup_steps=2, total_steps=TRAIN_STEPS),
        TrainerConfig(max_steps=TRAIN_STEPS, kernel_bags=True, trace_stall=False),
        embedding_store=store, device=device,
    )
    return trainer, store


def _rel_diff(a, b) -> float:
    """Norm of a - b over the norm of b, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _host_state(state):
    """A CPU copy of a trainer's dense state (params, AdamW mu/nu/step)."""
    opt = state["opt"]
    return {"params": {k: v.cpu().clone() for k, v in state["params"].items()},
            "opt": {"mu": {k: v.cpu().clone() for k, v in opt["mu"].items()},
                    "nu": {k: v.cpu().clone() for k, v in opt["nu"].items()},
                    "step": opt["step"].cpu().clone()},
            "step": state["step"]}


def _lockstep(torch, cfg, batches, tables):
    """Each step on the card and on the CPU from the same dense state: a
    card trainer and a CPU trainer step through the batches in turn, and
    before each step the CPU trainer loads the card trainer's MLP weights
    and AdamW state; each store runs free (its row-wise AdaGrad scales
    every row by that row's own rms, so rounding stays rounding).
    Free-running, AdamW's normalized first updates turn rounding-level
    gradient differences into loss differences of up to 5e-3 in 8 steps on
    some batch orders, on correct code.  After each step the card's dense
    state is held leaf by leaf: its mu and nu (which carry the clipped
    gradients) against the CPU's, within a relative norm of
    ``LOCKSTEP_RTOL``, its grad norm likewise, and its parameters against
    the AdamW update worked out here in float64 from its pre-step
    parameters and its post-step mu and nu, within ``UPDATE_RTOL``.
    The CPU step takes the card's ReLU pattern: a ReLU derivative jumps at
    0, and the one or two of a step's ~1.9 M pre-activations that lie
    within float32 rounding of 0 (about one step in three at this
    config's init) can round to opposite sides on the two devices, which
    moves a leaf's gradient by up to 1.5e-3 of its norm (as float32 against
    float64 does on the CPU; with the other's pattern both agree within
    3e-7).  The card's pre-activations are recorded, the CPU's ReLUs keep
    exactly the units the card kept, and the CPU's pre-activations must
    agree with the card's within ``LOCKSTEP_RTOL`` of their rms, so the
    borrowed pattern can differ only where a value is at rounding level.
    Returns both loss lists, the worst relative differences and the CPU's
    seconds."""
    from repro_torch.optim.optimizers import wsd_schedule

    card, _ = _make_trainer(cfg, tables, "cuda")
    cpu, _ = _make_trainer(cfg, tables, "cpu")
    oc = card.opt_cfg
    state = card.init_state()
    cpu_s = 0.0
    worst = {"mu": 0.0, "nu": 0.0, "grad_norm": 0.0, "params_vs_update": 0.0,
             "params_vs_cpu": 0.0, "pre_activations": 0.0, "relu_flips": 0}
    relu = torch.relu
    card_z, cpu_z = [], []

    def card_relu(z):
        card_z.append(z.detach().float().cpu())
        return relu(z)

    def cpu_relu(z):
        zc = card_z[len(cpu_z)]
        cpu_z.append(z.detach())
        return torch.where(zc > 0, z, torch.zeros((), dtype=z.dtype))

    for i, batch in enumerate(batches):
        for trainer in (card, cpu):
            trainer.cfg.max_steps = i + 1
        pre = _host_state(state)
        card_z.clear()
        cpu_z.clear()
        torch.relu = card_relu
        try:
            state = card.fit([batch], state)
        finally:
            torch.relu = relu
        torch.relu = cpu_relu
        t0 = time.perf_counter()
        try:
            cpu_after = cpu.fit([batch], pre)
        finally:
            torch.relu = relu
        cpu_s += time.perf_counter() - t0
        after = _host_state(state)
        n = i + 1
        if not card_z or len(cpu_z) != len(card_z):
            raise RuntimeError(f"step {n}: {len(card_z)} ReLUs on the card, "
                               f"{len(cpu_z)} on the CPU")
        flips = sum(int(((zc > 0) != (z > 0)).sum()) for zc, z in zip(card_z, cpu_z))
        forward = max(float((z - zc).abs().max() / zc.square().mean().sqrt().clamp_min(1e-30))
                      for zc, z in zip(card_z, cpu_z))
        if forward > LOCKSTEP_RTOL:
            raise RuntimeError(f"step {n}: the card's pre-activations differ from the "
                               f"CPU's by {forward:.3e} of their rms")
        diffs = {"mu": 0.0, "nu": 0.0, "params_vs_update": 0.0, "params_vs_cpu": 0.0,
                 "pre_activations": forward, "relu_flips": flips}
        lr = float(wsd_schedule(oc, torch.tensor(n, dtype=torch.int32)))
        # the betas as the update holds them, in float32
        bc1, bc2 = (1.0 - float(torch.tensor(b, dtype=torch.float32)) ** n
                    for b in (oc.beta1, oc.beta2))
        for k, p in pre["params"].items():
            for m in ("mu", "nu"):
                diffs[m] = max(diffs[m], _rel_diff(after["opt"][m][k], cpu_after["opt"][m][k]))
            mu, nu, p64 = (after["opt"]["mu"][k].double(), after["opt"]["nu"][k].double(),
                           p.double())
            delta = (mu / bc1) / ((nu / bc2).sqrt() + oc.eps)
            if p.dim() >= 2:
                delta = delta + oc.weight_decay * p64
            diffs["params_vs_update"] = max(diffs["params_vs_update"],
                                            _rel_diff(after["params"][k], p64 - lr * delta))
            diffs["params_vs_cpu"] = max(diffs["params_vs_cpu"],
                                         _rel_diff(after["params"][k], cpu_after["params"][k]))
        g_card, g_cpu = card.history[-1].grad_norm, cpu.history[-1].grad_norm
        diffs["grad_norm"] = abs(g_card - g_cpu) / abs(g_cpu)
        if int(after["opt"]["step"]) != n or int(cpu_after["opt"]["step"]) != n:
            raise RuntimeError(f"step {n}: AdamW step {int(after['opt']['step'])} on the "
                               f"card, {int(cpu_after['opt']['step'])} on the CPU")
        if max(diffs["mu"], diffs["nu"], diffs["grad_norm"]) > LOCKSTEP_RTOL:
            raise RuntimeError(f"step {n}: the card's dense gradients differ from the "
                               f"CPU's: {diffs}")
        if diffs["params_vs_update"] > UPDATE_RTOL:
            raise RuntimeError(f"step {n}: the card's parameters are not the AdamW update "
                               f"of its state: {diffs}")
        worst = {k: v + diffs[k] if k == "relu_flips" else max(v, diffs[k])
                 for k, v in worst.items()}
    return ([m.loss for m in card.history], [m.loss for m in cpu.history], worst, cpu_s)


def _train_run(torch, cfg, batches, tables, device, store_cls=None, profile=False):
    """Train ``TRAIN_STEPS`` steps of the tiered-store DLRM on the recorded
    batches; returns the trainer, its store, the wall seconds and (when
    profiled) the profiler."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    trainer, store = _make_trainer(cfg, tables, device, store_cls)
    prof = (profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            if profile else None)
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    state = trainer.fit(iter(batches))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    if state["step"] != TRAIN_STEPS:
        raise RuntimeError(f"{device} trainer took {state['step']} steps, "
                           f"expected {TRAIN_STEPS}")
    losses = [m.loss for m in trainer.history]
    print(f"[train] {device}: {TRAIN_STEPS} steps in {wall:.3f} s, "
          f"{TRAIN_STEPS / wall:.4f} steps/s, {TRAIN_STEPS * BATCH / wall:.1f} rows/s, "
          f"hot_rate {store.stats.hot_rate:.4f}, kernel_bags {store.stats.kernel_bags}, "
          f"losses {losses}", flush=True)
    for m in trainer.history:
        print(f"[train] {device} step {m.step}: loss {m.loss:.6f} embed_fetch_s "
              f"{m.embed_fetch_s:.4f} step_time_s {m.step_time_s:.4f} stall_s "
              f"{m.stall_s:.6f} hot_rate {m.hot_rate:.4f}", flush=True)
    return trainer, store, wall, prof


def _train_path(torch):
    """The trainer path: serve the cut-vocab dlrm-paper session on the card,
    train on its batches on the card, compare each step with the CPU from
    the card's dense state, profile a third run;
    returns the main run's launch counts, the kernel operands of the
    profiled run's first fully-hot lookup, and every bag of the first step
    folded onto the same hot-slot table."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.kernels import build
    from repro_torch.launch.train import dlrm_dpp_batches
    from repro_torch.train import TieredEmbeddingStore, init_tables

    cfg = dataclasses.replace(CONFIG, vocab_per_table=TRAIN_VOCAB)
    t = time.perf_counter()
    tables = init_tables(cfg, seed=3)
    print(f"[train] tables {tables.shape} f32 ({tables.nbytes / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t:.1f} s", flush=True)

    # the main path: counts set to 0 just before, read just after
    build.LAUNCHES.reset()
    t = time.perf_counter()
    gen, session = dlrm_dpp_batches(cfg, BATCH, device="cuda")
    batches = list(gen)
    if session.state != "COMPLETED" or len(batches) != TRAIN_STEPS:
        raise RuntimeError(f"session {session.state} served {len(batches)} batches")
    print(f"[train] served {len(batches)} batches of the vocab-{TRAIN_VOCAB} session in "
          f"{time.perf_counter() - t:.3f} s", flush=True)
    for b in batches:
        if b["sparse_ids"].max() >= TRAIN_VOCAB or b["sparse_ids"].min() < 0:
            raise RuntimeError("served ids outside the cut vocab")
    live = np.mean([b["sparse_mask"].sum() for b in batches])
    trainer, store, gpu_s, _ = _train_run(torch, cfg, batches, tables, "cuda")
    launches = build.LAUNCHES.snapshot()
    print(f"[train] main path launches {launches}", flush=True)
    if launches.get("embedding_bag_warp", 0) <= 0 or store.stats.kernel_bags <= 0:
        raise RuntimeError("the trainer path never launched embedding_bag's warp route")
    if launches.get("embedding_bag", 0) != 0:
        raise RuntimeError(f"the trainer path launched embedding_bag's block route "
                           f"{launches['embedding_bag']} times: every lookup must take "
                           "the warp route")
    gpu_hist = trainer.history
    gpu_losses = np.array([m.loss for m in gpu_hist])
    if not np.isfinite(gpu_losses).all():
        raise RuntimeError(f"non-finite losses {gpu_losses}")
    stats = {k: getattr(store.stats, k) for k in (
        "lookups", "hot_hits", "dram_fetches", "kernel_bags", "admitted", "evicted",
        "refreshed", "hot_rows")}
    del trainer, store

    step_losses, cpu_losses, state_diffs, cpu_s = _lockstep(torch, cfg, batches, tables)
    step_losses, cpu_losses = np.array(step_losses), np.array(cpu_losses)
    rel = np.abs(cpu_losses - step_losses) / np.abs(cpu_losses)
    if not np.allclose(step_losses, cpu_losses, rtol=1e-4, atol=0):
        raise RuntimeError(f"card losses {step_losses} vs CPU losses {cpu_losses}")
    if not np.array_equal(step_losses, gpu_losses):
        raise RuntimeError(f"the card's lockstep losses {step_losses} differ from its main "
                           f"run's {gpu_losses}")
    print(f"[train] card vs CPU, every step from the card's dense state: max rel loss "
          f"diff {rel.max():.3e} (rtol 1e-4); worst per-leaf relative norm of the card's "
          f"post-step state minus the CPU's: mu {state_diffs['mu']:.3e}, nu "
          f"{state_diffs['nu']:.3e}, grad norm {state_diffs['grad_norm']:.3e} (limit "
          f"{LOCKSTEP_RTOL:g}), params {state_diffs['params_vs_cpu']:.3e} (not held: AdamW "
          f"amplifies rounding); card params vs the float64 AdamW update of its own state "
          f"{state_diffs['params_vs_update']:.3e} (limit {UPDATE_RTOL:g}); pre-activations "
          f"{state_diffs['pre_activations']:.3e} of their rms (limit {LOCKSTEP_RTOL:g}), "
          f"{state_diffs['relu_flips']} ReLUs the CPU took from the card; CPU losses "
          f"{cpu_losses.tolist()}; the card's losses equal its main run's", flush=True)

    class TimedStore(TieredEmbeddingStore):
        """Host seconds of the store's phases, and the operands of the first
        kernel launch (copied on the host, so the profile holds no extra
        device work)."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.seconds = {"pooled": 0.0, "bag_launch": 0.0, "apply_sparse_update": 0.0}
            self.operands = None

        def _timed(self, name, fn, *a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.seconds[name] += time.perf_counter() - t0
            return out

        def pooled(self, *a, **k):
            return self._timed("pooled", super().pooled, *a, **k)

        def apply_sparse_update(self, *a, **k):
            return self._timed("apply_sparse_update", super().apply_sparse_update, *a, **k)

        def _bag_launch(self, table, ids, mask):
            if self.operands is None:
                self.operands = (table.copy(), ids.copy(), mask.copy())
            return self._timed("bag_launch", super()._bag_launch, table, ids, mask)

    trainer, store, prof_s, prof = _train_run(torch, cfg, batches, tables, "cuda",
                                              store_cls=TimedStore, profile=True)
    by_name, _ = _device_by_name(torch, prof)
    busy_s = copy_s = bag_s = None
    if by_name:
        busy_s = sum(by_name.values()) / 1e6
        copy_s = sum(v for k, v in by_name.items() if "memcpy" in k.lower()) / 1e6
        bag_s = sum(v for k, v in by_name.items() if "embedding_bag" in k) / 1e6
    step_s = sum(m.step_time_s for m in trainer.history)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({"train": {
        "config": cfg.name, "vocab_per_table": TRAIN_VOCAB, "batch": BATCH,
        "steps": TRAIN_STEPS, "hot_rows_per_table": HOT_ROWS,
        "live_ids_per_batch": float(live),
        "card_s": gpu_s, "cpu_s": cpu_s, "profiled_card_s": prof_s,
        "card_steps_per_s": TRAIN_STEPS / gpu_s, "card_rows_per_s": TRAIN_STEPS * BATCH / gpu_s,
        "card_losses": gpu_losses.tolist(), "cpu_losses": cpu_losses.tolist(),
        "max_rel_loss_diff": float(rel.max()), "lockstep_state_rel_diff": state_diffs,
        "card_step_metrics": [dataclasses.asdict(m) for m in gpu_hist],
        "store_stats": stats, "hot_rate": gpu_hist[-1].hot_rate,
        "profiled_host_s": dict(store.seconds, embed_fetch=sum(
            m.embed_fetch_s for m in trainer.history), step_time=step_s,
            mlp_step=step_s - store.seconds["apply_sparse_update"]),
        "device_busy_s": busy_s, "device_copy_s": copy_s,
        "device_embedding_bag_s": bag_s, "device_idle_share": _idle_share(busy_s, prof_s),
        "device_top_us": dict(top),
    }}), flush=True)
    operands = store.operands
    del trainer, store
    # every bag of the first step as the hot tier would serve it once it
    # covers the step: each table's ids folded onto its HOT_ROWS slots of
    # the same flattened (T * HOT_ROWS, E) table
    sid, smask = batches[0]["sparse_ids"], batches[0]["sparse_mask"]
    t = sid.shape[1]
    slot = sid % HOT_ROWS + (np.arange(t) * HOT_ROWS)[None, :, None]
    step_bags = (slot.reshape(-1, sid.shape[2]).astype(np.int32),
                 np.ascontiguousarray(smask.reshape(-1, sid.shape[2]), np.float32))
    return launches, operands, step_bags


def _bag_checks(torch, operands, step_bags, launches):
    """``embedding_bag`` at the operands of the trainer's first fully-hot
    lookup: both routes bit-exact against the plain version in both modes,
    times of each route, the plain version and
    ``torch.nn.functional.embedding_bag`` beside the bound, and the two
    routes again in turns (warp, block, block, warp, three times): one row
    for each route.  Then every bag of one step (``step_bags``) through
    both routes: bit-exact and timed beside its bound and
    ``F.embedding_bag``, not gated on time."""
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import kernel_bound

    routes = (("embedding_bag_warp", "warp", kbag.embedding_bag_warp),
              ("embedding_bag", "block", kbag.embedding_bag_block))

    def measure(table, ids, mask, label):
        if kbag.route(table) != "warp":
            raise RuntimeError(f"embedding_bag: {label} does not take the warp route")
        for mode in ("mean", "sum"):
            want = ref.embedding_bag(table, ids, mask, mode=mode)
            for name, _, fn in routes:
                got = fn(table, ids, mask, mode=mode)
                torch.cuda.synchronize()
                if not _bits_equal(torch, got, want):
                    raise RuntimeError(f"{name} ({mode}): kernel disagrees with its plain "
                                       f"version at {label}")
        err = float((got - want).abs().max().item())
        ids64 = ids.long()
        denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)
        plain = lambda: ref.embedding_bag(table, ids, mask, mode="mean")
        library = lambda: F.embedding_bag(ids64, table, mode="sum",
                                          per_sample_weights=mask) / denom
        if not torch.allclose(library(), plain(), rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"F.embedding_bag disagrees with the plain version at {label}")
        # the launch reads only the rows its ids name (every slot is read,
        # masked ones too), plus ids and mask, and writes the (b, e) output
        rows = int(torch.unique(ids).numel())
        bound_ms, bound_by = kernel_bound("embedding_bag", table, ids, mask)[:2]
        common = dict(
            shape=f"table {tuple(table.shape)} ids/mask {tuple(ids.shape)} {label}, rows "
                  f"read {rows}",
            max_abs_err=err, plain_ms=_queued_ms(torch, plain, iters=5),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=_queued_ms(torch, library),
            plain_call_ms=_call_ms(torch, plain, iters=20),
            library_call_ms=_call_ms(torch, library),
        )
        out = []
        for name, kernel_route, fn in routes:
            kernel = lambda fn=fn: fn(table, ids, mask, mode="mean")
            row = dict(name=name, route="cuda", kernel_route=kernel_route,
                       source="src/repro_torch/csrc/embedding_bag.cu",
                       replaces="src/repro/kernels/embedding_bag.py:40",
                       launches=launches.get(name, 0), **common,
                       ms=_queued_ms(torch, kernel), call_ms=_call_ms(torch, kernel))
            out.append(row)
            print(f"[kernel] {name} {row['shape']}: bit-exact (mean and sum), "
                  f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                  f"library_ms={row['library_ms']:.6f} bound_ms={row['bound_ms']:.6f} "
                  f"call_ms={row['call_ms']:.6f} plain_call_ms={row['plain_call_ms']:.6f} "
                  f"library_call_ms={row['library_call_ms']:.6f}", flush=True)
        turns = {name: [] for name, _, _ in routes}
        order = [routes[0], routes[1], routes[1], routes[0]]
        for _ in range(3):
            for name, _, fn in order:
                turns[name].append(
                    _queued_ms(torch, lambda fn=fn: fn(table, ids, mask, mode="mean")))
        out[0]["turns_ms"] = turns
        print(f"[kernel] embedding_bag {label}: warp and block routes in turns "
              f"{json.dumps(turns)}", flush=True)
        return out

    table, ids, mask = (torch.from_numpy(a).cuda() for a in operands)
    rows = measure(table, ids, mask, f"the first fully-hot lookup, {ids.shape[0]} bags")
    step_ids, step_mask = (torch.from_numpy(a).cuda() for a in step_bags)
    step = measure(table, step_ids, step_mask,
                   f"every bag of one step, {step_ids.shape[0]} bags")
    for row, one_step in zip(rows, step):
        row["one_step"] = {k: one_step[k] for k in (
            "shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call_ms", "turns_ms") if k in one_step}
    return rows


def _checkpoint_phase(torch):
    """``examples/torch/train_dlrm_e2e.py`` at its own size on the card:
    phase 1 trains half the steps into a fresh checkpoint directory, phase
    2 restarts a fresh trainer on it with a fresh DPP session.  Checks the
    checkpoints on disk (the newest step, ``keep``, the shard's bytes, the
    state read back byte-identical to the trainer's), the resume and the
    loss, and each session's launches; returns the phase's record."""
    import os
    import runpy
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import load_pytree
    from repro_torch.convert import flatten
    from repro_torch.kernels import build
    from repro_torch.models.common import param_count

    ex = runpy.run_path(str(Path(__file__).resolve().parent / "examples" / "torch"
                            / "train_dlrm_e2e.py"))
    make_trainer, run_phase = ex["make_trainer"], ex["run_phase"]

    def timed(fn, seconds):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            seconds.append(time.perf_counter() - t0)
            return out
        return call

    def session_launches(label):
        launches = build.LAUNCHES.snapshot()
        print(f"[ckpt] {label} session launches {launches}", flush=True)
        for name in DATA_PATH_KERNELS:
            if launches.get(name, 0) <= 0:
                raise RuntimeError(f"the {label} session never launched {name}")
        for general in GENERAL_ROUTES:
            if launches.get(general, 0) != 0:
                raise RuntimeError(f"the {label} session launched {general}'s general "
                                   f"route {launches[general]} times")
        return launches

    def kept(last, ends, every, keep):
        """The steps a manager keeps after saves every ``every`` steps up to
        ``last`` and at the end of each phase (``ends``)."""
        return sorted(set(range(every, last + 1, every)) | set(ends))[-keep:]

    def steps_per_s(trainer):
        loop_s = sum(m.step_time_s + m.embed_fetch_s + m.stall_s for m in trainer.history)
        return len(trainer.history) / loop_s

    ckpt_dir = tempfile.mkdtemp(prefix="dlrm_ckpt_")
    try:
        free = shutil.disk_usage(ckpt_dir).free
        print(f"[ckpt] checkpoint directory {ckpt_dir}, {free / 1e9:.1f} GB free", flush=True)
        saves, restores = [], []
        # phase 1: train CKPT_STEPS // 2 steps, saving every 50 and at the end
        trainer = make_trainer(CKPT_STEPS, ckpt_dir, "cuda")
        n_params = param_count(trainer.model.params())
        trainer.cfg.max_steps = CKPT_STEPS // 2
        trainer.ckpt.save = timed(trainer.ckpt.save, saves)
        build.LAUNCHES.reset()
        t0 = time.perf_counter()
        state, _ = run_phase(trainer, "cuda")
        phase1_s = time.perf_counter() - t0
        launches1 = session_launches("phase 1")
        half = CKPT_STEPS // 2
        if state["step"] != half or trainer.ckpt.latest_step() != half:
            raise RuntimeError(f"phase 1 ended at step {state['step']}, newest checkpoint "
                               f"{trainer.ckpt.latest_step()}; expected {half}")
        every, keep = trainer.cfg.checkpoint_every, trainer.ckpt.keep
        if trainer.ckpt.all_steps() != kept(half, {half}, every, keep):
            raise RuntimeError(f"checkpoints {trainer.ckpt.all_steps()} after phase 1")
        shard = os.path.join(ckpt_dir, f"step_{half:08d}", "shard_0.msgpack")
        shard_bytes = os.path.getsize(shard)
        # params, mu and nu in float32 and the int32 step: the bytes the
        # shard must hold, its msgpack framing aside
        reckoned = 3 * 4 * n_params + 4
        if abs(shard_bytes - reckoned) > 0.01 * reckoned:
            raise RuntimeError(f"shard of {shard_bytes} B, reckoned {reckoned} B")
        t0 = time.perf_counter()
        on_disk = load_pytree(trainer.checkpoint_tree(state["params"], state["opt"]),
                              os.path.dirname(shard))
        read_s = time.perf_counter() - t0
        pairs = [("params." + k, v, state["params"][k])
                 for k, v in flatten(on_disk["params"]).items()]
        for part in ("mu", "nu"):
            pairs += [(f"{part}.{k}", v, state["opt"][part][k])
                      for k, v in flatten(on_disk["opt"][part]).items()]
        pairs.append(("step", on_disk["opt"]["step"], state["opt"]["step"]))
        if len(pairs) != 3 * len(state["params"]) + 1:
            raise RuntimeError(f"{len(pairs)} leaves read back")
        for name, got, want in pairs:
            want = want.cpu()
            if got.dtype == torch.float32:
                same = _bits_equal(torch, got, want)
            else:
                same = got.dtype == want.dtype and torch.equal(got, want)
            if not same:
                raise RuntimeError(f"checkpoint leaf {name} read back differs from the "
                                   "trainer's state")
        del on_disk, pairs
        print(f"[ckpt] phase 1: {len(trainer.history)} steps in {phase1_s:.1f} s; "
              f"checkpoints {trainer.ckpt.all_steps()}; shard {shard_bytes} B (reckoned "
              f"{reckoned} B); {3 * len(state['params']) + 1} leaves read back "
              f"byte-identical in {read_s:.3f} s", flush=True)
        losses1 = [m.loss for m in trainer.history]
        phase1 = {"steps_per_s": steps_per_s(trainer), "phase_s": phase1_s,
                  "stall_fraction": trainer.stall_fraction()}
        del trainer, state
        torch.cuda.empty_cache()

        # phase 2: a fresh trainer and session on the same directory
        trainer2 = make_trainer(CKPT_STEPS, ckpt_dir, "cuda")
        trainer2.ckpt.save = timed(trainer2.ckpt.save, saves)
        trainer2.maybe_restore = timed(trainer2.maybe_restore, restores)
        build.LAUNCHES.reset()
        t0 = time.perf_counter()
        state2, _ = run_phase(trainer2, "cuda")
        phase2_s = time.perf_counter() - t0
        launches2 = session_launches("phase 2")
        losses2 = [m.loss for m in trainer2.history]
        if trainer2.history[0].step != half + 1 or state2["step"] != CKPT_STEPS:
            raise RuntimeError(f"phase 2 resumed at step {trainer2.history[0].step} and "
                               f"ended at {state2['step']}; expected {half + 1} and "
                               f"{CKPT_STEPS}")
        if not np.isfinite(losses1 + losses2).all() or not losses2[-1] < losses1[0]:
            raise RuntimeError(f"loss {losses1[0]} -> {losses2[-1]}")
        if trainer2.ckpt.all_steps() != kept(CKPT_STEPS, {half, CKPT_STEPS}, every, keep):
            raise RuntimeError(f"checkpoints {trainer2.ckpt.all_steps()} after phase 2")
        phase2 = {"steps_per_s": steps_per_s(trainer2), "phase_s": phase2_s,
                  "stall_fraction": trainer2.stall_fraction()}
        record = {
            "config": ex["CONFIG"].name, "params": n_params, "steps": CKPT_STEPS,
            "shard_bytes": shard_bytes, "reckoned_bytes": reckoned, "save_s": saves,
            "restore_s": restores[0], "read_back_s": read_s,
            "phase1": phase1, "phase2": phase2,
            "first_loss": losses1[0], "last_loss": losses2[-1],
            "resumed_at": trainer2.history[0].step, "finished_at": state2["step"],
            "launches": {"phase1": launches1, "phase2": launches2},
        }
        print(f"[ckpt] phase 2 resumed at step {record['resumed_at']} and finished at "
              f"{record['finished_at']}; loss {losses1[0]:.4f} -> {losses2[-1]:.4f}; "
              f"saves {['%.3f' % s for s in saves]} s, restore {restores[0]:.3f} s",
              flush=True)
        return record
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def _sharded_rank(rank, shape, batches, seed, pattern=None):
    """One rank of the sharded DLRM phase (spawned): ``dlrm-paper`` at full
    vocab on ``shape``, 8 steps of ``make_dlrm_sparse_train_step``.
    Returns the step's launch counts, losses and times, the MLPs, the
    touched rows and their accumulator entries in this rank's slice,
    whether a sample of untouched rows kept its bits, the all_reduce time
    of a pooled tensor, and peak device memory.  Without ``pattern``, rank
    0 also returns every step's MLP pre-activations (each ReLU's input, in
    call order); with ``pattern`` (those of another run), each ReLU keeps
    exactly the units that run kept, and the rank returns, per step, how
    many of its own pre-activations lie on the other side of 0 (flips)
    and their largest distance from the pattern's over its rms."""
    import numpy as np
    import torch

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_dlrm_sparse_train_step
    from repro_torch.optim import OptimizerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = build.BUILD_DIR / f"librepro_torch_{build.source_hash()}.so"
    if not lib.exists():
        raise RuntimeError(f"rank {rank}: {lib} not built: the parent builds before spawning")
    mesh = make_mesh(shape, ("data", "model"), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = make_dlrm_sparse_train_step(CONFIG, mesh, BATCH,
                                         opt_cfg=OptimizerConfig(**SHARDED_OPT), device="cuda")
    params, opt = bundle.init_state(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    v, e = CONFIG.vocab_per_table, CONFIG.embed_dim
    lo, hi = bundle.model.vocab_rows(mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 1)
    sample = torch.randint(lo, hi, (CONFIG.num_tables, SHARDED_SAMPLE), generator=gen,
                           device=mesh.device)
    t_idx = torch.arange(CONFIG.num_tables, device=mesh.device)[:, None]
    sample_rows = params["tables"][t_idx, sample - lo].clone()
    local = [bundle.shard_batch(b) for b in batches]
    torch.cuda.synchronize()

    def touched(batch_list):
        """The rows these batches touch (every occurrence, masked ones
        too) in this rank's slice, by key t * V + id: the rows and their
        accumulator entries."""
        ids = torch.as_tensor(np.stack([b["sparse_ids"] for b in batch_list]))
        ids = ids.to(mesh.device).long().clamp(0, v - 1)
        keys = torch.unique(ids + t_idx.reshape(1, 1, -1, 1) * v)
        keys = keys[(keys % v >= lo) & (keys % v < hi)]
        flat = (keys // v) * (hi - lo) + keys % v - lo
        return keys, {"keys": keys.cpu().numpy(),
                      "rows": params["tables"].view(-1, e)[flat].cpu().numpy(),
                      "acc": opt["acc"].view(-1)[flat].cpu().numpy()}

    relu = torch.relu
    relus = []                       # this step's ReLU inputs, and the pattern's

    def patched(z):
        zc = None
        if pattern is not None:
            zc = torch.from_numpy(pattern[len(losses)][len(relus)]).to(z.device)
        relus.append((z.detach(), zc))
        if zc is None:
            return relu(z)
        return torch.where(zc > 0, z, torch.zeros((), dtype=z.dtype, device=z.device))

    watch = pattern is not None or rank == 0
    pre_acts, flips, gaps = [], [], []
    # the main path: counts set to 0 just before, read just after; each
    # step timed to its loss on the host (a sync), the step-1 rows read
    # between steps 1 and 2
    build.LAUNCHES.reset()
    losses, step_s = [], []
    for i, b in enumerate(local):
        t = time.perf_counter()
        relus.clear()
        if watch:
            torch.relu = patched
        try:
            params, opt, metrics = bundle.fn(params, opt, b)
        finally:
            torch.relu = relu
        losses.append(metrics["loss"].item())
        step_s.append(time.perf_counter() - t)
        if pattern is not None:
            flips.append(sum(int(((zc > 0) != (z > 0)).sum()) for z, zc in relus))
            gaps.append(max(float((z - zc).abs().max() / zc.square().mean().sqrt()
                                  .clamp_min(1e-30)) for z, zc in relus))
        elif watch:
            pre_acts.append([z.cpu().numpy() for z, _ in relus])
        if i == 0:
            _, first = touched(batches[:1])
    launches = build.LAUNCHES.snapshot()
    keys, last = touched(batches)
    skeys = sample + t_idx * v
    untouched = ~torch.isin(skeys, keys)
    kept = bool(torch.equal(params["tables"][t_idx, sample - lo][untouched],
                            sample_rows[untouched]))

    allreduce_ms = None
    if mesh.shape["model"] > 1:
        x = torch.randn((BATCH, CONFIG.num_tables, e), device=mesh.device)
        for _ in range(2):
            mesh.all_reduce(x, "model")
        times = []
        for _ in range(10):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            mesh.all_reduce(x, "model")
            z.record()
            z.synchronize()
            times.append(a.elapsed_time(z))
        allreduce_ms = times
    return {
        "rank": rank, "coord": (mesh.coord("data"), mesh.coord("model")), "rows": (lo, hi),
        "backend": mesh.backend, "launches": launches, "losses": losses, "step_s": step_s,
        "steps_per_s": len(local) / sum(step_s),
        "steps_per_s_after_first": (len(local) - 1) / sum(step_s[1:]), "init_s": init_s,
        "pre_activations": pre_acts if pattern is None and rank == 0 else None,
        "relu_flips": flips, "pre_activation_gap": gaps,
        "mlp": {k: p.cpu().numpy() for k, p in params.items() if k != "tables"},
        "touched_first": first, "touched": last, "untouched_checked": int(untouched.sum()),
        "untouched_kept": kept, "allreduce_ms": allreduce_ms,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
    }


def _sharded_phase(torch, batches, card):
    """The sharded DLRM step: ``dlrm-paper`` at full width and full vocab
    (42 x 2,000,000 x 128 float32 tables, 43 GB) on mesh (1, 4), four gloo
    ranks on the one card (10.75 GB of tables each), for 8 steps on the
    serving phase's 8 batches; then the same steps on mesh (1, 1), one
    NCCL rank holding the whole tables (the unsharded path).
    Checks every rank's launches (8 ``embedding_bag_warp`` and 8
    ``rowwise_adagrad``, none of the block route; 8 ``rowwise_adagrad``
    and nothing else on the one rank), MLPs bit-identical across the four
    ranks, the losses, the touched rows and their accumulator entries
    against the one rank's, and a sample of untouched rows unchanged bit
    for bit; returns the phase's record.  The one rank takes the four
    ranks' ReLU pattern, as ``_lockstep`` takes the card's: the pooled
    embeddings are summed in another order there (four partial sums and
    an all_reduce against one sum), and a pre-activation within float32
    rounding of 0 then lies on either side of it; the ReLU's derivative
    jumps there, that sample's gradient moves, and by step 8 the touched
    rows' accumulator entries sat 1.192e-3 and 2.133e-3 apart in relative
    norm in two free-running runs (bound 1e-3; 3.1e-7 to 3.5e-7 in the
    others).  Its own pre-activations must agree with the four ranks'
    within ``LOCKSTEP_RTOL`` of their rms, so the borrowed pattern differs
    from its own only at rounding level; the flips are counted."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.distributed.spawn import spawn
    from repro_torch.kernels import build

    build.library()                  # the ranks load this build, never nvcc
    torch.cuda.empty_cache()
    n = len(batches)
    if n != TRAIN_STEPS:
        raise RuntimeError(f"the sharded phase takes the serving phase's {TRAIN_STEPS} "
                           f"batches, got {n}")
    tmp = tempfile.mkdtemp(prefix="sharded_")
    try:
        t = time.perf_counter()
        four = spawn(_sharded_rank, 4, f"{tmp}/rdv4", "gloo",
                     args=(SHARDED_MESH, batches, SHARDED_SEED), timeout_s=SHARDED_TIMEOUT_S)
        four_s = time.perf_counter() - t
        t = time.perf_counter()
        (one,) = spawn(_sharded_rank, 1, f"{tmp}/rdv1", "nccl",
                       args=((1, 1), batches, SHARDED_SEED, four[0].pop("pre_activations")),
                       timeout_s=SHARDED_TIMEOUT_S)
        one_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    for r in four:
        if r["launches"] != {"embedding_bag_warp": n, "rowwise_adagrad": n}:
            raise RuntimeError(f"rank {r['rank']} launched {r['launches']}: expected "
                               f"embedding_bag_warp and rowwise_adagrad once a step ({n}) "
                               "and no block route")
        if not r["untouched_kept"] or r["untouched_checked"] <= 0:
            raise RuntimeError(f"rank {r['rank']}: untouched rows changed "
                               f"({r['untouched_checked']} checked)")
    if one["launches"] != {"rowwise_adagrad": n}:
        raise RuntimeError(f"the one-rank run launched {one['launches']}: the unsharded "
                           f"path launches rowwise_adagrad once a step ({n}) and nothing else")
    # the one rank took the four ranks' ReLU pattern: its own pre-activations
    # must agree with theirs to rounding, so the borrowed pattern differs
    # from its own only where a value lies within rounding of 0
    if len(one["pre_activation_gap"]) != n or max(one["pre_activation_gap"]) > LOCKSTEP_RTOL:
        raise RuntimeError(f"the one rank's MLP pre-activations differ from the four ranks' "
                           f"by {one['pre_activation_gap']} of their rms, a step")
    if not one["untouched_kept"]:
        raise RuntimeError("the one-rank run changed untouched rows")
    for r in four[1:]:
        for k, a in four[0]["mlp"].items():
            if a.tobytes() != r["mlp"][k].tobytes():
                raise RuntimeError(f"MLP {k} differs between rank 0 and rank {r['rank']}")
        if r["losses"] != four[0]["losses"]:
            raise RuntimeError(f"rank {r['rank']} losses {r['losses']} != rank 0's")
    got, want = np.array(four[0]["losses"]), np.array(one["losses"])
    if not np.isfinite(got).all():
        raise RuntimeError(f"non-finite losses {got}")
    rel = np.abs(got - want) / np.abs(want)
    if rel[0] > SHARDED_LOSS_RTOL[0] or (rel[1:] > SHARDED_LOSS_RTOL[1]).any():
        raise RuntimeError(f"four-rank losses {got} vs one rank's {want}: rel {rel}")

    def gathered(part):
        """The four ranks' touched rows in key order, checked against the
        one rank's key set; (keys, rows, acc, the one rank's rows, acc)."""
        keys = np.concatenate([r[part]["keys"] for r in four])
        order = np.argsort(keys)
        if not np.array_equal(keys[order], one[part]["keys"]):
            raise RuntimeError(f"{part}: the four ranks' touched rows are not the one rank's")
        return (keys[order], np.concatenate([r[part]["rows"] for r in four])[order],
                np.concatenate([r[part]["acc"] for r in four])[order],
                one[part]["rows"], one[part]["acc"])

    # after step 1, from one state: each element within rtol 1e-4
    keys1, rows1, acc1, want_rows1, want_acc1 = gathered("touched_first")
    if not (np.allclose(rows1, want_rows1, **SHARDED_ROW_TOL)
            and np.allclose(acc1, want_acc1, rtol=SHARDED_ROW_TOL["rtol"], atol=0)):
        raise RuntimeError(
            f"step 1: touched rows differ by up to {np.abs(rows1 - want_rows1).max():.3e}, "
            f"accumulator entries by {np.abs(acc1 - want_acc1).max():.3e}")
    # after step 8: the trajectories have parted at the 1e-5 loss level, so
    # rows whose gradients are tiny and cancel differ by percents; held in
    # relative norm
    keys, rows, acc, want_rows, want_acc = gathered("touched")
    row_rel = float(np.linalg.norm(rows - want_rows) / np.linalg.norm(want_rows))
    acc_rel = float(np.linalg.norm(acc - want_acc) / np.linalg.norm(want_acc))
    if row_rel > SHARDED_NORM_RTOL or acc_rel > SHARDED_NORM_RTOL:
        raise RuntimeError(f"step {n}: touched rows off by {row_rel:.3e}, accumulator "
                           f"entries by {acc_rel:.3e} in relative norm")
    over = ~np.isclose(rows, want_rows, **SHARDED_ROW_TOL)
    row_diff = np.abs(rows - want_rows)
    acc_diff = np.abs(acc - want_acc)
    record = {
        "config": CONFIG.name, "vocab_per_table": CONFIG.vocab_per_table, "batch": BATCH,
        "steps": n,
        "card": card,
        "four": {"mesh": list(SHARDED_MESH), "backend": "gloo", "wall_s": four_s,
                 "steps_per_s": [r["steps_per_s"] for r in four],
                 "steps_per_s_after_first": [r["steps_per_s_after_first"] for r in four],
                 "step_s": four[0]["step_s"], "init_s": [r["init_s"] for r in four],
                 "max_memory_allocated": [r["max_memory_allocated"] for r in four],
                 "launches": [r["launches"] for r in four],
                 "allreduce_ms_pooled": four[0]["allreduce_ms"],
                 "allreduce_ms_median": statistics.median(four[0]["allreduce_ms"]),
                 "losses": four[0]["losses"]},
        "one": {"mesh": [1, 1], "backend": "nccl", "wall_s": one_s,
                "steps_per_s": one["steps_per_s"],
                "steps_per_s_after_first": one["steps_per_s_after_first"], "step_s": one["step_s"],
                "init_s": one["init_s"], "max_memory_allocated": one["max_memory_allocated"],
                "launches": one["launches"], "losses": one["losses"]},
        "touched_rows_step1": int(keys1.size), "touched_rows": int(keys.size),
        "max_rel_loss_diff": float(rel.max()),
        "step1_max_abs_row_diff": float(np.abs(rows1 - want_rows1).max()),
        "step1_max_abs_acc_diff": float(np.abs(acc1 - want_acc1).max()),
        "max_abs_row_diff": float(row_diff.max()), "max_abs_acc_diff": float(acc_diff.max()),
        "row_rel_norm_diff": row_rel, "acc_rel_norm_diff": acc_rel,
        "rows_over_rtol": int(over.any(axis=1).sum()),
        "relu_flips": one["relu_flips"], "pre_activation_gap": one["pre_activation_gap"],
        "untouched_checked": [r["untouched_checked"] for r in four],
    }
    print(f"[sharded] {card}: four gloo ranks {record['four']['steps_per_s']} steps/s "
          f"({record['four']['steps_per_s_after_first']} after the first step), one NCCL "
          f"rank {one['steps_per_s']:.3f} ({one['steps_per_s_after_first']:.3f}); peak memory "
          f"{[m / 1e9 for m in record['four']['max_memory_allocated']]} GB a rank, "
          f"{one['max_memory_allocated'] / 1e9:.3f} GB one rank; all_reduce of the "
          f"(512, 42, 128) pooled tensor {record['four']['allreduce_ms_median']:.3f} ms "
          f"(median of 10, CUDA events); losses {got.tolist()} vs {want.tolist()} "
          f"(max rel {rel.max():.3e}); step 1: {keys1.size} touched rows within rtol "
          f"{SHARDED_ROW_TOL['rtol']:g}; step {n}: {keys.size} touched rows, relative norm "
          f"{row_rel:.3e} (accumulator {acc_rel:.3e}), {record['rows_over_rtol']} rows past "
          f"rtol {SHARDED_ROW_TOL['rtol']:g}; the one rank's pre-activations within "
          f"{max(one['pre_activation_gap']):.3e} of their rms of the four ranks', ReLU units "
          f"on the other side of 0 a step {one['relu_flips']}; wall {four_s:.1f} + "
          f"{one_s:.1f} s", flush=True)
    return record


def _update_batch(np, cfg, b, seed):
    """(ids, mask) of ``b`` bags as a DPP batch of the benchmark cell has
    them: Zipf (a = 1.3) ids spread over the vocab by a multiplicative
    hash, each bag's first slots live (``TABLE_UPDATE_LIVE`` of them on
    average) and the rest pads (id 0, mask 0)."""
    rng = np.random.default_rng(seed)
    t, l, v = cfg.num_tables, cfg.max_ids_per_feature, cfg.vocab_per_table
    ids = ((rng.zipf(1.3, (b, t, l)) % v) * 2654435761 % v).astype(np.int32)
    n_live = rng.integers(0, int(2 * TABLE_UPDATE_LIVE * l) + 1, (b, t, 1))
    mask = (np.arange(l)[None, None, :] < n_live).astype(np.float32)
    ids[mask == 0] = 0
    return ids, mask


def _table_update_phase(torch):
    """``rowwise_adagrad`` at the benchmark cell's shape: ``dlrm-paper``'s
    42 tables of 2,000,000 x 128 float32 (43 GB) and a batch of 4096 bags
    of 32 slots, through ``DLRM.sparse_table_update_`` as the one-rank
    step calls it.  Each case is held against the plain version
    (``kernels.ref``) run on a compact copy of the rows it touches, with
    the keys renumbered, and against float64; a sample of untouched rows
    must keep its bits, the launch count grow by one, the device counters
    read the live occurrences and distinct rows, and the call's scratch
    stay far below the (N, E) per-slot gradient.  Then the kernel's
    device time (``_queued_ms``), the whole update's (operands too), the
    stable sort's alone, the parent's plain update (the per-slot
    expansion and two ``index_add_``) and the bound."""
    import numpy as np

    from repro_torch.configs.dlrm_paper import CONFIG as cfg
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import rowwise_adagrad as kadagrad
    from repro_torch.launch import roofline as rl
    from repro_torch.models.dlrm import DLRM

    dev = torch.device("cuda")
    t, v, e, l = cfg.num_tables, cfg.vocab_per_table, cfg.embed_dim, cfg.max_ids_per_feature
    b = TABLE_UPDATE_BATCH
    model = DLRM(cfg, tables=False, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    tables = torch.empty((t, v, e), device=dev).normal_(0.0, 0.02, generator=gen)
    acc = 1e-3 * torch.rand((t, v), generator=gen, device=dev)
    flat_t, flat_a = tables.view(-1, e), acc.view(-1)
    lr = torch.tensor(1e-2, device=dev)          # a 0-d device tensor, as the step's

    def device_batch(ids, mask):
        return {"sparse_ids": torch.from_numpy(ids).to(dev),
                "sparse_mask": torch.from_numpy(mask).to(dev)}

    def dpooled_of(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return 1e-2 * torch.randn((b, t, e), generator=g, device=dev)

    def check(label, batch, dpooled):
        keys, w = model._update_operands(batch, 0, v)
        grad = dpooled.reshape(-1, e)
        live = keys[(w != 0) | ~torch.isfinite(grad).all(dim=1)[:, None]]
        touched = torch.unique(keys)
        ckeys = torch.searchsorted(touched, keys.reshape(-1)).to(torch.int32).reshape(keys.shape)
        rows0, acc0 = flat_t[touched].clone(), flat_a[touched].clone()
        sample = torch.randint(0, t * v, (TABLE_UPDATE_SAMPLE,), generator=gen, device=dev)
        sample = sample[~torch.isin(sample, touched)]
        sample_rows, sample_acc = flat_t[sample].clone(), flat_a[sample].clone()
        plain = ref.rowwise_adagrad_(rows0.clone(), acc0.clone(), ckeys, w, grad, lr)
        again = ref.rowwise_adagrad_(rows0.clone(), acc0.clone(), ckeys, w, grad, lr)
        f64 = ref.rowwise_adagrad_(rows0.double(), acc0.double(), ckeys, w.double(),
                                   grad.double(), lr.double())
        kadagrad.TALLY.reset()
        launches = build.LAUNCHES.snapshot().get("rowwise_adagrad", 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.sparse_table_update_(tables, acc, dpooled, batch, lr)
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - base
        got = (flat_t[touched], flat_a[touched])
        if build.LAUNCHES.snapshot().get("rowwise_adagrad", 0) != launches + 1:
            raise RuntimeError(f"table update {label}: rowwise_adagrad not launched once")
        for name, a, want in (("rows", got[0], plain[0]), ("acc", got[1], plain[1])):
            for what in (torch.isnan, torch.isinf):
                if not torch.equal(what(a), what(want)):
                    raise RuntimeError(f"table update {label}: {name} {what.__name__[2:]} "
                                       "where the plain version has none, or none where it has")
        fin = torch.isfinite(plain[0])
        scale = float((plain[0] - rows0)[fin].abs().max()) if fin.any() else 0.0

        def rel(a, want):
            """Finite entries: rows by the largest change, accumulator
            entries each by its own size."""
            ft, fa = torch.isfinite(want[0]), torch.isfinite(want[1])
            dt = float((a[0] - want[0])[ft].abs().max()) if ft.any() else 0.0
            da = ((a[1] - want[1]).abs() / want[1].abs().clamp_min(1e-30))[fa]
            return (dt / scale if scale else dt, float(da.max()) if fa.any() else 0.0)

        err, err_plain = rel(got, plain), rel(again, plain)
        err64 = rel((got[0].double(), got[1].double()), f64)
        err64_plain = rel((plain[0].double(), plain[1].double()), f64)
        # held to float64: as close as the plain version is, give or take
        # the summation order (both add a row's occurrences to it one at a
        # time, the kernel in slot order, the plain version's atomics in the
        # hardware's)
        if any(k > p_ + TABLE_UPDATE_TOL for k, p_ in zip(err64, err64_plain)):
            raise RuntimeError(f"table update {label}: {err64} from float64 (rows by the "
                               f"largest change, accumulator entries each), the plain version "
                               f"{err64_plain} (tolerance {TABLE_UPDATE_TOL:g} beyond it)")
        if not (torch.equal(flat_t[sample], sample_rows)
                and torch.equal(flat_a[sample], sample_acc)):
            raise RuntimeError(f"table update {label}: an untouched row or accumulator moved")
        counts = kadagrad.TALLY.snapshot()[str(tables.device)]
        want_counts = {"occurrences": live.numel(), "rows": int(torch.unique(live).numel())}
        if counts != want_counts:
            raise RuntimeError(f"table update {label}: counters {counts}, expected {want_counts}")
        rec = {"slots": keys.numel(), **counts, "scratch_bytes": scratch,
               "slot_gradient_bytes": keys.numel() * e * 4,
               "rel_err_vs_plain": err, "plain_rel_err_vs_itself": err_plain,
               "rel_err_vs_float64": err64, "plain_rel_err_vs_float64": err64_plain,
               "nan_rows": int(torch.isnan(got[0]).any(dim=1).sum())}
        if scratch > rec["slot_gradient_bytes"] / 4:
            raise RuntimeError(f"table update {label}: {scratch} bytes of scratch")
        print(f"[table_update] {label}: {rec}", flush=True)
        return rec

    record = {}
    ids, mask = _update_batch(np, cfg, b, 21)
    batch, dpooled = device_batch(ids, mask), dpooled_of(22)
    record["main"] = check("main", batch, dpooled)

    # adversarial batches
    one = ids.copy(), mask.copy()
    one[0][:, 5], one[1][:, 5] = 123, 1.0              # every slot of table 5: one run of 4096 chunks
    record["one_row"] = check("one_row", device_batch(*one), dpooled_of(23))
    bad = dpooled_of(24)
    bad[7, 3, 5] = float("nan")
    bad[9, 4, 0] = float("inf")
    record["nan_inf"] = check("nan_inf", batch, bad)
    if record["nan_inf"]["nan_rows"] == 0:
        raise RuntimeError("table update nan_inf: no row took the NaN")
    pads = np.zeros_like(ids), np.zeros_like(mask)
    record["all_pads"] = check("all_pads", device_batch(*pads), dpooled_of(25))
    if record["all_pads"]["occurrences"] != 0:
        raise RuntimeError("table update all_pads: the kernel read a pad")
    last = ids.copy(), mask.copy()
    last[0][:64, t - 1, :2], last[1][:64, t - 1, :2] = (v - 1, v + 9), 1.0
    record["last_row"] = check("last_row", device_batch(*last), dpooled_of(26))
    # device times at the main batch, last, in place (the rows drift; the work does not)
    keys, w = model._update_operands(batch, 0, v)
    grad = dpooled.reshape(-1, e)
    marked = torch.where(w != 0, keys, torch.iinfo(torch.int32).max).reshape(-1)

    def parent_update():
        """The parent's one-rank update: per-slot gradients, two index_add_."""
        wb = w.reshape(b, t, l)
        rg = (dpooled[:, :, None, :] * wb[..., None]).reshape(-1, e)
        flat = keys.reshape(-1).long()
        flat_a.index_add_(0, flat, torch.mean(torch.square(rg), dim=-1))
        scale = lr / torch.sqrt(flat_a[flat] + 1e-8)
        flat_t.index_add_(0, flat, -scale[:, None] * rg)

    times = {
        "kernel_ms": _queued_ms(torch, lambda: ops.rowwise_adagrad_(flat_t, flat_a, keys, w,
                                                                   grad, lr)),
        "update_ms": _queued_ms(torch, lambda: model.sparse_table_update_(tables, acc, dpooled,
                                                                         batch, lr)),
        "sort_ms": _queued_ms(torch, lambda: torch.sort(marked, stable=True)),
        "parent_plain_ms": _queued_ms(torch, parent_update, iters=5),
        "plain_call_ms": _call_ms(torch, lambda: ref.rowwise_adagrad_(flat_t, flat_a, keys, w,
                                                                      grad, lr), iters=3),
    }
    bound_ms, side, flops, nbytes = rl.kernel_bound("rowwise_adagrad_", flat_t, flat_a, keys, w,
                                                    grad, lr)
    times.update(bound_ms=bound_ms, bound_by=side, bound_flops=flops, bound_bytes=nbytes)
    record["times"] = times
    print(f"[table_update] times at the cell's shape: {times}", flush=True)

    del tables, acc, flat_t, flat_a
    _free(torch)
    return record


def _characterization():
    """The paper's characterization models (host numpy), each once, held to
    the bands of ``tests/test_simulator.py`` and ``tests/test_extensions.py``."""
    from repro_torch.core.coordination import ReleaseProcessConfig, simulate
    from repro_torch.core.dpp.simulator import (
        C_V1, RM1, WORKLOADS, colocated_preprocessing_stall, dsi_power_split,
        worker_throughput, workers_per_trainer,
    )
    from repro_torch.core.scheduler import (
        Region, demands_from_release_sim, greedy_colocate, replicate_everywhere,
        replication_report,
    )

    out = {"host_only": True, "table9": {}, "power_split": {}}
    for name, want in TABLE9.items():
        w = WORKLOADS[name]
        t = worker_throughput(w, C_V1)
        got = dict(kqps=t.kqps, rx=t.storage_rx_gbps, trx=t.transform_rx_gbps,
                   tx=t.tx_gbps, wpt=workers_per_trainer(w, C_V1))
        for k, v in got.items():
            band = 0.12 if k == "wpt" else 0.08
            if abs(v - want[k]) / want[k] >= band:
                raise RuntimeError(f"Table 9 {name} {k} {v} vs the paper's {want[k]}")
        out["table9"][name] = dict(got, bound=t.bound)
    stall = colocated_preprocessing_stall(RM1)
    if not (0.45 < stall["gpu_stall_frac"] < 0.7 and stall["cpu_util"] > 0.85):
        raise RuntimeError(f"Table 7 co-located stall {stall}")
    out["table7_rm1"] = stall
    for name, w in WORKLOADS.items():
        out["power_split"][name] = dsi_power_split(w, n_trainers=16)
    p1, p2 = out["power_split"]["RM1"], out["power_split"]["RM2"]
    if not (p1["preprocessing_frac"] + p1["storage_frac"] > 0.5
            and p2["training_frac"] > p1["training_frac"]):
        raise RuntimeError(f"Fig. 1 power split {out['power_split']}")
    jobs = simulate(ReleaseProcessConfig(days=60, seed=3))
    demands = demands_from_release_sim(jobs, {})
    total_peak = sum(d.peak_compute for d in demands)
    regions = [Region(f"R{i}", capacity=total_peak, storage_pb=1e3) for i in range(5)]
    packed = greedy_colocate(demands, regions)
    rep = replication_report(demands, replicate_everywhere(demands, regions), packed)
    if rep["storage_saved_frac"] <= 0.3:
        raise RuntimeError(f"scheduler saved {rep['storage_saved_frac']} of storage")
    for d in demands:
        if packed.replicas(d.name) < 2:
            raise RuntimeError(f"{d.name} placed in {packed.replicas(d.name)} regions")
    for r in regions:
        if packed.region_peak[r.name] > r.capacity + 1e-6:
            raise RuntimeError(f"region {r.name} over capacity")
    out["release_sim_jobs"] = len(jobs)
    out["replication"] = rep
    return out


def _flash_close(got, want, v, dtype_name):
    """The largest |got - want| in units of rms(v), and the largest share of
    its per-element bound that an element uses: the sweep's bound is
    tol * (1 + |want|) in those units, so within tolerance means a share
    of at most 1."""
    tol = FLASH_TOL[dtype_name]
    scale = float(v.float().square().mean().sqrt())
    diff = (got.float() - want.float()).abs() / scale
    share = diff / (tol * (1 + want.float().abs() / scale))
    return float(diff.max()), float(share.max())


def _lm_serve_path(torch):
    """Full-width qwen3-8b through the port's serve path on the card, with
    the launch counts set to 0 just before and read just after; then a
    profiled decode loop, the attention operands of layers 0 and 35 from
    another prefill, and the full-width BatchingServer.  Returns the
    launches, the captured operands and the path's numbers."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import BatchingServer, Request, ServerConfig

    t = time.perf_counter()
    model = build_model(CONFIG, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[lm] {CONFIG.name}: {n_params} parameters ({param_bytes / 1e9:.3f} GB) drawn "
          f"on the card in {time.perf_counter() - t:.2f} s", flush=True)
    # a first call at the same shapes (cuBLAS handles, the kernel's set-up)
    t = time.perf_counter()
    serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=2,
                cache_len=LM_CACHE)
    print(f"[lm] first call (prefill + 2 decode steps) {time.perf_counter() - t:.2f} s",
          flush=True)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    out = serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=LM_DECODE,
                      cache_len=LM_CACHE)
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] main path launches {launches}", flush=True)
    # the prefill's bf16, D=128 operands take the tensor-core route in every
    # layer, and the FMA route not once
    if (launches.get("flash_attention_sm90", 0) != CONFIG.num_layers
            or launches.get("flash_attention", 0) != 0):
        raise RuntimeError(f"the prefill launched flash_attention_sm90 "
                           f"{launches.get('flash_attention_sm90', 0)} times and "
                           f"flash_attention {launches.get('flash_attention', 0)} times, "
                           f"expected {CONFIG.num_layers} and 0")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_BATCH, 1 + LM_DECODE) or int(tokens.min()) < 0
            or int(tokens.max()) >= CONFIG.vocab_size):
        raise RuntimeError(f"bad sampled tokens {tuple(tokens.shape)}")
    print(f"[lm] serve: prefill_s={out['prefill_s']:.6f} decode_s={out['decode_s']:.6f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.3f} peak device memory "
          f"{peak / 1e9:.3f} GB, finite logits, sampled tokens[0] "
          f"{tokens[0, :16].tolist()}", flush=True)

    # the decode loop again under the profiler: the device's busy share
    cache = model.init_cache(LM_BATCH, LM_CACHE)
    token = tokens[:, :1].to("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_DECODE):
            logits, cache = model.decode_step({"token": token, "pos": i, "cache": cache})
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_wall = time.perf_counter() - t0
    by_name, device_ops = _device_by_name(torch, prof)
    busy = sum(by_name.values()) / 1e6 if by_name else None
    launches_per_step = device_ops / LM_DECODE if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[lm] profiled decode loop: {decode_wall:.6f} s wall, device busy "
          f"{_fmt(busy, '.6f')} s, idle share {_fmt(_idle_share(busy, decode_wall), '.5f')}, "
          f"{_fmt(launches_per_step, '.0f')} device kernels "
          f"and copies a step (profile and summary "
          f"{time.perf_counter() - t:.2f} s)", flush=True)
    del cache, logits

    # what one decode step must read: every weight but the token table, of
    # which only B rows are read (the cache's few rows are left out)
    tok_bytes = model.embed.tok.numel() * model.embed.tok.element_size()
    step_bytes = param_bytes - tok_bytes + LM_BATCH * CONFIG.d_model * 2
    decode_bound = LM_BATCH / (step_bytes / HBM_BYTES_PER_S)

    # the attention operands of layers 0 and 35, from another prefill: the
    # (B, H, S, D) views that blocked_attention hands to kernels.ops
    captured = []
    original = ops.flash_attention

    def capture(q, k, v, **kw):
        if len(captured) in LM_CAPTURE_LAYERS:
            captured.append((q.clone(), k.clone(), v.clone()))
        else:
            captured.append(None)
        return original(q, k, v, **kw)

    ops.flash_attention = capture
    t = time.perf_counter()
    try:
        serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=0,
                    cache_len=LM_CACHE)
    finally:
        ops.flash_attention = original
    operands = {i: captured[i] for i in LM_CAPTURE_LAYERS}
    print(f"[lm] operands of layers {LM_CAPTURE_LAYERS} captured in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    numbers = {
        "config": CONFIG.name, "parameters": n_params, "param_bytes": param_bytes,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "decode_steps": LM_DECODE,
        "cache_len": LM_CACHE, "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "flash_attention_sm90_launches": launches.get("flash_attention_sm90", 0),
        "flash_attention_launches": launches.get("flash_attention", 0),
        "peak_device_bytes": peak, "profiled_decode_s": decode_wall,
        "decode_device_busy_s": busy, "decode_device_idle_share": _idle_share(busy, decode_wall),
        "decode_step_bytes": step_bytes, "decode_bound_tok_per_s": decode_bound,
        "decode_device_top_us": {k[:80]: v for k, v in top},
        "decode_device_ops_per_step": launches_per_step,
        "sampled_tokens_0": tokens[0, :16].tolist(),
    }
    del captured, model, out
    torch.cuda.empty_cache()

    # the full-width BatchingServer: 4 slots, 4 requests
    t = time.perf_counter()
    server = BatchingServer(CONFIG, ServerConfig(slots=4, cache_len=LM_CACHE), seed=0,
                            device="cuda")
    print(f"[lm] BatchingServer built in {time.perf_counter() - t:.2f} s", flush=True)
    rng = np.random.default_rng(1)
    for rid in range(4):
        server.submit(Request(rid=rid, prompt=rng.integers(0, CONFIG.vocab_size, 16)
                              .astype(np.int32), max_new_tokens=8))
    t0 = time.perf_counter()
    done = server.run()
    server_s = time.perf_counter() - t0
    if len(done) != 4 or any(len(r.output) != 8 for r in done) or any(
            not 0 <= tok < CONFIG.vocab_size for r in done for tok in r.output):
        raise RuntimeError(f"BatchingServer finished {[len(r.output) for r in done]}")
    report = BatchingServer.latency_report(done)
    print(f"[lm] BatchingServer: 4 requests in {server_s:.3f} s, latency_report "
          f"{json.dumps(report)}", flush=True)
    numbers["server"] = {"slots": 4, "requests": 4, "prompt_len": 16, "new_tokens": 8,
                         "run_s": server_s, "latency_report": report,
                         "outputs": {r.rid: r.output for r in done}}
    del server
    torch.cuda.empty_cache()
    return launches, operands, numbers


def _flash_checks(torch, operands, launches):
    """``flash_attention`` at the main path's operands (layers 0 and 35):
    in bf16 as the path runs it, through the tensor-core route the
    operands pick and through the FMA route, each within the sweep's bf16
    tolerance of the bf16 and the float32 plain versions; and on the same
    operands cast to float32 (same shapes and strides, the FMA route),
    within the sweep's float32 tolerance of the float32 plain version,
    which holds the masking, tiling and GQA indexing at main-path sizes to
    2e-5.  Then times of both routes, the plain version and
    ``F.scaled_dot_product_attention`` beside the bound (layer 0's
    operands): one row for each route."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import kernel_bound

    worst = {"flash_attention_sm90": 0.0, "flash_attention": 0.0}
    for layer, (q, k, v) in sorted(operands.items()):
        if kflash.route(q, k, v) != "sm90":
            raise RuntimeError(f"layer {layer}'s operands do not take the tensor-core route")
        want = ref.flash_attention(q, k, v)
        q32, k32, v32 = q.float(), k.float(), v.float()
        want32 = ref.flash_attention(q32, k32, v32)
        got32 = kflash.flash_attention(q32, k32, v32, causal=True)
        torch.cuda.synchronize()
        err32, share32 = _flash_close(got32, want32, v32, "float32")
        del got32
        if share32 > 1:
            raise RuntimeError(f"flash_attention: layer {layer}'s operands: float32 "
                               f"{err32:.3e} of rms(v), share of the bound {share32:.3f}")
        for name, fn in (("flash_attention_sm90", kflash.flash_attention),
                         ("flash_attention", kflash.flash_attention_fma)):
            got = fn(q, k, v, causal=True)
            torch.cuda.synchronize()
            err, share = _flash_close(got, want, v, "bfloat16")
            err_f, share_f = _flash_close(got, want32, v, "bfloat16")
            if max(share, share_f) > 1:
                raise RuntimeError(f"{name}: layer {layer}'s operands: bf16 {err:.3e} (plain "
                                   f"bf16), {err_f:.3e} (plain f32) of rms(v); shares of the "
                                   f"bound {share:.3f}, {share_f:.3f}")
            worst[name] = max(worst[name], err)
            print(f"[kernel] {name} layer {layer} q {tuple(q.shape)} k {tuple(k.shape)} "
                  f"strides {q.stride()}: bf16 max |kernel - plain| {err:.3e} rms(v) (bf16 "
                  f"plain), {err_f:.3e} (f32 plain), largest share of the per-element bound "
                  f"{FLASH_TOL['bfloat16']:g}*(1 + |want|/rms(v)) {share:.3f} and "
                  f"{share_f:.3f}", flush=True)
        print(f"[kernel] flash_attention layer {layer} float32 (FMA route) vs float32 plain "
              f"{err32:.3e} rms(v), share of {FLASH_TOL['float32']:g}*(1 + |want|/rms(v)) "
              f"{share32:.3f}; rms(v) {float(v.float().square().mean().sqrt()):.4f}",
              flush=True)
        del want, want32, q32, k32, v32

    q, k, v = operands[LM_CAPTURE_LAYERS[0]]
    plain = lambda: ref.flash_attention(q, k, v)
    library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    lib_err, lib_share = _flash_close(library(), plain(), v, "bfloat16")
    if lib_share > 1:
        raise RuntimeError(f"SDPA disagrees with the plain version: {lib_err:.3e} rms(v)")
    # bytes: q, k, v read once and out written once; operations: 2 products
    # of 2*D flops for each (query, key) pair the causal mask keeps
    bound_ms, bound_by, flops, nbytes = kernel_bound("flash_attention", q, k, v, causal=True)
    shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} {str(q.dtype).split('.')[-1]} causal "
             f"(layer {LM_CAPTURE_LAYERS[0]} of the qwen3-8b prefill)")
    plain_ms = _queued_ms(torch, plain, iters=5)
    plain_call_ms = _call_ms(torch, plain, iters=5)
    library_ms = _queued_ms(torch, library)
    library_call_ms = _call_ms(torch, library, iters=20)
    rows = []
    # device times from CUDA events around calls queued behind a sleep:
    # after the profiled decode loop, torch.profiler's sums for these calls
    # came out below the float32 FMA floor of the kernel's work, or empty
    for name, source, fn in (
            ("flash_attention_sm90", "src/repro_torch/csrc/flash_attention_sm90.cu",
             kflash.flash_attention_sm90),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             kflash.flash_attention_fma)):
        kernel = lambda fn=fn: fn(q, k, v, causal=True)
        row = dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/flash_attention.py:62", shape=shape,
            launches=launches.get(name, 0), max_abs_err=worst[name],
            ms=_queued_ms(torch, kernel), plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, call_ms=_call_ms(torch, kernel, iters=20),
            plain_call_ms=plain_call_ms, library_call_ms=library_call_ms,
        )
        rows.append(row)
        print(f"[kernel] {name} {shape}: kernel_ms={row['ms']:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms:.6f} "
              f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}: {flops} flops, {nbytes} "
              f"bytes) call_ms={row['call_ms']:.6f} plain_call_ms={plain_call_ms:.6f} "
              f"library_call_ms={library_call_ms:.6f}", flush=True)
    # the two routes and SDPA again, in turns, for the spread within this run
    turns = {"flash_attention_sm90": [], "library": []}
    for _ in range(3):
        turns["flash_attention_sm90"].append(
            _queued_ms(torch, lambda: kflash.flash_attention_sm90(q, k, v, causal=True)))
        turns["library"].append(_queued_ms(torch, library))
    rows[0]["turns_ms"] = turns
    print(f"[kernel] flash_attention_sm90 and SDPA in turns: {json.dumps(turns)}", flush=True)
    return rows


def _flash_adversarial_checks(torch) -> None:
    """``flash_attention`` against its plain version on inputs the main
    path never makes, through whichever route each takes: S of 1, 63, 65
    and 1000, T != S (full attention), head dims 32, 48 (padded to 64), 64
    and 128, GQA groups 1 and 4, both types; and scores of |s| ~ 1e4 from
    integer q and k at D=64 (every score exact in float32), one case with a
    key ramp that moves each row's running max at every key tile.  Then the
    tensor-core route at its edges: S and T of 1, 127, 129 and 1000, T != S
    with full attention, D 64 and 128, GQA groups 1, 4 and 8, and the
    model's transposed (B, S, H, D) views.  bf16 results are held to the
    float32 plain version on the same operands as well."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(13)
    routes = {"sm90": 0, "fma": 0}

    def check(name, q, k, v, causal):
        dtype = str(q.dtype).split(".")[-1]
        routes[kflash.route(q, k, v)] += 1
        got = kflash.flash_attention(q, k, v, causal=causal)
        want32 = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal)
        wants = [("f32 plain", want32)]
        if name != "large":       # the bf16 plain version rounds |s| ~ 1e4 scores to bf16
            wants.append(("plain", ref.flash_attention(q, k, v, causal=causal)))
        torch.cuda.synchronize()
        for label, want in wants:
            err, share = _flash_close(got, want, v, dtype)
            if share > 1:
                raise RuntimeError(f"flash_attention {name} {tuple(q.shape)} k "
                                   f"{tuple(k.shape)} {dtype} causal={causal} route "
                                   f"{kflash.route(q, k, v)}: {err:.3e} rms(v) from the "
                                   f"{label} version")

    def normal(b, h, kvh, s, t, d, dtype, model_layout=False):
        if model_layout:
            shapes = ((b, s, h, d), (b, t, kvh, d), (b, t, kvh, d))
            return [torch.randn(x, generator=gen, device="cuda").to(dtype).transpose(1, 2)
                    for x in shapes]
        return [torch.randn(x, generator=gen, device="cuda").to(dtype)
                for x in ((b, h, s, d), (b, kvh, t, d), (b, kvh, t, d))]

    shapes = ((1, 2, 2, 1, 1, 32, True), (2, 4, 1, 63, 63, 64, True),
              (2, 8, 2, 65, 65, 128, True), (1, 4, 4, 1000, 1000, 128, True),
              (2, 8, 2, 65, 100, 128, False), (2, 4, 4, 1, 300, 64, False),
              (3, 4, 1, 130, 77, 48, False), (1, 4, 1, 200, 130, 32, True))
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, kvh, s, t, d, causal in shapes:
            check("normal", *normal(b, h, kvh, s, t, d, dtype), causal)
        # large scores: integers in [-128, 128] are exact in bf16, every dot
        # (< 2^24) exact in float32, and the scale 1/8 exact at D=64
        q = torch.randint(-128, 129, (2, 4, 200, 64), generator=gen, device="cuda")
        k = torch.randint(-128, 129, (2, 2, 200, 64), generator=gen, device="cuda")
        v = torch.randn((2, 2, 200, 64), generator=gen, device="cuda")
        s_max = float((q.float() @ k.float().repeat_interleave(2, 1).transpose(-1, -2)).abs()
                      .max()) / 8
        check("large", q.to(dtype), k.to(dtype), v.to(dtype), True)
        check("large", q.to(dtype), k.to(dtype), v.to(dtype), False)
        # a ramp: row i's largest score is at key i, so the running max moves
        # at every key tile; scores up to 16 * 64 * 125 / 8 = 16000
        ramp = (torch.arange(1000, device="cuda") // 8).clamp(max=125)
        q = torch.full((1, 2, 1000, 64), 16.0, device="cuda")
        k = ramp[None, None, :, None].expand(1, 2, 1000, 64).float()
        v = torch.randn((1, 2, 1000, 64), generator=gen, device="cuda")
        check("large", q.to(dtype), k.to(dtype), v.to(dtype), True)
    fma_cases = routes["fma"]
    # the tensor-core route at its edges: ragged S and T against its 128-row
    # tiles, T != S, D 64 and 128, GQA groups 1, 4 and 8, the model layout
    edges = [(1, 8, 8, s, s, 128, True) for s in (1, 127, 129, 1000)]
    edges += [(2, 8, 2, 127, 129, 64, False), (1, 8, 1, 129, 1000, 128, False),
              (2, 8, 8, 1000, 1, 64, False), (1, 8, 2, 1, 1000, 128, False),
              (2, 4, 1, 129, 300, 128, True), (1, 8, 1, 1000, 127, 64, True)]
    for b, h, kvh, s, t, d, causal in edges:
        for layout in (False, True):
            ops = normal(b, h, kvh, s, t, d, torch.bfloat16, model_layout=layout)
            if kflash.route(*ops) != "sm90":
                raise RuntimeError(f"edge case {(b, h, kvh, s, t, d)} took the FMA route")
            check("edge", *ops, causal)
    # the |s| ~ 1e4 integer scores and the ramp at D = 128 on the tensor cores
    q = torch.randint(-128, 129, (1, 8, 300, 128), generator=gen, device="cuda")
    k = torch.randint(-128, 129, (1, 1, 300, 128), generator=gen, device="cuda")
    v = torch.randn((1, 1, 300, 128), generator=gen, device="cuda")
    check("large", q.bfloat16(), k.bfloat16(), v.bfloat16(), True)
    q = torch.full((1, 4, 1000, 128), 16.0, device="cuda")
    k = ramp[None, None, :, None].expand(1, 1, 1000, 128).float()
    v = torch.randn((1, 1, 1000, 128), generator=gen, device="cuda")
    check("large", q.bfloat16(), k.bfloat16(), v.bfloat16(), True)
    print(f"[adversarial] flash_attention S in (1, 63, 65, 127, 129, 130, 200, 300, 1000), "
          f"T != S, D in (32, 48, 64, 128), groups 1/2/4/8, f32 and bf16, the model's "
          f"transposed views, |s| up to {s_max:.0f} and a ramp to 16000: within tolerance "
          f"({routes['sm90']} cases on the tensor-core route, {fma_cases} on the FMA route)",
          flush=True)


def _lm_card_vs_cpu(torch):
    """A depth-2, full-width qwen3-8b from one set of weights (drawn on the
    card from seed 1) on the card and on the CPU: prefill of 2 prompts of
    64 tokens, then 4 greedy decode steps.  Every greedy token equal in
    both types; float32 logits within rtol = atol = 1e-3, bf16 logits
    each within 10% of their rms (the CPU tests' bound against the
    reference)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.models import build_model

    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, CONFIG.vocab_size, (2, 64)).astype(np.int32))
    result = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(CONFIG, num_layers=2, param_dtype=dtype, compute_dtype=dtype)
        card = build_model(cfg, device="cuda").init(1)
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        runs = {}
        for dev, model in (("cuda", card), ("cpu", cpu)):
            t0 = time.perf_counter()
            logits, _ = model.prefill({"tokens": prompt})
            steps = [logits.float().cpu()]
            cache = model.init_cache(2, 16)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            toks = [token.cpu()]
            for pos in range(4):
                logits, cache = model.decode_step({"token": token, "pos": pos, "cache": cache})
                steps.append(logits.float().cpu())
                token = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(token.cpu())
            runs[dev] = (steps, torch.cat(toks, dim=1), time.perf_counter() - t0)
            del cache, logits
        del card, cpu
        torch.cuda.empty_cache()
        (g_steps, g_toks, g_s), (c_steps, c_toks, c_s) = runs["cuda"], runs["cpu"]
        errs = [float((g - c).abs().max()) for g, c in zip(g_steps, c_steps)]
        rel = [e / float(c.square().mean().sqrt()) for e, c in zip(errs, c_steps)]
        same = bool(torch.equal(g_toks, c_toks))
        if name == "float32":
            if not all(torch.allclose(g, c, rtol=1e-3, atol=1e-3)
                       for g, c in zip(g_steps, c_steps)):
                raise RuntimeError(f"card vs CPU float32 logits differ by up to {max(errs)}")
        elif max(rel) > 0.1:
            raise RuntimeError(f"card vs CPU bf16 logits differ by {max(rel):.3f} of their rms")
        if not same:
            raise RuntimeError(f"card vs CPU {name} greedy tokens differ: {g_toks.tolist()} "
                               f"vs {c_toks.tolist()}")
        result[name] = {"max_abs_logit_diff": errs, "max_diff_over_rms": rel,
                        "greedy_tokens_equal": same, "card_tokens": g_toks.tolist(),
                        "cpu_tokens": c_toks.tolist(), "card_s": g_s, "cpu_s": c_s}
        print(f"[lm] card vs CPU, depth 2 full width, {name}: max |logit diff| per call "
              f"{['%.3e' % e for e in errs]} ({['%.3e' % r for r in rel]} of rms), greedy "
              f"tokens equal: {same}; card {g_s:.2f} s, CPU {c_s:.2f} s", flush=True)
    return result


def _standalone_checks(torch, operands):
    """``sigrid_hash`` and ``bucketize`` at one ``dlrm-paper`` batch's shapes:
    the (512, 1344) sparse id tile (42 tables x 32 ids, ids drawn over the
    whole int32 range from a seed, max_value 2,000,000) and the (512, 504)
    dense tile that ``dense_unpack`` gives for the first stripe (NaN where
    a value is absent) with the reference's 63 bucketize borders.  Each
    bit-exact against its plain version; times of kernel, plain version
    and, for ``bucketize``, ``torch.bucketize`` (which agrees where v is
    not NaN: a search puts NaN past the last border, the count gives 0).
    ``sigrid_hash`` is timed again in turns beside ``torch.bitwise_xor(ids,
    salt)``, which moves the same bytes with one op (``same_bytes_ms``: a
    floor, not a library time for the function), at this tile and at an
    8-batch one.  No path of the port launches either kernel (launches
    0)."""
    import numpy as np

    from repro_torch.configs.dlrm_paper import CONFIG
    from repro_torch.kernels import bucketize as kbucketize
    from repro_torch.kernels import decode as kdecode
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigrid_hash as ksigrid
    from repro_torch.launch.roofline import kernel_bound

    rng = np.random.default_rng(21)
    ids = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (
        BATCH, CONFIG.num_tables * CONFIG.max_ids_per_feature), dtype=np.int64)
        .astype(np.int32)).cuda()
    salt, max_value = 1, CONFIG.vocab_per_table
    bm, vals = operands["dense_unpack"]
    dense = kdecode.dense_unpack(bm, vals).view(torch.float32).T.contiguous()
    borders = torch.linspace(-3, 3, 63, dtype=torch.float64).float().cuda()
    cases = [
        dict(name="sigrid_hash", source="src/repro_torch/csrc/sigrid_hash.cu",
             replaces="src/repro/kernels/sigrid_hash.py:34",
             kernel=lambda: ksigrid.sigrid_hash(ids, salt, max_value),
             plain=lambda: ref.sigrid_hash(ids, salt, max_value), library=None,
             bound=kernel_bound("sigrid_hash", ids, salt, max_value),
             shape=f"ids {tuple(ids.shape)} max_value {max_value}"),
        dict(name="bucketize", source="src/repro_torch/csrc/bucketize.cu",
             replaces="src/repro/kernels/bucketize.py:30",
             kernel=lambda: kbucketize.bucketize(dense, borders),
             plain=lambda: ref.bucketize(dense, borders),
             library=lambda: torch.bucketize(dense, borders, out_int32=True),
             bound=kernel_bound("bucketize", dense, borders),
             shape=f"values {tuple(dense.shape)} borders {borders.numel()} "
                   f"(NaN {int(torch.isnan(dense).sum())})"),
    ]
    rows = []
    for c in cases:
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"{c['name']}: kernel disagrees with its plain version")
        if c["library"] is not None:
            ok = ~torch.isnan(dense)
            if not torch.equal(c["library"]()[ok], want[ok]):
                raise RuntimeError(f"{c['name']}: library call disagrees with the plain version")
        ms = _queued_ms(torch, c["kernel"])
        plain_ms = _queued_ms(torch, c["plain"], iters=5)
        library_ms = _queued_ms(torch, c["library"]) if c["library"] else None
        bound_ms, bound_by = c["bound"][:2]
        row = dict(
            name=c["name"], shape=c["shape"], route="cuda", source=c["source"],
            replaces=c["replaces"], launches=0, max_abs_err=0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, call_ms=_call_ms(torch, c["kernel"]),
            plain_call_ms=_call_ms(torch, c["plain"], iters=20),
            library_call_ms=_call_ms(torch, c["library"]) if c["library"] else None,
        )
        if c["name"] == "bucketize":
            row["more_borders"] = _bucketize_more_borders(torch, dense)
        rows.append(row)
        print(f"[kernel] {c['name']} {c['shape']}: bit-exact, kernel_ms={ms:.6f} "
              f"plain_ms={plain_ms:.6f} library_ms={library_ms} "
              f"bound_ms={row['bound_ms']:.6f} call_ms={row['call_ms']:.6f} "
              f"plain_call_ms={row['plain_call_ms']:.6f} "
              f"library_call_ms={row['library_call_ms']}", flush=True)
    turns = _sigrid_turns(torch, ids, salt, max_value)
    rows[0].update(turns_ms=turns, same_bytes_ms=statistics.median(turns["same_bytes"]))
    print(f"[kernel] sigrid_hash {rows[0]['shape']}: the kernel and the same-bytes "
          f"torch.bitwise_xor in turns {json.dumps(turns)}", flush=True)
    ids8 = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (
        8 * BATCH, ids.shape[1]), dtype=np.int64).astype(np.int32)).cuda()
    if not torch.equal(ksigrid.sigrid_hash(ids8, salt, max_value),
                       ref.sigrid_hash(ids8, salt, max_value)):
        raise RuntimeError(f"sigrid_hash at {tuple(ids8.shape)} differs")
    rows[0]["batch8"] = dict(shape=list(ids8.shape),
                             bound_ms=kernel_bound("sigrid_hash", ids8, salt, max_value)[0],
                             turns_ms=_sigrid_turns(torch, ids8, salt, max_value))
    print(f"[kernel] sigrid_hash 8-batch tile, bit-exact, in turns: "
          f"{json.dumps(rows[0]['batch8'])}", flush=True)
    return rows


def _sigrid_turns(torch, ids, salt, max_value):
    """``sigrid_hash`` and ``torch.bitwise_xor(ids, salt)`` (the same bytes
    with one op) in turns, three times each way round."""
    from repro_torch.kernels import sigrid_hash as ksigrid

    fns = {"sigrid_hash": lambda: ksigrid.sigrid_hash(ids, salt, max_value),
           "same_bytes": lambda: torch.bitwise_xor(ids, salt)}
    turns = {name: [] for name in fns}
    for t in range(6):
        for name in (list(fns) if t % 2 == 0 else list(fns)[::-1]):
            turns[name].append(_queued_ms(torch, fns[name]))
    return turns


def _bucketize_more_borders(torch, dense):
    """``bucketize`` on the same dense tile with other borders, bit-exact and
    timed beside ``torch.bucketize`` where the borders are sorted: 63 sorted
    borders with ties (runs of equal borders and -0.0/+0.0 pairs), 5,000
    sorted ones and 5,000 unsorted ones (past the 4,096 the first kernel
    held in shared memory)."""
    import numpy as np

    from repro_torch.kernels import bucketize as kbucketize
    from repro_torch.kernels import ref

    rng = np.random.default_rng(23)
    lin = np.linspace(-3, 3, 63).astype(np.float32)
    ties = np.sort(np.concatenate([lin[:36], np.repeat(lin[36:43], 3),
                                   [-0.0, 0.0, -0.0, 0.0, 0.0, -0.0]]).astype(np.float32),
                   kind="stable")
    many = rng.standard_normal(5000).astype(np.float32) * 2
    cases = {"63 with ties": ties, "5000 sorted": np.sort(many), "5000 unsorted": many}
    out = {}
    for name, b in cases.items():
        bd = torch.from_numpy(b).cuda()
        want = ref.bucketize(dense, bd)
        if not torch.equal(kbucketize.bucketize(dense, bd), want):
            raise RuntimeError(f"bucketize: {name} borders differ from the plain version")
        sorted_ = bool((bd[:-1] <= bd[1:]).all())
        ok = ~torch.isnan(dense)
        if sorted_ and not torch.equal(torch.bucketize(dense, bd, out_int32=True)[ok], want[ok]):
            raise RuntimeError(f"bucketize: torch.bucketize disagrees on {name} borders")
        out[name] = dict(
            ms=_queued_ms(torch, lambda: kbucketize.bucketize(dense, bd)),
            library_ms=(_queued_ms(torch, lambda: torch.bucketize(dense, bd, out_int32=True))
                        if sorted_ else None))
    print(f"[kernel] bucketize other borders on the same tile, bit-exact: {json.dumps(out)}",
          flush=True)
    return out


def _standalone_adversarial_checks(torch) -> None:
    """``sigrid_hash`` and ``bucketize`` bit-exact on inputs the data path
    never makes: INT_MIN, -1 and 0 ids, salts 0 and 2^32-1, max_value 1,
    2, 3, 2^16+1, 2,000,000, 2^31-1, 2^31, 2^31+5, 2^32-2 and 2^32-1
    (remainders above INT_MAX wrap negative), odd and unaligned tiles;
    NaN, infinite, subnormal and signed-zero values tied with borders, NaN
    and unsorted borders, sorted borders with ties, 0, 1, 1000 and 5000
    borders (sorted and unsorted)."""
    import numpy as np

    from repro_torch.kernels import bucketize as kbucketize
    from repro_torch.kernels import ref
    from repro_torch.kernels import sigrid_hash as ksigrid

    rng = np.random.default_rng(22)
    ids = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, 70_001, dtype=np.int64)
                           .astype(np.int32)).cuda()
    ids[:4] = torch.tensor([-(2 ** 31), -1, 0, 2 ** 31 - 1], dtype=torch.int32)
    negative = False
    for t in (ids, ids[1:], ids[:70_000].view(350, 200), ids[:1]):
        for salt in (0, 2 ** 32 - 1):
            for mv in (1, 2, 3, 2 ** 16 + 1, 2_000_000, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 5,
                       2 ** 32 - 2, 2 ** 32 - 1):
                got = ksigrid.sigrid_hash(t, salt, mv)
                if not torch.equal(got, ref.sigrid_hash(t, salt, mv)):
                    raise RuntimeError(f"sigrid_hash {tuple(t.shape)} salt {salt} "
                                       f"max_value {mv} differs")
                negative |= bool((got < 0).any())
    if not negative:
        raise RuntimeError("sigrid_hash: no remainder above INT_MAX wrapped negative")
    print("[adversarial] sigrid_hash INT_MIN/-1/0, salts 0 and 2^32-1, max_value 1, 2, 3, "
          "2^16+1, 2e6, 2^31-1, 2^31, 2^31+5, 2^32-2, 2^32-1, unaligned and odd tiles: "
          "bit-exact", flush=True)

    v = torch.from_numpy((rng.standard_normal(50_001) * 3).astype(np.float32)).cuda()
    v[:9] = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1e-40,
                          -1e-40, 1.0, -1.0])
    borders = {
        "none": torch.zeros(0), "one": torch.tensor([0.0]),
        "signed zeros": torch.tensor([-0.0, 0.0, 1e-40, 1.0]),
        "NaN": torch.tensor([-1.0, float("nan"), 0.5, float("nan")]),
        "unsorted": torch.tensor([2.0, -1.0, 0.0, -float("inf"), float("inf"), 0.5]),
        "1000": torch.from_numpy(np.sort(rng.standard_normal(1000).astype(np.float32))),
        "ties": torch.tensor([-2.0, -1.0, -1.0, -1.0, -0.0, 0.0, -0.0, 0.0, 1e-40, 1.0, 1.0]),
        "5000 sorted": torch.from_numpy(np.sort(rng.standard_normal(5000).astype(np.float32))
                                        .round(1)),
        "5000 unsorted": torch.from_numpy(rng.standard_normal(5000).astype(np.float32)),
    }
    for name, bd in borders.items():
        bd = bd.cuda()
        for t in (v, v[1:], v[2:], v[:50_000].view(100, 500)):
            if not torch.equal(kbucketize.bucketize(t, bd), ref.bucketize(t, bd)):
                raise RuntimeError(f"bucketize {name} borders {tuple(t.shape)} differs")
    print("[adversarial] bucketize NaN/inf/subnormal/signed-zero values, aligned and "
          "unaligned tiles; no, one, signed-zero, NaN, unsorted, 1000 sorted, tied, and 5000 "
          "sorted and unsorted borders: bit-exact", flush=True)


def _ssd_bound(x, b_, chunk):
    """The least time of one SSD launch: bytes (x, dt, A, B, C read once,
    y and the (B, H, P, N) float32 state written once) at 3.35 TB/s against
    the operations of the chunked form with the causal half of each
    chunk's Q x Q products only (C.B^T and m.x over the lower triangle,
    C.state and the state update in full) at the bf16 tensor peak.
    Returns (ms, bound_by, flops, bytes): ``launch.roofline.kernel_bound``,
    whose count reads only x's and B's shapes and dtypes."""
    from repro_torch.launch.roofline import kernel_bound

    return kernel_bound("ssd_chunk_forward", x, None, None, b_, None, chunk=chunk)


def _ssd_close(got, want, tol):
    """The largest |got - want| in units of rms(want), and the largest share
    of its per-element bound ``atol * rms(want) + rtol * |want|`` that an
    element uses (within tolerance: a share of at most 1)."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt())
    diff = (got - want).abs()
    share = diff / (atol * rms + rtol * want.abs())
    return float(diff.max()) / rms, float(share.max())


def _ssm_serve_path(torch):
    """Full-width mamba2-2.7b through the port's serve path on the card, with
    the launch counts set to 0 just before and read just after; then a
    short profiled decode window, the SSD operands of layers 0 and 63 from
    another prefill, and the full-width BatchingServer.  Returns the
    launches, the captured operands and the path's numbers."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.serving import BatchingServer, Request, ServerConfig

    s_cfg = CONFIG.ssm
    t = time.perf_counter()
    model = build_model(CONFIG, device="cuda").init(0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[ssm] {CONFIG.name}: {n_params} parameters ({param_bytes / 1e9:.3f} GB) drawn "
          f"on the card in {time.perf_counter() - t:.2f} s", flush=True)
    t = time.perf_counter()
    serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=2,
                cache_len=LM_CACHE)
    print(f"[ssm] first call (prefill + 2 decode steps) {time.perf_counter() - t:.2f} s",
          flush=True)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    out = serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=LM_DECODE,
                      cache_len=LM_CACHE)
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] main path launches {launches}", flush=True)
    if launches != {"ssd_chunk_forward_sm90": CONFIG.num_layers}:
        raise RuntimeError(f"the prefill launched {launches}, expected the tensor-core "
                           f"ssd_chunk_forward_sm90 {CONFIG.num_layers} times, the FMA "
                           "route's ssd_chunk_forward not once, and nothing else")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_BATCH, 1 + LM_DECODE) or int(tokens.min()) < 0
            or int(tokens.max()) >= CONFIG.vocab_size):
        raise RuntimeError(f"bad sampled tokens {tuple(tokens.shape)}")
    print(f"[ssm] serve: prefill_s={out['prefill_s']:.6f} decode_s={out['decode_s']:.6f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.3f} peak device memory "
          f"{peak / 1e9:.3f} GB, finite logits, sampled tokens[0] "
          f"{tokens[0, :16].tolist()}", flush=True)

    # one short profiled decode window: device ops and busy time a step
    window = 4
    cache = model.init_cache(LM_BATCH, LM_CACHE)
    token = tokens[:, :1].to("cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(window):
            logits, cache = model.decode_step({"token": token, "pos": i, "cache": cache})
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    by_name, device_ops = _device_by_name(torch, prof)
    busy = sum(by_name.values()) / 1e6 if by_name else None
    ops_per_step = device_ops / window if by_name else None
    busy_per_step = busy / window if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[ssm] profiled decode window of {window} steps: {window_s:.6f} s wall, device "
          f"busy {_fmt(busy, '.6f')} s, idle share {_fmt(_idle_share(busy, window_s), '.5f')}, "
          f"{_fmt(ops_per_step, '.0f')} device kernels and copies a step (profile and "
          f"summary {time.perf_counter() - t:.2f} s)", flush=True)
    del cache, logits

    # bounds: decode reads every weight but the token table (B rows of it)
    # and reads and writes the state and conv tails; the prefill's
    # projections and logits at the bf16 peak, plus the SSD's operations
    tok_bytes = model.embed.tok.numel() * model.embed.tok.element_size()
    cache_bytes = sum(math.prod(shape) * (torch.finfo(dtype).bits // 8)
                      for shape, dtype in model.abstract_cache(LM_BATCH, 0).values())
    step_bytes = param_bytes - tok_bytes + LM_BATCH * CONFIG.d_model * 2 + 2 * cache_bytes
    decode_bound = LM_BATCH / (step_bytes / HBM_BYTES_PER_S)
    d, din = CONFIG.d_model, s_cfg.d_inner(CONFIG.d_model)
    h, gn = s_cfg.n_heads(CONFIG.d_model), s_cfg.n_groups * s_cfg.d_state
    proj_flops = (2 * LM_BATCH * LM_PROMPT * CONFIG.num_layers
                  * (d * (2 * din + 2 * gn + h) + din * d)
                  + 2 * LM_BATCH * d * CONFIG.vocab_size)

    # the SSD operands of layers 0 and 63, from another prefill: what
    # ssd_chunked hands to kernels.ops
    captured = []
    original = ops.ssd_chunk_forward

    def capture(x, dt, a, b_, c_, **kw):
        if len(captured) in SSM_CAPTURE_LAYERS:
            captured.append(tuple(t.clone() for t in (x, dt, a, b_, c_)))
        else:
            captured.append(None)
        return original(x, dt, a, b_, c_, **kw)

    ops.ssd_chunk_forward = capture
    t = time.perf_counter()
    try:
        serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=0,
                    cache_len=LM_CACHE)
    finally:
        ops.ssd_chunk_forward = original
    operands = {i: captured[i] for i in SSM_CAPTURE_LAYERS}
    print(f"[ssm] operands of layers {SSM_CAPTURE_LAYERS} captured in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    x, _, _, b_, _ = operands[SSM_CAPTURE_LAYERS[0]]
    _, _, ssd_flops, _ = _ssd_bound(x, b_, s_cfg.chunk)
    prefill_bound = (proj_flops + CONFIG.num_layers * ssd_flops) / BF16_OPS_PER_S
    numbers = {
        "config": CONFIG.name, "parameters": n_params, "param_bytes": param_bytes,
        "batch": LM_BATCH, "prompt_len": LM_PROMPT, "decode_steps": LM_DECODE,
        "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "decode_tok_per_s": out["decode_tok_per_s"],
        "ssd_chunk_forward_sm90_launches": launches.get("ssd_chunk_forward_sm90", 0),
        "ssd_chunk_forward_launches": launches.get("ssd_chunk_forward", 0),
        "peak_device_bytes": peak, "prefill_projection_flops": proj_flops,
        "prefill_ssd_flops": CONFIG.num_layers * ssd_flops,
        "prefill_bound_s": prefill_bound, "decode_step_bytes": step_bytes,
        "decode_bound_tok_per_s": decode_bound, "profiled_window_steps": window,
        "profiled_window_s": window_s, "decode_device_busy_s_per_step": busy_per_step,
        "decode_device_ops_per_step": ops_per_step,
        "decode_device_idle_share": _idle_share(busy, window_s),
        "decode_device_top_us": {k[:80]: v for k, v in top},
        "sampled_tokens_0": tokens[0, :16].tolist(),
    }
    print(f"[ssm] bounds: prefill {prefill_bound * 1e3:.3f} ms ({proj_flops} projection "
          f"flops + {CONFIG.num_layers * ssd_flops} SSD flops at the bf16 peak), decode "
          f"{decode_bound:.1f} tokens/s ({step_bytes} bytes a step)", flush=True)
    del captured, model, out
    torch.cuda.empty_cache()

    t = time.perf_counter()
    server = BatchingServer(CONFIG, ServerConfig(slots=4, cache_len=LM_CACHE), seed=0,
                            device="cuda")
    print(f"[ssm] BatchingServer built in {time.perf_counter() - t:.2f} s", flush=True)
    rng = np.random.default_rng(1)
    for rid in range(4):
        server.submit(Request(rid=rid, prompt=rng.integers(0, CONFIG.vocab_size, 16)
                              .astype(np.int32), max_new_tokens=8))
    t0 = time.perf_counter()
    done = server.run()
    server_s = time.perf_counter() - t0
    if len(done) != 4 or any(len(r.output) != 8 for r in done) or any(
            not 0 <= tok < CONFIG.vocab_size for r in done for tok in r.output):
        raise RuntimeError(f"BatchingServer finished {[len(r.output) for r in done]}")
    report = BatchingServer.latency_report(done)
    print(f"[ssm] BatchingServer: 4 requests in {server_s:.3f} s, latency_report "
          f"{json.dumps(report)}", flush=True)
    numbers["server"] = {"slots": 4, "requests": 4, "prompt_len": 16, "new_tokens": 8,
                         "run_s": server_s, "latency_report": report,
                         "outputs": {r.rid: r.output for r in done}}
    del server
    torch.cuda.empty_cache()
    return launches, operands, numbers


def _ssd_checks(torch, operands, launches):
    """``ssd_chunk_forward`` at the main path's operands (layers 0 and 63):
    in bf16 as the path runs it, through the tensor-core route the
    operands pick and through the FMA route, and on the same operands cast
    to float32 (the FMA route), y and the final state against the plain
    version (the sequential float32 recurrence) within ``SSD_TOL``; each
    route's largest share of the per-element bound is printed.  Then times
    of both routes and the plain version beside the bound (layer 0's bf16
    operands), and the two routes again in turns: one row for each route.
    The plain version's 1024 positions take ~9 small launches each, more
    than can be queued behind a sleep, so its time is a call time (CUDA
    events around back-to-back calls)."""
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as kssd

    chunk = CONFIG.ssm.chunk
    routes = (("ssd_chunk_forward_sm90", "src/repro_torch/csrc/ssd_chunk_sm90.cu",
               kssd.ssd_chunk_forward_sm90),
              ("ssd_chunk_forward", "src/repro_torch/csrc/ssd_chunk.cu",
               kssd.ssd_chunk_forward_fma))
    worst = {name: 0.0 for name, _, _ in routes}
    shares = {name: 0.0 for name, _, _ in routes}
    for layer, ops_ in sorted(operands.items()):
        x, dt, a, b_, c_ = ops_
        if kssd.route(x, b_, c_, chunk) != "sm90":
            raise RuntimeError(f"layer {layer}'s SSD operands do not take the tensor-core route")
        for name, fn in [(n, f) for n, _, f in routes] + [("float32", kssd.ssd_chunk_forward)]:
            args = (x, b_, c_) if name != "float32" else (x.float(), b_.float(), c_.float())
            dtype = "float32" if name == "float32" else "bfloat16"
            xx, bb, cc = args
            y, state = fn(xx, dt, a, bb, cc, chunk=chunk)
            want_y, want_state = ref.ssd_scan(xx, dt, a, bb, cc)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(state).all()):
                raise RuntimeError(f"{name} layer {layer} {dtype}: not finite")
            err_y, share_y = _ssd_close(y, want_y, SSD_TOL[dtype])
            err_s, share_s = _ssd_close(state, want_state, SSD_TOL["float32"])
            if max(share_y, share_s) > 1:
                raise RuntimeError(f"{name} layer {layer} {dtype}: y {err_y:.3e} of rms(y), "
                                   f"state {err_s:.3e} of rms(state); shares of the bound "
                                   f"{share_y:.3f}, {share_s:.3f}")
            if name in worst:
                worst[name] = max(worst[name], err_y)
                shares[name] = max(shares[name], share_y, share_s)
            label = "ssd_chunk_forward (FMA route)" if name == "float32" else name
            print(f"[kernel] {label} layer {layer} {dtype} x {tuple(x.shape)} B/C "
                  f"{tuple(b_.shape)}: max |kernel - plain| y {err_y:.3e} rms(y), state "
                  f"{err_s:.3e} rms(state); largest share of the per-element bound "
                  f"atol*rms + rtol*|want| {SSD_TOL[dtype]} {share_y:.3f} (y), "
                  f"{SSD_TOL['float32']} {share_s:.3f} (state); rms(y) "
                  f"{float(want_y.float().square().mean().sqrt()):.4e}, rms(state) "
                  f"{float(want_state.square().mean().sqrt()):.4e}, dt max "
                  f"{float(dt.max()):.2f}", flush=True)
            del y, state, want_y, want_state
    print(f"[kernel] ssd_chunk_forward at layers {SSM_CAPTURE_LAYERS}, bf16: each route's "
          f"largest share of the per-element bound (y or state) {json.dumps(shares)}",
          flush=True)

    x, dt, a, b_, c_ = operands[SSM_CAPTURE_LAYERS[0]]
    plain = lambda: ref.ssd_scan(x, dt, a, b_, c_)
    bound_ms, bound_by, flops, nbytes = _ssd_bound(x, b_, chunk)
    plain_ms = _call_ms(torch, plain, iters=3)
    shape = (f"x {tuple(x.shape)} B/C {tuple(b_.shape)} bf16 chunk {chunk} "
             f"(layer {SSM_CAPTURE_LAYERS[0]} of the mamba2-2.7b prefill)")
    rows = []
    for name, source, fn in routes:
        kernel = lambda fn=fn: fn(x, dt, a, b_, c_, chunk=chunk)
        row = dict(
            name=name, route="cuda", source=source,
            replaces="src/repro/kernels/ssd_chunk.py:67", shape=shape,
            launches=launches.get(name, 0), max_abs_err=worst[name],
            ms=_queued_ms(torch, kernel), plain_ms=plain_ms, plain_timed_by="call",
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            call_ms=_call_ms(torch, kernel, iters=20), plain_call_ms=plain_ms,
            library_call_ms=None,
        )
        rows.append(row)
        print(f"[kernel] {name} {shape}: kernel_ms={row['ms']:.6f} plain_ms={plain_ms:.6f} "
              f"(call time) library_ms=None bound_ms={bound_ms:.6f} ({bound_by}: {flops} "
              f"flops, {nbytes} bytes) call_ms={row['call_ms']:.6f}", flush=True)
    # the two routes again, in turns, for the spread within this run
    turns = {name: [] for name, _, _ in routes}
    for _ in range(3):
        for name, _, fn in routes:
            turns[name].append(_queued_ms(torch, lambda fn=fn: fn(x, dt, a, b_, c_, chunk=chunk)))
    rows[0]["turns_ms"] = turns
    print(f"[kernel] ssd_chunk_forward's two routes in turns: {json.dumps(turns)}", flush=True)
    return rows


def _ssd_adversarial_checks(torch) -> None:
    """``ssd_chunk_forward`` against its plain version on inputs the main
    path never makes, through whichever route each takes: S of 1, 63, 256,
    300 and 1000 (ragged last chunks, one position); groups 1, 2 and 8; P
    and N of 16, 64 and 128; dt large enough that cs reaches -1e4 in a
    chunk (every exp underflows but the diagonal's); A = 0 (no decay at
    all); an initial state; float32 and bf16, y and the final state within
    ``SSD_TOL``.  Then bf16 cases that must take the tensor-core route:
    ragged S of 1, 63, 300 and 1000, G of 2 and 8, P of 128, N of 64,
    chunks of 64 and 128, dt*A ~ -40, A = 0 and an initial state."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as kssd

    gen = torch.Generator(device="cuda").manual_seed(14)
    # (B, S, H, P, G, N, chunk, kind)
    cases = ((1, 1, 8, 64, 1, 128, 256, "normal"), (2, 63, 8, 16, 2, 16, 256, "normal"),
             (1, 256, 16, 64, 8, 64, 256, "normal"), (2, 300, 8, 128, 2, 128, 256, "normal"),
             (1, 1000, 8, 64, 1, 128, 256, "normal"), (2, 130, 4, 16, 1, 64, 64, "normal"),
             (1, 512, 4, 64, 1, 64, 256, "large dt"), (1, 300, 4, 32, 2, 32, 128, "A = 0"),
             (2, 200, 8, 64, 2, 128, 256, "initial state"))
    sm90_cases = ((1, 1, 8, 64, 1, 128, 256, "normal"), (2, 63, 8, 64, 1, 128, 64, "normal"),
                  (2, 300, 8, 64, 2, 128, 256, "normal"),
                  (1, 1000, 16, 64, 8, 64, 128, "normal"),
                  (2, 300, 4, 128, 1, 128, 128, "normal"),
                  (1, 512, 4, 64, 1, 64, 256, "large dt"), (1, 300, 4, 64, 2, 128, 64, "A = 0"),
                  (2, 200, 8, 128, 2, 64, 256, "initial state"))
    taken = {"sm90": 0, "fma": 0}
    for dtype, case_list, must in ((torch.float32, cases, None), (torch.bfloat16, cases, None),
                                   (torch.bfloat16, sm90_cases, "sm90")):
        name = str(dtype).split(".")[-1]
        for bsz, s, h, p, g, n, chunk, kind in case_list:
            x = (torch.randn((bsz, s, h, p), generator=gen, device="cuda") * 0.5).to(dtype)
            dt = torch.nn.functional.softplus(torch.randn((bsz, s, h), generator=gen,
                                                          device="cuda"))
            a = -torch.exp(torch.randn(h, generator=gen, device="cuda") * 0.3)
            bm = (torch.randn((bsz, s, g, n), generator=gen, device="cuda") * 0.5).to(dtype)
            cm = (torch.randn((bsz, s, g, n), generator=gen, device="cuda") * 0.5).to(dtype)
            init = None
            if kind == "large dt":                 # dt*A ~ -40 a position
                dt = dt + 40.0
                a = -torch.ones_like(a)
            elif kind == "A = 0":
                a = torch.zeros_like(a)
            elif kind == "initial state":
                init = torch.randn((bsz, h, p, n), generator=gen, device="cuda")
            route = kssd.route(x, bm, cm, chunk)
            if must is not None and route != must:
                raise RuntimeError(f"ssd_chunk_forward {kind} (P={p}, N={n}, chunk {chunk}) "
                                   f"{name}: route {route}, expected {must}")
            taken[route] += 1
            y, state = kssd.ssd_chunk_forward(x, dt, a, bm, cm, chunk=chunk,
                                              initial_state=init)
            want_y, want_state = ref.ssd_scan(x, dt, a, bm, cm, init)
            torch.cuda.synchronize()
            if not (torch.isfinite(y.float()).all() and torch.isfinite(state).all()):
                raise RuntimeError(f"ssd_chunk_forward {kind} S={s} {name}: not finite")
            err_y, share_y = _ssd_close(y, want_y, SSD_TOL[name])
            err_s, share_s = _ssd_close(state, want_state, SSD_TOL["float32"])
            if max(share_y, share_s) > 1:
                raise RuntimeError(f"ssd_chunk_forward ({route} route) {kind} (B={bsz}, S={s}, "
                                   f"H={h}, P={p}, G={g}, N={n}, chunk {chunk}) {name}: y "
                                   f"{err_y:.3e} rms(y), state {err_s:.3e} rms(state), shares "
                                   f"{share_y:.3f}, {share_s:.3f}")
    print(f"[adversarial] ssd_chunk_forward S in (1, 63, 130, 200, 256, 300, 512, 1000), "
          f"G in (1, 2, 8), P and N in (16, 32, 64, 128), chunks 64/128/256, dt*A ~ -40 "
          f"(|cs| to 1e4), A = 0, an initial state, f32 and bf16, through the route each "
          f"takes ({taken['sm90']} cases on the tensor-core route, {taken['fma']} on the FMA "
          f"route): within tolerance", flush=True)


def _ssm_card_vs_cpu(torch):
    """A depth-2, full-width mamba2-2.7b from one set of weights (drawn on
    the card from seed 1) on the card and on the CPU: prefill of 2 prompts
    of 512 tokens (2 chunks), then 4 greedy decode steps.  float32: every
    call's logits within 1e-3 of their rms, greedy tokens equal; bf16:
    within 10% of their rms, both sides fed the CPU's tokens (bf16 logits
    of a random model tie often), and whether the card's greedy tokens
    equal the CPU's is printed.  The prefill's final state and conv tails
    are held to the same bounds in relative norm, ||card - cpu|| / ||cpu||:
    the state is heavy-tailed (its largest element ~50x its rms) and each
    element depends exponentially on dt, which reaches 150 at these random
    weights, so one rounding of dt's projection that differs between the
    devices moves single elements by far more than the rms (bf16: 1.5x the
    rms on an H100) while the tensor as a whole, and the decode
    steps that read it, stay close.  The largest |diff| over the rms is
    printed for each, and the largest relative norm of one (layer, batch
    row, head) of the state.

    That the per-element gap comes from the operands and not from the
    scan is checked per element: each layer's scan, fed on the CPU the
    card's own operands (x, dt, A, B, C as the card's projections, convs
    and softplus made them), gives the card's y and final state within
    ``SSD_TOL`` (the state at the float32 bound), and how far the card's
    operands sit from the CPU's is printed.  A fault of the kernel in one
    head would show there, undiluted by the other 79."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.models import build_model, ssm

    scan = ssm.ssd_chunked

    def prefill_capturing(model, scans):
        """The model's prefill, each layer's scan operands and outputs
        copied to the host."""
        def capture(x, dt, a, b_, c_, chunk, initial_state=None):
            y, state = scan(x, dt, a, b_, c_, chunk, initial_state)
            scans.append(([t.to("cpu", copy=True) for t in (x, dt, a, b_, c_)],
                          y.to("cpu", copy=True), state.to("cpu", copy=True)))
            return y, state

        ssm.ssd_chunked = capture
        try:
            return model.prefill({"tokens": prompt})
        finally:
            ssm.ssd_chunked = scan

    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, CONFIG.vocab_size, (2, 512)).astype(np.int32))
    result = {}
    for name, dtype, tol in (("float32", torch.float32, 1e-3),
                             ("bfloat16", torch.bfloat16, 0.1)):
        cfg = dataclasses.replace(CONFIG, num_layers=2, param_dtype=dtype, compute_dtype=dtype)
        card = build_model(cfg, device="cuda").init(1)
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        t0 = time.perf_counter()
        c_scans, g_scans = [], []
        c_logits, c_cache = prefill_capturing(cpu, c_scans)
        c_steps, c_toks = [c_logits.float()], [torch.argmax(c_logits, dim=-1).to(torch.int32)]
        cache = {k: v.clone() for k, v in c_cache.items()}
        for pos in range(4):
            lg, cache = cpu.decode_step({"token": c_toks[-1], "pos": pos, "cache": cache})
            c_steps.append(lg.float())
            c_toks.append(torch.argmax(lg, dim=-1).to(torch.int32))
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        g_logits, g_cache = prefill_capturing(card, g_scans)
        g_steps, g_toks = [g_logits.float().cpu()], [torch.argmax(g_logits, dim=-1).cpu()]
        g_prefill_cache = {k: v.to("cpu", torch.float32, copy=True) for k, v in g_cache.items()}
        cache = g_cache
        for pos in range(4):
            token = (g_toks[-1] if name == "float32" else c_toks[pos]).to(torch.int32)
            lg, cache = card.decode_step({"token": token, "pos": pos, "cache": cache})
            g_steps.append(lg.float().cpu())
            g_toks.append(torch.argmax(lg, dim=-1).cpu().to(torch.int32))
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        del card, cpu, cache, g_cache
        torch.cuda.empty_cache()
        rel = lambda g, c: float((g.float() - c.float()).abs().max()
                                 / c.float().square().mean().sqrt())
        rel_norm = lambda g, c: float((g.float() - c.float()).norm() / c.float().norm())
        logit_rel = [rel(g, c) for g, c in zip(g_steps, c_steps)]
        cache_rel = {k: rel(g_prefill_cache[k], c_cache[k]) for k in sorted(c_cache)}
        cache_norm = {k: rel_norm(g_prefill_cache[k], c_cache[k]) for k in sorted(c_cache)}
        same = bool(torch.equal(torch.cat(g_toks, 1).to(torch.int32),
                                torch.cat(c_toks, 1).to(torch.int32)))
        # ||card - cpu|| / ||cpu|| of each (layer, batch row, head) of the state
        g_state, c_state = g_prefill_cache["state"], c_cache["state"].float()
        head_norm = float(((g_state - c_state).flatten(3).norm(dim=-1)
                           / c_state.flatten(3).norm(dim=-1)).max())
        witness = []
        for layer, ((g_ops, g_y, g_s), (c_ops, _, _)) in enumerate(zip(g_scans, c_scans)):
            w_y, w_s = scan(*g_ops, CONFIG.ssm.chunk)
            err_y, share_y = _ssd_close(g_y, w_y, SSD_TOL[name])
            err_s, share_s = _ssd_close(g_s, w_s, SSD_TOL["float32"])
            if max(share_y, share_s) > 1:
                raise RuntimeError(f"card vs CPU {name} layer {layer}: the card's scan "
                                   f"against the CPU's on the card's operands: y {err_y:.3e}, "
                                   f"state {err_s:.3e} of the rms; shares of the bound "
                                   f"{share_y:.3f}, {share_s:.3f}")
            gdt, cdt = g_ops[1], c_ops[1]
            witness.append({
                "layer": layer, "y_max_diff_over_rms": err_y, "y_share": share_y,
                "state_max_diff_over_rms": err_s, "state_share": share_s,
                "dt_max": float(cdt.max()), "dt_max_abs_diff": float((gdt - cdt).abs().max()),
                "operand_share_differing": {
                    k: float((g != c).float().mean())
                    for k, g, c in zip(("x", "dt", "B", "C"), (g_ops[0], gdt, *g_ops[3:]),
                                       (c_ops[0], cdt, *c_ops[3:]))}})
        del g_scans, c_scans
        result[name] = {"logits_max_diff_over_rms": logit_rel,
                        "prefill_cache_rel_norm": cache_norm,
                        "prefill_cache_max_diff_over_rms": cache_rel,
                        "state_worst_head_rel_norm": head_norm,
                        "scan_on_card_operands": witness,
                        "greedy_tokens_equal": same, "card_s": card_s, "cpu_s": cpu_s}
        if max(logit_rel + list(cache_norm.values())) > tol:
            raise RuntimeError(f"card vs CPU {name}: logits {logit_rel} of their rms, prefill "
                               f"cache {cache_norm} in relative norm, bound {tol}")
        if name == "float32" and not same:
            raise RuntimeError(f"card vs CPU float32 greedy tokens differ: "
                               f"{torch.cat(g_toks, 1).tolist()} vs {torch.cat(c_toks, 1).tolist()}")
        print(f"[ssm] card vs CPU, depth 2 full width, prompt 512, {name}: logits per call "
              f"{['%.3e' % r for r in logit_rel]} (max |diff| over rms), prefill cache "
              f"{ {k: '%.3e' % v for k, v in cache_norm.items()} } (relative norm; bound "
              f"{tol}); prefill cache max |diff| over rms "
              f"{ {k: '%.3e' % v for k, v in cache_rel.items()} }; worst (layer, row, head) "
              f"of the state {head_norm:.3e} (relative norm); greedy tokens equal: "
              f"{same}; card {card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
        for w in witness:
            print(f"[ssm] card vs CPU {name} layer {w['layer']}: the CPU's scan on the card's "
                  f"operands gives the card's y within {w['y_max_diff_over_rms']:.3e} and its "
                  f"state within {w['state_max_diff_over_rms']:.3e} of the rms (shares of the "
                  f"per-element bound {w['y_share']:.3f}, {w['state_share']:.3f}); the card's "
                  f"operands against the CPU's: dt (max {w['dt_max']:.2f}) differs by up to "
                  f"{w['dt_max_abs_diff']:.4g}, share of elements differing "
                  f"{ {k: '%.3e' % v for k, v in w['operand_share_differing'].items()} }",
                  flush=True)
    return result


def _free(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def _lm_families_path(torch):
    """Full-width deepseek-v2-236b (MLA + MoE), its depth cut to
    ``FAM_LAYERS`` of 60, through the port's serve path on the card with
    the launch counts set to 0 just before and read just after; the
    attention operands of layers 0 and 5 from another prefill; then the
    full-width 4-slot BatchingServer.  Returns the launches, the captured
    operands and the path's numbers."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving import BatchingServer, Request, ServerConfig

    _free(torch)
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(CONFIG, num_layers=FAM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[families] {cfg.name} at full width, {FAM_LAYERS} of {CONFIG.num_layers} layers: "
          f"{n_params} parameters ({param_bytes / 1e9:.3f} GB) drawn on the card in "
          f"{init_s:.2f} s, peak {init_peak / 1e9:.3f} GB ({held / 1e9:.3f} GB held before)",
          flush=True)
    t = time.perf_counter()
    serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=2,
                cache_len=LM_CACHE)
    print(f"[families] first call (prefill + 2 decode steps) {time.perf_counter() - t:.2f} s",
          flush=True)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    out = serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=LM_DECODE,
                      cache_len=LM_CACHE)
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    print(f"[families] main path launches {launches}", flush=True)
    # MLA's D = 192 operands take the FMA route in every layer's prefill,
    # the tensor-core route not once, and no other kernel runs
    others = {k: n for k, n in launches.items() if n and k != "flash_attention"}
    if launches.get("flash_attention", 0) != FAM_LAYERS or others:
        raise RuntimeError(f"the prefill launched flash_attention "
                           f"{launches.get('flash_attention', 0)} times and {others}, "
                           f"expected {FAM_LAYERS} and nothing else")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError("non-finite logits")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_BATCH, 1 + LM_DECODE) or int(tokens.min()) < 0
            or int(tokens.max()) >= cfg.vocab_size):
        raise RuntimeError(f"bad sampled tokens {tuple(tokens.shape)}")
    cap = moe_lib._capacity(LM_BATCH * LM_PROMPT, cfg.moe)
    if cap != FAM_CAPACITY:
        raise RuntimeError(f"MoE capacity {cap} at {LM_BATCH * LM_PROMPT} tokens, expected "
                           f"{FAM_CAPACITY}")
    print(f"[families] serve: prefill_s={out['prefill_s']:.6f} decode_s={out['decode_s']:.6f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.3f} peak device memory "
          f"{peak / 1e9:.3f} GB, finite logits, MoE capacity {cap} slots an expert at "
          f"{LM_BATCH * LM_PROMPT} tokens (top {cfg.moe.top_k} of {cfg.moe.num_experts}), "
          f"sampled tokens[0] {tokens[0, :16].tolist()}", flush=True)

    # the attention operands of layers 0 and 5, from another prefill
    captured = []
    original = ops.flash_attention

    def capture(q, k, v, **kw):
        keep = len(captured) in FAM_CAPTURE_LAYERS
        captured.append((q.clone(), k.clone(), v.clone(), kw) if keep else None)
        return original(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        serve.serve(model, batch=LM_BATCH, prompt_len=LM_PROMPT, decode_steps=0,
                    cache_len=LM_CACHE)
    finally:
        ops.flash_attention = original
    operands = {i: captured[i] for i in FAM_CAPTURE_LAYERS}
    numbers = {
        "config": cfg.name, "layers": FAM_LAYERS, "published_layers": CONFIG.num_layers,
        "parameters": n_params, "param_bytes": param_bytes, "init_s": init_s,
        "init_peak_device_bytes": init_peak, "batch": LM_BATCH, "prompt_len": LM_PROMPT,
        "decode_steps": LM_DECODE, "cache_len": LM_CACHE, "prefill_s": out["prefill_s"],
        "decode_s": out["decode_s"], "decode_tok_per_s": out["decode_tok_per_s"],
        "launches": launches, "peak_device_bytes": peak, "moe_capacity": cap,
        "sampled_tokens_0": tokens[0, :16].tolist(),
    }
    del captured, model, out
    _free(torch)

    # the full-width BatchingServer: 4 slots, 4 requests
    t = time.perf_counter()
    server = BatchingServer(cfg, ServerConfig(slots=4, cache_len=LM_CACHE), seed=0,
                            device="cuda")
    print(f"[families] BatchingServer built in {time.perf_counter() - t:.2f} s", flush=True)
    rng = np.random.default_rng(1)
    for rid in range(4):
        server.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, 16)
                              .astype(np.int32), max_new_tokens=8))
    t0 = time.perf_counter()
    done = server.run()
    server_s = time.perf_counter() - t0
    if len(done) != 4 or any(len(r.output) != 8 for r in done) or any(
            not 0 <= tok < cfg.vocab_size for r in done for tok in r.output):
        raise RuntimeError(f"BatchingServer finished {[len(r.output) for r in done]}")
    report = BatchingServer.latency_report(done)
    print(f"[families] BatchingServer: 4 requests in {server_s:.3f} s, latency_report "
          f"{json.dumps(report)}", flush=True)
    numbers["server"] = {"slots": 4, "requests": 4, "prompt_len": 16, "new_tokens": 8,
                         "run_s": server_s, "latency_report": report}
    del server
    _free(torch)
    return launches, operands, numbers


def _mla_flash_checks(torch, operands, launches):
    """``flash_attention`` at MLA's D = 192 on the FMA route, at the
    prefill's operands of layers 0 and 5 (q, k and v padded from 128 to
    192 as ``mla_prefill_attention`` hands them over, scale 1/sqrt(192)):
    bf16 within the sweep's bf16 tolerance of the plain version on the
    same values in float32, the same operands in float32 within the
    float32 tolerance of it, and the padded output columns exactly 0.
    The plain version in bf16 rounds the scores q.k to bf16 (as the
    reference's oracle does), while the TPU kernel and this one keep them
    in float32: at these random weights MLA's scaled scores reach ~1e2,
    where a bf16 rounding moves a score by ~0.5 and the near one-hot
    softmax with it, so its distance is printed and not held (as for the
    |s| ~ 1e4 adversarial cases).  Then the kernel, the plain version and
    ``F.scaled_dot_product_attention`` timed at layer 0's operands beside
    the bound: one row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import kernel_bound

    worst = 0.0
    for layer, (q, k, v, kw) in sorted(operands.items()):
        scale = kw.get("scale")
        if (q.shape[-1] != MLA_QK_DIM or kflash.route(q, k, v) != "fma"
                or abs(scale - 1 / math.sqrt(MLA_QK_DIM)) > 1e-12):
            raise RuntimeError(f"layer {layer}: D {q.shape[-1]}, route "
                               f"{kflash.route(q, k, v)}, scale {scale}")
        if v[..., MLA_V_DIM:].any():
            raise RuntimeError(f"layer {layer}: v's padded columns are not zero")
        got = kflash.flash_attention(q, k, v, causal=True, scale=scale)
        want = ref.flash_attention(q, k, v, causal=True, scale=scale)
        want32 = ref.flash_attention(q.float(), k.float(), v.float(), causal=True, scale=scale)
        s_max = max(float((q[:, :, i:i + 128].float() @ k[:, :, :i + 128].float()
                           .transpose(-1, -2)).abs().max()) for i in range(0, q.shape[2], 128))
        torch.cuda.synchronize()
        err, share = _flash_close(got, want, v, "bfloat16")
        err_f, share_f = _flash_close(got, want32, v, "bfloat16")
        if share_f > 1 or got[..., MLA_V_DIM:].any():
            raise RuntimeError(f"flash_attention D=192 layer {layer}: bf16 {err_f:.3e} of rms(v) "
                               f"from the plain version in float32, share {share_f:.3f}; padded "
                               f"columns zero: {not got[..., MLA_V_DIM:].any()}")
        del got, want
        got32 = kflash.flash_attention(q.float(), k.float(), v.float(), causal=True,
                                       scale=scale)
        torch.cuda.synchronize()
        err32, share32 = _flash_close(got32, want32, v.float(), "float32")
        del got32, want32
        if share32 > 1:
            raise RuntimeError(f"flash_attention D=192 layer {layer}: float32 {err32:.3e} of "
                               f"rms(v), share {share32:.3f}")
        worst = max(worst, err_f)
        print(f"[kernel] flash_attention D=192 layer {layer} q {tuple(q.shape)} strides "
              f"{q.stride()}, largest scaled score {s_max * scale:.1f}: bf16 max |kernel - "
              f"plain| {err_f:.3e} rms(v) (plain in float32, share of the bound "
              f"{share_f:.3f}; the bf16 plain version, scores rounded to bf16, {err:.3e}); "
              f"float32 {err32:.3e} rms(v), share {share32:.3f}; padded columns 0", flush=True)

    q, k, v, kw = operands[FAM_CAPTURE_LAYERS[0]]
    scale = kw["scale"]
    kernel = lambda: kflash.flash_attention(q, k, v, causal=True, scale=scale)  # noqa: E731
    plain = lambda: ref.flash_attention(q, k, v, causal=True, scale=scale)  # noqa: E731
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, scale=scale)
    lib_err, lib_share = _flash_close(
        library(), ref.flash_attention(q.float(), k.float(), v.float(), causal=True,
                                       scale=scale), v, "bfloat16")
    if lib_share > 1:
        raise RuntimeError(f"SDPA disagrees with the plain version in float32 at D=192: "
                           f"{lib_err:.3e} rms(v)")
    bound_ms, bound_by, flops, nbytes = kernel_bound("flash_attention", q, k, v, causal=True,
                                                     scale=scale)
    shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} bfloat16 causal, v padded 128 -> 192 "
             f"(layer {FAM_CAPTURE_LAYERS[0]} of the deepseek-v2-236b prefill)")
    row = dict(
        name="flash_attention_d192", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:62", shape=shape, counter="flash_attention",
        launches=launches.get("flash_attention", 0), max_abs_err=worst,
        ms=_queued_ms(torch, kernel, iters=10), plain_ms=_queued_ms(torch, plain, iters=5),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_queued_ms(torch, library), call_ms=_call_ms(torch, kernel, iters=5),
        plain_call_ms=_call_ms(torch, plain, iters=5),
        library_call_ms=_call_ms(torch, library, iters=20), flops=flops, bytes=nbytes,
    )
    print(f"[kernel] flash_attention_d192 {shape}: kernel_ms={row['ms']:.6f} "
          f"plain_ms={row['plain_ms']:.6f} library_ms={row['library_ms']:.6f} "
          f"bound_ms={row['bound_ms']:.6f} ({row['bound_by']}: {flops} flops, {nbytes} bytes) "
          f"call_ms={row['call_ms']:.6f} plain_call_ms={row['plain_call_ms']:.6f} "
          f"library_call_ms={row['library_call_ms']:.6f}", flush=True)
    return row


def _mla_flash_adversarial_checks(torch) -> None:
    """``flash_attention`` above D = 128 against its plain version, every
    case on the FMA route: D of 129, 160 and 192 x S of 1, 63, 65 and 1000
    x float32 and bf16, each as the model's transposed (B, S, H, D) views
    with GQA group 1 (causal, T = S) and as contiguous (B, H, S, D)
    tensors with GQA group 4 and T = S + 37 (full attention); bf16 results
    also against the float32 plain version."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(192)
    n = 0
    for d in (129, 160, 192):
        for s in (1, 63, 65, 1000):
            for dtype in (torch.float32, torch.bfloat16):
                name = str(dtype).split(".")[-1]
                cases = (
                    [torch.randn(shape, generator=gen, device="cuda").to(dtype).transpose(1, 2)
                     for shape in ((2, s, 8, d), (2, s, 8, d), (2, s, 8, d))] + [True],
                    [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((1, 8, s, d), (1, 2, s + 37, d), (1, 2, s + 37, d))]
                    + [False])
                for q, k, v, causal in cases:
                    if kflash.route(q, k, v) != "fma":
                        raise RuntimeError(f"D={d} took the {kflash.route(q, k, v)} route")
                    got = kflash.flash_attention(q, k, v, causal=causal)
                    wants = [("plain", ref.flash_attention(q, k, v, causal=causal)),
                             ("f32 plain", ref.flash_attention(q.float(), k.float(), v.float(),
                                                               causal=causal))]
                    torch.cuda.synchronize()
                    for label, want in wants:
                        err, share = _flash_close(got, want, v, name)
                        if share > 1:
                            raise RuntimeError(
                                f"flash_attention D={d} q {tuple(q.shape)} k {tuple(k.shape)} "
                                f"{name} causal={causal}: {err:.3e} rms(v) from the {label} "
                                "version")
                    n += 1
    print(f"[adversarial] flash_attention D in (129, 160, 192) x S in (1, 63, 65, 1000) x "
          f"f32/bf16, model views with group 1 (causal) and contiguous with group 4, T = S + 37 "
          f"(full): {n} cases on the FMA route within tolerance", flush=True)


def _families_card_vs_cpu(torch):
    """deepseek-v2-236b at full width, depth 1, from one set of weights
    (drawn on the card from seed 1) on the card and on the CPU, in float32
    and in bf16: a prefill of one 64-token prompt, then ``FAM_CPU_DECODE``
    decode steps with both fed the card's tokens.  Each call's MoE routing
    is recorded on both; a token whose chosen set of experts differs is a
    flip, reported with its top-k margin (its k-th less its (k+1)-th
    router probability, on the card); every flip must sit at a margin
    under ``ROUTE_FLIP_MARGIN`` in both types.  float32: every call's
    logits within rtol = atol = 1e-3 of the CPU's and the greedy tokens
    equal.  bf16: the logits of every call with no flip within 10% of
    their rms (the CPU tests' bf16 bound) and the greedy tokens equal; a
    call with a flip is reported and not held.  A flip shows that the
    router's input moved between the devices, and the same move sets the
    logits apart: at these random weights MLA's scaled scores reach ~2e3
    (the "scaled" initializer's fan-in is the layer count, 1 here), so
    the attention's softmax is near one-hot, and a bf16 rounding of q or
    k that differs between the devices' matrix products moves a score by
    ~8 and can change the key a row attends to."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, CONFIG.vocab_size, (1, 64))
                              .astype(np.int32))
    k = CONFIG.moe.top_k
    records = []
    original = moe_lib.route

    def recording(router_w, x, m):
        idx, gates, aux = original(router_w, x, m)
        probs = torch.softmax(x.to(m.router_dtype) @ router_w, dim=-1)
        top = torch.topk(probs, k + 1, dim=-1).values
        records.append((idx.cpu(), (top[:, k - 1] - top[:, k]).cpu()))
        return idx, gates, aux

    result = {}
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        cfg = dataclasses.replace(CONFIG, num_layers=1, param_dtype=dtype, compute_dtype=dtype)
        card = build_model(cfg, device="cuda").init(1)
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict(card.state_dict())
        runs = {}
        moe_lib.route = recording
        try:
            tokens = None
            for dev, model in (("cuda", card), ("cpu", cpu)):
                records.clear()
                t0 = time.perf_counter()
                logits, _ = model.prefill({"tokens": prompt})
                steps = [logits.float().cpu()]
                cache = model.init_cache(1, 16)
                fed = [torch.argmax(logits, dim=-1).to(torch.int32).cpu() if tokens is None
                       else tokens[0]]
                for pos in range(FAM_CPU_DECODE):
                    logits, cache = model.decode_step({"token": fed[-1], "pos": pos,
                                                       "cache": cache})
                    steps.append(logits.float().cpu())
                    fed.append(torch.argmax(logits, dim=-1).to(torch.int32).cpu()
                               if tokens is None else tokens[pos + 1])
                if tokens is None:
                    tokens = fed
                runs[dev] = (steps, list(records), time.perf_counter() - t0)
                del cache, logits
        finally:
            moe_lib.route = original
        del card, cpu
        _free(torch)

        (g_steps, g_routes, g_s), (c_steps, c_routes, c_s) = runs["cuda"], runs["cpu"]
        flips, calls = [], []
        for call, ((gi, gm), (ci, _), g, c) in enumerate(zip(g_routes, c_routes, g_steps,
                                                             c_steps)):
            differ = [i for i in range(gi.shape[0])
                      if set(gi[i].tolist()) != set(ci[i].tolist())]
            flips += [{"call": call, "token": i, "margin": float(gm[i])} for i in differ]
            err = float((g - c).abs().max())
            calls.append({"max_abs_logit_diff": err,
                          "max_diff_over_rms": err / float(c.square().mean().sqrt()),
                          "greedy_equal": bool(torch.equal(g.argmax(-1), c.argmax(-1))),
                          "flipped_tokens": len(differ), "smallest_margin": float(gm.min()),
                          "allclose_1e-3": bool(torch.allclose(g, c, rtol=1e-3, atol=1e-3))})
        result[name] = {"calls": calls, "flips": flips, "card_s": g_s, "cpu_s": c_s,
                        "tokens": [int(x) for x in torch.cat(tokens, dim=1)[0]]}
        print(f"[families] card vs CPU, deepseek-v2-236b full width depth 1 {name}, prompt 64 "
              f"and {FAM_CPU_DECODE} decode steps: per call max |logit diff| "
              f"{['%.3e' % c['max_abs_logit_diff'] for c in calls]} "
              f"({['%.3e' % c['max_diff_over_rms'] for c in calls]} of rms), greedy equal "
              f"{[c['greedy_equal'] for c in calls]}, routing flips "
              f"{[c['flipped_tokens'] for c in calls]} (largest margins "
              f"{sorted((f['margin'] for f in flips), reverse=True)[:4]}); card {g_s:.2f} s, "
              f"CPU {c_s:.2f} s", flush=True)
        bad = [f for f in flips if f["margin"] >= ROUTE_FLIP_MARGIN]
        if bad:
            raise RuntimeError(f"card vs CPU {name}: expert choices differ at margins >= "
                               f"{ROUTE_FLIP_MARGIN}: {bad[:4]}")
        if name == "float32":
            held = [c["allclose_1e-3"] and c["greedy_equal"] for c in calls]
        else:
            held = [c["flipped_tokens"] > 0 or (c["max_diff_over_rms"] <= 0.1
                                                and c["greedy_equal"]) for c in calls]
        if not all(held):
            raise RuntimeError(f"card vs CPU {name}: {calls}")
    return result


def _other_families(torch):
    """The five other configs of the slice at full width, each with its
    depth as ``FAM_OTHERS`` keeps it: a first call, then with the launch
    counts set to 0 just before and read just after, a prefill and
    ``FAM_OTHER_DECODE`` decode steps at batch 1 through ``serve``; every
    prefill's attention on the tensor-core route (bf16, D = 128), once a
    layer, the FMA route not once, and finite logits."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    out = {}
    for arch, layers, prompt in FAM_OTHERS:
        _free(torch)
        cfg = configs.get_config(arch)
        full = cfg.num_layers
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model = build_model(cfg, device="cuda").init(0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        init_peak = torch.cuda.max_memory_allocated()
        param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
        serve.serve(model, batch=1, prompt_len=prompt, decode_steps=1, cache_len=LM_CACHE)
        torch.cuda.reset_peak_memory_stats()
        build.LAUNCHES.reset()
        res = serve.serve(model, batch=1, prompt_len=prompt, decode_steps=FAM_OTHER_DECODE,
                          cache_len=LM_CACHE)
        torch.cuda.synchronize()
        launches = build.LAUNCHES.snapshot()
        peak = torch.cuda.max_memory_allocated()
        others = {k: n for k, n in launches.items() if n and k != "flash_attention_sm90"}
        if launches.get("flash_attention_sm90", 0) != cfg.num_layers or others:
            raise RuntimeError(f"{arch}: the prefill launched flash_attention_sm90 "
                               f"{launches.get('flash_attention_sm90', 0)} times and {others}, "
                               f"expected {cfg.num_layers} and nothing else")
        if not torch.isfinite(res["logits"].float()).all():
            raise RuntimeError(f"{arch}: non-finite logits")
        out[arch] = {"layers": cfg.num_layers, "published_layers": full, "prompt_len": prompt,
                     "param_bytes": param_bytes, "init_s": init_s,
                     "init_peak_device_bytes": init_peak, "prefill_s": res["prefill_s"],
                     "decode_steps": FAM_OTHER_DECODE,
                     "decode_tok_per_s": res["decode_tok_per_s"], "peak_device_bytes": peak,
                     "launches": launches, "sampled_tokens_0": res["tokens"][0].tolist()}
        print(f"[families] {arch}: {cfg.num_layers} of {full} layers ({param_bytes / 1e9:.3f} "
              f"GB, drawn in {init_s:.2f} s, init peak {init_peak / 1e9:.3f} GB), prompt "
              f"{prompt}: launches {launches}, prefill_s={res['prefill_s']:.6f} "
              f"decode_tok_per_s={res['decode_tok_per_s']:.3f} peak device memory "
              f"{peak / 1e9:.3f} GB, finite logits", flush=True)
        del model, res
    _free(torch)
    return out


def _hybrid_encdec_serve(torch, label, cfg, prompt_len, expected):
    """One model of the hybrid and encoder-decoder phase at full width
    through ``serve`` on the card: drawn from seed 0, a first call, then
    with the launch counts set to 0 just before and read just after, the
    main path (batch ``LM_BATCH``, ``prompt_len``, ``LM_DECODE`` decode
    steps, cache ``LM_CACHE``), whose launches must be ``expected`` and
    nothing else, its logits finite and its tokens in the vocab; then
    another prefill that captures every ``flash_attention`` and
    ``ssd_chunk_forward`` call's operands.  Returns the launches, the
    captured calls in order and the path's numbers."""
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[{label}] {cfg.name} ({type(model).__name__}): {n_params} parameters "
          f"({param_bytes / 1e9:.3f} GB) drawn on the card in {init_s:.2f} s, init peak "
          f"{init_peak / 1e9:.3f} GB", flush=True)
    t = time.perf_counter()
    serve.serve(model, batch=LM_BATCH, prompt_len=prompt_len, decode_steps=2,
                cache_len=LM_CACHE)
    print(f"[{label}] first call (prefill + 2 decode steps) {time.perf_counter() - t:.2f} s",
          flush=True)

    # the main path: counts set to 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.reset()
    out = serve.serve(model, batch=LM_BATCH, prompt_len=prompt_len, decode_steps=LM_DECODE,
                      cache_len=LM_CACHE)
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] main path launches {launches}", flush=True)
    if {k: n for k, n in launches.items() if n} != expected:
        raise RuntimeError(f"{cfg.name}: the prefill launched {launches}, expected exactly "
                           f"{expected}")
    if not torch.isfinite(out["logits"].float()).all():
        raise RuntimeError(f"{cfg.name}: non-finite logits")
    tokens = out["tokens"]
    if (tuple(tokens.shape) != (LM_BATCH, 1 + LM_DECODE) or int(tokens.min()) < 0
            or int(tokens.max()) >= cfg.vocab_size):
        raise RuntimeError(f"{cfg.name}: bad sampled tokens {tuple(tokens.shape)}")
    print(f"[{label}] serve: prefill_s={out['prefill_s']:.6f} decode_s={out['decode_s']:.6f} "
          f"decode_tok_per_s={out['decode_tok_per_s']:.3f} peak device memory "
          f"{peak / 1e9:.3f} GB, finite logits, sampled tokens[0] {tokens[0, :16].tolist()}",
          flush=True)

    # every kernel call's operands, from another prefill
    captured = []
    originals = {name: getattr(ops, name) for name in ("flash_attention", "ssd_chunk_forward")}

    def capturing(name):
        def call(*args, **kw):
            captured.append((name, tuple(a.clone() for a in args), kw))
            return originals[name](*args, **kw)
        return call

    for name in originals:
        setattr(ops, name, capturing(name))
    try:
        serve.serve(model, batch=LM_BATCH, prompt_len=prompt_len, decode_steps=0,
                    cache_len=LM_CACHE)
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
    numbers = {
        "config": cfg.name, "model": type(model).__name__, "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "parameters": n_params,
        "param_bytes": param_bytes, "init_s": init_s, "init_peak_device_bytes": init_peak,
        "batch": LM_BATCH, "prompt_len": prompt_len, "decode_steps": LM_DECODE,
        "cache_len": LM_CACHE, "prefill_s": out["prefill_s"], "decode_s": out["decode_s"],
        "decode_tok_per_s": out["decode_tok_per_s"], "launches": launches,
        "peak_device_bytes": peak, "sampled_tokens_0": tokens[0, :16].tolist(),
    }
    del model, out
    _free(torch)
    return launches, captured, numbers


def _hybrid_encdec_path(torch):
    """``seamless-m4t-large-v2`` whole (24 encoder and 24 decoder layers,
    the audio frontend's frames drawn by ``serve``: ``ENCDEC_FRAMES`` frames
    and a decoder prompt of an eighth of them), then ``jamba-1.5-large-398b``
    at every published width with one block of its 72 layers and
    ``JAMBA_EXPERTS`` of its 16 experts, each through ``serve`` on the card
    (``_hybrid_encdec_serve``).  Gates: seamless launches exactly
    ``flash_attention_sm90`` 72 times a prefill (24 encoder, 24 decoder
    self, 24 cross), jamba exactly one ``flash_attention_sm90`` and 7
    ``ssd_chunk_forward`` (the FMA route: d_state 16) a prefill; jamba's MoE
    capacity ``JAMBA_CAPACITY``.  Returns the launches, the captured
    operands (seamless' encoder and cross calls of layer 0, jamba's
    attention and layer 0's scan) and the numbers."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe as moe_lib

    seamless = configs.get_config("seamless-m4t-large-v2")
    expected = {"flash_attention_sm90": 3 * seamless.num_layers}
    s_launches, s_calls, s_numbers = _hybrid_encdec_serve(
        torch, "encdec", seamless, ENCDEC_FRAMES, expected)
    n_enc = seamless.encoder_layers
    # encoder layers first, then each decoder layer's self and cross calls
    flash = [c for c in s_calls if c[0] == "flash_attention"]
    if len(flash) != expected["flash_attention_sm90"] or any(
            c[2]["causal"] != (n_enc <= i and (i - n_enc) % 2 == 0)
            for i, c in enumerate(flash)):
        raise RuntimeError(f"seamless: {len(flash)} captured attention calls, causal "
                           f"{[c[2]['causal'] for c in flash]}")
    operands = {"encoder": flash[0], "cross": flash[n_enc + 1]}

    full = configs.get_config("jamba-1.5-large-398b")
    jamba = dataclasses.replace(full, num_layers=full.block_period,
                                moe=dataclasses.replace(full.moe, num_experts=JAMBA_EXPERTS))
    cap = moe_lib._capacity(LM_BATCH * LM_PROMPT, jamba.moe)
    if cap != JAMBA_CAPACITY:
        raise RuntimeError(f"jamba MoE capacity {cap} at {LM_BATCH * LM_PROMPT} tokens, "
                           f"expected {JAMBA_CAPACITY}")
    expected = {"flash_attention_sm90": 1, "ssd_chunk_forward": full.block_period - 1}
    j_launches, j_calls, j_numbers = _hybrid_encdec_serve(
        torch, "hybrid", jamba, LM_PROMPT, expected)
    operands["attention"] = next(c for c in j_calls if c[0] == "flash_attention")
    operands["ssd"] = next(c for c in j_calls if c[0] == "ssd_chunk_forward")
    j_numbers.update(published_layers=full.num_layers, published_experts=full.moe.num_experts,
                     experts=JAMBA_EXPERTS, moe_capacity=cap)
    print(f"[hybrid] MoE capacity {cap} slots an expert at {LM_BATCH * LM_PROMPT} tokens "
          f"(top {jamba.moe.top_k} of {JAMBA_EXPERTS})", flush=True)
    del s_calls, j_calls, flash
    return {"encdec": s_launches, "hybrid": j_launches}, operands, {
        "encdec": s_numbers, "hybrid": j_numbers}


def _flash_row(torch, name, q, k, v, causal, launches, where):
    """``flash_attention`` at one captured call's bf16 operands: the tensor-
    core route they must take, held within the sweep's bf16 tolerance of
    the plain version on the same values in float32.  Neither model has
    qk_norm and the random weights' "scaled" fan-in is the layer count (24
    for seamless, 1 for jamba's block), so the scores reach the tens to
    thousands, where the bf16 plain version's rounding of each score to
    bf16 (which the kernel, keeping them in float32, does not do) moves a
    near one-hot softmax: its distance is printed, not held, as at MLA's
    D = 192.  Then timed beside the plain version,
    ``F.scaled_dot_product_attention`` and the bound (bytes: q, k, v read
    and out written once; operations: 4 D flops a (query, key) pair the
    mask keeps, at the bf16 peak).  Returns the kernels line's row."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref
    from repro_torch.launch.roofline import kernel_bound

    if kflash.route(q, k, v) != "sm90":
        raise RuntimeError(f"{name}: the operands take the {kflash.route(q, k, v)} route")
    got = kflash.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention(q, k, v, causal=causal)
    want32 = ref.flash_attention(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    err, share = _flash_close(got, want, v, "bfloat16")
    err_f, share_f = _flash_close(got, want32, v, "bfloat16")
    if share_f > 1:
        raise RuntimeError(f"{name}: {err_f:.3e} of rms(v) from the plain version in float32, "
                           f"share of the bound {share_f:.3f} (the bf16 plain version "
                           f"{err:.3e})")
    s_max = max(float((q[:, :, i:i + 128].float() @ k.float().repeat_interleave(
        q.shape[1] // k.shape[1], dim=1).transpose(-1, -2)).abs().max())
        for i in range(0, q.shape[2], 128)) / math.sqrt(q.shape[-1])
    del got, want
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])
    lib_err, lib_share = _flash_close(library(), want32, v, "bfloat16")
    if lib_share > 1:
        raise RuntimeError(f"{name}: SDPA disagrees with the plain version: {lib_err:.3e} rms(v)")
    del want32
    bound_ms, bound_by, flops, nbytes = kernel_bound("flash_attention", q, k, v, causal=causal)
    kernel = lambda: kflash.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: ref.flash_attention(q, k, v, causal=causal)  # noqa: E731
    shape = (f"q {tuple(q.shape)} k/v {tuple(k.shape)} bfloat16 "
             f"{'causal' if causal else 'full'} ({where})")
    row = dict(
        name=name, route="cuda", source="src/repro_torch/csrc/flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention.py:62", shape=shape,
        counter="flash_attention_sm90", launches=launches, max_abs_err=err_f,
        max_abs_err_bf16_plain=err, largest_scaled_score=s_max, ms=_queued_ms(torch, kernel),
        plain_ms=_queued_ms(torch, plain, iters=5), bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_queued_ms(torch, library), call_ms=_call_ms(torch, kernel, iters=20),
        plain_call_ms=_call_ms(torch, plain, iters=5),
        library_call_ms=_call_ms(torch, library, iters=20), flops=flops, bytes=nbytes,
    )
    print(f"[kernel] {name} {shape}: largest scaled score {s_max:.1f}; max |kernel - plain| "
          f"{err_f:.3e} rms(v) (plain in float32, share of the bound {share_f:.3f}; the bf16 "
          f"plain version {err:.3e}, share {share:.3f}); SDPA {lib_err:.3e}; "
          f"kernel_ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
          f"library_ms={row['library_ms']:.6f} bound_ms={row['bound_ms']:.6f} "
          f"({row['bound_by']}: {flops} flops, {nbytes} bytes) call_ms={row['call_ms']:.6f}",
          flush=True)
    return row


def _hybrid_encdec_kernel_checks(torch, operands, launches):
    """The phase's kernels at its captured operands: ``flash_attention_sm90``
    at seamless' D = 64 encoder (full, (4, 16, 1024, 64)) and cross (full,
    q (4, 16, 128, 64) against k/v (4, 16, 1024, 64)) calls of layer 0 and
    at jamba's attention (GQA 64/8, D = 128, causal) (``_flash_row``);
    ``ssd_chunk_forward``'s FMA route at jamba's layer-0 scan (x (4, 1024,
    256, 64), B/C (4, 1024, 1, 16), chunk 256, bf16), y and the final state
    against the plain version (the sequential float32 recurrence) within
    ``SSD_TOL``, timed beside the plain version (a call time, as row 9's)
    and ``_ssd_bound``; no single library call computes it.  Returns the
    kernels line's rows."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as kssd

    enc_n = launches["encdec"]["flash_attention_sm90"]
    rows = [_flash_row(torch, "flash_attention_sm90_d64_full", *operands["encoder"][1],
                       operands["encoder"][2]["causal"], enc_n,
                       "encoder layer 0 of the seamless-m4t-large-v2 prefill"),
            _flash_row(torch, "flash_attention_sm90_d64_cross", *operands["cross"][1],
                       operands["cross"][2]["causal"], enc_n,
                       "cross-attention of decoder layer 0, seamless-m4t-large-v2"),
            _flash_row(torch, "flash_attention_sm90_jamba", *operands["attention"][1],
                       operands["attention"][2]["causal"],
                       launches["hybrid"]["flash_attention_sm90"],
                       "the attention layer of the jamba-1.5-large-398b block")]
    if operands["encoder"][2]["causal"] or operands["cross"][2]["causal"]:
        raise RuntimeError("seamless' encoder or cross-attention call was causal")

    _, (x, dt, a, b_, c_), kw = operands["ssd"]
    chunk = kw["chunk"]
    if kssd.route(x, b_, c_, chunk) != "fma":
        raise RuntimeError(f"jamba's scan takes the {kssd.route(x, b_, c_, chunk)} route")
    y, state = kssd.ssd_chunk_forward(x, dt, a, b_, c_, chunk=chunk)
    want_y, want_state = ref.ssd_scan(x, dt, a, b_, c_)
    torch.cuda.synchronize()
    if not (torch.isfinite(y.float()).all() and torch.isfinite(state).all()):
        raise RuntimeError("ssd_chunk_forward at jamba's operands: not finite")
    err_y, share_y = _ssd_close(y, want_y, SSD_TOL["bfloat16"])
    err_s, share_s = _ssd_close(state, want_state, SSD_TOL["float32"])
    if max(share_y, share_s) > 1:
        raise RuntimeError(f"ssd_chunk_forward at jamba's operands: y {err_y:.3e} of rms(y), "
                           f"state {err_s:.3e} of rms(state); shares {share_y:.3f}, "
                           f"{share_s:.3f}")
    del y, state, want_y, want_state
    kernel = lambda: kssd.ssd_chunk_forward(x, dt, a, b_, c_, chunk=chunk)  # noqa: E731
    plain_ms = _call_ms(torch, lambda: ref.ssd_scan(x, dt, a, b_, c_), iters=3)
    bound_ms, bound_by, flops, nbytes = _ssd_bound(x, b_, chunk)
    shape = (f"x {tuple(x.shape)} B/C {tuple(b_.shape)} bf16 chunk {chunk} (layer 0 of the "
             "jamba-1.5-large-398b block, d_state 16: the FMA route)")
    row = dict(
        name="ssd_chunk_forward_n16", route="cuda", source="src/repro_torch/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk.py:67", shape=shape, counter="ssd_chunk_forward",
        launches=launches["hybrid"]["ssd_chunk_forward"], max_abs_err=err_y,
        state_err=err_s, ms=_queued_ms(torch, kernel), plain_ms=plain_ms,
        plain_timed_by="call", bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        call_ms=_call_ms(torch, kernel, iters=20), plain_call_ms=plain_ms,
        library_call_ms=None, flops=flops, bytes=nbytes,
    )
    rows.append(row)
    print(f"[kernel] ssd_chunk_forward_n16 {shape}: max |kernel - plain| y {err_y:.3e} rms(y), "
          f"state {err_s:.3e} rms(state), shares {share_y:.3f}, {share_s:.3f}; "
          f"kernel_ms={row['ms']:.6f} plain_ms={plain_ms:.6f} (call time) library_ms=None "
          f"bound_ms={bound_ms:.6f} ({bound_by}: {flops} flops, {nbytes} bytes) "
          f"call_ms={row['call_ms']:.6f}", flush=True)
    return rows


def _hybrid_encdec_card_vs_cpu(torch):
    """Float32 models from one set of weights (drawn on the card from seed
    1) on the card and on the CPU, and the same weights in a float64 model
    on the CPU: ``seamless-m4t-large-v2`` at full width with 2 encoder and
    2 decoder layers (one prompt of 256 frames and 32 tokens), and
    ``jamba``'s SMOKE (one block: every sublayer kind, the MoE and the FMA
    scan at N = 16; two prompts of 64 tokens).  Each runs a prefill and
    ``FAM_CPU_DECODE`` decode steps on the prefill's cache (K/V padded),
    all fed the card's tokens.  Every call's logits on the card within
    ``CARD_CPU_TOL`` of the float64 model's rms, or, where float32 itself
    cannot meet that, within ``F32_ERR_FACTOR`` times the CPU float32
    model's own distance from it; the greedy tokens of card and CPU equal.
    Neither model has qk_norm and the random weights' "scaled" fan-in is
    the layer count, so the softmax is near one-hot and a near tie of two
    scores turns a float32 rounding into a move of the logits, on either
    device: each call's distance of both from float64 is printed.  MoE
    routing is
    recorded on the card and the CPU in float32; a token whose chosen
    experts differ is a flip, and every flip must sit at a top-k margin
    under ``ROUTE_FLIP_MARGIN``."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    seamless = configs.get_config("seamless-m4t-large-v2")
    jamba = configs.get_smoke_config("jamba-1.5-large-398b")
    rng = np.random.default_rng(4)
    cases = (
        ("seamless-m4t-large-v2, 2 + 2 layers",
         dataclasses.replace(seamless, num_layers=2, encoder_layers=2),
         {"frames": torch.from_numpy(0.02 * rng.standard_normal((1, 256, seamless.d_model))),
          "tokens": torch.from_numpy(rng.integers(0, seamless.vocab_size, (1, 32))
                                     .astype(np.int32))}),
        (jamba.name, jamba,
         {"tokens": torch.from_numpy(rng.integers(0, jamba.vocab_size, (2, 64))
                                     .astype(np.int32))}))
    records = []
    original = moe_lib.route

    def recording(router_w, x, m):
        idx, gates, aux = original(router_w, x, m)
        probs = torch.softmax(x.to(m.router_dtype) @ router_w, dim=-1)
        top = torch.topk(probs, m.top_k + 1, dim=-1).values
        records.append((idx.cpu(), (top[:, m.top_k - 1] - top[:, m.top_k]).cpu()))
        return idx, gates, aux

    result = {}
    for name, cfg, prompt in cases:
        cfg32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
        cfg64 = dataclasses.replace(cfg, param_dtype=torch.float64, compute_dtype=torch.float64)
        card = build_model(cfg32, device="cuda").init(1)
        cpu = build_model(cfg32, device="cpu")
        cpu.load_state_dict(card.state_dict())
        cpu64 = build_model(cfg64, device="cpu")
        cpu64.load_state_dict(card.state_dict())     # float32 leaves stay float32
        runs = {}
        moe_lib.route = recording
        try:
            tokens = None
            for dev, model in (("cuda", card), ("cpu", cpu), ("cpu64", cpu64)):
                records.clear()
                t0 = time.perf_counter()
                logits, cache = model.prefill(prompt)
                cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, FAM_CPU_DECODE))
                         if k in ("k", "v") else v for k, v in cache.items()}
                steps = [logits.cpu().double()]
                fed = [torch.argmax(logits, dim=-1).to(torch.int32).cpu() if tokens is None
                       else tokens[0]]
                start = cache["k"].shape[2] - FAM_CPU_DECODE
                for i in range(FAM_CPU_DECODE):
                    logits, cache = model.decode_step({"token": fed[-1], "pos": start + i,
                                                       "cache": cache})
                    steps.append(logits.cpu().double())
                    fed.append(torch.argmax(logits, dim=-1).to(torch.int32).cpu()
                               if tokens is None else tokens[i + 1])
                if tokens is None:
                    tokens = fed
                runs[dev] = (steps, list(records), time.perf_counter() - t0)
                del cache, logits
        finally:
            moe_lib.route = original
        del card, cpu, cpu64
        _free(torch)
        (g_steps, g_routes, g_s), (c_steps, c_routes, c_s) = runs["cuda"], runs["cpu"]
        flips = [{"call": call, "token": i, "margin": float(gm[i])}
                 for call, ((gi, gm), (ci, _)) in enumerate(zip(g_routes, c_routes))
                 for i in range(gi.shape[0]) if set(gi[i].tolist()) != set(ci[i].tolist())]

        def over_rms(a, b):
            return float((a - b).abs().max() / b.square().mean().sqrt())

        calls = [{"card_vs_cpu": over_rms(g, c), "card_vs_f64": over_rms(g, w),
                  "cpu_vs_f64": over_rms(c, w),
                  "greedy_equal": bool(torch.equal(g.argmax(-1), c.argmax(-1)))}
                 for g, c, w in zip(g_steps, c_steps, runs["cpu64"][0])]
        result[cfg.name] = {"calls": calls, "routing_calls": len(g_routes), "flips": flips,
                            "card_s": g_s, "cpu_s": c_s, "cpu64_s": runs["cpu64"][2]}
        print(f"[hybrid/encdec] card vs CPU, {name}, float32, prefill and {FAM_CPU_DECODE} "
              f"decode steps, max |logit diff| over rms: card vs CPU "
              f"{['%.3e' % c['card_vs_cpu'] for c in calls]}, card vs float64 "
              f"{['%.3e' % c['card_vs_f64'] for c in calls]}, CPU float32 vs float64 "
              f"{['%.3e' % c['cpu_vs_f64'] for c in calls]}; greedy equal "
              f"{[c['greedy_equal'] for c in calls]}, {len(g_routes)} routing calls, "
              f"{len(flips)} flips (margins {[f['margin'] for f in flips][:4]}); card "
              f"{g_s:.2f} s, CPU {c_s:.2f} s, CPU float64 {runs['cpu64'][2]:.2f} s", flush=True)
        bad = [f for f in flips if f["margin"] >= ROUTE_FLIP_MARGIN]
        if bad:
            raise RuntimeError(f"card vs CPU {name}: expert choices differ at margins >= "
                               f"{ROUTE_FLIP_MARGIN}: {bad[:4]}")
        if not all(c["greedy_equal"] and c["card_vs_f64"] <= max(
                CARD_CPU_TOL, F32_ERR_FACTOR * c["cpu_vs_f64"]) for c in calls):
            raise RuntimeError(f"card vs CPU {name}: {calls}")
    return result


def _token_corpus(torch, vocab, b, s, tag):
    """A ``core.tokens.build_corpus`` table of ``LM_TRAIN_PARTITIONS`` x
    ``LM_TRAIN_DOCS`` documents at ``vocab``, and its (b, s) batches read
    by the numpy engine; then the whole corpus read through the decode
    kernels with the counts set to 0 just before: one ``xor_decrypt`` and
    one ``ragged_gather_vec`` launch a stripe, the scalar route never, and
    every batch byte-identical to the numpy engine's.  Returns (table, the
    numpy engine's batches, stripes, extract's launches)."""
    from repro_torch.core import tokens as T
    from repro_torch.core.warehouse import Warehouse
    from repro_torch.kernels import build

    t = time.perf_counter()
    table = T.build_corpus(Warehouse(), LM_TRAIN_PARTITIONS, LM_TRAIN_DOCS, vocab, seed=0)
    n_stripes = sum(len(p.footer.stripes) for p in table.partitions.values())
    ref = list(T.lm_batches_from_table(table, s, b))
    corpus_s = time.perf_counter() - t

    # the whole corpus through the decode kernels: counts set to 0 just before
    build.LAUNCHES.reset()
    t = time.perf_counter()
    got = list(T.lm_batches_from_table(table, s, b, decode_engine="torch"))
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t
    extract = build.LAUNCHES.snapshot()
    print(f"[{tag}] corpus: {table.total_rows} documents, {table.total_bytes} B in "
          f"{n_stripes} stripes, {len(ref)} batches of {b} x {s} tokens ({corpus_s:.2f} s "
          f"with the numpy engine's read); the torch engine's read {extract_s:.2f} s, "
          f"launches {extract}", flush=True)
    for name in ("xor_decrypt", "ragged_gather_vec"):
        if extract.get(name, 0) != n_stripes:
            raise RuntimeError(f"extract launched {name} {extract.get(name, 0)} times, "
                               f"expected one a stripe ({n_stripes})")
    if extract.get("ragged_gather", 0):
        raise RuntimeError(f"extract launched ragged_gather's scalar route "
                           f"{extract['ragged_gather']} times")
    if list(map(_digest, got)) != list(map(_digest, ref)) or len(ref) < LM_TRAIN_STEPS:
        raise RuntimeError("the torch engine's token batches differ from the numpy engine's")
    print(f"[{tag}] token batches byte-identical to the numpy engine's", flush=True)
    return table, ref, n_stripes, extract


def _lm_trainer(torch, cfg, tag, label):
    """A ``Trainer`` of ``cfg`` on the card at ``LM_TRAIN_OPT``, its state
    drawn from seed 0 with the peak memory counted from 0: returns it, the
    state in a list (``_timed_fit`` pops it), the parameter count and the
    draw's seconds."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import Trainer, TrainerConfig

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    trainer = Trainer(cfg, OptimizerConfig(**LM_TRAIN_OPT),
                      TrainerConfig(max_steps=LM_TRAIN_STEPS), device="cuda")
    held = [trainer.init_state(0)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[{tag}] {label}: {n_params} parameters drawn with AdamW's state in "
          f"{init_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    return trainer, held, n_params, init_s


def _timed_fit(torch, trainer, held, batches, steps, tag):
    """``trainer.fit(batches, held.pop())`` with CUDA events around each
    step and the counts set to 0 just before and read just after; fails if
    a forward-only kernel (``FORWARD_ONLY_KERNELS``) was launched, if it
    took another number of steps than ``steps`` or if a loss or grad norm
    is not finite.  Returns the launches, fit's wall seconds, the peak
    memory, the step times (ms), losses, grad norms and stall fraction."""
    from repro_torch.kernels import build

    events = []
    step = trainer._train_step

    def timed(opt, batch):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(opt, batch)
        end.record()
        events.append((start, end))
        return out

    trainer._train_step = timed
    # the main path: counts set to 0 just before, read just after
    build.LAUNCHES.reset()
    t = time.perf_counter()
    trainer.fit(batches, held.pop())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = build.LAUNCHES.snapshot()
    trainer._train_step = step
    run = {"launches": launches, "fit_s": fit_s, "peak": torch.cuda.max_memory_allocated(),
           "step_ms": [start.elapsed_time(end) for start, end in events],
           "losses": [m.loss for m in trainer.history],
           "norms": [m.grad_norm for m in trainer.history],
           "stall": trainer.stall_fraction()}
    print(f"[{tag}] main path launches {launches}", flush=True)
    forward_only = {k: launches[k] for k in FORWARD_ONLY_KERNELS if launches.get(k, 0)}
    if forward_only:
        raise RuntimeError(f"a training step launched forward-only kernels {forward_only}")
    if len(run["losses"]) != steps or len(run["step_ms"]) != steps:
        raise RuntimeError(f"trained {len(run['losses'])} steps, expected {steps}")
    if not all(math.isfinite(x) for x in run["losses"] + run["norms"]):
        raise RuntimeError(f"non-finite losses {run['losses']} or grad norms {run['norms']}")
    return run


def _read_through_decode_kernels(launches, fed, ref):
    """The batches a training run took came through the decode kernels
    once a stripe, ``xor_decrypt`` and ``ragged_gather_vec`` alike and the
    scalar route never, and equal the numpy engine's."""
    if (launches.get("xor_decrypt", 0) < 1
            or launches.get("xor_decrypt") != launches.get("ragged_gather_vec")
            or launches.get("ragged_gather", 0)):
        raise RuntimeError(f"the trainer's batches were not read through the decode "
                           f"kernels once a stripe: {launches}")
    if list(map(_digest, fed)) != list(map(_digest, ref[:len(fed)])):
        raise RuntimeError("the trainer's batches differ from the numpy engine's")


def _lm_train_path(torch):
    """Full-width qwen3-8b, its depth cut to ``LM_TRAIN_LAYERS`` of 36,
    trained ``LM_TRAIN_STEPS`` steps by the port's ``Trainer`` from a DWRF
    token corpus (``core.tokens.build_corpus``) read through
    ``lm_batches_from_table(..., decode_engine="torch")``.  First the
    whole corpus is extracted with the counts set to 0: one
    ``xor_decrypt`` and one ``ragged_gather_vec`` launch a stripe, the
    scalar route never, and every batch byte-identical to the numpy
    engine's.  Then the training run, counts set to 0 just before and read
    just after: the decode kernels launched by the batches it read, no
    forward-only kernel (``FORWARD_ONLY_KERNELS``) launched, every loss and
    grad norm finite, the batches it took the numpy engine's.  Step times
    are CUDA events around each step; the model FLOPs of a step are 6 x
    the matmul parameters (the layers and ``out``) x its tokens plus 6 x
    B H S^2 D a layer for the causal attention.  Then the attention's share
    of a step (``_Flash`` forward, recompute and backward at the step's
    operands, beside SDPA's forward and backward), ``_Flash`` alone against
    float64 (``_flash_bwd_check``) and one narrow step on the card against
    the CPU (``_lm_train_card_vs_cpu``)."""
    import dataclasses

    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.core import tokens as T

    _free(torch)
    cfg = dataclasses.replace(CONFIG, num_layers=LM_TRAIN_LAYERS)
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    table, ref, n_stripes, extract = _token_corpus(torch, cfg.vocab_size, b, s, "lm_train")
    trainer, held, n_params, init_s = _lm_trainer(
        torch, cfg, "lm_train", f"{cfg.name} at {LM_TRAIN_LAYERS} of {CONFIG.num_layers} layers")
    model = trainer.model
    n_matmul = sum(p.numel() for p in model.layers.parameters()) + model.embed.out.numel()

    fed = []

    def feed():
        for batch in T.lm_batches_from_table(table, s, b, decode_engine="torch"):
            fed.append(batch)
            yield batch

    run = _timed_fit(torch, trainer, held, feed(), LM_TRAIN_STEPS, "lm_train")
    launches, fit_s, peak, step_ms, losses, norms, stall = (
        run[k] for k in ("launches", "fit_s", "peak", "step_ms", "losses", "norms", "stall"))
    _read_through_decode_kernels(launches, fed, ref)
    median_ms = statistics.median(step_ms[1:])
    tokens = b * s
    h, d = cfg.num_heads, cfg.head_dim
    model_flops = 6 * n_matmul * tokens + 6 * LM_TRAIN_LAYERS * b * h * s * s * d
    print(f"[lm_train] {LM_TRAIN_STEPS} steps in {fit_s:.2f} s: step ms {step_ms} (CUDA "
          f"events), median after the first {median_ms:.3f} ms, {tokens / median_ms * 1e3:.1f} "
          f"tokens/s; model FLOPs a step {model_flops} ({model_flops / BF16_OPS_PER_S * 1e3:.3f} "
          f"ms at the bf16 peak, share {model_flops / (median_ms / 1e3) / BF16_OPS_PER_S:.4f}); "
          f"peak {peak / 1e9:.3f} GB; losses {losses}; grad norms {norms}; stall fraction "
          f"{stall:.5f}", flush=True)
    del trainer, model
    _free(torch)

    attention = _train_attention_share(torch, cfg, median_ms)
    flash_bwd = _flash_bwd_check(torch)
    card_vs_cpu = _lm_train_card_vs_cpu(torch)
    return {
        "arch": cfg.name, "layers": LM_TRAIN_LAYERS, "batch": b, "seq": s,
        "parameters": n_params, "corpus_batches": len(ref), "stripes": n_stripes,
        "extract_launches": extract, "launches": launches, "init_s": init_s, "fit_s": fit_s,
        "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": tokens / median_ms * 1e3, "peak_bytes": peak, "losses": losses,
        "grad_norms": norms, "stall_fraction": stall, "model_flops": model_flops,
        "model_flops_share": model_flops / (median_ms / 1e3) / BF16_OPS_PER_S,
        "attention": attention, "flash_bwd": flash_bwd, "card_vs_cpu": card_vs_cpu,
    }


def _train_attention_share(torch, cfg, step_ms):
    """A training step's attention at its operands (B, S, H, D) over KVH
    heads, bf16: ``_Flash``'s forward (run twice a step under remat: the
    forward and its recompute) and forward + backward, CUDA events around
    back-to-back calls; their share of ``step_ms``; SDPA's forward +
    backward at the same operands beside them."""
    import torch.nn.functional as F

    from repro_torch.models import attention as attn

    b, s, h, kvh, d = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, s, kvh, d), generator=gen, device="cuda").to(torch.bfloat16)
    dout = torch.randn((b, s, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    for x in (q, k, v):
        x.requires_grad_()
    scale = 1.0 / math.sqrt(d)
    kr, vr = k.detach().repeat_interleave(h // kvh, dim=2), v.detach().repeat_interleave(
        h // kvh, dim=2)

    def forward():
        attn._flash_fwd_impl(q.detach(), kr, vr, True, cfg.attn_chunk, cfg.attn_k_chunk, scale)

    def both():
        out = attn.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk,
                                     k_chunk=cfg.attn_k_chunk)
        torch.autograd.grad(out, (q, k, v), dout)

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    dt = dout.transpose(1, 2)

    def sdpa():
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        torch.autograd.grad(out, (qt, kt, vt), dt)

    fwd_ms = _call_ms(torch, forward, iters=5)
    both_ms = _call_ms(torch, both, iters=5)
    sdpa_ms = _call_ms(torch, sdpa, iters=5)
    step_attn = LM_TRAIN_LAYERS * (fwd_ms + both_ms)
    out = {"forward_ms": fwd_ms, "forward_backward_ms": both_ms, "sdpa_forward_backward_ms":
           sdpa_ms, "a_step_ms": step_attn, "share_of_step": step_attn / step_ms}
    print(f"[lm_train] attention at ({b}, {s}, {h}, {d}) over {kvh} KV heads, bf16: _Flash "
          f"forward {fwd_ms:.3f} ms, forward + backward {both_ms:.3f} ms (SDPA's "
          f"{sdpa_ms:.3f} ms); {LM_TRAIN_LAYERS} layers x (forward + recompute + backward) "
          f"{step_attn:.3f} ms, {step_attn / step_ms:.4f} of a step", flush=True)
    del q, k, v, kr, vr, dout, qt, kt, vt, dt
    _free(torch)
    return out


def _flash_bwd_check(torch):
    """``_Flash`` (``blocked_attention`` under autograd) on the card at
    ``FLASH_BWD_Q`` over ``FLASH_BWD_KV_HEADS`` heads, bf16, causal,
    against the same bf16 operands in float64 on the card: out, dq, dk and
    dv each within ``FLASH_BWD_TOL`` of the float64 one in relative norm,
    no kernel launched."""
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.models import attention as attn

    b, s, h, d = FLASH_BWD_Q
    rng = np.random.default_rng(7)
    shapes = ((b, s, h, d), (b, s, FLASH_BWD_KV_HEADS, d), (b, s, FLASH_BWD_KV_HEADS, d))
    ops_ = [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(
        "cuda", torch.bfloat16) for sh in shapes]
    dout = torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32)).to(
        "cuda", torch.bfloat16)
    cq, ck = FLASH_BWD_CHUNKS
    runs = []
    build.LAUNCHES.reset()
    for dtype in (torch.bfloat16, torch.float64):
        x = [o.to(dtype).requires_grad_() for o in ops_]
        out = attn.blocked_attention(*x, causal=True, chunk=cq, k_chunk=ck)
        if type(out.grad_fn).__name__ != "_FlashBackward":
            raise RuntimeError(f"blocked_attention under grad took {type(out.grad_fn)}")
        runs.append([out.detach(), *torch.autograd.grad(out, x, dout.to(dtype))])
    torch.cuda.synchronize()
    if build.LAUNCHES.snapshot():
        raise RuntimeError(f"the attention backward launched {build.LAUNCHES.snapshot()}")
    rel = {}
    for name, g, w in zip(("out", "dq", "dk", "dv"), *runs):
        rel[name] = float((g.double() - w).norm() / w.norm())
    print(f"[lm_train] _Flash at q {FLASH_BWD_Q} over {FLASH_BWD_KV_HEADS} KV heads, bf16, "
          f"blocks {FLASH_BWD_CHUNKS}: relative to float64 {rel}", flush=True)
    if not all(r <= FLASH_BWD_TOL for r in rel.values()):
        raise RuntimeError(f"_Flash on the card is off float64 by {rel}")
    return rel


def _lm_train_card_vs_cpu(torch):
    """One training step's loss and every gradient of a narrow qwen3
    (``LM_TRAIN_NARROW``, float32, weights drawn on the card from seed 1)
    on the card against the CPU (``_step_card_vs_cpu``), on one batch of
    (2, ``LM_TRAIN_NARROW_SEQ``) tokens."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.qwen3_8b import CONFIG

    cfg = dataclasses.replace(CONFIG, **LM_TRAIN_NARROW)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, cfg.vocab_size, (2, LM_TRAIN_NARROW_SEQ + 1)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(rows[:, :-1]), "labels": torch.from_numpy(rows[:, 1:])}
    return _step_card_vs_cpu(torch, cfg, batch, "lm_train",
                             f"narrow qwen3 ({LM_TRAIN_NARROW}, seq {LM_TRAIN_NARROW_SEQ})")


def _step_card_vs_cpu(torch, cfg, batch, tag, label):
    """One training step's loss and every gradient of ``cfg`` in float32
    (weights drawn on the card from seed 1; a MoE router scaled by
    ``TRAIN_ROUTER_SCALE``, and without qk_norm every ``wq`` and ``wk`` by
    ``TRAIN_QK_SCALE``) on the card and on the CPU, and of the same
    weights in float64 on the CPU, on ``batch``: the card within
    ``CARD_CPU_TOL`` of the float64 model, or within ``F32_ERR_FACTOR``
    times the CPU float32 model's own distance where that is larger, each
    gradient in relative norm; no forward-only kernel launched on the
    card.  A MoE model's routing is recorded in each run: a token whose
    chosen experts differ from the float64 run's is a flip, which must sit
    at a top-k margin under ``ROUTE_FLIP_MARGIN``; a run with a flip is
    reported and its gradients are not held (a flipped token's expert
    gradients differ by construction)."""
    import dataclasses

    from repro_torch.kernels import build
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib

    c32 = dataclasses.replace(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    c64 = dataclasses.replace(cfg, param_dtype=torch.float64, compute_dtype=torch.float64)
    card = build_model(c32, device="cuda").init(1)
    scales = {"router": TRAIN_ROUTER_SCALE} if cfg.moe else {}
    if not cfg.qk_norm:
        scales.update(wq=TRAIN_QK_SCALE, wk=TRAIN_QK_SCALE)
    with torch.no_grad():
        for name, p in card.named_parameters():
            p.mul_(scales.get(name.rsplit(".", 1)[-1], 1.0))
    cpu = build_model(c32, device="cpu")
    cpu.load_state_dict(card.state_dict())
    cpu64 = build_model(c64, device="cpu")
    cpu64.load_state_dict(card.state_dict())          # float32 leaves stay float32
    original = moe_lib.route
    records = []

    def recording(router_w, x, m):
        idx, gates, aux = original(router_w, x, m)
        k = m.top_k
        with torch.no_grad():
            top = torch.topk(torch.softmax(x.to(m.router_dtype) @ router_w, dim=-1), k + 1,
                             dim=-1).values
        records.append((idx.cpu(), (top[:, k - 1] - top[:, k]).cpu()))
        return idx, gates, aux

    runs = {}
    moe_lib.route = recording
    try:
        for dev, model in (("cuda", card), ("cpu", cpu), ("cpu64", cpu64)):
            records.clear()
            build.LAUNCHES.reset()
            t0 = time.perf_counter()
            names = sorted(n for n, _ in model.named_parameters())
            loss = model.loss(batch)
            grads = torch.autograd.grad(loss, [model.get_parameter(n) for n in names])
            runs[dev] = (loss.detach().cpu().double(),
                         {n: g.cpu().double() for n, g in zip(names, grads)},
                         time.perf_counter() - t0, list(records))
            if dev == "cuda":
                torch.cuda.synchronize()
                forward_only = {k: v for k, v in build.LAUNCHES.snapshot().items()
                                if k in FORWARD_ONLY_KERNELS}
                if forward_only:
                    raise RuntimeError(f"the card's training step launched {forward_only}")
    finally:
        moe_lib.route = original
    del card, cpu, cpu64
    _free(torch)
    (gl, gg, gs, gr), (cl, cg, cs, cr), (wl, wg, ws, wr) = (
        runs["cuda"], runs["cpu"], runs["cpu64"])
    flips = []
    for side, routes in (("card", gr), ("cpu", cr)):
        for call, ((gi, gm), (wi, _)) in enumerate(zip(routes, wr)):
            flips += [{"side": side, "call": call, "token": i, "margin": float(gm[i])}
                      for i in range(gi.shape[0])
                      if set(gi[i].tolist()) != set(wi[i].tolist())]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-300))

    gaps = {"loss": (rel(gl, wl), rel(cl, wl))}
    gaps.update({n: (rel(gg[n], wg[n]), rel(cg[n], wg[n])) for n in wg})
    worst = max(gaps, key=lambda n: gaps[n][0])
    routing = (f"; {len(gr)} routing calls, flips {len(flips)}, smallest margin "
               f"{min(float(m.min()) for _, m in gr):.3e}" if gr else "")
    print(f"[{tag}] card vs CPU, {label}, float32, one step: loss card {float(gl):.9f}, CPU "
          f"{float(cl):.9f}, float64 {float(wl):.9f}; worst leaf {worst} card vs float64 "
          f"{gaps[worst][0]:.3e} (CPU float32 {gaps[worst][1]:.3e}); card {gs:.2f} s, CPU "
          f"{cs:.2f} s, CPU float64 {ws:.2f} s{routing}", flush=True)
    bad_flips = [f for f in flips if f["margin"] >= ROUTE_FLIP_MARGIN]
    if bad_flips:
        raise RuntimeError(f"card vs CPU training step, {label}: expert choices differ at "
                           f"margins >= {ROUTE_FLIP_MARGIN}: {bad_flips[:4]}")
    bad = {n: g for n, g in gaps.items() if g[0] > max(CARD_CPU_TOL, F32_ERR_FACTOR * g[1])}
    if bad and not flips:
        raise RuntimeError(f"card vs CPU training step: {bad}")
    return {"loss": {"card": float(gl), "cpu": float(cl), "f64": float(wl)},
            "worst_leaf": worst, "worst_card_vs_f64": gaps[worst][0],
            "worst_cpu_vs_f64": gaps[worst][1], "leaves": len(wg),
            **({"routing_calls": len(gr), "flips": flips, "held": not flips} if gr else {})}


def _lm_train_families_path(torch):
    """The SSM and encoder-decoder families trained by the port's
    ``Trainer`` at full width.  ``mamba2-2.7b``, its depth cut to
    ``MAMBA_TRAIN_LAYERS`` of 64, on 6 batches of (2, 4096) tokens from a
    DWRF token corpus read through the decode kernels (``_token_corpus``
    first reads the whole corpus: one ``xor_decrypt`` and one
    ``ragged_gather_vec`` a stripe, the batches the numpy engine's); then
    ``seamless-m4t-large-v2`` whole on 6 batches of 4096 frames and 512
    decoder tokens from ``lm_synthetic_batches``.  Each run sets the counts
    to 0 just before and reads them just after (``_timed_fit``): no
    forward-only kernel, finite losses and grad norms; mamba2's batches
    read through the decode kernels once a stripe and byte-identical to
    the numpy engine's.  Model FLOPs of a step: 6 x the matrix products'
    parameters x the tokens they see (seamless: the encoder's, the cross-
    attention's K/V projections' at the frames, the rest at the decoder's
    tokens) plus 3 x the forward's scan or attention products (mamba2: the
    SSD's causal halves, ``_ssd_bound``; seamless: 4 B H S T D a full
    attention, half a causal one).  Then the SSD's share of a mamba2 step
    (``_train_ssd_share``), the SSD backward against float64
    (``_ssd_bwd_check``) and one narrow step on the card against the CPU
    for four families (``_train_families_card_vs_cpu``)."""
    import dataclasses

    from repro_torch.configs import mamba2_2p7b, seamless_m4t_v2
    from repro_torch.core import tokens as T
    from repro_torch.launch.train import lm_synthetic_batches

    tag = "lm_train_families"
    b, s = LM_TRAIN_BATCH, LM_TRAIN_SEQ
    out = {}

    def trainer_for(cfg):
        _free(torch)
        trainer, held, n_params, init_s = _lm_trainer(torch, cfg, tag,
                                                      f"{cfg.name}, {cfg.num_layers} layers")
        return trainer, held, {"parameters": n_params, "init_s": init_s}

    def summary(cfg, run, tokens, model_flops, row):
        median_ms = statistics.median(run["step_ms"][1:])
        share = model_flops / (median_ms / 1e3) / BF16_OPS_PER_S
        print(f"[{tag}] {cfg.name}: {LM_TRAIN_STEPS} steps in {run['fit_s']:.2f} s: step ms "
              f"{run['step_ms']} (CUDA events), median after the first {median_ms:.3f} ms, "
              f"{tokens / median_ms * 1e3:.1f} tokens/s; model FLOPs a step {model_flops} "
              f"({model_flops / BF16_OPS_PER_S * 1e3:.3f} ms at the bf16 peak, share "
              f"{share:.4f}); peak {run['peak'] / 1e9:.3f} GB; losses {run['losses']}; grad "
              f"norms {run['norms']}; stall fraction {run['stall']:.5f}", flush=True)
        row.update({"arch": cfg.name, "layers": cfg.num_layers, "batch": b,
                    "launches": run["launches"], "fit_s": run["fit_s"],
                    "step_ms": run["step_ms"], "median_step_ms": median_ms,
                    "tokens": tokens, "tokens_per_s": tokens / median_ms * 1e3,
                    "peak_bytes": run["peak"], "losses": run["losses"],
                    "grad_norms": run["norms"], "stall_fraction": run["stall"],
                    "model_flops": model_flops, "model_flops_share": share})
        return median_ms

    # mamba2-2.7b from the token corpus
    cfg = dataclasses.replace(mamba2_2p7b.CONFIG, num_layers=MAMBA_TRAIN_LAYERS)
    table, ref, n_stripes, extract = _token_corpus(torch, cfg.vocab_size, b, s, tag)
    trainer, held, row = trainer_for(cfg)
    model = trainer.model
    n_matmul = model.embed.out.numel() + sum(
        p.numel() for n, p in model.layers.named_parameters() if n.split(".")[-1] in SSM_MATMULS)
    fed = []

    def feed(batches):
        for batch in batches:
            fed.append(batch)
            yield batch

    run = _timed_fit(torch, trainer, held,
                     feed(T.lm_batches_from_table(table, s, b, decode_engine="torch")),
                     LM_TRAIN_STEPS, tag)
    _read_through_decode_kernels(run["launches"], fed, ref)
    sc = cfg.ssm
    h = sc.n_heads(cfg.d_model)
    x_meta = torch.empty((b, s, h, sc.head_dim), dtype=cfg.compute_dtype, device="meta")
    b_meta = torch.empty((b, s, sc.n_groups, sc.d_state), dtype=cfg.compute_dtype,
                         device="meta")
    ssd_flops = _ssd_bound(x_meta, b_meta, sc.chunk)[2]
    model_flops = 6 * n_matmul * b * s + 3 * cfg.num_layers * ssd_flops
    row.update({"seq": s, "corpus_batches": len(ref), "stripes": n_stripes,
                "extract_launches": extract, "matmul_parameters": n_matmul,
                "ssd_forward_flops_a_layer": ssd_flops})
    median_ms = summary(cfg, run, b * s, model_flops, row)
    del trainer, model, held
    _free(torch)
    row["ssd"] = _train_ssd_share(torch, cfg, median_ms)
    out["mamba2"] = row

    # seamless-m4t-large-v2 on lm_synthetic_batches' frames
    cfg = seamless_m4t_v2.CONFIG
    trainer, held, row = trainer_for(cfg)
    model = trainer.model
    fed.clear()
    run = _timed_fit(torch, trainer, held, feed(lm_synthetic_batches(cfg, b, s)),
                     LM_TRAIN_STEPS, tag)
    t_dec, heads, hd = fed[0]["tokens"].shape[1], cfg.num_heads, cfg.head_dim

    def matmuls(stack, keep):
        return sum(p.numel() for n, p in stack.named_parameters() if p.dim() >= 2 and keep(n))

    def cross_kv(n):          # "{layer}.cross_attn.wk": a projection of the frames
        return n.split(".", 1)[1] in ("cross_attn.wk", "cross_attn.wv")

    at_frames = matmuls(model.enc_layers, lambda n: True) + matmuls(model.dec_layers, cross_kv)
    at_tokens = (matmuls(model.dec_layers, lambda n: not cross_kv(n))
                 + model.embed.out.numel())
    model_flops = (6 * (at_frames * b * s + at_tokens * b * t_dec)
                   + 3 * cfg.encoder_layers * 4 * b * heads * s * s * hd
                   + 3 * cfg.num_layers * (2 * b * heads * t_dec * t_dec * hd
                                           + 4 * b * heads * t_dec * s * hd))
    row.update({"frames": s, "decoder_tokens": t_dec, "matmul_parameters_at_frames":
                at_frames, "matmul_parameters_at_tokens": at_tokens})
    summary(cfg, run, b * (s + t_dec), model_flops, row)
    del trainer, model, held, fed
    _free(torch)
    out["seamless"] = row

    out["ssd_bwd"] = _ssd_bwd_check(torch)
    out["card_vs_cpu"] = _train_families_card_vs_cpu(torch)
    return out


def _ssd_operands(torch, gen, x_shape, n, dtype):
    """SSD operands at (B, S, H, P) with one group of state size ``n``: x,
    B and C unit normal, dt = softplus of a unit normal and A = -exp of a
    normal of 0.5 (float32, as the mixer makes them), the others in
    ``dtype``."""
    b, s, h, p = x_shape
    x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    a = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    b_ = torch.randn((b, s, 1, n), generator=gen, device="cuda").to(dtype)
    c_ = torch.randn((b, s, 1, n), generator=gen, device="cuda").to(dtype)
    return [x, dt, a, b_, c_]


def _train_ssd_share(torch, cfg, step_ms):
    """A training step's SSD scans at the step's operands, bf16: the plain
    chunked form's forward under autograd (run twice a step under remat:
    the forward and its recompute) and forward + backward (the backward
    recomputes each chunk), CUDA events around back-to-back calls; their
    share of ``step_ms``; ``ssd_chunk_forward``'s forward at the same
    operands beside them (the yardstick for a hand-written backward)."""
    from repro_torch.kernels import ops
    from repro_torch.models import ssm

    sc = cfg.ssm
    shape = (LM_TRAIN_BATCH, LM_TRAIN_SEQ, sc.n_heads(cfg.d_model), sc.head_dim)
    gen = torch.Generator(device="cuda").manual_seed(4)
    operands = _ssd_operands(torch, gen, shape, sc.d_state, torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    for t in operands:
        t.requires_grad_()

    def forward():
        ssm.ssd_chunked(*operands, sc.chunk)

    def both():
        y, _ = ssm.ssd_chunked(*operands, sc.chunk)
        torch.autograd.grad(y, operands, dy)

    def kernel():
        with torch.no_grad():
            ops.ssd_chunk_forward(*(t.detach() for t in operands), chunk=sc.chunk)

    fwd_ms = _call_ms(torch, forward, iters=5)
    both_ms = _call_ms(torch, both, iters=5)
    kernel_ms = _call_ms(torch, kernel, iters=20)
    step_ssd = cfg.num_layers * (fwd_ms + both_ms)
    out = {"forward_ms": fwd_ms, "forward_backward_ms": both_ms,
           "kernel_forward_ms": kernel_ms, "a_step_ms": step_ssd,
           "share_of_step": step_ssd / step_ms}
    print(f"[lm_train_families] SSD at x {shape}, N {sc.d_state}, chunk {sc.chunk}, bf16: "
          f"the chunked form's forward {fwd_ms:.3f} ms, forward + backward {both_ms:.3f} ms "
          f"(ssd_chunk_forward's forward {kernel_ms:.3f} ms); {cfg.num_layers} layers x "
          f"(forward + recompute + backward) {step_ssd:.3f} ms, {step_ssd / step_ms:.4f} of "
          f"a step", flush=True)
    del operands, dy
    _free(torch)
    return out


def _ssd_bwd_check(torch):
    """``ssd_chunked`` under autograd on the card at ``SSD_BWD_X`` with one
    group of state ``SSD_BWD_N``, chunk ``SSD_BWD_CHUNK``, bf16, against
    the same operands in float64 on the card (the chunked form keeps
    float64 operands' precision): y and the gradients of x, dt, A, B and C
    each within ``FLASH_BWD_TOL`` of the float64 ones in relative norm;
    the output carries a graph (the chunked route), and no kernel is
    launched."""
    from repro_torch.kernels import build
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(8)
    operands = _ssd_operands(torch, gen, SSD_BWD_X, SSD_BWD_N, torch.bfloat16)
    dy = torch.randn(SSD_BWD_X, generator=gen, device="cuda").to(torch.bfloat16)
    runs = []
    build.LAUNCHES.reset()
    for dtype in (None, torch.float64):
        x = [(t if dtype is None else t.to(dtype)).detach().requires_grad_() for t in operands]
        y, _ = ssm.ssd_chunked(*x, SSD_BWD_CHUNK)
        if y.grad_fn is None:
            raise RuntimeError("ssd_chunked under grad returned no graph")
        runs.append([y.detach(), *torch.autograd.grad(y, x, dy.to(y.dtype))])
        del x, y
    torch.cuda.synchronize()
    if build.LAUNCHES.snapshot():
        raise RuntimeError(f"the SSD backward launched {build.LAUNCHES.snapshot()}")
    rel = {}
    for name, g, w in zip(("y", "dx", "ddt", "dA", "dB", "dC"), *runs):
        rel[name] = float((g.double() - w).norm() / w.norm())
    print(f"[lm_train_families] SSD backward at x {SSD_BWD_X}, N {SSD_BWD_N}, chunk "
          f"{SSD_BWD_CHUNK}, bf16: relative to float64 {rel}", flush=True)
    del runs, operands, dy
    _free(torch)
    if not all(r <= FLASH_BWD_TOL for r in rel.values()):
        raise RuntimeError(f"the SSD backward on the card is off float64 by {rel}")
    return rel


def _train_families_card_vs_cpu(torch):
    """One training step on the card against the CPU (``_step_card_vs_cpu``)
    for a narrow mamba2 (``MAMBA_TRAIN_NARROW``, chunk
    ``MAMBA_TRAIN_NARROW_CHUNK``) and the SMOKE configs of jamba, seamless
    and deepseek-v2, each on one ``lm_synthetic_batches`` batch of 2 rows
    of ``LM_TRAIN_NARROW_SEQ`` tokens (seamless: frames, and 32 decoder
    tokens)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch.train import lm_synthetic_batches

    mamba = configs.get_config("mamba2-2.7b")
    cases = {
        "mamba2": dataclasses.replace(mamba, **MAMBA_TRAIN_NARROW, ssm=dataclasses.replace(
            mamba.ssm, chunk=MAMBA_TRAIN_NARROW_CHUNK)),
        "jamba": configs.get_smoke_config("jamba-1.5-large-398b"),
        "seamless": configs.get_smoke_config("seamless-m4t-large-v2"),
        "deepseek-v2": configs.get_smoke_config("deepseek-v2-236b"),
    }
    out = {}
    for name, cfg in cases.items():
        batch = next(lm_synthetic_batches(cfg, 2, LM_TRAIN_NARROW_SEQ, seed=5))
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        out[name] = _step_card_vs_cpu(torch, cfg, batch, "lm_train_families",
                                      f"{cfg.name} ({cfg.num_layers} layers, d_model "
                                      f"{cfg.d_model})")
    return out


class _MeshShape:
    """A mesh's axis names and sizes, for ``partition_specs`` before any
    rank exists."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


def _sharded_lm_config():
    """``deepseek-v2-236b`` at full width with ``SHARDED_LM_LAYERS``
    layers and ``SHARDED_LM_EXPERTS`` experts, the plain attention's
    query blocks ``SHARDED_LM_ATTN_CHUNK`` rows."""
    import dataclasses

    from repro_torch.configs.deepseek_v2_236b import CONFIG

    return dataclasses.replace(CONFIG, num_layers=SHARDED_LM_LAYERS,
                               attn_chunk=SHARDED_LM_ATTN_CHUNK,
                               moe=dataclasses.replace(CONFIG.moe,
                                                       num_experts=SHARDED_LM_EXPERTS))


def _sharded_lm_reckoning(torch):
    """The parameters of the cut config and, on ``SHARDED_LM_MESH`` under
    ``TRAIN_RULES``, one rank's slices, the leaves it gathers for its
    forward and their bytes: parameters by their dtypes, AdamW's float32
    mu and nu beside the slices, gradients as the gathered leaves."""
    import math as m

    from repro_torch.convert import flatten
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.models import build_model
    from repro_torch.models.common import partition_specs

    cfg = _sharded_lm_config()
    model = build_model(cfg, device="meta")
    mesh = _MeshShape(SHARDED_LM_MESH)
    specs = flatten(partition_specs(model.stacked_param_specs(), TRAIN_RULES, mesh))
    leaves = flatten(model.stacked_param_specs())
    out = dict(experts=0, layer_other=0, embed=0, rank_slice=0, rank_slice_bytes=0,
               rank_gathered_bytes=0)
    n_model = SHARDED_LM_MESH[1]
    for k, spec in leaves.items():
        n = m.prod(spec.shape)
        size = torch.empty((), dtype=spec.dtype).element_size()
        expert = spec.logical[1:2] == ("expert",)
        key = "experts" if expert else ("embed" if k.startswith("embed.") else "layer_other")
        out[key] += n
        split = m.prod(mesh.shape[a] for ax in specs[k] if ax
                       for a in ((ax,) if isinstance(ax, str) else ax))
        out["rank_slice"] += n // split
        out["rank_slice_bytes"] += n // split * size
        out["rank_gathered_bytes"] += (n // n_model if expert else n) * size
    out["total"] = out["experts"] + out["layer_other"] + out["embed"]
    out["rank_moments_bytes"] = 8 * out["rank_slice"]
    out["one_rank_bytes"] = 2 * out["total"] * 2 + 8 * out["total"]   # bf16 w + g, f32 mu, nu
    return out


def _scale_routers(torch, params):
    """``params`` (a rank's slices by name) with every MoE router scaled
    by ``TRAIN_ROUTER_SCALE``, in place: the init's "scaled" std takes
    the stack's length as the fan-in, 1 for one layer, and the routing
    softmax of d_model 5120 would underflow to exact ties."""
    with torch.no_grad():
        for k, p in params.items():
            if k.endswith(".router"):
                p.mul_(TRAIN_ROUTER_SCALE)
    return params


def _sharded_lm_rank(rank, shape, batches, prompt, next_token):
    """One rank of the sharded LM phase (spawned): the cut
    ``deepseek-v2-236b`` on ``shape``, ``SHARDED_LM_STEPS`` steps of
    ``make_train_step`` from ``init_state(SHARDED_LM_SEED)``, then
    ``make_prefill_step`` on ``prompt`` and one ``make_decode_step`` on
    its cache, from the seed's weights.  Returns the losses, grad norms,
    step times and the collectives' time in each (every ``Mesh``
    collective timed between two synchronizations), launch counts of the
    steps and of the serving steps, how often ``moe_forward_ep`` ran, the
    experts each expert leaf holds, the step-1 forward's routing and its
    slots past capacity, a digest of every slice after the last step,
    peak memory, and the serving steps' logits and times."""
    import os

    # four ranks share the card: segments that grow in place keep each
    # rank's freed blocks reusable (a first run lost 3.75 GB a rank to
    # reserved, unallocated blocks and ran out of memory)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import numpy as np
    import torch

    from repro_torch.distributed.sharding import P, shard_leaf
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_mesh, record_collectives
    from repro_torch.launch.steps import make_decode_step, make_prefill_step, make_train_step
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import OptimizerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = build.BUILD_DIR / f"librepro_torch_{build.source_hash()}.so"
    if not lib.exists():
        raise RuntimeError(f"rank {rank}: {lib} not built: the parent builds before spawning")
    cfg = _sharded_lm_config()
    mesh = make_mesh(shape, ("data", "model"), device="cuda")
    coll = [0.0]

    def timed(fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                coll[0] += time.perf_counter() - t
        return run

    mesh.all_reduce, mesh.all_gather = timed(mesh.all_reduce), timed(mesh.all_gather)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = make_train_step(cfg, mesh, SHARDED_LM_BATCH, SHARDED_LM_SEQ,
                             opt_cfg=OptimizerConfig(**SHARDED_LM_OPT), device="cuda")
    params, opt = bundle.init_state(SHARDED_LM_SEED)
    _scale_routers(torch, params)
    local = [bundle.shard_batch(b) for b in batches]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    experts = {k: int(p.shape[0]) for k, p in params.items()
               if k.endswith(("ffn.wi_gate", "ffn.wi_up", "ffn.wo"))}

    real_route, real_ep = moe_lib.route, moe_lib.moe_forward_ep
    routes, dropped, ep_calls = [], [], [0]

    def route(router_w, x, m):
        idx, gates, aux = real_route(router_w, x, m)
        if not routes:
            routes.append(idx.to(torch.int16).cpu().numpy())
        counts = torch.bincount(idx.reshape(-1), minlength=m.num_experts)
        cap = moe_lib._capacity(idx.shape[0], m)
        dropped.append(int((counts - cap).clamp(min=0).sum()))
        return idx, gates, aux

    def ep(*args, **kwargs):
        ep_calls[0] += 1
        return real_ep(*args, **kwargs)

    moe_lib.route, moe_lib.moe_forward_ep = route, ep
    losses, norms, step_s, coll_s = [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts set to 0 just before, read just after
    build.LAUNCHES.reset()
    try:
        for i, b in enumerate(local):
            coll[0] = 0.0
            t = time.perf_counter()
            with record_collectives() as log:
                params, opt, metrics = bundle.fn(params, opt, b)
            if i == 0:       # step 1's collectives: (kind, result bytes, axis, group)
                collectives = [[c.kind, c.nbytes, c.axis, c.group] for c in log]
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            step_s.append(time.perf_counter() - t)
            coll_s.append(coll[0])
        train_launches = build.LAUNCHES.snapshot()
        train_peak = torch.cuda.max_memory_allocated()
        specs = {k: tuple(s) for k, s in bundle.in_specs[0].items()}
        digests = {k: hashlib.sha1(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                                   .tobytes()).hexdigest() for k, p in params.items()}
        del params, opt, local, bundle
        _free(torch)

        torch.cuda.reset_peak_memory_stats()
        pre = make_prefill_step(cfg, mesh, SHARDED_LM_BATCH, SHARDED_LM_SEQ, device="cuda")
        dec = make_decode_step(cfg, mesh, SHARDED_LM_BATCH,
                               SHARDED_LM_SEQ + SHARDED_LM_DECODE_EXTRA, device="cuda")
        serve_params = _scale_routers(torch, pre.init_params(SHARDED_LM_SEED))
        ins = pre.shard_batch({"tokens": prompt})
        n_ep = ep_calls[0]
        torch.cuda.synchronize()
        build.LAUNCHES.reset()
        t = time.perf_counter()
        logits, cache = pre.fn(serve_params, ins)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        prefill_launches = build.LAUNCHES.snapshot()
        logical = dec.model.cache_logical_axes()
        local_cache = {}
        for k, c in cache.items():
            pad = c.new_zeros(c.shape[:2] + (SHARDED_LM_DECODE_EXTRA,) + c.shape[3:])
            beyond = P(*(None if n == "batch" else ax
                         for n, ax in zip(logical[k], dec.in_specs[1]["cache"][k])))
            local_cache[k] = shard_leaf(torch.cat([c, pad], dim=2), beyond, mesh).contiguous()
        del cache
        token = dec.shard_batch({"token": next_token})["token"]
        build.LAUNCHES.reset()
        t = time.perf_counter()
        dlogits, _ = dec.fn(serve_params, {"token": token, "pos": SHARDED_LM_SEQ,
                                           "cache": local_cache})
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        decode_launches = build.LAUNCHES.snapshot()
        serve_peak = torch.cuda.max_memory_allocated()
        serve_ep = ep_calls[0] - n_ep
    finally:
        moe_lib.route, moe_lib.moe_forward_ep = real_route, real_ep
    return {
        "rank": rank, "coord": (mesh.coord("data"), mesh.coord("model")),
        "backend": mesh.backend, "losses": losses, "grad_norms": norms, "step_s": step_s,
        "collective_s": coll_s, "init_s": init_s, "init_peak": init_peak,
        "train_peak": train_peak, "serve_peak": serve_peak,
        "train_launches": train_launches, "prefill_launches": prefill_launches,
        "decode_launches": decode_launches, "ep_calls_train": n_ep, "ep_calls_serve": serve_ep,
        "experts": experts, "routes_step1": routes[0], "dropped": dropped,
        "specs": specs, "digests": digests, "collectives_step1": collectives,
        "prefill_logits": logits.float().cpu().numpy(), "prefill_s": prefill_s,
        "decode_logits": dlogits.float().cpu().numpy(), "decode_s": decode_s,
    }


def _sharded_lm_smoke_rank(rank, batches):
    """One rank of the SMOKE float32 check (spawned): ``deepseek-smoke``'s
    train step on each of ``SHARDED_LM_SMOKE_MESHES``, 3 steps on the CPU
    then the same on the card from the same slices (routers scaled by
    ``TRAIN_ROUTER_SCALE``).  Returns each side's losses and grad norms,
    the largest gaps between them, and the routing: every routed token's
    experts on the card against the CPU's, a token whose set differs a
    flip, with its top-k margin on the CPU; each step's forward calls are
    compared (its first ``num_layers`` calls: remat's recomputations
    follow them in an order the backward picks).  A mesh's run with a
    flip is reported and not held (a flipped token's gradients differ by
    construction), as ``_step_card_vs_cpu`` does."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.deepseek_v2_236b import SMOKE
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim import OptimizerConfig, adamw_init, wsd_schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    cfg = dataclasses.replace(SMOKE, param_dtype=torch.float32, compute_dtype=torch.float32,
                              remat=True)
    opt_cfg = OptimizerConfig(**SHARDED_LM_OPT)
    real_route, routes = moe_lib.route, []

    def route(router_w, x, m):
        idx, gates, aux = real_route(router_w, x, m)
        with torch.no_grad():
            top = torch.topk(torch.softmax(x.to(m.router_dtype) @ router_w, dim=-1),
                             m.top_k + 1, dim=-1).values
            routes.append((np.sort(idx.cpu().numpy(), axis=1),
                           (top[:, -2] - top[:, -1]).cpu().numpy()))
        return idx, gates, aux

    out = {}
    moe_lib.route = route
    try:
        for shape in SHARDED_LM_SMOKE_MESHES:
            runs = {}
            for dev in ("cpu", "cuda"):
                mesh = make_mesh(shape, ("data", "model"), device=dev)
                bundle = make_train_step(cfg, mesh, SHARDED_LM_SMOKE_BATCH,
                                         SHARDED_LM_SMOKE_SEQ, opt_cfg=opt_cfg, device=dev)
                if dev == "cpu":
                    start = _scale_routers(torch, bundle.init_params(SHARDED_LM_SEED))
                params = {k: p.clone().to(mesh.device) for k, p in start.items()}
                opt = adamw_init(params, opt_cfg)
                losses, norms, forward, calls, lrs, slices = [], [], [], [], [], []
                for i, b in enumerate(batches):
                    routes.clear()
                    params, opt, metrics = bundle.fn(params, opt, bundle.shard_batch(b))
                    losses.append(metrics["loss"].item())
                    norms.append(metrics["grad_norm"].item())
                    lrs.append(wsd_schedule(opt_cfg, opt["step"]).item())
                    forward += routes[:cfg.num_layers]
                    calls.append(len(routes))
                    if i in (0, len(batches) - 1):     # copies: the step updates in place
                        slices.append({k: p.cpu().numpy().copy() for k, p in params.items()})
                runs[dev] = (np.array(losses), np.array(norms), slices, forward, calls)
            (cl, cn, cp, cr, c_calls), (gl, gn, gp, gr, g_calls) = runs["cpu"], runs["cuda"]
            flips = [(call, float(margin[i]))
                     for call, ((ci, margin), (gi, _)) in enumerate(zip(cr, gr))
                     for i in np.nonzero((ci != gi).any(axis=1))[0]]
            over = {}
            for (want, got), atol in zip(zip(cp, gp), (SHARDED_LM_SMOKE_TOL, SHARDED_LM_SMOKE_TOL
                                                      + 2 * sum(lrs))):
                over.update({f"{k} ({'step 1' if atol == SHARDED_LM_SMOKE_TOL else 'last'})":
                             float(np.abs(got[k] - want[k]).max()) for k in want
                             if not np.allclose(got[k], want[k], rtol=SHARDED_LM_SMOKE_TOL,
                                                atol=atol)})
            norm_rel = np.abs(gn - cn) / np.abs(cn)
            out[shape] = {"cpu_losses": cl.tolist(), "card_losses": gl.tolist(),
                          "cpu_grad_norms": cn.tolist(), "card_grad_norms": gn.tolist(),
                          "loss_rel": float(np.max(np.abs(gl - cl) / np.abs(cl))),
                          "grad_norm_rel": norm_rel.tolist(),
                          "grad_norms_over": bool(
                              norm_rel[0] > SHARDED_LM_SMOKE_TOL
                              or (norm_rel[1:] > SHARDED_LM_SMOKE_LATER_NORM_RTOL).any()),
                          "max_abs_slice_diff": [max(float(np.abs(g[k] - w[k]).max())
                                                     for k in w) for w, g in zip(cp, gp)],
                          "lr": lrs, "slices_over_tol": over, "forward_calls": len(cr),
                          "calls_a_step": [c_calls, g_calls], "flips": len(flips),
                          "max_flip_margin": max((m for _, m in flips), default=0.0),
                          "first_flips": flips[:4], "held": not flips,
                          "min_margin": float(min(m.min() for _, m in cr))}
    finally:
        moe_lib.route = real_route
    return out


def _sharded_lm_phase(torch, card):
    """The sharded LM step on the card (``SHARDED_LM_*``): the reckoning
    printed first; the cut ``deepseek-v2-236b`` on four gloo ranks of mesh
    (2, 2), then on one NCCL rank of mesh (1, 1) (the unsharded path);
    then the float32 SMOKE steps on the card against the CPU.  Checks
    that each rank holds 16 experts and ran ``moe_forward_ep``, the
    replicated slices are bit-identical across the ranks that hold them,
    the losses and grad norms within ``SHARDED_LM_LOSS_RTOL`` and
    ``SHARDED_LM_NORM_RTOL`` of the one rank's, no forward-only kernel in
    a step, one ``flash_attention`` launch a prefill layer on every rank
    and nothing else, the prefill and decode logits of each rank's rows
    within ``SHARDED_LM_LOGIT_RTOL`` of the one rank's in relative norm,
    and the SMOKE steps within ``SHARDED_LM_SMOKE_TOL`` (later steps as
    the constants' comment says); counts the
    tokens whose top-6 expert set differs from the one rank's.  Returns
    the phase's record."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.distributed.spawn import spawn
    from repro_torch.kernels import build

    reckoning = _sharded_lm_reckoning(torch)
    print(f"[sharded_lm] reckoning: {reckoning['total']:,} parameters ("
          f"{reckoning['experts']:,} in {SHARDED_LM_EXPERTS} experts, "
          f"{reckoning['layer_other']:,} other layer, {reckoning['embed']:,} tok + out); one "
          f"rank holding it whole {reckoning['one_rank_bytes'] / 1e9:.2f} GB of bf16 weights "
          f"and gradients and float32 moments, before AdamW's copies; on "
          f"{SHARDED_LM_MESH} a rank holds {reckoning['rank_slice']:,} parameters in slices "
          f"({reckoning['rank_slice_bytes'] / 1e9:.2f} GB, moments "
          f"{reckoning['rank_moments_bytes'] / 1e9:.2f} GB) and gathers "
          f"{reckoning['rank_gathered_bytes'] / 1e9:.2f} GB of weights for its forward "
          f"(gradients the same again)", flush=True)
    build.library()                  # the ranks load this build, never nvcc
    _free(torch)
    free_b, total_b = torch.cuda.mem_get_info()
    parent = {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
              "card_free": free_b, "card_total": total_b}
    print(f"[sharded_lm] this process holds {parent['allocated'] / 1e9:.3f} GB allocated, "
          f"{parent['reserved'] / 1e9:.3f} GB reserved; the card has {free_b / 1e9:.2f} of "
          f"{total_b / 1e9:.2f} GB free", flush=True)
    rng = np.random.default_rng(SHARDED_LM_SEED)
    vocab = _sharded_lm_config().vocab_size
    b, s = SHARDED_LM_BATCH, SHARDED_LM_SEQ
    toks = rng.integers(0, vocab, (SHARDED_LM_STEPS, b, s + 1)).astype(np.int32)
    batches = [{"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()} for t in toks]
    prompt = rng.integers(0, vocab, (b, s)).astype(np.int32)
    next_token = rng.integers(0, vocab, (b, 1)).astype(np.int32)
    srng = np.random.default_rng(SHARDED_LM_SMOKE_SEED)
    stoks = srng.integers(0, 512, (SHARDED_LM_STEPS, SHARDED_LM_SMOKE_BATCH,
                                   SHARDED_LM_SMOKE_SEQ + 1)).astype(np.int32)
    smoke_batches = [{"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()} for t in stoks]
    tmp = tempfile.mkdtemp(prefix="sharded_lm_")
    try:
        t = time.perf_counter()
        four = spawn(_sharded_lm_rank, 4, f"{tmp}/rdv4", "gloo",
                     args=(SHARDED_LM_MESH, batches, prompt, next_token),
                     timeout_s=SHARDED_LM_TIMEOUT_S)
        four_s = time.perf_counter() - t
        t = time.perf_counter()
        (one,) = spawn(_sharded_lm_rank, 1, f"{tmp}/rdv1", "nccl",
                       args=((1, 1), batches, prompt, next_token),
                       timeout_s=SHARDED_LM_TIMEOUT_S)
        one_s = time.perf_counter() - t
        t = time.perf_counter()
        smoke = spawn(_sharded_lm_smoke_rank, 4, f"{tmp}/rdv_smoke", "gloo",
                      args=(smoke_batches,), timeout_s=SHARDED_LM_TIMEOUT_S)
        smoke_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    problems = []          # every check's failure, raised after the record prints
    per = SHARDED_LM_EXPERTS // SHARDED_LM_MESH[1]
    n_data = SHARDED_LM_MESH[0]
    for r, want in [(r, per) for r in four] + [(one, SHARDED_LM_EXPERTS)]:
        if not r["experts"] or set(r["experts"].values()) != {want}:
            problems.append(f"rank {r['rank']} of {r['coord']} holds experts "
                            f"{r['experts']}, expected {want} a leaf")
        forward_only = {k: v for k, v in r["train_launches"].items()
                        if k in FORWARD_ONLY_KERNELS}
        if forward_only:
            problems.append(f"rank {r['rank']}: a training step launched {forward_only}")
        if r["prefill_launches"] != {"flash_attention": SHARDED_LM_LAYERS}:
            problems.append(f"rank {r['rank']}'s prefill launched {r['prefill_launches']}: "
                            f"expected flash_attention's FMA route (D = 192) once a layer")
        if not all(np.isfinite(r["losses"])) or not np.isfinite(r["prefill_logits"]).all():
            problems.append(f"rank {r['rank']}: non-finite losses or logits")
    for r in four:
        if r["ep_calls_train"] <= 0 or r["ep_calls_serve"] <= 0:
            problems.append(f"rank {r['rank']} never ran moe_forward_ep "
                            f"({r['ep_calls_train']}, {r['ep_calls_serve']})")
        if r["losses"] != four[0]["losses"] or r["grad_norms"] != four[0]["grad_norms"]:
            problems.append(f"rank {r['rank']} losses {r['losses']} != rank 0's")
    if one["ep_calls_train"] or one["ep_calls_serve"]:
        problems.append("the one rank took the expert-parallel forward")
    # the ranks that hold one slice hold it bit for bit
    held = {}
    for r in four:
        coord = dict(zip(("data", "model"), r["coord"]))
        for k, spec in r["specs"].items():
            used = sorted({a for ax in spec if ax
                           for a in ((ax,) if isinstance(ax, str) else ax)})
            key = (k, tuple(coord[a] for a in used))
            if held.setdefault(key, r["digests"][k]) != r["digests"][k]:
                problems.append(f"{k} differs between ranks holding the same slice {key}")
    got_l, want_l = np.array(four[0]["losses"]), np.array(one["losses"])
    got_n, want_n = np.array(four[0]["grad_norms"]), np.array(one["grad_norms"])
    loss_rel = np.abs(got_l - want_l) / np.abs(want_l)
    norm_rel = np.abs(got_n - want_n) / np.abs(want_n)
    if (loss_rel > SHARDED_LM_LOSS_RTOL).any() or (norm_rel > SHARDED_LM_NORM_RTOL).any():
        problems.append(f"four-rank losses {got_l} / grad norms {got_n} vs one rank's "
                        f"{want_l} / {want_n}: rel {loss_rel} / {norm_rel}")

    def rel(a, b_):
        return float(np.linalg.norm(a - b_) / np.linalg.norm(b_))

    rows = SHARDED_LM_BATCH // n_data
    logit_rel, flips = {"prefill": [], "decode": []}, 0
    tokens_a_shard = rows * SHARDED_LM_SEQ
    for r in four:
        d, m = r["coord"]
        for part in ("prefill", "decode"):
            mine = r[f"{part}_logits"]
            logit_rel[part].append(rel(mine, one[f"{part}_logits"][d * rows:(d + 1) * rows]))
        if m == 0:
            a = np.sort(r["routes_step1"], axis=1)
            w = np.sort(one["routes_step1"][d * tokens_a_shard:(d + 1) * tokens_a_shard], axis=1)
            flips += int((a != w).any(axis=1).sum())
    worst = {k: max(v) for k, v in logit_rel.items()}
    if max(worst.values()) > SHARDED_LM_LOGIT_RTOL:
        problems.append(f"each rank's logits against the one rank's rows, relative norm: "
                        f"{logit_rel}")
    bad_flips = {(r_i, str(k)): (v["flips"], v["first_flips"], v["calls_a_step"])
                 for r_i, r in enumerate(smoke) for k, v in r.items()
                 if v["max_flip_margin"] >= ROUTE_FLIP_MARGIN}
    if bad_flips:
        problems.append(f"SMOKE steps: expert choices differ between the card and the CPU "
                        f"at margins >= {ROUTE_FLIP_MARGIN} (rank, mesh): (flips, first "
                        f"(call, margin), route calls a step on CPU and card) {bad_flips}")
    bad_smoke = {str(k): v for r in smoke for k, v in r.items() if v["held"]
                 and (v["loss_rel"] > SHARDED_LM_SMOKE_TOL or v["grad_norms_over"]
                      or v["slices_over_tol"])}
    if bad_smoke:
        problems.append(f"SMOKE float32 steps on the card against the CPU: {bad_smoke}")

    after = slice(1, None)
    record = {
        "config": "deepseek-v2-236b", "card": card,
        "cuts": {"layers": [SHARDED_LM_LAYERS, 60], "experts": [SHARDED_LM_EXPERTS, 160]},
        "reckoning": reckoning, "parent_memory": parent,
        "batch": [SHARDED_LM_BATCH, SHARDED_LM_SEQ], "attn_chunk": SHARDED_LM_ATTN_CHUNK,
        "steps": SHARDED_LM_STEPS,
        "four": {"mesh": list(SHARDED_LM_MESH), "backend": "gloo", "wall_s": four_s,
                 "step_s": [r["step_s"] for r in four],
                 "step_s_after_first_mean": statistics.mean(
                     x for r in four for x in r["step_s"][after]),
                 "collective_s": [r["collective_s"] for r in four],
                 "collective_share_after_first": statistics.mean(
                     c / t for r in four for c, t in zip(r["collective_s"][after],
                                                         r["step_s"][after])),
                 "init_s": [r["init_s"] for r in four],
                 "init_peak": [r["init_peak"] for r in four],
                 "train_peak": [r["train_peak"] for r in four],
                 "serve_peak": [r["serve_peak"] for r in four],
                 "losses": four[0]["losses"], "grad_norms": four[0]["grad_norms"],
                 "train_launches": [r["train_launches"] for r in four],
                 "prefill_launches": [r["prefill_launches"] for r in four],
                 "decode_launches": [r["decode_launches"] for r in four],
                 "prefill_s": [r["prefill_s"] for r in four],
                 "decode_s": [r["decode_s"] for r in four],
                 "ep_calls": [[r["ep_calls_train"], r["ep_calls_serve"]] for r in four],
                 "dropped": [r["dropped"] for r in four]},
        "one": {"mesh": [1, 1], "backend": "nccl", "wall_s": one_s, "step_s": one["step_s"],
                "collective_s": one["collective_s"], "init_s": one["init_s"],
                "train_peak": one["train_peak"], "serve_peak": one["serve_peak"],
                "losses": one["losses"], "grad_norms": one["grad_norms"],
                "prefill_launches": one["prefill_launches"],
                "decode_launches": one["decode_launches"], "prefill_s": one["prefill_s"],
                "decode_s": one["decode_s"], "dropped": one["dropped"]},
        "loss_rel": loss_rel.tolist(), "grad_norm_rel": norm_rel.tolist(),
        "logit_rel": logit_rel, "routing_flips_step1": flips,
        "rank0_coord": list(four[0]["coord"]),
        "rank0_collectives_step1": four[0]["collectives_step1"],
        "routed_tokens_step1": SHARDED_LM_BATCH * SHARDED_LM_SEQ,
        "smoke": {"wall_s": smoke_s, **{str(k): v for k, v in smoke[0].items()},
                  "held": [[v["held"] for v in r.values()] for r in smoke],
                  "min_margin": min(v["min_margin"] for r in smoke for v in r.values())},
    }
    print(f"[sharded_lm] {card}: deepseek-v2-236b, 1 of 60 layers, {SHARDED_LM_EXPERTS} of "
          f"160 experts, on {SHARDED_LM_MESH} gloo ranks: steps {four[0]['step_s']} s "
          f"(rank 0), collectives {four[0]['collective_s']} s, peaks "
          f"{[r['train_peak'] / 1e9 for r in four]} GB a rank (init "
          f"{[r['init_peak'] / 1e9 for r in four]}); one NCCL rank steps {one['step_s']} s, "
          f"peak {one['train_peak'] / 1e9:.2f} GB; losses {got_l.tolist()} vs "
          f"{want_l.tolist()} (rel {loss_rel.max():.3e}), grad norms {got_n.tolist()} vs "
          f"{want_n.tolist()} (rel {norm_rel.max():.3e}); routing flips at step 1 {flips} of "
          f"{SHARDED_LM_BATCH * SHARDED_LM_SEQ} tokens; slots past capacity {four[0]['dropped']} "
          f"(rank 0) vs {one['dropped']}; prefill {[r['prefill_s'] for r in four]} s "
          f"launches {four[0]['prefill_launches']}, logits rel {worst}; SMOKE float32 card vs "
          f"CPU {[(str(k), v['loss_rel'], v['grad_norm_rel'], v['max_abs_slice_diff'], v['held']) for k, v in smoke[0].items()]}, "
          f"smallest top-k margin {record['smoke']['min_margin']:.3e}; wall {four_s:.1f} + "
          f"{one_s:.1f} + {smoke_s:.1f} s", flush=True)
    if problems:
        raise RuntimeError("; ".join(problems))
    return record


def _op_count_diff(a, b):
    """{op: (count in a, count in b)} where two traces' op counts differ."""
    ca, cb = a.op_counts(), b.op_counts()
    return {k: (ca.get(k, 0), cb.get(k, 0)) for k in sorted(set(ca) | set(cb))
            if ca.get(k, 0) != cb.get(k, 0)}


def _by_kind(log):
    """{kind: [count, result bytes]} of a collective log of (kind, bytes, ...)."""
    out = {}
    for kind, nbytes, *_ in log:
        c = out.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nbytes
    return out


def _launch_tooling_phase(torch, card, lm_train, sharded_lm):
    """The launch tooling against the card.  ``TOOLING_CELLS`` are dry-run
    at production scale by ``python -m repro_torch.launch.dryrun``, each in
    a process of its own started first, and must be ``ok``.  Meanwhile:
    the LM training phase's step (qwen3-8b at every width, its depth cut to
    ``LM_TRAIN_LAYERS``, ``LM_TRAIN_BATCH`` x ``LM_TRAIN_SEQ``, remat) by
    ``make_train_step`` on a (1, 1) ``VirtualMesh`` on the card, one step
    traced by the analyzer after a first one, then ``TOOLING_TIMED`` steps
    timed with CUDA events, against the same step on ``meta``: flops
    identical, bytes within ``TOOLING_BYTES_RTOL`` (ops whose counts differ
    printed), the card's peak memory within ``TOOLING_PEAK_RTOL`` of the dry
    run's ``total_bytes_per_device``; the roofline's compute and memory
    terms beside the measured median step, and ``model_flops_estimate``'s
    share of the bf16 peak beside the LM training phase's own.  Then the
    serving phase's whole qwen3-8b prefill traced on the card: as many
    ``flash_attention`` kernel ops as layers, equal to the launches, and
    the totals of its ``meta`` dry run; the measured ``prefill_s`` beside
    the roofline's ``step_time_s``.  Last, the sharded LM phase's rank 0
    step-1 collectives against its dry run on a (2, 2) ``VirtualMesh``, by
    kind, count and bytes.  Returns the phase's record."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.configs.qwen3_8b import CONFIG
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.hlo_analysis import analyze, memory_analysis, trace
    from repro_torch.launch.mesh import PEAK_FLOPS_BF16, VirtualMesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import OptimizerConfig

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    procs, problems, record = [], [], {"card": card}
    axes = ("data", "model")
    try:
        for arch, shape_name in TOOLING_CELLS:
            out = f"{tmp}/{arch}_{shape_name}.jsonl"
            procs.append((arch, shape_name, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape_name, "--out", out], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

        # the LM training step on the card, traced, against its meta dry run
        _free(torch)
        cfg = dataclasses.replace(CONFIG, num_layers=LM_TRAIN_LAYERS)
        shape = configs.ShapeSpec("lm_train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
        opt_cfg = OptimizerConfig(**LM_TRAIN_OPT)
        bundle = make_train_step(cfg, VirtualMesh((1, 1), axes, device="cuda"), LM_TRAIN_BATCH,
                                 LM_TRAIN_SEQ, opt_cfg=opt_cfg, device="cuda")
        params, opt = bundle.init_state(0)
        gen = torch.Generator(device="cuda").manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (LM_TRAIN_BATCH, LM_TRAIN_SEQ + 1),
                             generator=gen, device="cuda", dtype=torch.int32)
        batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
        params, opt, _ = bundle.fn(params, opt, batch)       # a first step: cuBLAS, caches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        card_tr = trace(bundle.fn, params, opt, batch)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t
        card_peak = torch.cuda.max_memory_allocated()
        params, opt, metrics = card_tr.result
        card_tr.result = None
        step_ms = []
        for _ in range(TOOLING_TIMED):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            params, opt, metrics = bundle.fn(params, opt, batch)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
        loss = float(metrics["loss"])
        del params, opt, metrics, bundle, batch, toks
        _free(torch)
        meta_b = make_train_step(cfg, VirtualMesh((1, 1), axes), LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                                 opt_cfg=opt_cfg, device="meta")
        meta_tr = trace(meta_b.fn, *dryrun.lm_args(meta_b, shape))
        card_c, meta_c = analyze(card_tr), analyze(meta_tr)
        mem = memory_analysis(meta_tr)
        diff = _op_count_diff(card_tr, meta_tr)
        bytes_rel = abs(card_c.bytes_accessed - meta_c.bytes_accessed) / meta_c.bytes_accessed
        peak_rel = abs(card_peak - mem["total_bytes_per_device"]) / mem["total_bytes_per_device"]
        median_ms = statistics.median(step_ms)
        terms = rl.RooflineTerms(meta_c.flops, meta_c.bytes_accessed, 0.0, 1,
                                 rl.model_flops_estimate(cfg, shape))
        est_share = terms.model_flops / (lm_train["median_step_ms"] / 1e3) / PEAK_FLOPS_BF16
        own_share = lm_train["model_flops_share"]
        record["train_step"] = {
            "layers": LM_TRAIN_LAYERS, "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ],
            "card_flops": card_c.flops, "meta_flops": meta_c.flops,
            "card_bytes": card_c.bytes_accessed, "meta_bytes": meta_c.bytes_accessed,
            "bytes_rel": bytes_rel, "op_count_diff": {k: list(v) for k, v in diff.items()},
            "ops": [len(card_tr.ops), len(meta_tr.ops)], "card_peak": card_peak,
            "dry_run_memory": mem, "peak_rel": peak_rel, "traced_s": traced_s,
            "step_ms": step_ms, "median_step_ms": median_ms, "loss": loss,
            "compute_s": terms.compute_s, "memory_s": terms.memory_s,
            "step_time_s": terms.step_time_s, "bottleneck": terms.bottleneck,
            "model_flops_estimate": terms.model_flops,
            "estimate_share_at_lm_train_step": est_share,
            "estimate_share_at_this_step": terms.model_flops / (median_ms / 1e3) / PEAK_FLOPS_BF16,
            "lm_train_model_flops": lm_train["model_flops"],
            "lm_train_model_flops_share": own_share,
            "share_gap": est_share - own_share,
        }
        print(f"[tooling] train step {cfg.name} {LM_TRAIN_LAYERS} layers {LM_TRAIN_BATCH}x"
              f"{LM_TRAIN_SEQ}: flops card {card_c.flops:.0f} meta {meta_c.flops:.0f}; bytes card "
              f"{card_c.bytes_accessed:.0f} meta {meta_c.bytes_accessed:.0f} (rel {bytes_rel:.2e}); "
              f"ops {len(card_tr.ops)} / {len(meta_tr.ops)}, counts differing {diff}; peak card "
              f"{card_peak} B, dry run {mem['total_bytes_per_device']} B (rel {peak_rel:.3f}; "
              f"{mem}); compute_s {terms.compute_s:.6f} memory_s {terms.memory_s:.6f} "
              f"(bottleneck {terms.bottleneck}) against the measured median step "
              f"{median_ms / 1e3:.6f} s ({step_ms} ms, CUDA events; the traced step "
              f"{traced_s:.2f} s wall); model_flops_estimate {terms.model_flops:.4e}, share "
              f"{est_share:.4f} at the LM training phase's {lm_train['median_step_ms']:.3f} ms "
              f"against that phase's {own_share:.4f} (its {lm_train['model_flops']:.4e} FLOPs), "
              f"gap {est_share - own_share:+.4f}", flush=True)
        if card_c.flops != meta_c.flops:
            problems.append(f"train step flops: card {card_c.flops} != meta {meta_c.flops}")
        if bytes_rel > TOOLING_BYTES_RTOL:
            problems.append(f"train step bytes: card {card_c.bytes_accessed} vs meta "
                            f"{meta_c.bytes_accessed} (rel {bytes_rel:.3e}); {diff}")
        if peak_rel > TOOLING_PEAK_RTOL:
            problems.append(f"train step peak: card {card_peak} vs dry run "
                            f"{mem['total_bytes_per_device']} (rel {peak_rel:.3f})")
        if not math.isfinite(loss):
            problems.append(f"train step loss {loss}")
        del card_tr, meta_tr

        # the whole qwen3-8b prefill on the card, traced, against its meta dry run
        model = build_model(CONFIG, device="cuda").init(0)
        prompt = {"tokens": torch.randint(0, CONFIG.vocab_size, (LM_BATCH, LM_PROMPT),
                                          generator=gen, device="cuda", dtype=torch.int32)}
        with torch.no_grad():
            model.prefill(prompt)                      # a first call
            torch.cuda.synchronize()
            build.LAUNCHES.reset()
            card_tr = trace(model.prefill, prompt)
            torch.cuda.synchronize()
            launches = build.LAUNCHES.snapshot()
            card_tr.result = None
            prefill_s = []
            for _ in range(TOOLING_TIMED):
                t = time.perf_counter()
                model.prefill(prompt)
                torch.cuda.synchronize()
                prefill_s.append(time.perf_counter() - t)
            del model, prompt
            _free(torch)
            meta_tr = trace(build_model(CONFIG, device="meta").prefill,
                            {"tokens": torch.empty((LM_BATCH, LM_PROMPT), dtype=torch.int32,
                                                   device="meta")})
        card_c, meta_c = analyze(card_tr), analyze(meta_tr)
        diff = _op_count_diff(card_tr, meta_tr)
        flash = launches.get("flash_attention_sm90", 0) + launches.get("flash_attention", 0)
        pshape = configs.ShapeSpec("lm_prefill", LM_PROMPT, LM_BATCH, "prefill")
        pterms = rl.RooflineTerms(meta_c.flops, meta_c.bytes_accessed, 0.0, 1,
                                  rl.model_flops_estimate(CONFIG, pshape))
        record["prefill"] = {
            "batch": [LM_BATCH, LM_PROMPT], "kernel_calls": card_tr.kernel_calls(),
            "launches": launches, "card_flops": card_c.flops, "meta_flops": meta_c.flops,
            "card_bytes": card_c.bytes_accessed, "meta_bytes": meta_c.bytes_accessed,
            "op_count_diff": {k: list(v) for k, v in diff.items()},
            "prefill_s": prefill_s, "median_prefill_s": statistics.median(prefill_s),
            "compute_s": pterms.compute_s, "memory_s": pterms.memory_s,
            "step_time_s": pterms.step_time_s, "bottleneck": pterms.bottleneck,
        }
        print(f"[tooling] prefill {CONFIG.name} {LM_BATCH}x{LM_PROMPT}: kernel ops "
              f"{card_tr.kernel_calls()}, launches {launches}; flops card {card_c.flops:.0f} "
              f"meta {meta_c.flops:.0f}; bytes card {card_c.bytes_accessed:.0f} meta "
              f"{meta_c.bytes_accessed:.0f}; counts differing {diff}; prefill_s {prefill_s} "
              f"(median {statistics.median(prefill_s):.6f}) against step_time_s "
              f"{pterms.step_time_s:.6f} (compute_s {pterms.compute_s:.6f}, memory_s "
              f"{pterms.memory_s:.6f}, {pterms.bottleneck})", flush=True)
        if card_tr.kernel_calls() != {"flash_attention": CONFIG.num_layers} or \
                flash != CONFIG.num_layers:
            problems.append(f"prefill: kernel ops {card_tr.kernel_calls()}, launches "
                            f"{launches}, expected {CONFIG.num_layers} flash_attention")
        if card_c.flops != meta_c.flops or \
                abs(card_c.bytes_accessed - meta_c.bytes_accessed) > \
                TOOLING_BYTES_RTOL * meta_c.bytes_accessed:
            problems.append(f"prefill totals: card {card_c.flops}, {card_c.bytes_accessed} vs "
                            f"meta {meta_c.flops}, {meta_c.bytes_accessed}; {diff}")
        del card_tr, meta_tr

        # the sharded LM phase's rank 0 step-1 collectives against its dry run
        scfg = _sharded_lm_config()
        sb = make_train_step(scfg, VirtualMesh(SHARDED_LM_MESH, axes,
                                               coord=tuple(sharded_lm["rank0_coord"])),
                             SHARDED_LM_BATCH, SHARDED_LM_SEQ,
                             opt_cfg=OptimizerConfig(**SHARDED_LM_OPT), device="meta")
        sshape = configs.ShapeSpec("sharded_lm", SHARDED_LM_SEQ, SHARDED_LM_BATCH, "train")
        str_ = trace(sb.fn, *dryrun.lm_args(sb, sshape))
        want = [[c.kind, c.nbytes, c.axis, c.group] for c in str_.collectives]
        got = [list(c) for c in sharded_lm["rank0_collectives_step1"]]
        record["sharded_collectives"] = {"rank0": _by_kind(got), "dry_run": _by_kind(want),
                                         "in_order_equal": got == want,
                                         "wire_bytes": analyze(str_).wire_bytes}
        print(f"[tooling] sharded LM step 1 on {SHARDED_LM_MESH}, rank 0's collectives "
              f"{_by_kind(got)} against the dry run's {_by_kind(want)} (kind: [count, result "
              f"bytes]); in order equal {got == want}", flush=True)
        if got != want:
            problems.append(f"sharded collectives: rank 0 {_by_kind(got)} vs dry run "
                            f"{_by_kind(want)}")

        # the production dry runs
        record["dryruns"] = []
        for arch, shape_name, out, proc in procs:
            log, _ = proc.communicate(timeout=TOOLING_DRYRUN_TIMEOUT_S)
            recs = [json.loads(line) for line in Path(out).read_text().splitlines()] \
                if Path(out).exists() else []
            rec = recs[-1] if recs else {"status": "missing", "log": log[-2000:]}
            if rec.get("status") == "ok":
                brief = {k: rec[k] for k in ("arch", "shape", "mesh", "status", "device",
                                             "compile_s", "wall_s", "memory_analysis",
                                             "collectives", "collective_result_bytes",
                                             "wire_bytes_per_device", "kernel_calls",
                                             "hlo_flops_per_device", "hlo_bytes_per_device",
                                             "flop_counter", "roofline")}
            else:
                brief = {"arch": arch, "shape": shape_name, **rec}
                problems.append(f"dry run {arch} {shape_name}: {rec.get('status')} "
                                f"{rec.get('error')} {log[-1500:]}")
            record["dryruns"].append(brief)
            print(f"[tooling] dry run {json.dumps(brief)}", flush=True)
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        raise RuntimeError("; ".join(problems))
    return record


def main() -> int:
    torch, card = _setup()
    import numpy as np

    from repro_torch.kernels import build

    t_all = t = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        build.build(verbose=True)
    print(log.getvalue(), end="", flush=True)
    build.library()
    print(f"[build] {time.perf_counter() - t:.1f} s", flush=True)
    for line in _ptxas_summary(log.getvalue(), PTXAS_KERNELS):
        print(f"[ptxas] {line}", flush=True)
    t = time.perf_counter()
    _warm_profiler(torch)
    print(f"[profiler] first session {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    operands, waves = _capture_operands(torch)
    results = _kernel_checks(torch, operands, waves)
    _adversarial_checks(torch)
    _bag_adversarial_checks(torch)
    print(f"[phase] data-path kernel checks and adversarial inputs "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    standalone = _standalone_checks(torch, operands)
    _standalone_adversarial_checks(torch)
    print(f"[phase] sigrid_hash and bucketize checks {time.perf_counter() - t:.1f} s",
          flush=True)

    # the serving path: counts set to 0 just before, read just after
    t = time.perf_counter()
    build.LAUNCHES.reset()
    batches, session, serve_s, _ = _serve(torch, "torch")
    torch.cuda.synchronize()
    launches = build.LAUNCHES.snapshot()
    print(f"[serve] main path launches {launches}", flush=True)
    for name in DATA_PATH_KERNELS:
        if launches.get(name, 0) <= 0:
            raise RuntimeError(f"the main path never launched {name}")
    for general in GENERAL_ROUTES:
        if launches.get(general, 0) != 0:
            raise RuntimeError(f"the main path launched {general}'s general route "
                               f"{launches[general]} times: every engine operand must "
                               "take the new route")
    n_stripes = sum(len(p.footer.stripes) for p in session.table.partitions.values())
    for name in ("dense_unpack_warp", "ragged_gather_vec"):
        if launches[name] != n_stripes:
            raise RuntimeError(f"the main path launched {name} {launches[name]} times, "
                               f"expected one a stripe ({n_stripes})")
    n_rows = sum(p.num_rows for p in session.table.partitions.values())
    if sum(len(b["label"]) for b in batches) != n_rows or len(batches) != n_rows // BATCH:
        raise RuntimeError(f"served {len(batches)} batches, expected {n_rows // BATCH}")
    from repro_torch.configs.dlrm_paper import CONFIG

    ids_shape = (BATCH, CONFIG.num_tables, CONFIG.max_ids_per_feature)
    for b in batches:
        if (b["dense"].shape != (BATCH, CONFIG.num_dense)
                or not np.isfinite(b["dense"]).all()):
            raise RuntimeError(f"bad dense block {b['dense'].shape}")
        if b["sparse_ids"].shape != ids_shape or b["sparse_mask"].shape != ids_shape:
            raise RuntimeError(f"bad sparse block {b['sparse_ids'].shape}")

    ref_batches, _, ref_serve_s, _ = _serve(torch, "numpy")
    if sorted(map(_digest, batches)) != sorted(map(_digest, ref_batches)):
        raise RuntimeError("torch-engine batches differ from the numpy-engine batches")
    print("[serve] batches byte-identical to the numpy engines", flush=True)
    # the same pair in the other order (numpy first), then a profiled
    # torch run for the device's busy and idle share
    serve = {"torch": [serve_s], "numpy": [ref_serve_s]}
    for engine in ("numpy", "torch"):
        serve[engine].append(_serve(torch, engine)[2])
    _, _, prof_serve_s, device_s = _serve(torch, "torch", profile=True)
    print(json.dumps({"serve": {
        "batches": len(batches), "rows": n_rows, "serve_s": serve,
        "profiled_torch_serve_s": prof_serve_s, "device_busy_s": device_s,
        "device_idle_share": _idle_share(device_s, prof_serve_s),
    }}), flush=True)

    for r in results:
        r["launches"] = launches.get(r["name"], 0)
    results.extend(standalone)            # on no path of the port: 0 launches
    print(f"[phase] serving path {time.perf_counter() - t:.1f} s", flush=True)

    # the multi-tenant service: each of its runs sets the counts to 0 just
    # before and reads them just after
    t = time.perf_counter()
    service = _service_phase(torch, sorted(map(_digest, ref_batches)),
                             session.worker_metrics())
    print(json.dumps({"service": service}), flush=True)
    print(f"[phase] multi-tenant service {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    sanitizers = _sanitizer_phase(torch, sorted(map(_digest, ref_batches)))
    print(json.dumps({"sanitizers": sanitizers}), flush=True)
    print(f"[phase] invariant gate and sanitizers {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    train_launches, bag_operands, step_bags = _train_path(torch)
    print(f"[phase] trainer path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.extend(_bag_checks(torch, bag_operands, step_bags, train_launches))
    print(f"[phase] embedding_bag checks {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(json.dumps({"checkpoint": _checkpoint_phase(torch)}), flush=True)
    print(f"[phase] checkpoint and restart {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(json.dumps({"sharded": _sharded_phase(torch, batches, card)}), flush=True)
    print(f"[phase] sharded DLRM step {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(json.dumps({"table_update": _table_update_phase(torch)}), flush=True)
    print(f"[phase] table-update kernel {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(json.dumps({"characterization": _characterization()}), flush=True)
    print(f"[phase] characterization models (host only) {time.perf_counter() - t:.1f} s",
          flush=True)

    t = time.perf_counter()
    lm_launches, lm_operands, lm = _lm_serve_path(torch)
    print(f"[phase] LM serving path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.extend(_flash_checks(torch, lm_operands, lm_launches))
    del lm_operands
    torch.cuda.empty_cache()
    _flash_adversarial_checks(torch)
    print(f"[phase] flash_attention checks {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    lm["card_vs_cpu"] = _lm_card_vs_cpu(torch)
    print(json.dumps({"lm": lm}), flush=True)
    print(f"[phase] LM card vs CPU {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    ssm_launches, ssm_operands, ssm = _ssm_serve_path(torch)
    print(f"[phase] SSM serving path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.extend(_ssd_checks(torch, ssm_operands, ssm_launches))
    del ssm_operands
    torch.cuda.empty_cache()
    _ssd_adversarial_checks(torch)
    print(f"[phase] ssd_chunk_forward checks {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    ssm["card_vs_cpu"] = _ssm_card_vs_cpu(torch)
    print(json.dumps({"ssm": ssm}), flush=True)
    print(f"[phase] SSM card vs CPU {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    fam_launches, fam_operands, families = _lm_families_path(torch)
    print(f"[phase] LM families serving path {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    results.append(_mla_flash_checks(torch, fam_operands, fam_launches))
    del fam_operands
    _free(torch)
    _mla_flash_adversarial_checks(torch)
    print(f"[phase] flash_attention D=192 checks {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    families["card_vs_cpu"] = _families_card_vs_cpu(torch)
    print(f"[phase] LM families card vs CPU {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    families["others"] = _other_families(torch)
    print(json.dumps({"lm_families": families}), flush=True)
    print(f"[phase] LM families, five other configs {time.perf_counter() - t:.1f} s",
          flush=True)

    t = time.perf_counter()
    he_launches, he_operands, hybrid_encdec = _hybrid_encdec_path(torch)
    results.extend(_hybrid_encdec_kernel_checks(torch, he_operands, he_launches))
    del he_operands
    _free(torch)
    hybrid_encdec["card_vs_cpu"] = _hybrid_encdec_card_vs_cpu(torch)
    print(json.dumps({"hybrid_encdec": hybrid_encdec}), flush=True)
    print(f"[phase] hybrid and encoder-decoder {time.perf_counter() - t:.1f} s", flush=True)

    t = time.perf_counter()
    lm_train = _lm_train_path(torch)
    print(json.dumps({"lm_train": lm_train}), flush=True)
    print(f"[phase] LM training {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(json.dumps({"lm_train_families": _lm_train_families_path(torch)}), flush=True)
    print(f"[phase] LM training, SSM and encoder-decoder families "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    sharded_lm = _sharded_lm_phase(torch, card)
    print(json.dumps({"sharded_lm": sharded_lm}), flush=True)
    print(f"[phase] sharded LM step {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    print(json.dumps({"launch_tooling": _launch_tooling_phase(torch, card, lm_train,
                                                              sharded_lm)}), flush=True)
    print(f"[phase] launch tooling {time.perf_counter() - t:.1f} s", flush=True)
    print(f"[phase] total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"kernels": results}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
